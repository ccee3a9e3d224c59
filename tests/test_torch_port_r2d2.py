"""The port's R2D2 against the JAX package's on the CPU, in f32.

- the value rescaling ``_h`` and its inverse against JAX's (rel 1e-6);
- ``_SeqBuffer``: the same rows and seed give the same samples, exactly;
- ``q_seq`` on params bridged from JAX's init, with a stored carry;
- ``make_r2d2_update`` (burn-in 2 under ``no_grad``, double Q against a
  distinct target net, h-rescaled targets, the alive mask over the whole
  sequence with episode ends inside the burn-in): the loss and every
  gradient against JAX's own ``value_and_grad`` (read through an optax
  transform whose state is the gradients) within rel 1e-5, then two Adam
  updates' params within atol 1e-5;
- two whole ``train()`` iterations from a JAX ``save()`` restored into the
  port: both draw only from numpy after their init, so the actions, the
  stored sequences (their carries within 1e-5) and the params agree;
- a JAX ``save()`` restored into the port and back; ``device=None``
  without a card raises.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from _torch_port_rl import (GradTap, assert_trees_close, assert_trees_equal,
                            jax_grad_tap, jnp_tree, np_tree, opt_back,
                            t_tree)
from ray_tpu.models.zoo import LSTMNetConfig
from ray_tpu.rllib import r2d2 as jr2d2
from ray_tpu_torch.rllib import optim
from ray_tpu_torch.rllib import r2d2 as tr2d2

SMALL = dict(env="CartPole-v1", num_envs_per_worker=2, rollout_length=24,
             learning_starts=4, batch_size=4, seq_len=8, burn_in=2,
             cell_size=16, target_update_freq=16, seed=0)


@pytest.fixture(scope="module")
def jalgo():
    """One JAX R2D2 for the file (its jitted programs compile once), its
    initial save and params (the iteration test trains it later); its
    init runs as one jit."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jr2d2, "init_r2d2_params", functools.partial(
            _jitted_init, jr2d2.init_r2d2_params))
        algo = jr2d2.R2D2Config(**SMALL).build()
    return algo, algo.save(), algo.params


def _jitted_init(init, obs_dim, num_actions, cell_size, rng):
    """JAX's init as one jit (eagerly each op compiles on its own, ~55 ms
    each on the CPU); the config it returns is built outside."""
    params = jax.jit(lambda k: init(obs_dim, num_actions, cell_size, k)[0])(
        rng)
    return params, LSTMNetConfig(obs_dim, cell_size)


def _port(saved, **kw):
    port = tr2d2.R2D2Config(**dict(SMALL, **kw), device="cpu").build()
    port.restore(saved)
    return port


def _batch(B=4, T=8, D=4, seed=0):
    """Replayed sequences: obs [B, T+1, D], episode ends (one inside the
    burn-in, then padding with done=1), stored carries."""
    rng = np.random.default_rng(seed)
    dones = np.zeros((B, T), np.float32)
    dones[0, 1] = 1.0                       # inside the burn-in
    dones[1, 5:] = 1.0                      # a padded partial row
    dones[2, 3] = 1.0
    return {"obs": rng.standard_normal((B, T + 1, D)).astype(np.float32),
            "actions": rng.integers(0, 2, (B, T)).astype(np.int32),
            "rewards": rng.standard_normal((B, T)).astype(np.float32),
            "dones": dones,
            "h0": (0.3 * rng.standard_normal((B, 16))).astype(np.float32),
            "c0": (0.3 * rng.standard_normal((B, 16))).astype(np.float32)}


def test_value_rescaling_matches():
    x = np.concatenate([np.linspace(-300, 300, 101),
                        [-1.0, -1e-3, 0.0, 1e-3, 0.5]]).astype(np.float32)
    for jf, tf in ((jr2d2._h, tr2d2._h), (jr2d2._h_inv, tr2d2._h_inv)):
        np.testing.assert_allclose(tf(torch.from_numpy(x)).numpy(),
                                   np.asarray(jf(x)), rtol=1e-6, atol=1e-7)
    back = tr2d2._h_inv(tr2d2._h(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(back, x, rtol=1e-4, atol=1e-4)


def test_seq_buffer_draws_the_same():
    jb, tb = jr2d2._SeqBuffer(5, seed=2), tr2d2._SeqBuffer(5, seed=2)
    rng = np.random.default_rng(0)
    for i in range(8):
        row = {"obs": rng.standard_normal((3, 2)).astype(np.float32),
               "actions": rng.integers(0, 2, 2).astype(np.int32)}
        jb.add(row)
        tb.add(row)
        js, ts = jb.sample(4), tb.sample(4)
        for k in js:
            assert np.array_equal(js[k], ts[k]), (i, k)


def test_q_seq_matches(jalgo):
    algo, saved, params = jalgo
    port = _port(saved)
    b = _batch(seed=1)
    carry = (b["h0"], b["c0"])
    jq, (jh, jc) = jax.jit(lambda p, o, c: jr2d2.q_seq(p, algo.lcfg, o, c))(
        params, b["obs"], carry)
    tq, (th, tc) = tr2d2.q_seq(port.params, port.lcfg,
                               torch.from_numpy(b["obs"]),
                               tuple(map(torch.from_numpy, carry)))
    for got, want in ((tq, jq), (th, jh), (tc, jc)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-5)


def test_update_loss_grads_and_steps_match(jalgo):
    algo, saved, params0 = jalgo
    port = _port(saved)
    # a target net distinct from the online one: another init
    rng = np.random.default_rng(9)
    other = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(
            np.float32), np_tree(params0))
    optim.copy_into(port.target_params, np_tree(other))
    b = _batch(seed=2)
    _, jg, jl = jr2d2.make_r2d2_update(algo.config, algo.lcfg,
                                       jax_grad_tap())(
        params0, other, (), jnp_tree(b))
    tap = GradTap(port.params)
    port._update(port.params, port.target_params, tap, t_tree(b))
    np.testing.assert_allclose(tap.loss.item(), float(jl), rtol=1e-5)
    assert_trees_close(tap.grads, jg, atol=1e-6, rtol=1e-5)

    params, opt_state = params0, algo.opt_state
    for i in range(2):
        b = _batch(seed=3 + i)
        params, opt_state, jl = algo._update(params, other, opt_state,
                                             jnp_tree(b))
        _, _, tl = port._update(port.params, port.target_params, port.opt,
                                t_tree(b))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
        assert_trees_close(port.params, params, atol=1e-5,
                           err=f"update {i}")
    assert_trees_equal(port.target_params, other)


def test_train_iterations_from_a_jax_save_match(jalgo):
    """The file's JAX R2D2, untrained so far (its numpy draws start from
    the seed), and the port restored from its initial save."""
    algo, saved, _ = jalgo
    port = _port(saved)
    for it in range(2):
        jr, tr = algo.train(), port.train()
        assert jr["buffer_sequences"] == tr["buffer_sequences"] > 0
        np.testing.assert_allclose(tr["mean_td_loss"], jr["mean_td_loss"],
                                   rtol=1e-4, atol=1e-7)
        assert algo._ep_returns == port._ep_returns
    for jrow, trow in zip(algo.buffer.rows, port.buffer.rows):
        for k in ("obs", "actions", "rewards", "dones"):
            assert np.array_equal(jrow[k], trow[k]), k
        for k in ("h0", "c0"):
            np.testing.assert_allclose(trow[k], jrow[k], atol=1e-5)
    assert_trees_close(port.params, algo.params, atol=1e-5)
    assert_trees_close(port.target_params, algo.target_params, atol=1e-5)


def test_jax_save_restores_into_the_port_and_back(jalgo):
    """The file's JAX R2D2 after the iteration test's two iterations."""
    algo = jalgo[0]
    saved = algo.save()
    port = _port(saved, seed=5)
    assert port.iteration == algo.iteration == 2
    assert port._timesteps == algo._timesteps
    ck = port.save()["payload"]
    assert_trees_equal(ck["params"], algo.params)
    assert_trees_equal(ck["target_params"], algo.target_params)
    opt = opt_back(ck["opt_state"], algo.opt_state)
    assert jax.tree_util.tree_structure(opt) == \
        jax.tree_util.tree_structure(algo.opt_state)
    assert_trees_equal(opt, algo.opt_state)
    assert port.train()["training_iteration"] == 3


def test_device_none_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr2d2.R2D2Config(**SMALL).build()
