"""The port's QMIX against the JAX package's on the CPU, in f32.

- ``TeamSwitch``: the same seed and actions give the same observations,
  global states and rewards, exactly;
- ``agent_q`` (every agent as one batched product over the stacked
  leaves) and the monotonic ``mix`` on params bridged from JAX's
  ``vmap``-ed init;
- ``make_qmix_update``: the loss and every gradient against JAX's own
  ``value_and_grad`` (read through an optax transform whose state is the
  gradients) within rel 1e-5, then two Adam updates' params within atol
  1e-5;
- two whole ``train()`` iterations from a JAX ``save()``: both draw only
  from numpy after their init, so the buffer and the params agree;
- that save restored into the port and back through the Adam bridge;
  ``device=None`` without a card raises.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_port_rl import (GradTap, assert_trees_close, assert_trees_equal,
                            jax_grad_tap, jnp_tree, np_tree, opt_back,
                            t_tree)
from ray_tpu.rllib import qmix as jqmix
from ray_tpu_torch.rllib import optim
from ray_tpu_torch.rllib import qmix as tqmix

QMIX_SMALL = dict(num_agents=3, rollout_length=48, learning_starts=16,
                  batch_size=8, hiddens=(16, 16), mixing_embed=8,
                  target_update_freq=24, seed=0)


@pytest.fixture(scope="module")
def jqalgo():
    """One JAX QMIX for the file, its initial save and params (the
    iteration test trains it last).  Its init runs as one jit: eagerly,
    each of its ops compiles on its own (~55 ms each on the CPU)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jqmix, "init_qmix_params", jax.jit(
            jqmix.init_qmix_params, static_argnums=(0, 1, 2, 3, 4, 5)))
        algo = jqmix.QMIXConfig(**QMIX_SMALL).build()
    return algo, algo.save(), algo.params


def _port(cls, kw, saved, **over):
    port = cls(**dict(kw, **over), device="cpu").build()
    port.restore(saved)
    return port


def _qmix_batch(B=8, N=3, seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((B, N, 2)).astype(np.float32),
            "actions": rng.integers(0, 2, (B, N)).astype(np.int32),
            "rewards": rng.integers(0, 2, B).astype(np.float32),
            "dones": (rng.random(B) < 0.25).astype(np.float32),
            "next_obs": rng.standard_normal((B, N, 2)).astype(np.float32),
            "state": rng.standard_normal((B, N + 1)).astype(np.float32),
            "next_state": rng.standard_normal((B, N + 1)).astype(
                np.float32)}


def test_team_switch_matches():
    je, te = jqmix.TeamSwitch(3, seed=2), tqmix.TeamSwitch(3, seed=2)
    jo, to = je.reset(), te.reset()
    rng = np.random.default_rng(0)
    for _ in range(40):
        assert np.array_equal(je.state(), te.state())
        for a in jo:
            assert np.array_equal(jo[a], to[a])
        acts = {a: int(rng.integers(0, 2)) for a in je.agent_ids}
        jo, jr, jd, _ = je.step(acts)
        to, tr, td, _ = te.step(acts)
        assert jr == tr and jd == td
        if jd["__all__"]:
            jo, to = je.reset(), te.reset()


def test_agent_q_and_mixer_match(jqalgo):
    """agent_q through the JAX algorithm's own jit (the shape it acts
    on); the mixer through the update's loss below, and monotonic."""
    algo, saved, params = jqalgo
    port = _port(tqmix.QMIXConfig, QMIX_SMALL, saved)
    b = _qmix_batch(B=1, seed=1)
    jq = algo._agent_q(params["agents"], b["obs"])
    tq = tqmix.agent_q(port.params["agents"], torch.from_numpy(b["obs"]))
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq),
                               atol=1e-6, rtol=1e-5)
    chosen, state = torch.randn(64, 3), torch.randn(64, 4)
    q = tqmix.mix(port.params, chosen, state)
    for i in range(3):
        up = tqmix.mix(port.params, chosen + torch.eye(3)[i], state)
        assert bool((up >= q).all())


def test_qmix_update_loss_grads_and_steps_match(jqalgo):
    algo, saved, params0 = jqalgo
    port = _port(tqmix.QMIXConfig, QMIX_SMALL, saved)
    # a target net distinct from the online one
    rng = np.random.default_rng(9)
    other = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(
            np.float32), np_tree(params0))
    optim.copy_into(port.target_params, np_tree(other))
    b = _qmix_batch(seed=2)
    _, jg, jl = jqmix.make_qmix_update(algo.config, jax_grad_tap())(
        params0, other, (), jnp_tree(b))
    tap = GradTap(port.params)
    port._update(port.params, port.target_params, tap, t_tree(b))
    np.testing.assert_allclose(tap.loss.item(), float(jl), rtol=1e-5)
    assert_trees_close(tap.grads, jg, atol=1e-6, rtol=1e-5)

    params, opt_state = params0, algo.opt_state
    for i in range(2):
        b = _qmix_batch(seed=3 + i)
        params, opt_state, jl = algo._update(params, other, opt_state,
                                             jnp_tree(b))
        _, _, tl = port._update(port.params, port.target_params, port.opt,
                                t_tree(b))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
        assert_trees_close(port.params, params, atol=1e-5,
                           err=f"update {i}")


def test_qmix_train_iterations_and_save_match(jqalgo):
    algo, saved, _ = jqalgo
    port = _port(tqmix.QMIXConfig, QMIX_SMALL, saved)
    for _ in range(2):
        jr, tr = algo.train(), port.train()
        np.testing.assert_allclose(tr["mean_td_loss"], jr["mean_td_loss"],
                                   rtol=1e-4, atol=1e-7)
        assert algo._ep_returns == port._ep_returns
    assert algo.buffer._size == port.buffer._size
    for k, v in algo.buffer._cols.items():
        assert np.array_equal(v[:algo.buffer._size],
                              port.buffer._cols[k][:port.buffer._size]), k
    assert_trees_close(port.params, algo.params, atol=1e-5)

    back = _port(tqmix.QMIXConfig, QMIX_SMALL, algo.save(), seed=4)
    ck = back.save()["payload"]
    assert_trees_equal(ck["params"], algo.params)
    assert_trees_equal(ck["target_params"], algo.target_params)
    assert_trees_equal(opt_back(ck["opt_state"], algo.opt_state),
                       algo.opt_state)
    assert back.train()["training_iteration"] == 3


def test_device_none_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tqmix.QMIXConfig(**QMIX_SMALL).build()
