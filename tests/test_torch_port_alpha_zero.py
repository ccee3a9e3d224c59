"""The port's AlphaZero against the JAX package's on the CPU, in f32.

- ``GridGoal`` and ``RankedRewardsBuffer`` behave the same, exactly;
- ``MCTS`` (a numpy copy) with one predictor and one seed: the same
  visit distributions, and the env put back at the root;
- ``az_forward`` on params bridged from JAX's init;
- the train step (policy cross-entropy to the visit distribution, value
  MSE, L2 over every leaf): its three losses and every gradient against
  JAX's own ``value_and_grad`` (read through an optax transform whose
  state is the gradients) within rel 1e-5, then two Adam steps' params
  within atol 1e-5;
- two whole ``train()`` iterations from a JAX ``save()``: self-play draws
  only from numpy, so with the same net the searches visit alike (a
  PUCT tie broken apart by f32 rounding would show here), and the
  replay rows and the params agree;
- that save restored into the port and back through the Adam bridge;
  ``device=None`` without a card raises.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_port_rl import (GradTap, assert_trees_close, assert_trees_equal,
                            jax_grad_tap, opt_back)
from ray_tpu.rllib import alpha_zero as jaz
from ray_tpu_torch.rllib import alpha_zero as taz

SMALL = dict(num_sims=12, episodes_per_iter=4, batch_size=16,
             hiddens=(16, 16), buffer_size=256, seed=0)


@pytest.fixture(scope="module")
def jalgo():
    """One JAX AlphaZero for the file, its initial save and params (the
    iteration test trains it last); its init runs as one jit (eagerly,
    each op compiles on its own, ~55 ms each on the CPU)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jaz, "init_az_params", jax.jit(
            jaz.init_az_params, static_argnums=(0, 1, 2)))
        algo = jaz.AlphaZeroConfig(**SMALL).build()
    return algo, algo.save(), algo.params


def _port(saved, **kw):
    port = taz.AlphaZeroConfig(**dict(SMALL, **kw), device="cpu").build()
    port.restore(saved)
    return port


def test_grid_goal_and_ranked_rewards_match():
    je, te = jaz.GridGoal(), taz.GridGoal()
    rng = np.random.default_rng(0)
    for _ in range(6):
        jo, to = je.reset(), te.reset()
        done = False
        while not done:
            for k in jo:
                assert np.array_equal(jo[k], to[k])
            a = int(rng.integers(0, 4))
            jo, jr, done, _ = je.step(a)
            to, tr, tdone, _ = te.step(a)
            assert (jr, done, je.get_state()) == (tr, tdone, te.get_state())
    jb, tb = jaz.RankedRewardsBuffer(5, 60.0), taz.RankedRewardsBuffer(
        5, 60.0)
    for r in rng.integers(0, 2, 30).astype(float):
        assert jb.normalize(r) == tb.normalize(r)
        jb.add(r)
        tb.add(r)
        assert jb.buffer == tb.buffer


def test_mcts_visits_match():
    cfg = taz.AlphaZeroConfig(num_sims=24)
    w = np.random.default_rng(3).standard_normal((17, 5)).astype(np.float32)

    def predict(obs):
        out = np.tanh(obs @ w)
        p = np.exp(out[:4])
        return p / p.sum(), float(out[4])
    je, te = jaz.GridGoal(), taz.GridGoal()
    jm = jaz.MCTS(predict, cfg, np.random.default_rng(1))
    tm = taz.MCTS(predict, cfg, np.random.default_rng(1))
    jo, to = je.reset(), te.reset()
    for a in (1, 2, 1, 1):
        jpi, tpi = jm.search(je, jo), tm.search(te, to)
        assert np.array_equal(jpi, tpi)
        assert je.get_state() == te.get_state()
        jo, _, _, _ = je.step(a)
        to, _, _, _ = te.step(a)


def _rows(n=16, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((n, 17)).astype(np.float32)
    pi = rng.dirichlet(np.ones(4), n).astype(np.float32)
    z = rng.choice([-1.0, 1.0], n).astype(np.float32)
    return obs, pi, z


def test_forward_losses_grads_and_steps_match(jalgo):
    algo, saved, params0 = jalgo
    port = _port(saved)
    obs, pi, z = _rows(seed=1)
    jl, jv = jax.jit(jaz.az_forward)(params0, obs)
    tl, tv = taz.az_forward(port.params, torch.from_numpy(obs))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                               atol=1e-6, rtol=1e-5)

    # JAX's update reads ``algo.tx`` when it traces: a tap for the
    # gradients (an empty optimizer state), then Adam again
    tx = algo.tx
    algo.tx = jax_grad_tap()
    _, jg, jloss, jpl, jvl = algo._update(params0, (), obs, pi, z)
    algo.tx = tx
    tap = GradTap(port.params)
    port.opt, opt = tap, port.opt
    tloss, tpl, tvl = port.update(*map(torch.from_numpy, (obs, pi, z)))
    port.opt = opt
    np.testing.assert_allclose([tloss.item(), tpl.item(), tvl.item()],
                               [float(jloss), float(jpl), float(jvl)],
                               rtol=1e-5)
    assert_trees_close(tap.grads, jg, atol=1e-6, rtol=1e-5)

    params, opt_state = params0, algo.opt_state
    for i in range(2):
        obs, pi, z = _rows(seed=2 + i)
        params, opt_state, jloss, _, _ = algo._update(params, opt_state,
                                                      obs, pi, z)
        tloss, _, _ = port.update(*map(torch.from_numpy, (obs, pi, z)))
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
        assert_trees_close(port.params, params, atol=1e-5,
                           err=f"update {i}")


def test_train_iterations_and_save_match(jalgo):
    algo, saved, _ = jalgo
    port = _port(saved)
    for _ in range(2):
        jr, tr = algo.train(), port.train()
        assert jr["replay_rows"] == tr["replay_rows"]
        assert jr["episode_reward_mean"] == tr["episode_reward_mean"]
        np.testing.assert_allclose(tr["mean_loss"], jr["mean_loss"],
                                   rtol=1e-4, atol=1e-7)
    assert len(algo._replay) == len(port._replay)
    for (jo, jpi, jz), (to, tpi, tz) in zip(algo._replay, port._replay):
        assert np.array_equal(jo, to) and np.array_equal(jpi, tpi)
        assert jz == tz
    assert_trees_close(port.params, algo.params, atol=1e-5)

    back = _port(algo.save(), seed=4)
    ck = back.save()["payload"]
    assert_trees_equal(ck["params"], algo.params)
    assert ck["r2"] == list(algo.r2.buffer)
    assert_trees_equal(opt_back(ck["opt_state"], algo.opt_state),
                       algo.opt_state)
    assert back.train()["training_iteration"] == 3


def test_device_none_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        taz.AlphaZeroConfig(**SMALL).build()
