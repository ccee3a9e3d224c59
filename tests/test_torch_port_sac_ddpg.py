"""The port's SAC, DDPG and TD3 against the JAX package's on the CPU, f32.

- SAC: two ``make_sac_update`` calls from JAX's initial state (restored
  through ``save()``) on the same batches: the two critics, their
  targets, the policy and ``log_alpha`` within atol 1e-5, the metrics
  within rel 1e-4 (the policy step reads the already-updated critics,
  the temperature its own Adam).  At SAC's default lr 3e-4: the
  policy's trunk gets gradients down to 1e-9, below Adam's eps, where
  Adam's first step g / (|g| + eps) turns f32 rounding of the gradient
  into moves of 2.5e5 times it (5e-5 at lr 3e-3);
- TD3: two updates (an actor step, then a skipped one: policy delay 2)
  with JAX's own target-noise draws fed in; DDPG (one critic: ``q2``
  gets zero gradients in the shared critic Adam and does not move);
- JAX ``save()``s restored into the port and back through the Adam
  bridge (SAC's four optimizers, DDPG's two, the critics' over the
  pair ``(q1, q2)``); one more port iteration; ``device=None`` without a
  card raises.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_port_rl import (assert_metrics_close, assert_trees_close,
                            assert_trees_equal, jnp_tree, np_tree, t_tree,
                            transition_batch)
from ray_tpu.rllib import ddpg as jddpg
from ray_tpu.rllib import sac as jsac
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import ddpg as tddpg
from ray_tpu_torch.rllib import sac as tsac

SAC_SMALL = dict(env="CartPole-v1", num_envs_per_worker=4,
                 rollout_length=16, learning_starts=32, buffer_size=256,
                 batch_size=16, hiddens=(32, 32), tau=0.05,
                 target_entropy_scale=0.3, seed=0)
DDPG_SMALL = dict(env="Pendulum-v1", num_envs_per_worker=2,
                  rollout_length=16, learning_starts=16, buffer_size=256,
                  batch_size=16, hiddens=(32, 32), actor_lr=3e-3,
                  critic_lr=3e-3, tau=0.05, seed=0)


@pytest.fixture(scope="module")
def jax_algos():
    """One JAX algorithm of each kind (their jitted updates compile once
    for the file) with its initial save and state."""
    out = {}
    for name, cls, kw in (("sac", jsac.SACConfig, SAC_SMALL),
                          ("td3", jddpg.TD3Config, DDPG_SMALL),
                          ("ddpg", jddpg.DDPGConfig, DDPG_SMALL)):
        algo = cls(**kw).build()
        out[name] = (algo, algo.save(), algo.state)
    return out


def _pair(jax_algos, name, tcls, kw):
    """The JAX algorithm, its initial state, and the port's algorithm
    restored from its initial save."""
    jalgo, saved, state = jax_algos[name]
    port = tcls(**kw, device="cpu").build()
    port.restore(saved)
    return jalgo, state, port


def _opt_back(port_opt, like):
    """The port's optimizer state in optax's layout of ``like``."""
    return convert.torch_adam_to_optax(np_tree(port_opt), like=np_tree(like))


def test_sac_updates_match_jax(jax_algos):
    jalgo, state, port = _pair(jax_algos, "sac", tsac.SACConfig, SAC_SMALL)
    assert_trees_equal(tuple(port.nets[k] for k in tsac.NETS), state[:6])
    for i in range(2):
        batch = transition_batch(16, seed=10 + i)
        state, jm = jalgo._update(state, jnp_tree(batch))
        tm = port._update(port.nets, port.opts, t_tree(batch))
        assert set(tm) == set(jm)
        assert_metrics_close(tm, jm)
        for k, want in zip(tsac.NETS, state[:6]):
            assert_trees_close(port.nets[k], want, atol=1e-5,
                               err=f"update {i} {k}")
    for k, want in zip(tsac.OPTS, state[6:]):
        assert port.opts[k].count == 2
        assert_trees_close(_opt_back(port.opts[k].state(), want), want,
                           atol=1e-5, rtol=1e-4, err=k)


def test_sac_actions_come_from_the_generator():
    a = tsac.SACConfig(**SAC_SMALL, device="cpu").build()
    b = tsac.SACConfig(**SAC_SMALL, device="cpu").build()
    obs = np.random.default_rng(0).standard_normal((64, 4)).astype(
        np.float32)
    x, y = a._sample_action(obs), b._sample_action(obs)
    assert np.array_equal(x, y) and set(np.unique(x)) <= {0, 1}
    assert not np.array_equal(a._sample_action(obs), x)


def _jax_noise(rng, shape):
    """The draw JAX's update makes for TD3's target noise from its key
    (batches of the algorithm's batch size: its jitted update compiles
    once for the file)."""
    rng, sub = jax.random.split(rng)
    return np.array(jax.random.normal(sub, shape))


@pytest.mark.parametrize("which", ["td3", "ddpg"])
def test_ddpg_updates_match_jax(jax_algos, which):
    tcls = tddpg.TD3Config if which == "td3" else tddpg.DDPGConfig
    jalgo, state, port = _pair(jax_algos, which, tcls, DDPG_SMALL)
    assert_trees_equal(tuple(port.nets[k] for k in tddpg.NETS), state[:6])
    q2 = np_tree(state[3])
    for step in range(2):
        batch = transition_batch(16, obs_dim=3, seed=20 + step, act_dim=1)
        noise = _jax_noise(state[8], (16, 1))
        state, jc, ja = jalgo._update(state, jnp_tree(batch),
                                      np.int32(step))
        tc, ta = port._update(port.nets, port.opts, t_tree(batch), step,
                              noise=torch.as_tensor(noise))
        np.testing.assert_allclose(tc.item(), float(jc), rtol=1e-4)
        np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-4,
                                   atol=1e-7)
        for k, want in zip(tddpg.NETS, state[:6]):
            assert_trees_close(port.nets[k], want, atol=1e-5,
                               err=f"step {step} {k}")
    if which == "td3":      # policy delay 2: the second step skips pi
        assert float(ja) == 0.0 and port.opts["pi"].count == 1
    else:                   # one critic: q2 has zero gradients
        assert_trees_equal(port.nets["q2"], q2)
    assert port.opts["q"].count == 2
    assert_trees_close(_opt_back(port.opts["q"].state(), state[7]),
                       state[7], atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("which", ["sac", "td3", "ddpg"])
def test_jax_save_restores_into_the_port_and_back(jax_algos, which):
    tcls, kw = {"sac": (tsac.SACConfig, SAC_SMALL),
                "td3": (tddpg.TD3Config, DDPG_SMALL),
                "ddpg": (tddpg.DDPGConfig, DDPG_SMALL)}[which]
    jalgo = jax_algos[which][0]
    jalgo.train()
    saved = jalgo.save()
    port = tcls(**dict(kw, seed=7), device="cpu").build()
    port.restore(saved)
    assert port.iteration == 1 and port._timesteps == jalgo._timesteps
    state = port.save()["payload"]["state"]
    n = len(tsac.NETS) if which == "sac" else len(tddpg.NETS)
    assert_trees_equal(state[:n], jalgo.state[:n])
    for got, want in zip(state[n:], jalgo.state[n:n + len(state) - n]):
        opt = _opt_back(got, want)
        assert jax.tree_util.tree_structure(opt) == \
            jax.tree_util.tree_structure(want)
        assert_trees_equal(opt, want)
    r = port.train()
    assert r["training_iteration"] == 2 and r["buffer_size"] > 0
    if which != "sac":
        assert port._grad_steps > jalgo._grad_steps
        a = port.compute_action(np.zeros(3, np.float32))
        assert a.shape == (1,) and -2.0 <= float(a[0]) <= 2.0


def test_device_none_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cfg in (tsac.SACConfig(**SAC_SMALL), tddpg.DDPGConfig(**DDPG_SMALL),
                tddpg.TD3Config(**DDPG_SMALL)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cfg.build()
