"""The port's Dreamer against the JAX package's on the CPU, in f32.

- ``LinearLatentEnv`` and ``EpisodeBuffer``: the same seeds give the same
  episodes and windows, exactly;
- two updates from a JAX ``save()`` restored into the port (params
  bridged from JAX's init, optax's ``chain(clip_by_global_norm, adam)``
  bridged), with JAX's ``jax.random.normal`` draws fed in (the posterior
  pass's and the imagination's actor and prior noise).  The first
  update's world-model losses (the GRU, prior, posterior and KL of
  ``observe``, the decoders), the actor's (through the dynamics, over
  the actor's leaves only) and the critic's within rel 1e-5, and every
  gradient of the three optimizers (read back from Adam's first moment)
  within rel 1e-5; both updates' params and moments within atol 1e-5;
- a warm-up update steps the model alone, as the full update's model
  step;
- ``policy_step`` (filtering and acting) with JAX's draws fed in;
- the save restored into the port and back through the Adam bridge;
  ``device=None`` without a card raises.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_port_rl import (assert_trees_close, assert_trees_equal, jnp_tree,
                            np_tree, opt_back, t_tree)
from ray_tpu.rllib import dreamer as jdreamer
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import dreamer as tdreamer

SMALL = dict(deter_size=16, stoch_size=4, hidden=16, imagine_horizon=5,
             batch_size=3, seq_len=6, prefill_episodes=2,
             episodes_per_step=1, train_iters_per_step=2,
             model_warmup_updates=1, seed=0)
T, B, S, A = 6, 3, 4, 2


@pytest.fixture(scope="module")
def jalgo():
    """One JAX Dreamer for the file and its initial save and state; its
    init runs as one jit (eagerly, each op compiles on its own, ~55 ms
    each on the CPU)."""
    init = jdreamer.init_dreamer_params
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdreamer, "init_dreamer_params",
                   lambda cfg, o, a, rng: jax.jit(
                       lambda k: init(cfg, o, a, k))(rng))
        algo = jdreamer.DreamerConfig(**SMALL).build()
    return algo, algo.save(), algo.state


def _port(saved, **kw):
    port = tdreamer.DreamerConfig(**dict(SMALL, **kw), device="cpu").build()
    port.restore(saved)
    return port


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((B, T, 6)).astype(np.float32),
            "actions": rng.uniform(-1, 1, (B, T, A)).astype(np.float32),
            "rewards": -rng.uniform(0, 2, (B, T)).astype(np.float32)}


@jax.jit
def _jax_draws(rng):
    """The normal draws JAX's update makes from its key: the observe
    pass's [T, B, S] and the imagination's actor [H, N, A] and prior
    [H, N, S] noise (N = B * T)."""
    H, N = SMALL["imagine_horizon"], B * T
    r1, r2, _ = jax.random.split(rng, 3)
    obs = []
    for _ in range(T):
        r1, sub = jax.random.split(r1)
        obs.append(jax.random.normal(sub, (B, S)))
    act, lat = [], []
    for _ in range(H):
        r2, s1, s2 = jax.random.split(r2, 3)
        act.append(jax.random.normal(s1, (N, A)))
        lat.append(jax.random.normal(s2, (N, S)))
    stack = jax.numpy.stack
    return {"observe": stack(obs), "imagine_a": stack(act),
            "imagine_s": stack(lat)}


def _eps(rng):
    return {k: torch.from_numpy(np.array(v))
            for k, v in _jax_draws(rng).items()}


def test_env_and_episode_buffer_match():
    je, te = jdreamer.LinearLatentEnv(seed=3), tdreamer.LinearLatentEnv(
        seed=3)
    assert np.array_equal(je.reset(), te.reset())
    rng = np.random.default_rng(0)
    for _ in range(70):
        a = rng.uniform(-1.5, 1.5, 2)
        jo, jr, jd = je.step(a)
        to, tr, td = te.step(a)
        assert np.array_equal(jo, to) and (jr, jd) == (tr, td)
    jb, tb = jdreamer.EpisodeBuffer(3, seed=1), tdreamer.EpisodeBuffer(
        3, seed=1)
    for n in (10, 4, 7, 12):
        ep = {"obs": rng.standard_normal((n, 6)).astype(np.float32),
              "actions": rng.standard_normal((n, 2)).astype(np.float32),
              "rewards": rng.standard_normal(n).astype(np.float32)}
        jb.add(ep)
        tb.add(ep)
        js, ts = jb.sample(4, 6), tb.sample(4, 6)
        for k in js:
            assert np.array_equal(js[k], ts[k]), k


def _first_grads(opt_state):
    """A step's gradients from Adam's first moment after it, the first
    step from zero moments: mu = (1 - b1) g, b1 = 0.9."""
    if not isinstance(opt_state, dict):
        opt_state = convert.optax_adam_to_torch(opt_state)
    mu = opt_state["mu"]
    return jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, mu)


def test_updates_from_a_save_match(jalgo):
    """The first update's losses and gradients (each optimizer's, read
    back from its first moment; the clip at global norm 100 is not
    reached) within rel 1e-5, then both updates' metrics within rel 1e-4
    and params and moments within atol 1e-5."""
    algo, saved, state = jalgo
    port = _port(saved)
    for i in range(2):
        b, rng = _batch(seed=3 + i), jax.random.PRNGKey(6 + i)
        state, jm = algo._update(state, jnp_tree(b), rng, train_ac=True)
        tm = port._update(port.params, port.opts, t_tree(b), eps=_eps(rng))
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                       rtol=1e-5 if i == 0 else 1e-4,
                                       atol=1e-7 if i == 0 else 1e-6,
                                       err_msg=f"update {i} {k}")
        if i == 0:
            for k, want in zip(("model", "actor", "critic"), state[1:]):
                assert_trees_close(_first_grads(port.opts[k].state()),
                                   _first_grads(want), atol=1e-6,
                                   rtol=1e-5, err=f"{k} gradients")
        assert_trees_close(port.params, state[0], atol=1e-5,
                           err=f"update {i}")
    for k, want in zip(("model", "actor", "critic"), state[1:]):
        assert port.opts[k].count == 2
        assert_trees_close(opt_back(port.opts[k].state(), want), want,
                           atol=1e-5, rtol=1e-4, err=k)
    # the save test below restores this state
    algo.state, algo._model_updates = state, 2


def test_warmup_steps_the_model_alone(jalgo):
    """The warm-up's model step is the full update's, bit for bit; the
    actor and the critic do not move."""
    saved = jalgo[1]
    warm, full = _port(saved), _port(saved)
    b, eps = t_tree(_batch(seed=9)), _eps(jax.random.PRNGKey(9))
    m = warm._update(warm.params, warm.opts, b, train_ac=False, eps=eps)
    full._update(full.params, full.opts, b, eps=eps)
    assert float(m["actor_loss"]) == float(m["critic_loss"]) == 0.0
    for k in tdreamer.MODEL_KEYS:
        assert_trees_equal(warm.params[k], full.params[k])
    for k in ("actor", "critic"):
        assert_trees_equal(warm.params[k], np_tree(saved["payload"][
            "state"][0][k]))
        assert warm.opts[k].count == 0


def test_policy_step_matches(jalgo):
    algo, saved, state = jalgo
    port = _port(saved)
    rng = np.random.default_rng(7)
    stoch = rng.standard_normal((1, S)).astype(np.float32)
    deter = rng.standard_normal((1, 16)).astype(np.float32)
    prev = rng.uniform(-1, 1, (1, A)).astype(np.float32)
    obs = rng.standard_normal((1, 6)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    js, jh, ja, _ = algo._policy_step(state[0], stoch, deter, prev, obs,
                                      key)
    _, s1, s2 = jax.random.split(key, 3)
    eps_s = np.array(jax.random.normal(s1, (1, S)))
    eps_a = np.array(jax.random.normal(s2, (1, A)))
    out = tdreamer.policy_step(port.params, *map(torch.from_numpy, (
        stoch, deter, prev, obs, eps_s, eps_a)))
    for got, want in zip(out, (js, jh, ja)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-5)


def _after_two_updates(jalgo):
    """The JAX Dreamer after ``test_updates_from_a_save_match``'s two
    updates, made here when that test ran on another xdist worker."""
    algo, _, state = jalgo
    if algo._model_updates == 0:
        for i in range(2):
            state, _ = algo._update(state, jnp_tree(_batch(seed=3 + i)),
                                    jax.random.PRNGKey(6 + i),
                                    train_ac=True)
        algo.state, algo._model_updates = state, 2
    return algo


def test_save_restores_into_the_port_and_back(jalgo):
    algo = _after_two_updates(jalgo)
    saved = algo.save()
    port = _port(saved, seed=3)
    assert port._model_updates == algo._model_updates == 2
    assert port.opts["actor"].count == 2
    ck = port.save()["payload"]
    assert_trees_equal(ck["state"][0], algo.state[0])
    for got, want in zip(ck["state"][1:], algo.state[1:]):
        opt = opt_back(got, want)
        assert jax.tree_util.tree_structure(opt) == \
            jax.tree_util.tree_structure(want)
        assert_trees_equal(opt, want)
    r = port.train()
    assert r["training_iteration"] == 1 and np.isfinite(r["obs_loss"])
    assert np.isfinite(port.evaluate_episodes(1))
    assert np_tree(port.params["gru"]["wi"]["w"]).shape == (6, 48)


def test_device_none_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdreamer.DreamerConfig(**SMALL).build()
