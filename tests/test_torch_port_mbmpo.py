"""The port's MB-MPO against the JAX package's on the CPU, in f32.

- the transitions a rollout gives the dynamics fit (successors from the
  next step or the bootstrap observation), equal to the JAX package's;
- the ensemble fit (every member on its own bootstrap rows, Adam over
  the stacked members, from the ensemble bridged from JAX's ``vmap``-ed
  init) with JAX's ``jax.random.randint`` indices fed in: every member
  within atol 1e-5, the members' losses (``_model_forward`` on all the
  data) within rel 1e-5;
- the meta-update's SECOND-ORDER meta-gradient (one inner
  policy-gradient step per model, differentiated through with
  ``create_graph=True``) against ``jax.grad`` through the JAX package's
  scans, with JAX's Gumbel noise fed in, within rel 1e-5 (read back
  from Adam's first moment after the step, both packages), and the
  meta-loss, the imagined return and the policy after the Adam step;
- a JAX ``save()`` restored into the port (the layout has no optimizer
  state) and back; ``device=None`` without a card raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_rl import assert_trees_close, assert_trees_equal, np_tree
from ray_tpu.rllib import mbmpo as jmbmpo
from ray_tpu.rllib import policy as jpolicy
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import mbmpo as tmbmpo

SMALL = dict(env="CartPole-v1", num_envs_per_worker=4, rollout_length=16,
             real_batch_size=64, ensemble_size=2, model_epochs=3,
             meta_steps=1, imagine_horizon=5, imagine_rollouts=8,
             model_hidden=16, hiddens=(16,), seed=0)


@pytest.fixture(scope="module")
def jalgo():
    """One JAX MB-MPO for the file and its initial save; its inits run
    as jits (eagerly, each op compiles on its own, ~55 ms each on the
    CPU)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jmbmpo, jpolicy):
            mp.setattr(mod, "init_policy_params", jax.jit(
                jpolicy.init_policy_params, static_argnums=0))
        mp.setattr(jmbmpo, "_model_init", jax.jit(
            jmbmpo._model_init, static_argnums=(1, 2, 3)))
        algo = jmbmpo.MBMPOConfig(**SMALL).build()
    return algo, algo.save()


def _port(saved, **kw):
    port = tmbmpo.MBMPOConfig(**dict(SMALL, **kw), device="cpu").build()
    port.restore(saved)
    return port


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    obs = (0.2 * rng.standard_normal((n, 4))).astype(np.float32)
    act = rng.integers(0, 2, n)
    return {"obs": obs, "act1h": np.eye(2, dtype=np.float32)[act],
            "next_obs": (obs + 0.05 * rng.standard_normal((n, 4))).astype(
                np.float32),
            "rew": np.ones(n, np.float32),
            "done": (rng.random(n) < 0.1).astype(np.float32)}


def _jax_fit_idx(rng, E, epochs, n):
    """The bootstrap rows JAX's fit draws: member keys, then epoch keys."""
    return np.stack([np.stack([
        np.asarray(jax.random.randint(k, (min(512, n),), 0, n))
        for k in jax.random.split(r, epochs)])
        for r in jax.random.split(rng, E)])


def _jax_gumbel(rng, cfg, B, A=2):
    """The Gumbel noise behind JAX's imagined categorical draws:
    [meta steps, members, (inner, outer), horizon, B, A]."""
    def member(r):
        return jnp.stack([jax.vmap(lambda k: jax.random.gumbel(k, (B, A)))(
            jax.random.split(ri, cfg.imagine_horizon))
            for ri in jax.random.split(r)])
    return np.asarray(jax.jit(lambda rng: jnp.stack([
        jnp.stack([member(r) for r in jax.random.split(rs,
                                                       cfg.ensemble_size)])
        for rs in jax.random.split(rng, cfg.meta_steps)]))(rng))


def test_transitions_match(jalgo):
    port = _port(jalgo[1])
    b, _ = port.workers.sample_sync()
    t = port.transitions([b])
    # the JAX package's own construction, for one worker's rollout
    T, Bn = SMALL["rollout_length"], SMALL["num_envs_per_worker"]
    blk = np.asarray(b["obs"]).reshape(T, Bn, 4)
    nxt = np.concatenate([blk[1:], np.asarray(b["bootstrap_obs"])[None]])
    assert np.array_equal(t["next_obs"].numpy(), nxt.reshape(-1, 4))
    assert np.array_equal(t["act1h"].numpy().argmax(-1), b["actions"])


def test_ensemble_fit_with_jax_indices_matches(jalgo):
    algo, saved = jalgo
    port = _port(saved)
    d = _data(seed=2)
    rng = jax.random.PRNGKey(3)
    models, _, jl = algo._fit_models(algo.models, algo.model_opt, rng,
                                     jax.tree_util.tree_map(jnp.asarray, d))
    idx = _jax_fit_idx(rng, 2, SMALL["model_epochs"], 64)
    tl = port._fit_models(port.models, port.model_opt,
                          {k: torch.from_numpy(v) for k, v in d.items()},
                          idx=idx)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    assert_trees_close(port.models, models, atol=1e-5)


def _first_moment(opt_state):
    """Adam's first moment after its first step from zero: mu = 0.1 g."""
    if not isinstance(opt_state, dict):
        opt_state = convert.optax_adam_to_torch(opt_state)
    return jax.tree_util.tree_map(np.asarray, opt_state["mu"])


def test_meta_gradient_and_meta_step_match(jalgo):
    """One meta step (``meta_steps`` 1): JAX's meta-gradient read back
    from Adam's first moment (mu = (1 - b1) g from zero moments) against
    the port's, the meta-loss, the imagined return and the policy after
    the Adam step."""
    algo, saved = jalgo
    starts = _data(n=8, seed=4)["obs"]
    rng = jax.random.PRNGKey(5)
    jp, jopt, jl, jret = algo._meta_update(algo.params, algo.opt_state,
                                           algo.models, rng, starts)
    port = _port(saved)
    tp, topt, tl, tret = port._meta_update(
        port.params, port.opt, port.models, torch.from_numpy(starts),
        gumbel=_jax_gumbel(rng, algo.config, 8))
    # the surrogate is a mean of terms of both signs: 1e-6 absolute on a
    # meta-loss near 1e-3 is f32 rounding of that sum
    np.testing.assert_allclose([tl.item(), tret.item()],
                               [float(jl), float(jret)], rtol=1e-5,
                               atol=1e-6)
    assert_trees_close(_first_moment(topt.state()), _first_moment(jopt),
                       atol=1e-7, rtol=1e-5)
    assert_trees_close(tp, jp, atol=1e-5)


def test_jax_save_restores_into_the_port_and_back(jalgo):
    algo, _ = jalgo
    algo.train()
    saved = algo.save()
    port = _port(saved, seed=3)
    assert port.iteration == 1 and port._timesteps == algo._timesteps
    ck = port.save()["payload"]
    assert set(ck) == {"params", "models", "timesteps"}
    assert_trees_equal(ck["params"], algo.params)
    assert_trees_equal(ck["models"], algo.models)
    r = port.train()
    assert r["training_iteration"] == 2 and np.isfinite(r["meta_loss"])
    assert np_tree(port.models)["w1"].shape == (2, 6, 16)


def test_device_none_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmbmpo.MBMPOConfig(**SMALL).build()
