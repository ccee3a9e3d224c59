"""The port's LinUCB, LinTS, ES and ARS against the JAX package's on the
CPU, in f32.

- the bandit env's contexts, rewards and regrets are the same draws;
  the UCB scores and the Thompson scores (JAX's normal draw ``z`` fed
  in) within rel 1e-4 on ridge statistics after 40 updates;
- 120 LinUCB steps on JAX's arms: the port's scores within rel 1e-4 at
  each step and the same A and b (rel 1e-5);
- ES and ARS: the flat parameter vector in JAX's leaf order, centred
  ranks exact, and two iterations with JAX's perturbations fed in: the
  same greedy returns, ARS's observation filter moments and theta
  within atol 1e-5;
- JAX ``save()``s restored into the port and back; ``eval_parallelism
  > 0`` without the actor stand-in initialised raises at the first
  evaluation, as the JAX package's does without ``ray_tpu.init()`` (the
  arm itself is in ``test_torch_port_es_parallel.py``); ``device=None``
  without a card raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_rl import np_tree
from ray_tpu.rllib import bandit as jbandit
from ray_tpu.rllib import es as jes
from ray_tpu_torch.rllib import bandit as tbandit
from ray_tpu_torch.rllib import es as tes


def _bandit_pair(exploration, seed=1):
    kw = dict(exploration=exploration, steps_per_iter=64, seed=0)
    j = jbandit.BanditConfig(env=lambda: jbandit.LinearBanditEnv(seed=seed),
                             **kw).build()
    t = tbandit.BanditConfig(env=lambda: tbandit.LinearBanditEnv(seed=seed),
                             device="cpu", **kw).build()
    return j, t


def test_bandit_env_draws_match():
    je, te = jbandit.LinearBanditEnv(seed=3), tbandit.LinearBanditEnv(seed=3)
    assert np.array_equal(je.w, te.w)
    assert np.array_equal(je.reset(), te.reset())
    for arm in [0, 3, 1, 4, 2] * 4:
        a, b = je.step(arm), te.step(arm)
        assert np.array_equal(a[0], b[0]) and a[1:] == b[1:]


def _stats(seed=4, n=40, K=5, d=8):
    rng = np.random.default_rng(seed)
    A = np.stack([np.eye(d)] * K).astype(np.float32)
    b = np.zeros((K, d), np.float32)
    for _ in range(n):
        x = rng.standard_normal(d).astype(np.float32)
        k = int(rng.integers(0, K))
        A[k] += np.outer(x, x)
        b[k] += np.float32(rng.standard_normal()) * x
    return A, b, rng.standard_normal(d).astype(np.float32)


def test_ucb_and_ts_scores_match_jax():
    j, t = _bandit_pair("ucb")
    A, b, x = _stats()
    want = j._score_ucb(jnp.asarray(A), jnp.asarray(b), jnp.asarray(x))
    got = tbandit.ucb_scores(*map(torch.from_numpy, (A, b, x)), 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)
    rng = jax.random.PRNGKey(5)
    want, _ = j._score_ts(jnp.asarray(A), jnp.asarray(b), jnp.asarray(x),
                          rng)
    z = np.array(jax.random.normal(jax.random.split(rng)[1], (5, 8)))
    got = tbandit.ts_scores(*map(torch.from_numpy, (A, b, x, z)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)


def test_linucb_steps_match_jax_on_its_arms():
    """JAX's arms drive both (a fresh arm's UCB score is a tie of all
    untouched arms, 1.0 in JAX and 1 - 6e-8 or 1.0 per arm in torch's
    batched solve, so the port's own argmax may pick another of them):
    the scores within rel 1e-4 at every step, the same A and b."""
    j, t = _bandit_pair("ucb")
    ctx = j.env.reset()
    t.env.reset()
    for _ in range(120):
        x = jnp.asarray(ctx, jnp.float32)
        want = np.asarray(j._score_ucb(j.A, j.b, x))
        xt = torch.from_numpy(np.array(ctx, np.float32))
        np.testing.assert_allclose(t.scores(xt).numpy(), want, rtol=1e-4)
        arm = int(want.argmax())
        ctx, rew, _, _ = j.env.step(arm)
        assert np.array_equal(t.env.step(arm)[0], ctx)
        j.A, j.b = j._posterior(j.A, j.b, arm, x, rew)
        t.observe(arm, xt, rew)
    np.testing.assert_allclose(t.A.numpy(), np.asarray(j.A), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(t.b.numpy(), np.asarray(j.b), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("exploration", ["ucb", "ts"])
def test_bandit_jax_save_restores_into_the_port_and_back(exploration):
    j, t = _bandit_pair(exploration)
    j.train()
    saved = j.save()
    t.restore(saved)
    back = t.save()["payload"]
    assert np.array_equal(back["A"], np.asarray(j.A))
    assert np.array_equal(back["b"], np.asarray(j.b))
    assert t.iteration == 1 and back["timesteps"] == 64
    assert np.isfinite(t.train()["mean_regret"])


def test_es_flat_vector_and_ranks_match(rng_seed=0):
    j = jes.ESConfig(env="CartPole-v1", seed=rng_seed).build()
    params = np_tree(j.get_policy_params())
    from ray_tpu_torch.rllib.optim import params_on
    flat, like = tes.flatten(params_on(params, "cpu", grad=False))
    assert np.array_equal(flat.numpy(), np.asarray(j.theta))
    back = np_tree(tes.unflatten(flat, like))
    for k in params:
        for n in params[k]:
            assert np.array_equal(back[k][n], params[k][n])
    x = np.random.default_rng(1).standard_normal(11).astype(np.float32)
    assert np.array_equal(tes._centered_ranks(x), jes._centered_ranks(x))


@pytest.mark.parametrize("which", ["es", "ars"])
def test_two_iterations_with_jax_perturbations_match(which):
    jcls, tcls = ((jes.ESConfig, tes.ESConfig) if which == "es"
                  else (jes.ARSConfig, tes.ARSConfig))
    kw = dict(env="CartPole-v1", pop_size=3, max_episode_steps=30,
              hiddens=(16,), seed=0)
    if which == "ars":
        kw["top_directions"] = 2
    j = jcls(**kw).build()
    t = tcls(**kw, device="cpu").build()
    t.restore(j.save())
    for it in range(2):
        _, eps, _ = j._perturb(j._rng, j.theta)
        jr = j.train()
        tr = t.iterate(eps=np.asarray(eps))
        t._iteration += 1           # train() counts; iterate() does not
        for k in ("steps_this_iter", "pop_return_mean", "pop_return_max"):
            assert jr[k] == tr[k], (k, it)
        np.testing.assert_allclose(t.theta.numpy(), np.asarray(j.theta),
                                   atol=1e-5, err_msg=f"iteration {it}")
    assert t._obs_n == j._obs_n
    np.testing.assert_allclose(t._obs_sum, j._obs_sum, rtol=1e-12)
    back = t.save()["payload"]
    j.restore({"_iteration": 2, "payload": back})
    assert np.array_equal(np.asarray(j.theta), back["theta"])


def test_refusals(monkeypatch):
    algo = tes.ESConfig(eval_parallelism=2, pop_size=2, hiddens=(8,),
                        device="cpu").build()
    with pytest.raises(RuntimeError, match="not initialized"):
        algo.train()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cfg in (tbandit.BanditConfig(), tbandit.BanditConfig(
            exploration="ts"), tes.ESConfig(), tes.ARSConfig()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cfg.build()
