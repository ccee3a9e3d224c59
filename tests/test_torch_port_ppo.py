"""The port's PPO against the JAX package's on the CPU, in f32.

- ``policy_forward`` on bridged params (atol 1e-6 plus rel 1e-6: the
  value head reaches 9, where one f32 ulp is 1e-6), ``compute_gae``
  exact, ``ppo_loss`` value and grads against ``jax.value_and_grad``
  (1e-5);
- one whole ``make_ppo_update`` (6 epochs x 3 minibatches of 64 over a
  200-row batch: 8 rows dropped each epoch) with JAX's permutations fed
  in: params within atol 1e-5, metrics within rel 1e-4.  The advantages'
  population std differs from the sample std by 2.5e-3 relative at 200
  rows, so the policy loss pins ``correction=0``;
- CartPole trajectories equal under the same seeds and actions;
- a JAX ``PPO.save()`` restored into the port's ``PPO`` through the Adam
  bridge, and back;
- a CPU learning run at the settings of ``tests/test_rllib.py``'s PPO
  test (best mean return above 60 within 18 iterations).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib import env as jenv
from ray_tpu.rllib import policy as jpolicy
from ray_tpu.rllib import ppo as jppo
from ray_tpu_torch.models import convert
from ray_tpu_torch.models.convert import _leaves
from ray_tpu_torch.rllib import env as tenv
from ray_tpu_torch.rllib import policy as tpolicy
from ray_tpu_torch.rllib import ppo as tppo
from ray_tpu_torch.rllib import sample_batch as SB
from ray_tpu_torch.rllib.algorithm import WorkerSet
from ray_tpu_torch.train import adam

PCFG = dict(obs_dim=4, num_actions=2, hiddens=(64, 64))
LOSS = dict(clip=0.2, vf_clip=10.0, vf_coeff=0.5, ent_coeff=0.01)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def params():
    """JAX's initial policy params as numpy (seed 0)."""
    cfg = jpolicy.PolicyConfig(**PCFG)
    return _np(jpolicy.init_policy_params(cfg, jax.random.PRNGKey(0)))


def _batch(n, seed=0):
    """A rollout-shaped batch: CartPole observations, actions and the
    behaviour policy's logp and value predictions near the current
    ones, advantages and targets of a few units."""
    rng = np.random.default_rng(seed)
    return {SB.OBS: rng.standard_normal((n, 4)).astype(np.float32),
            SB.ACTIONS: rng.integers(0, 2, n).astype(np.int64),
            SB.LOGP: (np.log(0.5) + 0.05 * rng.standard_normal(n))
            .astype(np.float32),
            SB.VF_PREDS: rng.standard_normal(n).astype(np.float32),
            SB.ADVANTAGES: (2.0 * rng.standard_normal(n) + 0.5)
            .astype(np.float32),
            SB.VALUE_TARGETS: (3.0 * rng.standard_normal(n))
            .astype(np.float32)}


def _port(tree):
    return convert.params_from_numpy(tree, device="cpu")


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_policy_forward_matches_jax(params):
    obs = np.random.default_rng(1).standard_normal((32, 4)).astype(
        np.float32)
    jl, jv = jpolicy.policy_forward(params, jnp.asarray(obs))
    tl, tv = tpolicy.policy_forward(_port(params), torch.from_numpy(obs))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6,
                               rtol=1e-6)


def test_init_policy_params_tree_matches_jax(params):
    got = tpolicy.init_policy_params(tpolicy.PolicyConfig(**PCFG), 0,
                                     device="cpu")
    assert list(got) == ["fc0", "fc1", "pi", "vf"]
    for g, w in zip(jax.tree_util.tree_leaves(convert.params_to_numpy(got)),
                    jax.tree_util.tree_leaves(params)):
        assert g.shape == w.shape and g.dtype == w.dtype
    assert float(got["pi"]["w"].std()) < 0.05 < float(got["vf"]["w"].std())


def test_compute_gae_exact():
    rng = np.random.default_rng(2)
    T, B = 16, 3
    rew = rng.standard_normal((T, B)).astype(np.float32)
    val = rng.standard_normal((T, B)).astype(np.float32)
    done = rng.random((T, B)) < 0.2
    last = rng.standard_normal(B).astype(np.float32)
    want = jpolicy.compute_gae(rew, val, done, last, gamma=0.98, lam=0.9)
    got = tpolicy.compute_gae(rew, val, done, last, gamma=0.98, lam=0.9)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_ppo_loss_value_and_grads_match_jax(params):
    batch = _batch(96, seed=3)
    (jl, jaux), jg = jax.value_and_grad(
        functools.partial(jppo.ppo_loss, **LOSS), has_aux=True)(
        params, jax.tree_util.tree_map(jnp.asarray, batch))
    tp = _port(params)
    leaves = _leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tl, taux = tppo.ppo_loss(tp, _t(batch), **LOSS)
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for k, v in jaux.items():
        np.testing.assert_allclose(taux[k].item(), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want = jax.tree_util.tree_leaves(_np(jg))
    got = jax.tree_util.tree_leaves(
        convert.params_to_numpy(_map_like(tp, grads)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def _map_like(tree, flat):
    it = iter(flat)
    return convert._map(lambda _: next(it), tree)


def test_ppo_update_with_jax_permutations_matches(params):
    cfg = jppo.PPOConfig(minibatch_size=64, num_epochs=6, lr=3e-3,
                         entropy_coeff=0.01)
    batch = _batch(200, seed=4)
    tx = optax.adam(cfg.lr)
    rng = jax.random.PRNGKey(11)
    jp, _, jm = jppo.make_ppo_update(cfg, tx)(
        jax.tree_util.tree_map(jnp.asarray, params),
        tx.init(jax.tree_util.tree_map(jnp.asarray, params)), rng,
        jax.tree_util.tree_map(jnp.asarray, batch))
    perms = [np.asarray(jax.random.permutation(r, 200))
             for r in jax.random.split(rng, cfg.num_epochs)]

    tcfg = tppo.PPOConfig(minibatch_size=64, num_epochs=6, lr=3e-3,
                          entropy_coeff=0.01)
    tp = convert._map(lambda t: t.requires_grad_(True), _port(params))
    opt = adam(tcfg.lr)(_leaves(tp))
    tp, opt, tm = tppo.make_ppo_update(tcfg)(tp, opt, _t(batch),
                                            perms=perms)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    for g, w in zip(jax.tree_util.tree_leaves(convert.params_to_numpy(tp)),
                    jax.tree_util.tree_leaves(_np(jp))):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    # 6 epochs x 3 minibatches: the 8 rows left over are dropped
    assert float(opt.state[_leaves(tp)[0]]["step"]) == 18


def test_ppo_update_draws_its_own_permutations_from_the_generator(params):
    cfg = tppo.PPOConfig(minibatch_size=32, num_epochs=2, lr=1e-3)
    batch = _t(_batch(64, seed=5))
    out = []
    for _ in range(2):
        tp = convert._map(lambda t: t.requires_grad_(True), _port(params))
        opt = adam(cfg.lr)(_leaves(tp))
        gen = torch.Generator().manual_seed(3)
        tp, _, _ = tppo.make_ppo_update(cfg)(tp, opt, batch, generator=gen)
        out.append(convert.params_to_numpy(tp))
    for a, b in zip(jax.tree_util.tree_leaves(out[0]),
                    jax.tree_util.tree_leaves(out[1])):
        assert np.array_equal(a, b)


def test_cartpole_trajectories_match(params):
    rng = np.random.default_rng(6)
    jv, tv = jenv.VectorEnv("CartPole-v1", 4, seed=3), \
        tenv.VectorEnv("CartPole-v1", 4, seed=3)
    assert np.array_equal(jv.reset(), tv.reset())
    ends = 0
    for _ in range(300):
        a = rng.integers(0, 2, 4)
        jo, jr, jd = jv.step(a)
        to, tr, td = tv.step(a)
        assert np.array_equal(jo, to) and np.array_equal(jr, tr) \
            and np.array_equal(jd, td)
        ends += int(td.sum())
    assert ends > 0


def _jax_ppo():
    algo = jppo.PPOConfig(env="CartPole-v1", num_envs_per_worker=4,
                          rollout_length=32, train_batch_size=128,
                          minibatch_size=64, num_epochs=2, lr=1e-3,
                          seed=0).build()
    algo.train()
    return algo


def test_jax_ppo_save_restores_into_the_port():
    jalgo = _jax_ppo()
    saved = jalgo.save()
    port = tppo.PPOConfig(env="CartPole-v1", num_envs_per_worker=4,
                          rollout_length=32, train_batch_size=128,
                          minibatch_size=64, num_epochs=2, lr=1e-3, seed=5,
                          device="cpu").build()
    port.restore(saved)
    assert port.iteration == 1 and port._timesteps == jalgo._timesteps
    for g, w in zip(
            jax.tree_util.tree_leaves(convert.params_to_numpy(port.params)),
            jax.tree_util.tree_leaves(_np(jalgo.params))):
        assert np.array_equal(g, w)
    # the restored moments, back in optax's layout, are JAX's
    back = port.save()
    assert back["_iteration"] == 1
    opt = convert.torch_adam_to_optax(back["payload"]["opt_state"],
                                      like=jalgo.opt_state)
    assert jax.tree_util.tree_structure(opt) == \
        jax.tree_util.tree_structure(jalgo.opt_state)
    for g, w in zip(jax.tree_util.tree_leaves(opt),
                    jax.tree_util.tree_leaves(_np(jalgo.opt_state))):
        assert np.array_equal(g, w)
    # the port's workers act with the restored weights
    for w in port.workers.workers:
        got = convert.params_to_numpy(w.policy.params)
        assert np.array_equal(got["pi"]["w"], _np(jalgo.params)["pi"]["w"])
    r = port.train()
    assert r["training_iteration"] == 2 and np.isfinite(r["total_loss"])
    jalgo.cleanup()
    port.cleanup()


def test_port_save_restore_round_trip():
    kw = dict(env="CartPole-v1", num_envs_per_worker=2, rollout_length=16,
              train_batch_size=32, minibatch_size=16, num_epochs=1,
              device="cpu")
    a = tppo.PPOConfig(seed=0, **kw).build()
    a.train()
    saved = a.save()
    b = tppo.PPOConfig(seed=1, **kw).build()
    b.restore(saved)
    for x, y in zip(_leaves(a.params), _leaves(b.params)):
        assert torch.equal(x.detach(), y.detach())
    assert b.opt_state.param_groups[0]["params"][0] is _leaves(b.params)[0]
    pa, pb = a.save()["payload"], b.save()["payload"]
    for x, y in zip(jax.tree_util.tree_leaves(pa),
                    jax.tree_util.tree_leaves(pb)):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_ppo_learns_cartpole_on_the_cpu():
    """tests/test_rllib.py's PPO settings and bar."""
    algo = tppo.PPOConfig(env="CartPole-v1", num_rollout_workers=0,
                          num_envs_per_worker=8, rollout_length=64,
                          train_batch_size=512, minibatch_size=128,
                          num_epochs=6, lr=3e-3, entropy_coeff=0.01, seed=0,
                          device="cpu").build()
    best = 0.0
    for _ in range(18):
        r = algo.train()
        assert r["steps_this_iter"] == 512
        best = max(best, r.get("episode_reward_mean", 0.0))
    assert best > 60.0, f"PPO failed to learn: best {best}"
    algo.cleanup()


def test_actor_workers_and_a_missing_card_raise(monkeypatch):
    # actor workers without the stand-in initialised raise, as the JAX
    # package's do without ray_tpu.init()
    with pytest.raises(RuntimeError, match="not initialized"):
        WorkerSet(tppo.PPOConfig(use_actors=True, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tppo.PPOConfig().build(),
                 lambda: tpolicy.TorchPolicy(tpolicy.PolicyConfig(**PCFG)),
                 lambda: tpolicy.init_policy_params(
                     tpolicy.PolicyConfig(**PCFG))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
