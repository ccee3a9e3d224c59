"""The port's PG and A2C against the JAX package's on the CPU, in f32.

- ``pg_loss`` and ``a2c_loss`` values and grads against
  ``jax.value_and_grad`` (rtol 1e-5) on params bridged from JAX's init;
- one whole update of each algorithm on the same batch, from a JAX
  ``save()`` restored into the port: params within atol 1e-5, metrics
  within rel 1e-4.  A2C's is held twice, with optax's
  ``clip_by_global_norm(40)`` engaged (targets of scale 50) and idle;
- ``optim.clip_by_global_norm`` against optax's on both sides of the
  bound;
- a JAX ``save()`` restored into the port and back through the Adam
  bridge (A2C's optax state is a chain), then one more port iteration;
- ``device=None`` with no card raises.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_rl import (assert_metrics_close, assert_trees_close,
                            assert_trees_equal, grads_of, jnp_tree, np_tree,
                            rollout_batch, t_tree, with_grad)
from ray_tpu.rllib import a2c as ja2c
from ray_tpu.rllib import pg as jpg
from ray_tpu.rllib import policy as jpolicy
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import a2c as ta2c
from ray_tpu_torch.rllib import optim
from ray_tpu_torch.rllib import pg as tpg

SMALL = dict(env="CartPole-v1", num_envs_per_worker=2, rollout_length=16,
             train_batch_size=32, seed=0)
KEYS = ("obs", "actions", "advantages", "value_targets")


@pytest.fixture(scope="module")
def params():
    cfg = jpolicy.PolicyConfig(obs_dim=4, num_actions=2, hiddens=(64, 64))
    return np_tree(jpolicy.init_policy_params(cfg, jax.random.PRNGKey(0)))


def _cols(batch):
    return {k: batch[k] for k in KEYS}


@pytest.mark.parametrize("which", ["pg", "a2c"])
def test_loss_value_and_grads_match_jax(params, which):
    batch = _cols(rollout_batch(96, seed=1))
    jmod, tmod = (jpg, tpg) if which == "pg" else (ja2c, ta2c)
    jloss, tloss = getattr(jmod, f"{which}_loss"), getattr(tmod,
                                                          f"{which}_loss")
    kw = dict(vf_coeff=0.5, ent_coeff=0.01)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        functools.partial(jloss, **kw), has_aux=True))(
        jnp_tree(params), jnp_tree(batch))
    tp = with_grad(params)
    tl, taux = tloss(tp, t_tree(batch), **kw)
    grads = grads_of(tl, optim.tree_leaves(tp))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert_metrics_close(taux, jaux, rtol=1e-5)
    assert_trees_close(optim.tree_unflatten(tp, grads), jg, atol=1e-5,
                       rtol=1e-5)


@pytest.mark.parametrize("norm", [3.0, 40.0, 400.0])
def test_clip_by_global_norm_is_optax(norm):
    rng = np.random.default_rng(2)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((4, 8), (8,), ())]
    scale = norm / np.sqrt(sum((g * g).sum() for g in grads))
    grads = [np.asarray(g * np.float32(scale)) for g in grads]
    want, _ = optax.clip_by_global_norm(40.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = optim.clip_by_global_norm([torch.from_numpy(g) for g in grads],
                                    40.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def _pair(jcls, tcls, **kw):
    """A JAX algorithm and the port's, the port restored from JAX's
    initial save."""
    jalgo = jcls(**SMALL, **kw).build()
    port = tcls(**SMALL, device="cpu", **kw).build()
    port.restore(jalgo.save())
    assert_trees_equal(port.params, jalgo.params)
    return jalgo, port


def test_pg_update_matches_jax():
    jalgo, port = _pair(jpg.PGConfig, tpg.PGConfig, lr=4e-3, ent_coeff=0.01)
    batch = _cols(rollout_batch(128, seed=3))
    jp, jo, jaux = jalgo._update(jalgo.params, jalgo.opt_state,
                                 jnp_tree(batch))
    taux = port.update(t_tree(batch))
    assert_trees_close(port.params, jp, atol=1e-5)
    assert_metrics_close(taux, jaux)
    assert port.opt.count == int(jo[0].count) == 1


@pytest.mark.parametrize("clipped", [True, False])
def test_a2c_update_matches_jax(clipped):
    jalgo, port = _pair(ja2c.A2CConfig, ta2c.A2CConfig, lr=2e-3)
    batch = _cols(rollout_batch(128, seed=4, vt_scale=50.0))
    if not clipped:     # targets near the values: small value gradients
        _, v = jpolicy.policy_forward(jalgo.params, batch["obs"])
        batch["value_targets"] = np.asarray(v) + 0.1 * batch["advantages"]
    # is the clip engaged on this batch? (the loss's grads match JAX's)
    tb = t_tree(batch)
    std = dict(tb, advantages=tpg.standardize(tb["advantages"]))
    grads = grads_of(ta2c.a2c_loss(port.params, std, vf_coeff=0.5,
                                   ent_coeff=0.01)[0], port.opt.leaves)
    norm = float(torch.sqrt(sum((g * g).sum() for g in grads)))
    assert (norm > 40.0) == clipped
    jp, _, jm = jalgo._update(jalgo.params, jalgo.opt_state,
                              jnp_tree(batch))
    tm = port.update(t_tree(batch))
    assert set(tm) == set(jm)
    assert_trees_close(port.params, jp, atol=1e-5)
    assert_metrics_close(tm, jm)


@pytest.mark.parametrize("which", ["pg", "a2c"])
def test_jax_save_restores_into_the_port_and_back(which):
    jcls, tcls = ((jpg.PGConfig, tpg.PGConfig) if which == "pg"
                  else (ja2c.A2CConfig, ta2c.A2CConfig))
    jalgo = jcls(**SMALL).build()
    jalgo.train()
    saved = jalgo.save()
    port = tcls(**dict(SMALL, seed=5), device="cpu").build()
    port.restore(saved)
    assert port.iteration == 1 and port._timesteps == jalgo._timesteps
    assert_trees_equal(port.params, jalgo.params)
    back = port.save()["payload"]
    opt = convert.torch_adam_to_optax(back["opt_state"],
                                      like=np_tree(jalgo.opt_state))
    assert jax.tree_util.tree_structure(opt) == \
        jax.tree_util.tree_structure(jalgo.opt_state)
    assert_trees_equal(opt, jalgo.opt_state)
    for w in port.workers.workers:
        assert_trees_equal(w.policy.params, jalgo.params)
    r = port.train()
    assert r["training_iteration"] == 2 and r["steps_this_iter"] > 0
    assert all(np.isfinite(v) for v in r.values())
    jalgo.cleanup()
    port.cleanup()


@pytest.mark.parametrize("tcls", [tpg.PGConfig, ta2c.A2CConfig],
                         ids=["pg", "a2c"])
def test_port_save_restore_round_trip(tcls):
    a = tcls(**SMALL, device="cpu").build()
    a.train()
    saved = a.save()
    b = tcls(**dict(SMALL, seed=1), device="cpu").build()
    b.restore(saved)
    assert_trees_equal(b.params, a.params)
    assert_trees_equal(b.save()["payload"], saved["payload"])
    assert b.opt.opt.param_groups[0]["params"][0] is \
        optim.tree_leaves(b.params)[0]


def test_device_none_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cfg in (tpg.PGConfig(**SMALL), ta2c.A2CConfig(**SMALL)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cfg.build()
