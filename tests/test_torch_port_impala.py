"""The port's IMPALA and APPO against the JAX package's on the CPU, f32.

- ``vtrace`` against JAX's reverse ``lax.scan`` within 1e-6, with
  episode ends and clipped ratios;
- IMPALA's loss value and grads (rtol 1e-5), and one whole update on a
  real time-major rollout (its ``bootstrap_obs`` the bootstrap state),
  from a JAX ``save()`` restored into the port: params within atol
  1e-5, metrics within rel 1e-4;
- APPO's updates against JAX's over three rollouts with the target
  refreshed every second update: the target stays the params it was
  cloned from until the refresh (the JAX package's ``target_params =
  params`` would alias the port's in-place-stepped leaves);
- a JAX ``save()`` restored into the port and back (APPO's target
  included), then one more port iteration; ``device=None`` without a
  card raises.
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
                            t_tree)
from ray_tpu.rllib import appo as jappo
from ray_tpu.rllib import impala as jimpala
from ray_tpu.rllib.sample_batch import SampleBatch
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import appo as tappo
from ray_tpu_torch.rllib import impala as timpala
from ray_tpu_torch.rllib import optim

# an optax transform whose state after an update is the gradients: the
# JAX update's own value_and_grad, read back exactly
GRAD_TAP = optax.GradientTransformation(
    lambda params: (),
    lambda grads, state, params=None: (
        jax.tree_util.tree_map(jnp.zeros_like, grads), grads))

SMALL = dict(env="CartPole-v1", num_envs_per_worker=4, rollout_length=16,
             batches_per_step=1, lr=2e-3, entropy_coeff=0.01, seed=0)


def test_vtrace_matches_jax():
    rng = np.random.default_rng(0)
    T, B = 24, 5
    cols = dict(
        behavior_logp=np.log(rng.uniform(0.2, 0.8, (T, B))),
        target_logp=np.log(rng.uniform(0.2, 0.8, (T, B))),
        rewards=rng.standard_normal((T, B)),
        values=rng.standard_normal((T, B)),
        dones=rng.random((T, B)) < 0.15,
        bootstrap_value=rng.standard_normal(B))
    cols = {k: v.astype(np.float32) if v.dtype != bool else v
            for k, v in cols.items()}
    kw = dict(gamma=0.97, rho_clip=1.0, c_clip=0.9)
    jvs, jadv = jax.jit(functools.partial(jimpala.vtrace, **kw))(
        **jnp_tree(cols))
    tvs, tadv = timpala.vtrace(**t_tree(cols), **kw)
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), atol=1e-6)
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), atol=1e-6)


def _pair(jcls, tcls, **kw):
    jalgo = jcls(**SMALL, **kw).build()
    port = tcls(**SMALL, device="cpu", **kw).build()
    port.restore(jalgo.save())
    assert_trees_equal(port.params, jalgo.params)
    return jalgo, port


def _rollout(jalgo):
    """One worker's rollout (JAX's worker draws the actions)."""
    return SampleBatch(jalgo.workers.workers[0].sample())


def test_impala_loss_and_update_match_jax():
    jalgo, port = _pair(jimpala.ImpalaConfig, timpala.ImpalaConfig)
    b = _rollout(jalgo)
    jb, tb = jalgo._time_major(b), port._time_major(b)
    assert tb["last_obs"].shape == (4, 4) and tb["obs"].shape == (16, 4, 4)

    tp = optim.params_on(np_tree(jalgo.params), "cpu")
    tl, _ = timpala.impala_loss(tp, tb, port.config)
    tg = grads_of(tl, optim.tree_leaves(tp))

    _, jg, jm = jimpala.make_impala_update(jalgo.config, GRAD_TAP)(
        jalgo.params, (), jb)
    jl = jm["total_loss"]
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert_trees_close(optim.tree_unflatten(tp, tg), jg, atol=1e-5,
                       rtol=1e-5)

    jp, _, jm = jalgo._update(jalgo.params, jalgo.opt_state, jb)
    tm = port._learn_on(b)
    assert set(tm) == set(jm)
    assert_trees_close(port.params, jp, atol=1e-5)
    assert_metrics_close(tm, jm)


def test_appo_updates_and_target_refresh_match_jax():
    jalgo, port = _pair(jappo.APPOConfig, tappo.APPOConfig,
                        target_update_freq=2, clip_param=0.2)
    initial = np_tree(jalgo.params)
    for i in range(3):
        b = _rollout(jalgo)
        jalgo.params, jalgo.opt_state, jm = jalgo._update(
            jalgo.params, jalgo.opt_state, jalgo._time_major(b))
        tm = port._learn_on(b)
        assert_trees_close(port.params, jalgo.params, atol=1e-5,
                           err=f"update {i}")
        assert_metrics_close(tm, jm)
        assert_trees_close(port.target_params, jalgo.target_params,
                           atol=1e-5)
        if i == 0:      # not refreshed yet: still the initial params
            assert_trees_equal(port.target_params, initial)
    assert port._updates_since_refresh == jalgo._updates_since_refresh == 1


@pytest.mark.parametrize("which", ["impala", "appo"])
def test_jax_save_restores_into_the_port_and_back(which):
    jcls, tcls = ((jimpala.ImpalaConfig, timpala.ImpalaConfig)
                  if which == "impala" else
                  (jappo.APPOConfig, tappo.APPOConfig))
    jalgo = jcls(**SMALL).build()
    jalgo.train()
    saved = jalgo.save()
    port = tcls(**dict(SMALL, seed=3), device="cpu").build()
    port.restore(saved)
    assert port.iteration == 1 and port._timesteps == jalgo._timesteps
    assert_trees_equal(port.params, jalgo.params)
    back = port.save()["payload"]
    if which == "appo":
        assert_trees_equal(port.target_params, jalgo.target_params)
        assert_trees_equal(back["target_params"], jalgo.target_params)
    opt = convert.torch_adam_to_optax(back["opt_state"],
                                      like=np_tree(jalgo.opt_state))
    assert_trees_equal(opt, jalgo.opt_state)
    r = port.train()
    assert r["training_iteration"] == 2 and r["steps_this_iter"] == 64
    assert all(np.isfinite(v) for v in r.values())
    jalgo.cleanup()
    port.cleanup()


def test_device_none_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cfg in (timpala.ImpalaConfig(**SMALL), tappo.APPOConfig(**SMALL)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cfg.build()
