"""IMPALA's and APPO's asynchronous actor arm in the port
(``Impala._async_batches`` on ``core.actors``) against the JAX package's
arm run on the same stand-in (``tests/_torch_port_actors.py`` points
``ray_tpu``'s runtime calls, ``wait`` included, at it), on the CPU, f32:

- with one actor worker the order of batches is fixed, so each of three
  iterations' metrics (rel 1e-4) and the params (atol 1e-5; APPO: the
  target params and the refresh counter too) equal the JAX arm's, as the
  inline IMPALA tests hold them; the port's worker is fed its JAX twin's
  Gumbel noise and the params are bridged from a JAX ``save()``;
- with two actor workers every batch a worker made is consumed at most
  once and, but for the one in flight at each worker, exactly once;
  both workers are consumed and resubmitted; ``steps_this_iter`` adds up;
  APPO's update counter and target refresh advance once per consumed
  batch; ``cleanup`` stops the workers with samples in flight and leaves
  no actor thread.
"""

import numpy as np
import pytest

from _torch_port_actors import (JaxKeys, instance, live_threads,  # noqa: F401
                                standin)
from _torch_port_rl import assert_metrics_close, assert_trees_close
from ray_tpu.rllib import appo as jappo
from ray_tpu.rllib import impala as jimpala
from ray_tpu_torch.core import actors
from ray_tpu_torch.rllib import appo as tappo
from ray_tpu_torch.rllib import impala as timpala

ARM = dict(env="CartPole-v1", num_envs_per_worker=4, rollout_length=16,
           batches_per_step=2, lr=2e-3, hiddens=(16, 16), use_actors=True,
           seed=0)
APPO_KW = dict(target_update_freq=3, clip_param=0.2)
METRICS = ("policy_loss", "vf_loss", "entropy", "total_loss")


def _configs(which):
    if which == "impala":
        return jimpala.ImpalaConfig, timpala.ImpalaConfig, {}
    return jappo.APPOConfig, tappo.APPOConfig, APPO_KW


@pytest.mark.parametrize("which", ["impala", "appo"])
def test_one_actor_worker_matches_the_jax_arm(standin, which):  # noqa: F811
    jcls, tcls, kw = _configs(which)
    jalgo = jcls(**ARM, **kw, num_rollout_workers=1).build()
    port = tcls(**ARM, **kw, num_rollout_workers=1, device="cpu").build()
    try:
        assert jalgo.workers.use_actors and port.workers.use_actors
        port.restore(jalgo.save())
        instance(port.workers.workers[0]).policy.gumbel_fn = JaxKeys(
            ARM["seed"] + 1, (ARM["num_envs_per_worker"], 2))
        for it in range(3):
            jr, tr = jalgo.train(), port.train()
            assert tr["steps_this_iter"] == jr["steps_this_iter"] == 128
            assert tr["timesteps_total"] == jr["timesteps_total"]
            assert_metrics_close({k: tr[k] for k in METRICS},
                                 {k: jr[k] for k in METRICS})
            assert port._ep_returns == jalgo._ep_returns
            assert_trees_close(port.params, jalgo.params, atol=1e-5,
                               err=f"iteration {it}")
            if which == "appo":
                assert (port._updates_since_refresh
                        == jalgo._updates_since_refresh == (2 * it + 2) % 3)
                assert_trees_close(port.target_params, jalgo.target_params,
                                   atol=1e-5, err=f"iteration {it} target")
        assert port.opt.count == int(jalgo.opt_state[0].count) == 6
        assert len(port._inflight) == len(jalgo._inflight) == 1
    finally:
        jalgo.cleanup()
        port.cleanup()


@pytest.mark.parametrize("which", ["impala", "appo"])
def test_two_actor_workers_consume_every_batch_once(standin,  # noqa: F811
                                                    which):
    _, tcls, kw = _configs(which)
    algo = tcls(**dict(ARM, batches_per_step=8), **kw,
                num_rollout_workers=2, device="cpu").build()
    made, used = [], []
    for i, w in enumerate(algo.workers.workers):
        worker = instance(w)

        def sample(i=i, inner=worker.sample):
            b = inner()
            made.append((i, b["obs"].tobytes()))
            return b
        worker.sample = sample
    learn = algo._learn_on

    def learn_on(b):
        used.append(b["obs"].tobytes())
        return learn(b)
    algo._learn_on = learn_on
    try:
        steps = 0
        for it in range(3):
            r = algo.train()
            assert r["steps_this_iter"] == 8 * 4 * 16, it
            steps += r["steps_this_iter"]
            assert sorted(algo._inflight.values(), key=id) == sorted(
                algo.workers.workers, key=id)          # both resubmitted
        assert algo._timesteps == steps == len(used) * 4 * 16
        assert len(used) == len(set(used)) == 24    # none consumed twice
        by_obs = dict((o, i) for i, o in made)
        assert set(used) <= set(by_obs)
        per_worker = [sum(by_obs[o] == i for o in used) for i in (0, 1)]
        assert min(per_worker) > 0, per_worker
        if which == "appo":
            assert algo.opt.count == 24
            assert algo._updates_since_refresh == 24 % 3
    finally:
        algo.cleanup()
    # every batch made before the stop is consumed, but each worker's last
    assert len(made) - len(used) <= 2
    assert standin._runtime().actors == []
    assert all(w._lane._closed for w in algo.workers.workers)
    assert [n for n in live_threads()
            if not n.startswith(f"{actors.THREAD_PREFIX}task:")] == []
