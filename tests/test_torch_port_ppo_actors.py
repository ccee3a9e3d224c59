"""RLlib's rollout workers as actors of the port's in-process stand-in
``ray_tpu_torch.core.actors`` (``WorkerSet(use_actors=True)``), against
the port's inline workers and the JAX package's actor arm run on the same
stand-in (``tests/_torch_port_actors.py`` points ``ray_tpu``'s runtime
calls at it), on the CPU, in f32:

- PPO with ``use_actors=True`` and two workers equals the inline
  two-worker run exactly over two iterations (results, params, returns);
- the actor workers' batches equal the JAX actor arm's, concatenated in
  worker order (each port worker's policy fed the Gumbel noise of its JAX
  twin's key stream): observations, actions, rewards and returns exact,
  log-probabilities, values and advantages within 1e-5, before and after
  a weight sync through one ``put``;
- IMPALA takes actor workers (its asynchronous arm), runs an iteration
  and kills them at ``cleanup``.
"""

import jax
import numpy as np

from _torch_port_actors import JaxKeys, instance, standin  # noqa: F401
from _torch_port_rl import assert_trees_equal, np_tree
from ray_tpu.rllib import ppo as jppo
from ray_tpu_torch.rllib import ppo as tppo


PPO = dict(env="CartPole-v1", num_rollout_workers=2, num_envs_per_worker=2,
           rollout_length=32, train_batch_size=128, minibatch_size=64,
           num_epochs=1, hiddens=(16, 16), seed=0)


def test_ppo_actor_workers_equal_inline_workers(standin):  # noqa: F811
    algos = [tppo.PPOConfig(**PPO, use_actors=u, device="cpu").build()
             for u in (True, False)]
    assert [a.workers.use_actors for a in algos] == [True, False]
    for it in range(2):
        ra, ri = (a.train() for a in algos)
        ra.pop("env_steps_per_sec")
        ri.pop("env_steps_per_sec")
        assert ra == ri, it
        assert algos[0]._ep_returns == algos[1]._ep_returns
        assert_trees_equal(algos[0].params, algos[1].params)
    for a in algos:
        a.cleanup()
    assert standin._runtime().actors == []      # the workers are killed


def test_actor_workers_match_the_jax_actor_arm(standin):  # noqa: F811
    jalgo = jppo.PPOConfig(**PPO, use_actors=True).build()
    port = tppo.PPOConfig(**PPO, use_actors=True, device="cpu").build()
    assert jalgo.workers.use_actors and port.workers.use_actors
    port.restore(jalgo.save())
    for i, w in enumerate(port.workers.workers):
        # RolloutWorker(seed=seed + 1000 i) keys its JaxPolicy seed + 1
        instance(w).policy.gumbel_fn = JaxKeys(
            PPO["seed"] + 1000 * i + 1, (PPO["num_envs_per_worker"], 2))
    weights = np_tree(jalgo.params)
    for rnd in range(2):
        (jb, jrets), (tb, trets) = (a.workers.sample_sync()
                                    for a in (jalgo, port))
        assert jrets == trets
        assert set(jb) == set(tb) and jb.count == tb.count == 128
        for k in ("obs", "actions", "rewards", "dones", "bootstrap_obs"):
            assert np.array_equal(jb[k], tb[k]), (rnd, k)
        for k in ("logp", "vf_preds", "advantages", "value_targets"):
            np.testing.assert_allclose(tb[k], jb[k], atol=1e-5, rtol=1e-5,
                                       err_msg=f"round {rnd} {k}")
        weights = jax.tree_util.tree_map(lambda a: a * 0.9, weights)
        jalgo.workers.sync_weights(weights)
        port.workers.sync_weights(weights)
        for w in port.workers.workers:
            assert_trees_equal(instance(w).get_weights(), weights)
    jalgo.cleanup()
    port.cleanup()


def test_impala_refuses_actor_workers(standin):  # noqa: F811
    """Named for the refusal it once checked: IMPALA now takes actor
    workers, runs an iteration on the stand-in and kills them at
    ``cleanup``."""
    from ray_tpu_torch.rllib import impala as timpala
    algo = timpala.ImpalaConfig(**PPO, use_actors=True, device="cpu",
                                batches_per_step=2).build()
    assert algo.workers.use_actors
    assert len(standin._runtime().actors) == 2
    r = algo.train()
    assert r["steps_this_iter"] == 2 * 2 * 32
    assert all(np.isfinite(v) for v in r.values())
    algo.cleanup()
    assert standin._runtime().actors == []
    assert all(w._lane._closed for w in algo.workers.workers)
