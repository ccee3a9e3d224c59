"""The port's PPO under the JAX package's unchanged ``ray_tpu.tune``
with PBT over lr, on the CPU (glue: ``tests/_torch_port_tune.py``):

- after every exploit the target's params and Adam moments equal the
  source's save bit for bit, its Adam lr is its new config's and its
  workers act with the restored weights; no save was moved by later
  training (a save aliasing live tensors would be);
- a target goes on from its source's iteration and timesteps (the
  tuner's iteration and the one in the saves are one number);
- ``reset_config`` is False (PBT rebuilds), config keys the algorithm
  does not know are ignored, and ``cleanup`` drops the learner's
  tensors.
"""

import weakref

import pytest

from ray_tpu import tune
from ray_tpu.train.config import RunConfig
from ray_tpu.tune import TuneConfig, Tuner
from ray_tpu_torch.models import convert
from ray_tpu_torch.models.convert import _leaves
from ray_tpu_torch.rllib import ppo as tppo

from _torch_port_tune import (RecordingPBT, one_thread,  # noqa: F401
                              port_trainable, trees_equal)

PPO = dict(env="CartPole-v1", num_envs_per_worker=4, rollout_length=32,
           train_batch_size=128, minibatch_size=64, num_epochs=2, seed=0)
LRS = [3e-3, 3e-4]
ITERS = 6


def _restored(algo, saved, config):
    """What the PBT test reads right after a restore."""
    ws = algo.workers.workers
    return {"lr": config["lr"],
            "adam_lr": algo.opt_state.param_groups[0]["lr"],
            "payload": algo.save_checkpoint(),
            "workers": [convert.params_to_numpy(w.policy.params)
                        for w in ws]}


@pytest.fixture(scope="module")
def pbt(tmp_path_factory):
    seen = []
    cls = port_trainable(
        tppo.PPO, on_restore=lambda a, s, c: seen.append(_restored(a, s, c)))
    sched = RecordingPBT(metric="episode_reward_mean", mode="max",
                         perturbation_interval=2, seed=0,
                         hyperparam_mutations={"lr": [1e-3, 3e-3]})
    grid = Tuner(
        cls, param_space={**PPO, "lr": tune.grid_search(LRS)},
        tune_config=TuneConfig(metric="episode_reward_mean", mode="max",
                               scheduler=sched, use_actors=False),
        run_config=RunConfig(
            name="pbt", storage_path=str(tmp_path_factory.mktemp("pbt")),
            stop={"training_iteration": ITERS})).fit()
    return grid, sched, cls, seen


def test_pbt_exploit_clones_the_source_exactly_at_the_new_lr(pbt):
    grid, sched, cls, seen = pbt
    assert [t.status for t in grid.trials] == ["TERMINATED"] * 2
    assert sched.exploits and len(cls.restores) == len(sched.exploits)
    saves = {id(s[2]): s for s in cls.saves}
    for (it, src, tgt, new_cfg, _, src_cfg), (_, cfg, saved), got in zip(
            sched.exploits, cls.restores, seen):
        assert cfg == new_cfg and got["lr"] == new_cfg["lr"]
        assert got["adam_lr"] == new_cfg["lr"]
        # the save the target took is one its source made
        assert saves[id(saved)][1] == src_cfg
        assert trees_equal(got["payload"], saved["payload"])
        params = saved["payload"]["params"]
        assert all(trees_equal(w, params) for w in got["workers"])
    # no save moved after it was made
    for _, _, saved, copied in cls.saves:
        assert trees_equal(saved, copied)


def test_pbt_target_resumes_at_its_source_iteration(pbt):
    """The tuner's iteration and the one in the saves are one number: a
    target goes on from its source's iteration and timesteps."""
    grid, sched, _, _ = pbt
    for it, src, tgt, _, at, _ in sched.exploits:
        was = sched.last_result(src, at)
        nxt = sched.next_result(tgt, at)
        assert nxt["training_iteration"] == was["training_iteration"] + 1
        assert nxt["timesteps_total"] == was["timesteps_total"] + \
            PPO["train_batch_size"]
    for t in grid.trials:
        assert t.history[-1]["training_iteration"] == t.iterations == ITERS


def test_reset_config_unknown_keys_and_cleanup():
    algo = tppo.PPO({**PPO, "lr": 1e-3, "device": "cpu",
                     "trial_resources": {"CPU": 1}, "fail_at": 2})
    assert algo.config.lr == 1e-3
    assert algo.reset_config({"lr": 2e-3}) is False
    algo.train()
    ref = weakref.ref(_leaves(algo.params)[0])
    algo.cleanup()
    assert ref() is None
    assert not hasattr(algo, "params") and not hasattr(algo, "opt_state")
    assert algo.workers.workers == [] and algo.iteration == 1
    algo.cleanup()          # a second cleanup is harmless
