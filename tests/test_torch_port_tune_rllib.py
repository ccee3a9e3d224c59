"""The port's PPO as a trial of the JAX package's unchanged
``ray_tpu.tune`` on the CPU (glue: ``tests/_torch_port_tune.py``; PBT
in ``test_torch_port_tune_rllib_pbt.py``).

A two-point lr grid under ``Tuner`` with ASHA, a checkpoint every
iteration and the JSON and CSV loggers, once over the JAX ``PPO`` and
once over ``port_trainable(PPO)``: every trial ends TERMINATED, the
port's results carry the JAX trials' keys, every value a Python scalar,
the loggers hold every result, and the port's final checkpoint restores
into a fresh port PPO and (Adam through ``torch_adam_to_optax``) into
the JAX PPO with equal params.
"""

import csv
import json
import os

import jax
import numpy as np
import pytest

from ray_tpu import tune
from ray_tpu.rllib import policy as jpolicy
from ray_tpu.rllib import ppo as jppo
from ray_tpu.train.config import CheckpointConfig, RunConfig
from ray_tpu.tune import (ASHAScheduler, CSVLoggerCallback,
                          JSONLoggerCallback, TuneConfig, Tuner)
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import ppo as tppo

from _torch_port_tune import one_thread, port_trainable  # noqa: F401

PPO = dict(env="CartPole-v1", num_envs_per_worker=4, rollout_length=32,
           train_batch_size=128, minibatch_size=64, num_epochs=2, seed=0)
LRS = [3e-3, 3e-4]
ITERS = 3


def _grid(trainable, root, name):
    return Tuner(
        trainable,
        param_space={**PPO, "lr": tune.grid_search(LRS)},
        tune_config=TuneConfig(
            metric="episode_reward_mean", mode="max", use_actors=False,
            scheduler=ASHAScheduler(metric="episode_reward_mean",
                                    mode="max", max_t=ITERS,
                                    grace_period=1, reduction_factor=2)),
        run_config=RunConfig(
            name=name, storage_path=root,
            checkpoint_config=CheckpointConfig(checkpoint_frequency=1),
            callbacks=[JSONLoggerCallback(), CSVLoggerCallback()])).fit()


@pytest.fixture(scope="module")
def jax_init():
    """The JAX PPO's init as one jit (eagerly each op compiles on its own,
    ~55 ms each on the CPU) while the file runs."""
    init = jax.jit(jpolicy.init_policy_params, static_argnums=0)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jppo, jpolicy):
            mp.setattr(mod, "init_policy_params", init)
        yield


@pytest.fixture(scope="module")
def grids(jax_init, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("grid"))
    return (_grid(jppo.PPO, root, "jax"),
            _grid(port_trainable(tppo.PPO), root, "port"), root)


def test_grid_under_asha_ends_terminated_with_the_jax_keys(grids):
    jgrid, tgrid, _ = grids
    assert [t.config["lr"] for t in tgrid.trials] == LRS
    assert [t.trial_id for t in tgrid.trials] == \
        [t.trial_id for t in jgrid.trials]
    for jt, tt in zip(jgrid.trials, tgrid.trials):
        assert tt.status == jt.status == "TERMINATED", tt.error
        assert 1 <= tt.iterations <= ITERS
        assert [r["training_iteration"] for r in tt.history] == \
            list(range(1, tt.iterations + 1))
        assert set(tt.history[0]) == set(jt.history[0])
        for r in tt.history:
            for k, v in r.items():
                assert type(v) in (int, float, bool), (k, type(v))
    best = tgrid.get_best_result()
    assert best.metrics["episode_reward_mean"] == max(
        t.last_result["episode_reward_mean"] for t in tgrid.trials)


def test_loggers_write_every_port_result(grids):
    _, tgrid, root = grids
    for t in tgrid.trials:
        d = os.path.join(root, "port", t.trial_id)
        with open(os.path.join(d, "result.json")) as f:
            lines = [json.loads(x) for x in f]
        assert lines == t.history
        with open(os.path.join(d, "progress.csv"), newline="") as f:
            rows = list(csv.DictReader(f))
        assert len(rows) == len(t.history)
        for row, r in zip(rows, t.history):
            assert set(row) == set(r)
            assert float(row["total_loss"]) == r["total_loss"]
        with open(os.path.join(d, "params.json")) as f:
            assert json.load(f)["lr"] == t.config["lr"]


def test_final_checkpoint_restores_into_both_packages(grids):
    _, tgrid, _ = grids
    for t in tgrid.trials:
        ck = t.checkpoint
        assert ck["_iteration"] == t.iterations
        port = tppo.PPOConfig(**{**PPO, "seed": 7}, device="cpu").build()
        port.restore(ck)
        want = jax.tree_util.tree_leaves(ck["payload"]["params"])
        got = jax.tree_util.tree_leaves(
            convert.params_to_numpy(port.params))
        assert port.iteration == t.iterations
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        jalgo = jppo.PPOConfig(**{**PPO, "seed": 7}).build()
        payload = dict(ck["payload"])
        payload["opt_state"] = convert.torch_adam_to_optax(
            payload["opt_state"], like=jalgo.opt_state)
        jalgo.restore({**ck, "payload": payload})
        assert jalgo.iteration == t.iterations
        for g, w in zip(jax.tree_util.tree_leaves(jalgo.params), want):
            assert np.array_equal(np.asarray(g), w)
        port.cleanup()
        jalgo.cleanup()
