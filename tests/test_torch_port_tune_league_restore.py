"""``Tuner.restore`` of the JAX package's unchanged ``ray_tpu.tune``
over the port's AlphaStar league on the CPU, in f32, at
``test_torch_port_alpha_star.py``'s ``RUN`` (glue:
``tests/_torch_port_tune.py``).

A two-point ``league_lr`` grid with a checkpoint every iteration, whose
first trial fails once at iteration 3 (``fail_once``), then
``Tuner.restore`` of the run, once over the JAX ``AlphaStar`` and once
over ``port_trainable(AlphaStar)``: both packages keep the finished
trial, resume the failed one at iteration 3 with the same
``timesteps_total``, and end with every result within 1e-5 of JAX's.
"""

import pytest

from ray_tpu import tune
from ray_tpu.rllib import alpha_star as ja
from ray_tpu.train.config import CheckpointConfig, RunConfig
from ray_tpu.tune import TuneConfig, Tuner
from ray_tpu_torch.rllib import alpha_star as ta

from _torch_port_tune import (assert_results_close, fail_once,
                              one_thread, port_trainable,  # noqa: F401
                              trial_summary)

RUN = dict(seed=0, snapshot_every=5, entropy_coeff=0.05, league_lr=0.3)
LRS = [0.3, 0.05]
BOUND = 1e-5


def _restore_run(cls, root, name, marker):
    space = {**RUN, "league_lr": tune.grid_search(LRS), "fail_at": 3,
             "fail_marker": marker}
    run = RunConfig(name=name, storage_path=root,
                    stop={"training_iteration": 5},
                    checkpoint_config=CheckpointConfig(checkpoint_frequency=1))
    first = Tuner(cls, param_space=space,
                  tune_config=TuneConfig(metric="league_exploitability",
                                         mode="min", use_actors=False),
                  run_config=run).fit()
    resumed = Tuner.restore(run.resolved_storage_path(), cls).fit()
    return first, resumed


@pytest.fixture(scope="module")
def restore_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("restore")
    return (_restore_run(fail_once(ja.AlphaStar), str(root), "jax",
                         str(root / "jax.failed")),
            _restore_run(fail_once(port_trainable(ta.AlphaStar)), str(root),
                         "port", str(root / "port.failed")))


def test_restore_resumes_at_the_jax_iteration(restore_runs):
    (jfirst, jres), (tfirst, tres) = restore_runs
    assert [t.status for t in tfirst.trials] == \
        [t.status for t in jfirst.trials] == ["ERROR", "TERMINATED"]
    assert "injected failure at iteration 3" in tfirst.trials[0].error
    # the packages' trials apart from their marker files
    assert [(i, {**c, "fail_marker": None}, s, n)
            for i, c, s, n in trial_summary(tres)] == \
        [(i, {**c, "fail_marker": None}, s, n)
         for i, c, s, n in trial_summary(jres)]
    assert [t.status for t in tres.trials] == ["TERMINATED"] * 2
    # the restored run keeps the finished trial and then resumes the
    # failed one: its two results before the failure, then 3 to 5
    failed = next(t for t in tres.trials if t.trial_id == "trial_00000")
    jfailed = next(t for t in jres.trials if t.trial_id == "trial_00000")
    assert [r["training_iteration"] for r in failed.history] == \
        [r["training_iteration"] for r in jfailed.history] == [1, 2, 3, 4, 5]
    assert failed.history[2]["timesteps_total"] == \
        jfailed.history[2]["timesteps_total"] == 3 * 256
    for t, j in zip(tres.trials, jres.trials):
        assert assert_results_close(t.history, j.history,
                                    atol=BOUND) <= BOUND
