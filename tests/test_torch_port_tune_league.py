"""The port's AlphaStar league as a trial of the JAX package's unchanged
``ray_tpu.tune`` on the CPU, in f32, at ``test_torch_port_alpha_star.py``'s
``RUN`` (glue: ``tests/_torch_port_tune.py``; ``Tuner.restore`` in
``test_torch_port_tune_league_restore.py``).

PBT (seeded) over ``league_lr`` on ``league_exploitability``, once over
the JAX ``AlphaStar`` and once over ``port_trainable(AlphaStar)``: the
same trial ids, configs, statuses and iteration counts, the same
exploits in the same order, and every result within 1e-5 of JAX's (that
file's bound); the scores at every perturbation point are further apart
than their bounds.
"""

import pytest

from ray_tpu import tune
from ray_tpu.rllib import alpha_star as ja
from ray_tpu.train.config import RunConfig
from ray_tpu.tune import TuneConfig, Tuner
from ray_tpu_torch.rllib import alpha_star as ta

from _torch_port_tune import (RecordingPBT, assert_results_close,
                              one_thread, port_trainable,  # noqa: F401
                              trial_summary)

RUN = dict(seed=0, snapshot_every=5, entropy_coeff=0.05, league_lr=0.3)
LRS = [0.3, 0.05]
ITERS = 8
BOUND = 1e-5


def _pbt(trainable, root, name):
    sched = RecordingPBT(metric="league_exploitability", mode="min",
                         perturbation_interval=3, seed=0,
                         hyperparam_mutations={"league_lr": [0.1, 0.3]})
    grid = Tuner(
        trainable,
        param_space={**RUN, "league_lr": tune.grid_search(LRS)},
        tune_config=TuneConfig(metric="league_exploitability", mode="min",
                               scheduler=sched, use_actors=False),
        run_config=RunConfig(name=name, storage_path=root,
                             stop={"training_iteration": ITERS})).fit()
    return grid, sched


@pytest.fixture(scope="module")
def pbt_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pbt"))
    return (_pbt(ja.AlphaStar, root, "jax"),
            _pbt(port_trainable(ta.AlphaStar), root, "port"))


def test_pbt_makes_the_jax_decisions(pbt_runs):
    (jgrid, jsched), (tgrid, tsched) = pbt_runs
    assert trial_summary(tgrid) == trial_summary(jgrid)
    assert [t.status for t in tgrid.trials] == ["TERMINATED"] * len(LRS)
    assert tsched.exploits, "no exploit to compare"
    assert [e[:4] for e in tsched.exploits] == \
        [e[:4] for e in jsched.exploits]
    assert [(tid, r["training_iteration"]) for tid, r in tsched.seen] == \
        [(tid, r["training_iteration"]) for tid, r in jsched.seen]


def test_pbt_results_within_the_bound(pbt_runs):
    (jgrid, _), (tgrid, _) = pbt_runs
    worst = max(assert_results_close(t.history, j.history, atol=BOUND)
                for t, j in zip(tgrid.trials, jgrid.trials))
    assert worst <= BOUND


def test_pbt_decisions_sit_far_from_their_boundaries(pbt_runs):
    """At every perturbation point any two of the JAX run's scores are
    further apart than their two bounds together, so scores within the
    bound of them rank alike."""
    (_, jsched), (_, tsched) = pbt_runs
    assert len(tsched.decisions) == len(jsched.decisions) > 0
    for scores in jsched.decisions:
        vals = sorted(scores.values())
        for a, b in zip(vals, vals[1:]):
            assert b - a > 2 * BOUND, scores
