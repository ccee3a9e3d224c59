"""The port's GPT train step as a function trainable of the JAX
package's unchanged ``ray_tpu.tune`` on the CPU, in f32 (glue:
``tests/_torch_port_tune.py``).

``port_gpt_train_fn`` (``make_train_step``, ``adamw``, ``state_to_host``,
``load_state``) and ``jax_gpt_train_fn`` (the JAX package's
``make_train_step`` and optax's AdamW) run ``GPTConfig.tiny`` from the
same numpy weights on the same batches under PBT over lr, reporting
every step with the state as their checkpoint, each a step at a time
(``lockstep``: the JAX package's function thread would run a step ahead
and PBT would clone a state past its source's iteration, R2):

- both runs make the same exploits in the same order, with the same
  trial ids, configs, statuses and iteration counts; the scores at every
  perturbation point are further apart than their bounds;
- every reported loss and grad norm within rel 1e-4 of JAX's (the
  trajectory bound of ``test_torch_port_train.py``);
- a target restored through ``tune.get_checkpoint()`` goes on from the
  cloned state: its next step is the source's next step, with the same
  loss bit for bit, under its new lr;
- a trial's port state dies with its function's thread.
"""

import gc

import pytest

from ray_tpu import tune
from ray_tpu.train.config import RunConfig
from ray_tpu.tune import TuneConfig, Tuner

import _torch_port_tune as glue
from _torch_port_tune import (GPT_STEPS, RecordingPBT, jax_gpt_train_fn,
                              lockstep, one_thread,  # noqa: F401
                              port_gpt_train_fn, trial_summary)

LRS = [1e-2, 1e-4]
MUTATIONS = [3e-3, 3e-2]
RTOL = 1e-4


def _pbt(fn, root, name):
    sched = RecordingPBT(metric="loss", mode="min", perturbation_interval=2,
                         seed=0, hyperparam_mutations={"lr": MUTATIONS})
    grid = Tuner(
        lockstep(fn), param_space={"lr": tune.grid_search(LRS)},
        tune_config=TuneConfig(metric="loss", mode="min", scheduler=sched,
                               use_actors=False),
        run_config=RunConfig(name=name, storage_path=root,
                             stop={"training_iteration": GPT_STEPS})).fit()
    return grid, sched


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gpt"))
    return (_pbt(jax_gpt_train_fn, root, "jax"),
            _pbt(port_gpt_train_fn, root, "port"))


def test_pbt_makes_the_jax_decisions(runs):
    (jgrid, jsched), (tgrid, tsched) = runs
    assert trial_summary(tgrid) == trial_summary(jgrid)
    assert [t.status for t in tgrid.trials] == ["TERMINATED"] * len(LRS)
    assert tsched.exploits, "no exploit to compare"
    assert [e[:4] for e in tsched.exploits] == \
        [e[:4] for e in jsched.exploits]
    assert [(tid, r["step"]) for tid, r in tsched.seen] == \
        [(tid, r["step"]) for tid, r in jsched.seen]


def test_losses_within_rel_1e4_of_jax(runs):
    (_, jsched), (_, tsched) = runs
    for (_, got), (_, want) in zip(tsched.seen, jsched.seen):
        for key in ("loss", "grad_norm"):
            assert abs(got[key] - want[key]) <= RTOL * abs(want[key]), (
                key, got, want)
        assert abs(got["lr"] - want["lr"]) <= 1e-6 * want["lr"]


def test_decisions_sit_far_from_their_boundaries(runs):
    """At every perturbation point any two of the JAX run's scores are
    further apart than their two bounds together, so scores within the
    bound of them rank alike."""
    (_, jsched), (_, tsched) = runs
    assert len(tsched.decisions) == len(jsched.decisions) > 0
    for scores in jsched.decisions:
        vals = sorted(scores.values())
        for a, b in zip(vals, vals[1:]):
            assert b - a > RTOL * (abs(a) + abs(b)), scores


@pytest.mark.parametrize("which", ["jax", "port"])
def test_restored_target_goes_on_from_the_cloned_state(runs, which):
    _, sched = runs[0] if which == "jax" else runs[1]
    for _, src, tgt, new_cfg, at, _ in sched.exploits:
        was = sched.last_result(src, at)
        mine, theirs = sched.next_result(tgt, at), sched.next_result(src, at)
        assert mine["step"] == theirs["step"] == was["step"] + 1
        assert mine["loss"] == theirs["loss"]
        assert mine["lr"] == pytest.approx(new_cfg["lr"], rel=1e-6)


def test_a_trial_state_dies_with_its_thread(runs):
    assert glue.PORT_THREADS
    for t in glue.PORT_THREADS:
        t.join(timeout=30)
        assert not t.is_alive()
    gc.collect()
    assert glue.PORT_STATES
    assert all(ref() is None for ref in glue.PORT_STATES)
