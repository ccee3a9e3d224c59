"""The port's multi-host gang with a process per member
(``MultiHostGang(host=ProcessHost())``, gloo on the CPU), held to the
JAX package's gang contract (``tests/test_elastic_gang.py``): the
members are processes that import no JAX; a lambda is refused before any
member runs it; a failed call is not a death; a member that SIGKILLs its
own process while its peers wait in a collective is named promptly;
``reform`` keeps the survivors' processes and ``readmit`` adds exactly
one fresh one, the all-reduce giving 24.0 / 12.0 / 24.0 at worlds 3 / 2
/ 3.  One gang for the module (a spawn costs seconds); every test leaves
it at world 3 and every wait is bounded."""

import functools
import time

import pytest

from _torch_port_procs import (SPMD_SUM, die_in_a_collective, fail_on,
                               spmd_sum, whoami)
from ray_tpu_torch.parallel.gang import (GangMemberDied, MultiHostGang,
                                         ProcessHost)

DEATH_BOUND_S = 5.0
RUN_S = 60.0


@pytest.fixture(scope="module")
def gang3():
    gang = MultiHostGang(3, device="cpu", host=ProcessHost())
    yield gang
    gang.shutdown()


def test_members_are_processes_that_import_no_jax(gang3):
    out = gang3.run(whoami, timeout=RUN_S)
    pids = gang3.member_pids()
    assert len(set(pids)) == 3
    assert [o["pid"] for o in out] == pids
    assert [o["member_id"] for o in out] == gang3.member_ids()
    assert [(o["rank"], o["world"]) for o in out] == [(r, 3) for r in range(3)]
    assert not any(o["jax"] or o["ray_tpu"] for o in out)
    assert gang3.run(spmd_sum, timeout=RUN_S) == [SPMD_SUM[3]] * 3


def test_a_run_without_a_timeout_waits_for_its_answer(gang3):
    """``run``'s default (no timeout, an attempt may run for hours) waits
    until every member has answered."""
    assert gang3.run(spmd_sum) == [SPMD_SUM[3]] * 3
    assert gang3.run(functools.partial(fail_on, target=-1)) == [0, 1, 2]


def test_a_lambda_is_refused_before_any_member_runs_it(gang3):
    pids = gang3.member_pids()
    for fn in (lambda rank: rank, functools.partial(lambda r, k: r, k=1)):
        with pytest.raises(TypeError, match="module-level function"):
            gang3.run(fn, timeout=RUN_S)
    assert gang3.member_pids() == pids
    assert gang3.run(spmd_sum, timeout=RUN_S) == [SPMD_SUM[3]] * 3


def test_a_failed_call_is_not_a_death(gang3):
    """Rank 2 raises while the others wait in a barrier: it leaves its
    world, so they are unblocked at once; every process lives on, the
    next run joins a fresh world with no re-form (as an in-process gang's
    does), and a re-form in place at the same size runs."""
    pids = gang3.member_pids()
    t0 = time.monotonic()
    with pytest.raises(GangMemberDied, match="rank 2/3") as err:
        gang3.run(functools.partial(fail_on, target=2), timeout=RUN_S)
    assert time.monotonic() - t0 < DEATH_BOUND_S
    assert err.value.rank == 2 and "step failed on rank 2" in str(err.value)
    assert gang3.alive_ranks() == [0, 1, 2]
    assert gang3.run(spmd_sum, timeout=RUN_S) == [SPMD_SUM[3]] * 3
    assert gang3.member_pids() == pids
    gang3.reform([0, 1, 2])
    assert gang3.member_pids() == pids
    assert gang3.run(spmd_sum, timeout=RUN_S) == [SPMD_SUM[3]] * 3


def test_a_member_killed_in_a_collective_is_named_then_replaced(gang3):
    pids, ids = gang3.member_pids(), gang3.member_ids()
    t0 = time.monotonic()
    with pytest.raises(GangMemberDied, match="rank 1/3") as err:
        gang3.run(functools.partial(die_in_a_collective, target=1),
                  timeout=RUN_S)
    elapsed = time.monotonic() - t0
    assert err.value.rank == 1 and "exit code -9" in str(err.value)
    assert elapsed < DEATH_BOUND_S, f"death took {elapsed:.2f} s to surface"
    assert gang3.alive_ranks() == [0, 2]

    gang3.reform([0, 2])
    assert gang3.num_members == 2 and gang3.target_members == 3
    assert gang3.member_pids() == [pids[0], pids[2]]   # not restarted
    assert gang3.member_ids() == [ids[0], ids[2]]
    assert gang3.run(spmd_sum, timeout=RUN_S) == [SPMD_SUM[2]] * 2

    assert gang3.readmit() == 3
    final = gang3.member_pids()
    assert final[:2] == [pids[0], pids[2]] and final[2] not in pids
    assert gang3.run(spmd_sum, timeout=RUN_S) == [SPMD_SUM[3]] * 3
