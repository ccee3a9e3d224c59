"""The port's elastic multi-host gang (``parallel.gang``: ``GangMember``,
``MultiHostGang``) and a member's world (``parallel.distributed``), held
to the contract of the JAX package's gang tests
(``tests/test_elastic_gang.py``, ``tests/test_elastic_ingest.py``'s
readmit chaos point) with in-process members on the CPU.

``spmd_sum`` is a dp reduction over the whole world whose value encodes
the world's size: each rank holds a [1, 4] block of ``rank + 1`` of a
DTensor split over ``dp``, so 3 ranks sum to (1 + 2 + 3) * 4 = 24 and 2
to 12.  A member dies by its own code (``kill()`` or ``MemberKilled``),
the counterpart of the JAX tests' ``os.kill(pid, SIGKILL)``; no
subprocess, no runtime session, no sleep."""

import threading
import time

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from ray_tpu.core import fault_injection as jfi
from ray_tpu_torch.core import fault_injection as tfi
from ray_tpu_torch.parallel import distributed, threaded
from ray_tpu_torch.parallel.gang import (GangConfig, GangMember,
                                         GangMemberDied, MemberKilled,
                                         MultiHostGang, TpuGang,
                                         current_member)

DEATH_BOUND_S = 5.0


def spmd_sum(rank):
    gang = TpuGang(GangConfig({"dp": -1}, num_hosts=dist.get_world_size(),
                              device="cpu"))
    local = torch.full((1, 4), float(rank + 1))
    x = DTensor.from_local(local, gang.mesh, [Shard(0)], run_check=False)
    return float(x.full_tensor().sum())


@pytest.fixture
def gang3():
    gang = MultiHostGang(3, device="cpu")
    yield gang
    gang.shutdown()


def _kill_rank(target):
    def fn(rank):
        if rank == target:
            current_member().kill()
        dist.barrier()          # the others wait in a collective
        return rank
    return fn


def test_reform_shrinks_then_readmits_keeping_the_survivors(gang3):
    gang = gang3
    ids = gang.member_ids()
    assert len(set(ids)) == 3 and gang.global_devices == 3
    assert gang.run(spmd_sum) == [24.0] * 3
    coordinator = gang.coordinator

    with pytest.raises(GangMemberDied) as err:
        gang.run(_kill_rank(1))
    assert err.value.rank == 1
    assert gang.alive_ranks() == [0, 2]

    gang.reform(gang.alive_ranks())
    assert gang.num_members == 2 and gang.target_members == 3
    assert gang.member_ids() == [ids[0], ids[2]]
    assert gang.coordinator != coordinator          # a fresh rendezvous
    assert [m.rank for m in gang.members] == [0, 1]
    assert gang.run(spmd_sum) == [12.0] * 2          # dp resharded

    assert gang.readmit() == 3
    final = gang.member_ids()
    assert final[:2] == [ids[0], ids[2]] and final[2] not in ids
    assert gang.run(spmd_sum) == [24.0] * 3


def test_a_failed_call_is_not_a_death(gang3):
    """A member's exception fails the call (naming its rank) and leaves
    it alive; a re-form in place at the same size keeps every member."""
    gang = gang3
    ids = gang.member_ids()

    def fn(rank):
        if rank == 2:
            raise ValueError("step failed on rank 2")
        dist.barrier()

    with pytest.raises(GangMemberDied, match="rank 2/3") as err:
        gang.run(fn)
    assert err.value.rank == 2
    assert gang.alive_ranks() == [0, 1, 2]
    gang.reform([0, 1, 2])
    assert gang.member_ids() == ids and gang.run(spmd_sum) == [24.0] * 3


class FailingSetupMember(GangMember):
    """Rank 1's setup fails: the partial-formation shape."""

    made: list = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        FailingSetupMember.made.append(self)

    def formed(self):
        if self.rank == 1:
            raise RuntimeError("injected setup failure (rank 1)")
        super().formed()


def test_partial_formation_leaves_no_member_alive():
    FailingSetupMember.made = []
    with pytest.raises(GangMemberDied, match="injected setup failure") \
            as err:
        MultiHostGang(3, device="cpu", member_cls=FailingSetupMember)
    assert err.value.rank == 1
    made = FailingSetupMember.made
    assert len(made) == 3 and not any(m.alive for m in made)
    for m in made:
        with pytest.raises(GangMemberDied):
            m.ping()


def test_member_death_in_a_collective_names_its_rank_promptly(gang3):
    gang = gang3
    waiting = threading.Event()

    def fn(rank):
        if rank == 1:
            # die only once rank 0 waits in the barrier
            with threaded.waiting_outside_collectives():
                assert waiting.wait(30)
            raise MemberKilled("rank 1 dies")
        if rank == 0:
            waiting.set()
        dist.barrier()

    t0 = time.perf_counter()
    with pytest.raises(GangMemberDied, match="rank 1/3") as err:
        gang.run(fn)
    elapsed = time.perf_counter() - t0
    assert err.value.rank == 1
    assert elapsed < DEATH_BOUND_S, f"death took {elapsed:.2f} s to surface"
    assert gang.alive_ranks() == [0, 2]


def test_readmit_chaos_point_and_kill_rules(gang3):
    """A scripted raise at ``gang_readmit`` (the JAX package's
    ``FaultPlan`` in the port's gate) fails the readmission before any
    member spawns; disarmed, it succeeds.  A running member cannot be
    killed from outside; an idle one can."""
    gang = gang3
    ids = gang.member_ids()
    gang.members[1].kill()                     # idle: killed from outside
    assert gang.alive_ranks() == [0, 2]
    gang.reform([0, 2])

    def boom(ctx):
        raise RuntimeError(f"scripted readmit fault (world={ctx['world']}, "
                           f"want={ctx['want']})")

    plan = jfi.FaultPlan()
    plan.script(boom, point="gang_readmit", nth=None, times=1)
    with tfi.injected(plan):
        with pytest.raises(RuntimeError,
                           match=r"readmit fault \(world=2, want=1\)"):
            gang.readmit()
    assert gang.num_members == 2 and gang.member_ids() == [ids[0], ids[2]]
    assert any(p == "gang_readmit" for (p, _a, _d) in plan.log)
    assert gang.readmit() == 3

    def from_outside(rank):
        dist.barrier()              # every member is running now
        if rank == 0:
            with pytest.raises(RuntimeError, match="cannot be killed"):
                gang.members[1].kill()
        dist.barrier()
        return rank
    assert gang.run(from_outside) == [0, 1, 2]
    assert gang.alive_ranks() == [0, 1, 2]


def test_a_failed_readmission_reaps_the_fresh_members(gang3):
    gang = gang3
    gang.members[2].kill()
    gang.reform(gang.alive_ranks())
    made = []

    class FailingJoin(GangMember):
        def formed(self):
            made.append(self)
            raise RuntimeError("fresh member failed to join")

    gang._member_cls = FailingJoin
    with pytest.raises(GangMemberDied, match="fresh member failed"):
        gang.readmit()
    assert len(made) == 1 and not made[0].alive
    gang._member_cls = GangMember
    assert gang.num_members == 2 and gang.run(spmd_sum) == [12.0] * 2


class FailingReform(GangMember):
    """Fails to prove the next world it joins formed, once, when armed."""

    fail = False

    def formed(self):
        if self.fail:
            self.fail = False
            raise RuntimeError("member failed to re-form")
        super().formed()


def test_a_failed_reform_keeps_the_gang_and_leaks_no_rendezvous():
    """A re-form whose world fails leaves the gang on its members and
    coordinator (it still runs at 3), releases the rendezvous it had
    picked, and the gang's shutdown releases its own: no in-process
    store outlives the gang."""
    before = set(distributed._stores)
    gang = MultiHostGang(3, device="cpu", member_cls=FailingReform)
    try:
        ids, coordinator = gang.member_ids(), gang.coordinator
        assert set(distributed._stores) == before | {coordinator}
        gang.members[2].fail = True
        with pytest.raises(GangMemberDied, match="during reform") as err:
            gang.reform([0, 2])
        assert err.value.rank == 1              # member 2, renumbered
        assert gang.coordinator == coordinator
        assert gang.member_ids() == ids and gang.num_members == 3
        assert set(distributed._stores) == before | {coordinator}
        assert gang.run(spmd_sum) == [24.0] * 3
    finally:
        gang.shutdown()
    assert set(distributed._stores) == before


def test_tpu_gang_of_many_hosts_forms_inside_a_member():
    gang = MultiHostGang(2, device="cpu")
    try:
        def view(rank):
            g = TpuGang(GangConfig({"dp": -1}, num_hosts=2, device="cpu"))
            return g.num_hosts, g.axis_sizes, current_member().member_id
        out = gang.run(view)
        assert [o[:2] for o in out] == [(2, {"dp": 2})] * 2
        assert [o[2] for o in out] == gang.member_ids()
    finally:
        gang.shutdown()
    with pytest.raises(ValueError, match="inside a member"):
        TpuGang(GangConfig({"dp": -1}, num_hosts=2, device="cpu"))


def test_gloo_world_is_left_without_a_handshake():
    """The process route (``backend_for``): a gloo world of one rank at a
    fresh localhost coordinator, abandoned (its group parked, never shut
    down), then a second world at a new coordinator."""
    assert distributed.backend_for("cpu") == "gloo"
    assert distributed.backend_for("cuda") == "nccl"
    parked = len(distributed._abandoned_worlds)
    for _ in range(2):
        coordinator = distributed.new_coordinator("gloo")
        assert coordinator.startswith("tcp://127.0.0.1:")
        distributed.initialize(coordinator, 1, 0, "gloo")
        x = torch.ones(3)
        dist.all_reduce(x)
        assert (dist.get_rank(), dist.get_world_size()) == (0, 1)
        assert x.tolist() == [1.0, 1.0, 1.0]
        distributed.abandon()
        assert not dist.is_initialized()
    assert len(distributed._abandoned_worlds) == parked + 2


def test_device_none_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiHostGang(2)
