"""The gang, the port of ``ray_tpu/parallel/gang.py``: the single-host
gang (``GangConfig``, ``TpuGang``, ``form_gang``) and the elastic
multi-host gang (``GangMemberDied``, ``GangMember``, ``MultiHostGang``).

A gang is the mesh a trainer runs on.  Where the JAX package lays a
``Mesh`` over the devices of one process, the port lays a ``DeviceMesh``
over the ranks of the process's ``torch.distributed`` world (``-1`` on
one axis fills it): every rank forms the gang, SPMD, as torchrun would
start it.  ``put_batch`` is ``train.step.shard_batch``: each rank keeps
the rows of the host batch it owns.  Inside a member of a multi-host
gang, ``TpuGang(GangConfig(num_hosts=world))`` is the member's view of
the whole world, as in the JAX package.

The multi-host gang is the unit of fault tolerance.  One member per host
runs the same program (``run``); when a member dies the survivors are
re-formed in place at the smaller world (``reform``: the same member
objects, renumbered in order, a fresh coordinator), and replacements are
re-admitted at the next boundary (``readmit``).  Full teardown and a
fresh gang stay the fallback.

Members are hosted behind a small interface (``InProcessHost``: spawn a
member, run a method on a set of members in one world, probe one, kill
one).  The port ships in-process members: each ``GangMember`` is an
object that lasts across worlds, and each world is one
``threaded.run_ranks`` call over the current members, whose threads join
through the gang's coordinator (``distributed.initialize``, backend
``"threaded"``, named here: in-process members take no other).  Members may then share one device: the CPU in tests,
one card in the smoke run.  Hosting members as processes or as actors on
other hosts (``distributed``'s NCCL and gloo routes) needs a host
runtime, which the port does not import.

A member's identity (``member_id``, process-wide, never reused) lasts
across re-forms as a process id does in the JAX package
(``member_ids()``, the counterpart of ``member_pids()``).  An in-process
member cannot be killed from outside while it runs (Python has no
SIGKILL for a thread): a member dies when its own code kills it,
``GangMember.kill()`` or raising ``MemberKilled`` out of ``run``, and
from then on it answers no ``ping``.  ``current_member()`` is the member
whose thread calls it (None elsewhere).
"""

from __future__ import annotations

import itertools
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.core import fault_injection as _fi
from ray_tpu_torch.parallel import distributed
from ray_tpu_torch.parallel.mesh import create_mesh, mesh_shape


@dataclass
class GangConfig:
    mesh_axes: dict[str, int] = field(default_factory=lambda: {"dp": -1})
    num_hosts: int = 1
    device: Any = None           # the ranks' device type; None: the card


class TpuGang:
    """A formed gang on this process's world: ``mesh`` (a ``DeviceMesh``
    over every rank), ``run(fn, *args)`` and ``put_batch``.  With
    ``num_hosts > 1`` the world is a multi-host gang's, joined by this
    member: the world's size must be a multiple of ``num_hosts``."""

    def __init__(self, config: Optional[GangConfig] = None):
        self.config = config or GangConfig()
        hosts = self.config.num_hosts
        if hosts > 1:
            world = (dist.get_world_size() if dist.is_initialized()
                     else 1)
            if world % hosts:
                raise ValueError(
                    f"a gang of {hosts} hosts over a world of {world} "
                    f"ranks: form it inside a member of a MultiHostGang "
                    f"of {hosts} (its run)")
        self.mesh = create_mesh(self.config.mesh_axes,
                                device=self.config.device)
        self.num_hosts = hosts

    @property
    def axis_sizes(self) -> dict[str, int]:
        return mesh_shape(self.mesh)

    @property
    def num_devices(self) -> int:
        return math.prod(self.mesh.shape)

    def run(self, fn: Callable, *args, **kwargs) -> Any:
        """``fn(*args, **kwargs)`` on this rank (every rank calls it:
        the mesh needs no context to be active)."""
        return fn(*args, **kwargs)

    def put_batch(self, batch: dict) -> dict:
        """A host batch (the global batch, the same on every rank) ->
        DTensors split over the data axes (``step.shard_batch``)."""
        from ray_tpu_torch.train.step import shard_batch

        return shard_batch(batch, self.mesh)

    def shutdown(self) -> None:
        pass


def form_gang(mesh_axes: Optional[dict[str, int]] = None, *,
              num_hosts: int = 1, device=None) -> TpuGang:
    """The gang of ``mesh_axes`` (default ``{"dp": -1}``) over this
    process's world; call it on every rank."""
    return TpuGang(GangConfig(mesh_axes=dict(mesh_axes or {"dp": -1}),
                              num_hosts=num_hosts, device=device))


# ---------------------------------------------------------------------------
# the multi-host gang


class GangMemberDied(RuntimeError):
    """A member died, or its call failed, during a collective gang
    operation.  Carries the rank so elastic recovery can name survivors
    without parsing error strings."""

    def __init__(self, rank: int, message: str):
        self.rank = rank
        super().__init__(message)


class MemberKilled(BaseException):
    """Raised by a member's own code to die: the in-process counterpart
    of SIGKILL of a member process.  A ``BaseException``, so no handler
    of ordinary errors on the way out (a trainer's retry, a feed's error
    agreement) takes it for a failure to recover from in place."""


_local = threading.local()
_member_ids = itertools.count(1)
# the bound on forming a world (formation, re-form, readmission)
SETUP_TIMEOUT_S = 120.0


def current_member() -> Optional["GangMember"]:
    """The member whose thread calls this (None off a member's thread)."""
    return getattr(_local, "member", None)


class GangMember:
    """One member, hosted in this process: its rank in the current world,
    its ``device``, a ``state`` dict kept across worlds (a member's
    long-lived objects: a learner, a rollout worker) and its identity
    ``member_id``.  The gang calls ``formed`` and ``run`` on the member's
    thread inside a world; ``ping`` and ``kill`` anywhere."""

    def __init__(self, rank: int, world: int, *, device=None):
        self.rank, self.world = rank, world
        self.device = torch.device("cuda" if device is None else device)
        self.member_id = next(_member_ids)
        self.coordinator: Optional[str] = None
        self.state: dict = {}
        self._alive = True
        self._busy = False
        self._thread: Optional[threading.Thread] = None

    def choose_coordinator(self) -> str:
        """Rank 0 picks the rendezvous of the next world."""
        return distributed.new_coordinator("threaded")

    def join(self, coordinator: str, world: int, rank: int) -> None:
        """Enter a world on this member's thread (the gang's per-world
        init): take the rank and world given, join through
        ``coordinator``."""
        if not self._alive:
            raise MemberKilled(f"member {self.member_id} is dead")
        self.coordinator, self.world, self.rank = coordinator, world, rank
        self._thread = threading.current_thread()
        _local.member = self
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device.index or 0)
        distributed.initialize(coordinator, world, rank, "threaded")

    def formed(self) -> None:
        """Every member has joined the world (``join``: a formation, a
        re-form or a readmission; the old world was left with no
        handshake when its last call ended, nothing to park for a
        threaded world); one collective proves it formed."""
        dist.barrier()

    def run(self, fn: Callable, *args) -> Any:
        """``fn(rank, *args)`` on this member.  ``MemberKilled`` out of
        ``fn`` kills the member."""
        self._busy = True
        try:
            return fn(self.rank, *args)
        except MemberKilled:
            self._alive = False
            raise
        finally:
            self._busy = False

    def ping(self) -> dict:
        """Liveness probe: raises once the member is dead; answers while
        it runs."""
        if not self._alive:
            raise GangMemberDied(self.rank,
                                 f"member {self.member_id} is dead")
        return {"rank": self.rank, "member_id": self.member_id}

    def kill(self) -> None:
        """Die.  On the member's own thread this raises ``MemberKilled``,
        so its call unwinds; from another thread only an idle member can
        be killed (a running thread cannot be stopped from outside)."""
        if threading.current_thread() is self._thread and self._busy:
            self._alive = False
            raise MemberKilled(f"member {self.member_id} killed itself")
        if self._busy:
            raise RuntimeError(
                f"member {self.member_id} is running: an in-process member "
                f"cannot be killed from outside")
        self._alive = False

    @property
    def alive(self) -> bool:
        return self._alive


class InProcessHost:
    """Hosts gang members as objects of this process; a world is one
    ``run_ranks`` call over the members given, each member's thread
    joining through the world's coordinator."""

    def spawn(self, member_cls: type, rank: int, world: int,
              **kw) -> GangMember:
        return member_cls(rank=rank, world=world, **kw)

    def call(self, members: list, coordinator: str,
             calls: list, what: str,
             timeout: Optional[float]) -> list:
        """``calls[i](members[i])`` on member i's thread, all in one world
        of ``len(members)`` at ``coordinator``; the first member to fail
        raises ``GangMemberDied`` naming its rank (the others, waiting in
        a collective it will never join, are woken and unwound first)."""
        from ray_tpu_torch.parallel.threaded import RankError, run_ranks

        world = len(members)

        def init(rank):
            members[rank].join(coordinator, world, rank)

        try:
            return run_ranks(lambda r: calls[r](members[r]), world,
                             timeout=timeout, init=init)
        except RankError as e:
            raise GangMemberDied(
                e.rank, f"gang member rank {e.rank}/{world} failed during "
                        f"{what}: {e}") from e
        except TimeoutError as e:
            raise TimeoutError(f"gang {what} timed out: {e}") from e

    def probe(self, member: GangMember) -> bool:
        try:
            member.ping()
            return True
        except Exception:
            return False

    def kill(self, member: GangMember) -> None:
        try:
            member.kill()
        except Exception:
            pass


class MultiHostGang:
    """A formed multi-host gang: one ``GangMember`` per host, formed
    together through rank 0's coordinator (SPMD across members), on
    ``device`` (None: the card; the members share it).

    The gang is elastic: ``reform(survivors)`` re-forms it at the smaller
    world from the surviving members (the same objects and ids, a fresh
    coordinator, a fresh world, the dp axis resharded by the new world's
    size) and ``readmit()`` grows it back toward the target size with
    fresh members.  Full teardown and re-formation stay the fallback when
    too few members survive or re-forming fails."""

    def __init__(self, num_members: int, *, device=None,
                 member_cls: Optional[type] = None):
        self.num_members = num_members
        self.target_members = num_members
        self.device = resolve_device(device)
        self.host = InProcessHost()
        self._member_cls = member_cls or GangMember
        self.coordinator: Optional[str] = None
        self.members = [self._spawn(i, num_members)
                        for i in range(num_members)]
        try:
            # the first failed setup surfaces as GangMemberDied
            self._new_world(self.members, "formation setup")
        except BaseException:
            # a half-formed gang leaks no member
            self.shutdown()
            raise

    def _spawn(self, rank: int, world: int) -> GangMember:
        return self.host.spawn(self._member_cls, rank, world,
                               device=self.device)

    def _new_world(self, members: list, what: str) -> None:
        """``members``, renumbered in order, join a fresh world through a
        fresh coordinator that their rank 0 picks, and one collective
        proves it formed.  Only then are they the gang's and the old
        rendezvous released; a failure releases the fresh one and leaves
        the gang as it was."""
        coordinator = members[0].choose_coordinator()
        try:
            self.host.call(members, coordinator,
                           [lambda m: m.formed()] * len(members), what,
                           SETUP_TIMEOUT_S)
        except BaseException:
            distributed.release_coordinator(coordinator)
            raise
        if self.coordinator is not None:
            distributed.release_coordinator(self.coordinator)
        self.coordinator = coordinator
        self.members = members
        self.num_members = len(members)

    @property
    def global_devices(self) -> int:
        """The devices of the world: one a member."""
        return self.num_members

    # ----------------------------------------------------------- execution

    def run(self, fn: Callable, *args,
            timeout: Optional[float] = None) -> list:
        """``fn(rank, *args)`` on every member; returns the per-rank
        results.  No default timeout: an attempt may run for hours.  The
        first failure, a member's death or its exception, surfaces as
        ``GangMemberDied`` naming the rank, after the members waiting in a
        collective it will never join were woken."""
        return self.host.call(
            self.members, self.coordinator,
            [lambda m: m.run(fn, *args)] * self.num_members, "run",
            timeout)

    def member_ids(self) -> list[int]:
        return [m.member_id for m in self.members]

    # ------------------------------------------------------------ elasticity

    def alive_ranks(self, timeout: float = 15.0) -> list[int]:
        """The ranks whose members still answer a probe, under one
        deadline shared by every probe: a member not probed before it
        passes counts as not alive."""
        deadline = time.monotonic() + timeout
        out = []
        for i, m in enumerate(self.members):
            if time.monotonic() > deadline:
                break
            if self.host.probe(m):
                out.append(i)
        return out

    def reform(self, survivors: list[int]) -> None:
        """Re-form the gang from the surviving members at world size
        ``len(survivors)``: the same member objects, renumbered in order,
        join a fresh world through a fresh coordinator (the old one may
        have died with rank 0).  Dead members are reaped."""
        if not survivors:
            raise ValueError("reform needs at least one survivor")
        survivors = sorted(survivors)
        dead = [m for i, m in enumerate(self.members) if i not in survivors]
        self._new_world([self.members[i] for i in survivors], "reform")
        for m in dead:
            self.host.kill(m)

    def _chaos(self, point: str, **ctx) -> None:
        """The fault plane's trigger at gang-membership boundaries: one
        global load and a None test when no plan is installed."""
        fi = _fi._active
        if fi is None:
            return
        ctx.setdefault("world", self.num_members)
        fi.on_gang(point, ctx)

    def readmit(self, count: Optional[int] = None) -> int:
        """Grow the gang back toward ``target_members`` with fresh
        members, re-forming the whole world at the larger size (the
        survivors keep their objects and ids).  A readmission that fails
        reaps the fresh members.  Returns the new world size."""
        want = (self.target_members - self.num_members
                if count is None else count)
        if want <= 0:
            return self.num_members
        self._chaos("gang_readmit", target=self.target_members, want=want)
        world = self.num_members + want
        fresh = [self._spawn(self.num_members + j, world)
                 for j in range(want)]
        try:
            self._new_world(self.members + fresh, "readmit")
        except BaseException:
            for m in fresh:
                self.host.kill(m)
            raise
        return world

    def shutdown(self) -> None:
        for m in self.members:
            self.host.kill(m)
        if self.coordinator is not None:
            distributed.release_coordinator(self.coordinator)


__all__ = ["GangConfig", "TpuGang", "form_gang", "GangMemberDied",
           "MemberKilled", "GangMember", "InProcessHost", "MultiHostGang",
           "current_member"]
