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

Members are hosted behind a small interface (spawn a member, pick a
world's coordinator, run a method on a set of members in one world,
probe one, kill one), with two hosts:

- ``InProcessHost`` (the default): each ``GangMember`` is an object of
  this process that lasts across worlds, and each world is one
  ``threaded.run_ranks`` call over the current members, whose threads
  join through the gang's coordinator (``distributed.initialize``,
  backend ``"threaded"``).  Members may then share one device: the CPU in
  tests, one card in the smoke run.  An in-process member cannot be
  killed from outside while it runs (Python has no SIGKILL for a
  thread): it dies when its own code kills it, ``GangMember.kill()`` or
  raising ``MemberKilled`` out of ``run``, and from then on it answers no
  ``ping``.
- ``ProcessHost``: each member is a process of its own (spawned, never
  forked), the JAX package's member actor; a SIGKILL ends it, from
  outside or from its own code.  Its world is gloo over a
  ``tcp://127.0.0.1`` coordinator whose port the owner holds from its
  choice until the world is spent or the gang shuts down, on the CPU or
  on a card the members share (NCCL runs no two ranks on one card).  The member object and its
  ``state`` live in the child; the parent holds a ``ProcessMember``
  handle.  Functions reach the child by reference with the standard
  ``pickle``: a module-level function or a ``functools.partial`` of one,
  never a lambda or a closure (``cannot_travel`` says why an object
  cannot).

The callers choose the host from what they run, never from an option:
``Trainer(num_hosts > 1)`` takes ``ProcessHost`` when its attempt's spec
travels and the in-process host when it does not (a lambda, a closure);
DD-PPO always takes ``ProcessHost``.

A member's identity (``member_id``, process-wide, never reused) lasts
across re-forms as a process id does in the JAX package
(``member_ids()``; ``member_pids()`` the processes hosting them).
``current_member()`` is the member whose thread calls it (None
elsewhere), in a member process the member that process hosts.
"""

from __future__ import annotations

import itertools
import math
import os
import pickle
import queue
import signal
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing

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
# the bound on forming a world (formation, re-form, readmission); a
# process world's collectives have the same bound
SETUP_TIMEOUT_S = distributed.WORLD_TIMEOUT_S


def current_member() -> Optional["GangMember"]:
    """The member whose thread calls this (None off a member's thread)."""
    return getattr(_local, "member", None)


class GangMember:
    """One member, in this process or (``ProcessHost``) in a process of
    its own: its rank in the current world, its ``device``, the
    ``backend`` of its worlds (``"threaded"`` in this process, ``"gloo"``
    in its own), a ``state`` dict kept across worlds (a member's
    long-lived objects: a learner, a rollout worker) and its identity
    ``member_id``.  The gang calls ``formed`` and ``run`` on the member's
    thread inside a world; ``ping`` and ``kill`` anywhere."""

    def __init__(self, rank: int, world: int, *, device=None):
        self.rank, self.world = rank, world
        self.device = torch.device("cuda" if device is None else device)
        self.backend = "threaded"   # "gloo" in a process of its own
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
        ``coordinator``; a process member leaves its previous world
        first."""
        if not self._alive:
            raise MemberKilled(f"member {self.member_id} is dead")
        if self.backend != "threaded":
            distributed.leave()     # the previous world, if any
        self.coordinator, self.world, self.rank = coordinator, world, rank
        self._thread = threading.current_thread()
        _local.member = self
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device.index or 0)
        distributed.initialize(coordinator, world, rank, self.backend)

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
        return {"rank": self.rank, "member_id": self.member_id,
                "pid": os.getpid()}

    def kill(self) -> None:
        """Die.  A member hosted in a process of its own SIGKILLs that
        process.  In this process, on the member's own thread this raises
        ``MemberKilled``, so its call unwinds; from another thread only an
        idle member can be killed (a running thread cannot be stopped
        from outside)."""
        if self.backend != "threaded":          # a process of its own
            os.kill(os.getpid(), signal.SIGKILL)
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

    def new_coordinator(self, members: list) -> str:
        """The next world's rendezvous, picked by its rank 0."""
        return members[0].choose_coordinator()

    def release(self, coordinator: str) -> None:
        """Drop a rendezvous no world will enter again."""
        distributed.release_coordinator(coordinator)

    def call(self, members: list, coordinator: str, method: str,
             args: tuple, what: str, timeout: Optional[float]) -> list:
        """``members[i].<method>(*args)`` on member i's thread, all in one
        world of ``len(members)`` at ``coordinator``; the first member to
        fail raises ``GangMemberDied`` naming its rank (the others,
        waiting in a collective it will never join, are woken and unwound
        first)."""
        from ray_tpu_torch.parallel.threaded import RankError, run_ranks

        world = len(members)

        def init(rank):
            members[rank].join(coordinator, world, rank)

        try:
            return run_ranks(
                lambda r: getattr(members[r], method)(*args), world,
                timeout=timeout, init=init)
        except RankError as e:
            raise GangMemberDied(
                e.rank, f"gang member rank {e.rank}/{world} failed during "
                        f"{what}: {e}") from e
        except TimeoutError as e:
            raise TimeoutError(f"gang {what} timed out: {e}") from e

    def probe(self, member: GangMember, timeout: float) -> bool:
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

    def pid(self, member: GangMember) -> int:
        return os.getpid()


# ---------------------------------------------------------------------------
# members as processes

def _pickled(obj) -> tuple:
    """(``obj`` pickled with the standard pickle, None), or (None, why it
    cannot be): a lambda, a closure, a local class, a generator."""
    try:
        return pickle.dumps(obj), None
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        return None, f"{type(e).__name__}: {e}"


def cannot_travel(obj) -> Optional[str]:
    """Why ``obj`` cannot reach a process member (``ProcessHost``), or
    None when it can: it must pickle with the standard pickle, every
    function and class in it by reference (module-level, or a
    ``functools.partial`` of such)."""
    return _pickled(obj)[1]


# after a member's first error, how long the others' answers and exits are
# awaited before one is blamed (a peer's "connection closed" error can
# come before the death that caused it is seen)
BLAME_WINDOW_S = 3.0
# the bound on a killed member's exit
KILL_JOIN_S = 10.0


def _serve_member(conn, member_cls: type, rank: int, world: int,
                  member_id: int, kw: dict) -> None:
    """A member process's loop.  The main thread reads the owner's
    commands from ``conn`` and answers ``ping`` itself, so a member stuck
    in a collective still answers; ``call`` runs on one worker thread, in
    order, so a survivor joins a new world only once its previous call
    has unwound.  A call that raises leaves its world before it answers,
    so that peers blocked in a collective with it raise at once (and the
    next call joins afresh); the failure is stamped with
    ``time.monotonic()`` (one clock for every process of a machine) when
    it is caught.  At EOF (the owner died) the
    process exits."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")   # 127.0.0.1 worlds
    member = member_cls(rank=rank, world=world, **kw)
    member.member_id, member.backend = member_id, "gloo"
    send_lock = threading.Lock()

    def send(msg) -> None:
        with send_lock:
            conn.send_bytes(pickle.dumps(msg))

    calls: queue.SimpleQueue = queue.SimpleQueue()

    def work() -> None:
        _local.member = member
        while True:
            seq, where, blob = calls.get()
            try:
                method, args = pickle.loads(blob)
                if where != (member.coordinator, member.world, member.rank):
                    member.join(*where)
                send((seq, "ok", getattr(member, method)(*args)))
            except MemberKilled:
                os.kill(os.getpid(), signal.SIGKILL)
            except Exception as e:      # answered; the member lives on
                stamp = time.monotonic()
                distributed.leave()
                member.coordinator = None
                send((seq, "error", stamp, f"{type(e).__name__}: {e}",
                      traceback.format_exc()))
            except BaseException:       # SystemExit and the like
                os._exit(1)

    threading.Thread(target=work, name="gang-member-call",
                     daemon=True).start()
    while True:
        try:
            kind, seq, *rest = pickle.loads(conn.recv_bytes())
        except (EOFError, OSError):
            os._exit(0)
        if kind == "ping":
            send((seq, "ok", member.ping()))
        else:
            calls.put((seq, *rest))


class ProcessMember:
    """The owner's handle to a member in a process of its own: its
    ``member_id``, current ``rank`` and ``world``, ``pid`` and
    ``alive``, and the ``address`` of the world it was last sent to.  A
    reader thread files the child's answers by sequence number and marks
    the member gone at EOF (its process ended)."""

    def __init__(self, proc, conn, member_id: int, rank: int, world: int,
                 cond: threading.Condition):
        self.proc, self.pid = proc, proc.pid
        self.member_id, self.rank, self.world = member_id, rank, world
        self.address: Optional[str] = None     # of the world it was sent to
        self._conn, self._cond = conn, cond
        self._send_lock = threading.Lock()
        self._seq = itertools.count()
        self._waiting: set = set()
        self._answers: dict = {}
        self.gone_at: Optional[float] = None
        self._reader = threading.Thread(
            target=self._read, name=f"gang-member-{member_id}-reader",
            daemon=True)
        self._reader.start()

    def _read(self) -> None:
        while True:
            try:
                seq, *answer = pickle.loads(self._conn.recv_bytes())
            except (EOFError, OSError):
                with self._cond:
                    self.gone_at = time.monotonic()
                    self._cond.notify_all()
                return
            with self._cond:
                if seq in self._waiting:
                    self._answers[seq] = answer
                    self._cond.notify_all()

    def submit(self, kind: str, *rest) -> int:
        """Send a command -> its sequence number (its answer is awaited
        until ``forget``)."""
        seq = next(self._seq)
        with self._cond:
            self._waiting.add(seq)
        try:
            with self._send_lock:
                self._conn.send_bytes(pickle.dumps((kind, seq, *rest)))
        except OSError:
            pass                        # gone: the reader marks it
        return seq

    def answer(self, seq: int):
        """The answer to ``seq`` or None; call under the host's lock."""
        return self._answers.get(seq)

    def forget(self, seq: int) -> None:
        with self._cond:
            self._waiting.discard(seq)
            self._answers.pop(seq, None)

    @property
    def alive(self) -> bool:
        return self.gone_at is None and self.proc.is_alive()

    def exit_code(self) -> Optional[int]:
        self.proc.join(KILL_JOIN_S)
        return self.proc.exitcode

    def close(self) -> None:
        """SIGKILL the process (if alive), join it and the reader (each
        bounded), close the pipe."""
        if self.proc.is_alive():
            try:
                os.kill(self.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        self.proc.join(KILL_JOIN_S)
        self._reader.join(KILL_JOIN_S)
        self._conn.close()


class ProcessHost:
    """Hosts each gang member in a process of its own, spawned by
    ``torch.multiprocessing`` (never forked: the owner may hold CUDA or
    XLA threads).  ``member_cls`` and every function given to ``run``
    must be importable in the child; a process whose owner dies exits
    (EOF on its pipe), and members are daemons."""

    def __init__(self):
        self._ctx = torch.multiprocessing.get_context("spawn")
        self._cond = threading.Condition()
        # a gang's coordinator -> the address its members join, and the
        # addresses of spent worlds, which some member has left (its call
        # failed, or it joined another world since): the next call on a
        # spent world joins a fresh one, as an in-process world is joined
        # afresh on every call
        self._address: dict = {}
        self._spent: set = set()

    def spawn(self, member_cls: type, rank: int, world: int,
              **kw) -> ProcessMember:
        member_id = next(_member_ids)
        parent, child = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=_serve_member, name=f"gang-member-{member_id}",
            args=(child, member_cls, rank, world, member_id, kw),
            daemon=True)
        proc.start()
        child.close()
        return ProcessMember(proc, parent, member_id, rank, world,
                             self._cond)

    def new_coordinator(self, members: list) -> str:
        """A rendezvous on 127.0.0.1 whose port the owner holds until it
        is released (``distributed.new_coordinator``)."""
        address = distributed.new_coordinator("gloo")
        self._spent.discard(address)    # a port released before, reused
        return address

    def release(self, coordinator: str) -> None:
        """Close a gang's rendezvous and the address its members were
        last moved to."""
        distributed.release_coordinator(
            self._address.pop(coordinator, coordinator))
        distributed.release_coordinator(coordinator)

    def _spend(self, address: str) -> None:
        """No world enters ``address`` again: its port is closed."""
        self._spent.add(address)
        distributed.release_coordinator(address)

    def call(self, members: list, coordinator: str, method: str,
             args: tuple, what: str, timeout: Optional[float]) -> list:
        """``<method>(*args)`` on every member in one world of
        ``len(members)`` at ``coordinator`` (a member not yet in it joins
        first) -> the results in rank order.  The arguments travel by
        reference with the standard pickle: a lambda or a closure raises
        ``TypeError`` before any member is sent anything.
        ``GangMemberDied`` names a member whose process exited as soon as
        its pipe closes; after an error, every member's answer or exit is
        awaited for ``BLAME_WINDOW_S`` first, and without a death the
        member whose failure came first is named (its peers' "connection
        closed" errors come after it).  A failure spends the world: the
        next call's members join a fresh one, with no re-form needed."""
        blob, why = _pickled((method, args))
        if why is not None:
            raise TypeError(
                f"a process member runs a module-level function or a "
                f"functools.partial of one, sent by reference with the "
                f"standard pickle; {method}{args!r} cannot be: {why}")
        world = len(members)
        address = self._address.get(coordinator, coordinator)
        if address in self._spent:
            address = self._address[coordinator] = self.new_coordinator(
                members)
        seqs = []
        for rank, m in enumerate(members):
            if m.address not in (None, address):
                self._spend(m.address)          # m leaves it to join this
            m.rank, m.world, m.address = rank, world, address
            seqs.append(m.submit("call", (address, world, rank), blob))
        try:
            return self._collect(members, seqs, what, timeout)
        except BaseException:
            self._spend(address)
            raise
        finally:
            for m, seq in zip(members, seqs):
                m.forget(seq)

    def _collect(self, members, seqs, what, timeout) -> list:
        world = len(members)
        deadline = (math.inf if timeout is None
                    else time.monotonic() + timeout)
        window_end = math.inf
        with self._cond:
            while True:
                answers = [m.answer(s) for m, s in zip(members, seqs)]
                dead = [i for i, (m, a) in enumerate(zip(members, answers))
                        if a is None and m.gone_at is not None]
                failed = [i for i, a in enumerate(answers)
                          if a is not None and a[0] == "error"]
                if dead:                # a death outranks every error
                    break
                if not failed and None not in answers:
                    return [a[1] for a in answers]
                now = time.monotonic()
                if failed:
                    window_end = min(window_end, now + BLAME_WINDOW_S)
                    if None not in answers or now >= window_end:
                        break
                if now >= deadline:
                    raise TimeoutError(f"gang {what} timed out after "
                                       f"{timeout} s")
                left = min(deadline, window_end) - now
                # no bound yet (run's default): wait for any answer or exit
                self._cond.wait(None if math.isinf(left) else left)
            if not dead:
                # a member whose process has ended is dead even where its
                # reader (starved of the GIL, say) has not filed the EOF
                # yet: its peers' "connection closed" errors came after it
                dead = [i for i, (m, a) in enumerate(zip(members, answers))
                        if a is None and not m.proc.is_alive()]
        if dead:
            r = min(dead, key=lambda i: (members[i].gone_at is None,
                                         members[i].gone_at or 0.0, i))
            raise GangMemberDied(
                r, f"gang member rank {r}/{world} died during {what} "
                   f"(pid {members[r].pid}, exit code "
                   f"{members[r].exit_code()})")
        r = min(failed, key=lambda i: answers[i][1])
        _, _, err, tb = answers[r]
        raise GangMemberDied(
            r, f"gang member rank {r}/{world} failed during {what}: "
               f"{err}\n{tb}")

    def probe(self, member: ProcessMember, timeout: float) -> bool:
        """Alive and answering a ``ping`` within ``timeout``."""
        if not member.alive:
            return False
        seq = member.submit("ping")
        deadline = time.monotonic() + timeout
        try:
            with self._cond:
                while member.answer(seq) is None and member.alive:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return False
                    self._cond.wait(left)
                return member.answer(seq) is not None
        finally:
            member.forget(seq)

    def kill(self, member: ProcessMember) -> None:
        member.close()

    def pid(self, member: ProcessMember) -> int:
        return member.pid


class MultiHostGang:
    """A formed multi-host gang: one ``GangMember`` per host, formed
    together through rank 0's coordinator (SPMD across members), on
    ``device`` (None: the card; the members share it), hosted by
    ``host`` (None: ``InProcessHost()``; ``ProcessHost()`` for a process
    per member).

    The gang is elastic: ``reform(survivors)`` re-forms it at the smaller
    world from the surviving members (the same objects and ids, a fresh
    coordinator, a fresh world, the dp axis resharded by the new world's
    size) and ``readmit()`` grows it back toward the target size with
    fresh members.  Full teardown and re-formation stay the fallback when
    too few members survive or re-forming fails."""

    def __init__(self, num_members: int, *, device=None,
                 member_cls: Optional[type] = None, host=None):
        self.num_members = num_members
        self.target_members = num_members
        self.device = resolve_device(device)
        self.host = InProcessHost() if host is None else host
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
        coordinator = self.host.new_coordinator(members)
        try:
            self.host.call(members, coordinator, "formed", (), what,
                           SETUP_TIMEOUT_S)
        except BaseException:
            self.host.release(coordinator)
            raise
        if self.coordinator is not None:
            self.host.release(self.coordinator)
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
        return self.host.call(self.members, self.coordinator, "run",
                              (fn, *args), "run", timeout)

    def member_ids(self) -> list[int]:
        return [m.member_id for m in self.members]

    def member_pids(self) -> list[int]:
        """The processes hosting the members (this process's id for each
        in-process member)."""
        return [self.host.pid(m) for m in self.members]

    # ------------------------------------------------------------ elasticity

    def alive_ranks(self, timeout: float = 15.0) -> list[int]:
        """The ranks whose members still answer a probe, under one
        deadline shared by every probe: a member not probed before it
        passes counts as not alive."""
        deadline = time.monotonic() + timeout
        out = []
        for i, m in enumerate(self.members):
            left = deadline - time.monotonic()
            if left <= 0:
                break
            if self.host.probe(m, left):
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
            self.host.release(self.coordinator)


__all__ = ["GangConfig", "TpuGang", "form_gang", "GangMemberDied",
           "MemberKilled", "GangMember", "InProcessHost", "ProcessHost",
           "ProcessMember", "MultiHostGang", "cannot_travel",
           "current_member"]
