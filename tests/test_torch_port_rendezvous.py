"""The rendezvous of the port's process worlds
(``ray_tpu_torch.parallel.distributed``, ``gang.ProcessHost``): the
process that picks a ``tcp://127.0.0.1:<port>`` coordinator holds the
port with the world's master ``TCPStore`` until it is released, so no
other socket of the machine can take it between the choice and the
world's formation; every rank joins as a client, each entry under a
prefix of its own.  Against the JAX package's gang contract value
(``SPMD_SUM``, ``tests/test_elastic_gang.py``'s ``_spmd_sum``):

- (a) a live coordinator's port cannot be bound by another socket, and
  is free once released;
- (b) two member processes form a world on it through ``ProcessHost``
  and all-reduce to ``SPMD_SUM[2]``;
- (c) two worlds entered one after the other at one coordinator do not
  see each other's keys;
- (d) a spent world's port is closed, and so is the last one at
  ``shutdown``;
- a member SIGKILLed in a collective is named even when the owner's
  reader has not filed its EOF by the end of the blame window, where
  its peer's "connection closed" error came first.

No ``ray_tpu.init``; every wait is bounded."""

import multiprocessing
import socket
import threading
from urllib.parse import urlsplit

import pytest
import torch
import torch.distributed as dist

from _torch_port_procs import SPMD_SUM, die_in_a_collective, fail_on, spmd_sum
from ray_tpu_torch.parallel import distributed
from ray_tpu_torch.parallel.gang import (GangMemberDied, MultiHostGang,
                                         ProcessHost, ProcessMember)

RUN_S = 60.0
# how long a held-back reader waits before it files the EOF anyway
HELD_S = 30.0


def port_taken(address: str) -> bool:
    """Another socket cannot bind ``address``'s port on 127.0.0.1 (with
    ``SO_REUSEADDR``, so only a listener refuses it, not a closed
    connection's TIME_WAIT)."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("127.0.0.1", urlsplit(address).port))
        except OSError:
            return True
    return False


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_a_live_coordinator_holds_its_port(backend):
    coordinator = distributed.new_coordinator(backend)
    try:
        assert coordinator.startswith("tcp://127.0.0.1:")
        assert port_taken(coordinator)
    finally:
        distributed.release_coordinator(coordinator)
    assert not port_taken(coordinator)


def test_worlds_entered_at_one_coordinator_do_not_see_each_others_keys():
    coordinator = distributed.new_coordinator("gloo")
    try:
        seen = []
        for _ in range(2):
            distributed.initialize(coordinator, 1, 0, "gloo")
            try:
                store = dist.distributed_c10d._get_default_store()
                seen.append(store.check(["left_by_a_world"]))
                store.set("left_by_a_world", "1")
                x = torch.ones(3)
                dist.all_reduce(x)
                assert x.tolist() == [1.0, 1.0, 1.0]
            finally:
                distributed.leave()
        assert seen == [False, False]
    finally:
        distributed.release_coordinator(coordinator)


def test_member_processes_form_worlds_on_held_ports_and_free_them():
    """(b) and (d): the world's port is held while the gang runs on it,
    a failed call spends it (closed) and the next call forms a fresh
    world; ``shutdown`` closes that one."""
    gang = MultiHostGang(2, device="cpu", host=ProcessHost())
    try:
        first = gang.members[0].address
        assert port_taken(first)
        assert gang.run(spmd_sum, timeout=RUN_S) == [SPMD_SUM[2]] * 2
        with pytest.raises(GangMemberDied) as e:
            gang.run(fail_on, 1, timeout=RUN_S)
        assert e.value.rank == 1
        assert not port_taken(first)
        assert gang.run(spmd_sum, timeout=RUN_S) == [SPMD_SUM[2]] * 2
        second = gang.members[0].address
        assert second != first and port_taken(second)
    finally:
        gang.shutdown()
    assert not port_taken(second)
    assert multiprocessing.active_children() == []


class HeldEOF:
    """A member's pipe whose EOF reaches the owner's reader only once
    ``gate`` is set (or after ``HELD_S``): a reader starved until its
    peers' errors have come in."""

    def __init__(self, conn, gate: threading.Event):
        self._conn, self._gate = conn, gate

    def recv_bytes(self):
        try:
            return self._conn.recv_bytes()
        except (EOFError, OSError):
            self._gate.wait(HELD_S)
            raise

    def __getattr__(self, name):
        return getattr(self._conn, name)


def test_a_death_is_named_before_its_peers_error_when_its_eof_is_late(
        monkeypatch):
    """Rank 1 SIGKILLs itself while rank 0 waits in an all-reduce with
    it; rank 0 answers gloo's "connection closed" error, and rank 1's EOF
    is held back past the blame window.  The owner still names rank 1,
    dead, from its process's exit."""
    gate = threading.Event()
    init = ProcessMember.__init__

    def held(self, proc, conn, *a, **kw):
        init(self, proc, HeldEOF(conn, gate), *a, **kw)

    monkeypatch.setattr(ProcessMember, "__init__", held)
    gang = MultiHostGang(2, device="cpu", host=ProcessHost())
    try:
        pids = gang.member_pids()
        with pytest.raises(GangMemberDied) as e:
            gang.run(die_in_a_collective, 1, timeout=RUN_S)
        assert gang.members[1].gone_at is None       # still held back
        assert e.value.rank == 1, str(e.value)
        assert f"died during run (pid {pids[1]}, exit code -9)" \
            in str(e.value)
    finally:
        gate.set()
        gang.shutdown()
    assert multiprocessing.active_children() == []
