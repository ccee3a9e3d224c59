"""Ranks as threads of one process, on ``torch.distributed``'s threaded
process group (the one PyTorch's own distributed tests use).

``run_ranks(fn, n)`` runs ``fn(rank)`` on ``n`` threads, each the rank of
a world of ``n``, and returns their results in rank order.  The
collectives are Python reductions over the ranks' tensors, so the ranks
may share one device: the CPU in tests, one card in the smoke run (the
ranks then queue their kernels on that card's default stream).  It
carries the collectives of ``parallel/collectives.py`` and DTensor; it has
no ``isend``/``irecv``.

The group is process-wide state: ``run_ranks`` installs it, and restores
c10d's world, the thread-isolation mode and autograd's multithreading in
``finally``.  Autograd runs each backward on the rank's own thread while
it is installed, so collectives in a backward see their rank's world.
A rank woken when another raised stops in the first collective that can
no longer complete; one that had completed completes on every rank.
One rank runs at a time: a rank holds a baton from the end of its first
collective and hands it on whenever it waits in one (or in a store
barrier, as creating a mesh's groups does).  Eight ranks scrambling for
the GIL at every small op ran a step several times slower than the same
work in turn.  Each rank computes on one CPU thread
(``torch.set_num_threads(1)``) for the same reason.
"""

from __future__ import annotations

import contextlib
import threading
import time
import traceback
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist


# the baton of the run_ranks call in progress (one at a time per process)
_active_baton: Optional["_Baton"] = None


class RankError(RuntimeError):
    """A rank raised; the message holds that rank's traceback and
    ``rank`` names it (the first to raise, before the woken ones)."""

    def __init__(self, message: str, rank: int = -1):
        super().__init__(message)
        self.rank = rank


def run_ranks(fn: Callable[[int], Any], world_size: int, *,
              timeout: Optional[float] = 60.0,
              init: Optional[Callable[[int], Any]] = None) -> list:
    """``[fn(0), ..., fn(world_size - 1)]``, each on its own thread with
    the threaded default process group initialised for that rank.  The
    first rank to raise re-raises here as ``RankError`` with its
    traceback, after the others were woken from their collectives (where
    they raise ``SystemExit``); when no rank raised, a rank still running
    after ``timeout`` seconds in all raises ``TimeoutError`` (woken the
    same way; a rank that never waits in a collective is left behind, a
    daemon thread).  ``timeout=None`` waits as long as the ranks run (a
    serving executor's ranks, stopped by their caller).  ``init(rank)``,
    when given, joins the rank's thread to the world in place of the
    default ``init_process_group`` over a fresh store (a gang member
    joins through its coordinator: ``distributed.initialize``)."""
    from torch.testing._internal.distributed import multi_threaded_pg as mtp

    global _active_baton
    baton = _Baton()
    join, barrier = mtp.Collective.join, dist.distributed_c10d._store_based_barrier

    def baton_join(self, rank, data):
        with baton.handed_on(reacquire=True):
            try:
                return join(self, rank, data)
            except SystemExit:
                # a wake-up that raced the end of a collective which
                # completed (its data is copied): it completes here too,
                # so only a collective that can never complete raises
                if self._done:
                    return mtp.ret_work(data)
                raise

    def baton_barrier(*a, **kw):
        with baton.handed_on(reacquire=False):
            return barrier(*a, **kw)

    c10d = torch._C._distributed_c10d
    intra_op = torch.get_num_threads()
    results: dict = {}
    errors: dict = {}
    order: list = []                  # ranks in the order they raised
    lock = threading.Lock()
    c10d._set_thread_isolation_mode(True)
    mtp._install_threaded_pg()
    mtp.ProcessLocalGroup.reset()        # no stop left from a woken world
    _active_baton = baton
    mtp.Collective.join = baton_join
    dist.distributed_c10d._store_based_barrier = baton_barrier
    try:
        store = dist.HashStore()

        def worker(rank):
            # no destroy_process_group: the threaded world is dropped
            # whole below (and torch 2.11's destroy fails on it)
            try:
                torch.set_num_threads(1)
                if init is None:
                    dist.init_process_group("threaded", rank=rank,
                                            world_size=world_size,
                                            store=store)
                else:
                    init(rank)
                results[rank] = fn(rank)
            except BaseException:            # reported by the caller
                with lock:
                    errors.setdefault(rank, traceback.format_exc())
                    order.append(rank)
                _wake_all(mtp.ProcessLocalGroup)
            finally:
                baton.drop()

        threads = [threading.Thread(target=worker, args=(r,), daemon=True,
                                    name=f"rank{r}")
                   for r in range(world_size)]
        for t in threads:
            t.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in threads:
            t.join(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
        hung = [r for r, t in enumerate(threads) if t.is_alive()]
        with lock:
            raised = list(order)     # not those the wake-up below stops
        if hung:
            # wake them from their collectives and let them unwind before
            # the group's state is reset under them
            _wake_all(mtp.ProcessLocalGroup)
            for t in threads:
                t.join(5.0)
    finally:
        _active_baton = None
        mtp.Collective.join = join
        dist.distributed_c10d._store_based_barrier = barrier
        mtp.ProcessLocalGroup.reset()
        mtp._uninstall_threaded_pg()
        c10d._set_thread_isolation_mode(False)
        torch.set_num_threads(intra_op)
    if raised:
        rank = raised[0]
        stuck = f" (ranks {hung} still running)" if hung else ""
        raise RankError(f"rank {rank} of {world_size} failed{stuck}:\n"
                        f"{errors[rank]}", rank)
    if hung:
        raise TimeoutError(f"ranks {hung} of {world_size} did not finish "
                           f"within {timeout} s")
    return [results[r] for r in range(world_size)]


@contextlib.contextmanager
def waiting_outside_collectives():
    """Let the other ranks run while this rank waits on something other
    than a collective (a queue of work): it hands the baton on and takes
    it back after.  Nothing outside ``run_ranks``."""
    baton = _active_baton
    if baton is None:
        yield
        return
    with baton.handed_on(reacquire=True):
        yield


def wake_collectives() -> None:
    """Stop every rank waiting in a collective of the threaded group
    (they raise ``SystemExit`` there), for a caller that knows a rank
    will never join them.  Call it on a rank's thread: from another
    thread, while the ranks unwound, it corrupted the heap under load."""
    from torch.testing._internal.distributed import multi_threaded_pg as mtp

    _wake_all(mtp.ProcessLocalGroup)


def _wake_all(group_cls) -> None:
    """Stop every rank waiting in a collective: they raise ``SystemExit``
    there (``ProcessLocalGroup.exception_handle``, over a snapshot of the
    collectives in flight, which other ranks may be changing)."""
    group_cls._terminate.set()
    for coll in list(group_cls._cur_coll_on_pgs.values()):
        with coll._start_cond:
            coll._start_cond.notify()
        with coll._done_cond:
            coll._done_cond.notify_all()


class _Baton:
    """The right to run, held by one rank thread at a time."""

    def __init__(self):
        self._lock = threading.Lock()
        self._held = threading.local()

    def drop(self) -> None:
        if getattr(self._held, "on", False):
            self._held.on = False
            self._lock.release()

    @contextlib.contextmanager
    def handed_on(self, reacquire: bool):
        """Let the other ranks run while this one waits; take the baton
        back after (``reacquire``: even if this rank did not hold it)."""
        had = getattr(self._held, "on", False)
        self.drop()
        try:
            yield
        finally:
            if had or reacquire:
                self._lock.acquire()
                self._held.on = True
