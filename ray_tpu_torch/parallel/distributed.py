"""A gang member's ``torch.distributed`` world: formed from a
coordinator, left without a handshake.  The port's counterpart of the
elastic half of ``ray_tpu/parallel/jax_compat.py``
(``distributed_initialize``, ``distributed_abandon``, ``clear_backends``).

A member joins a world with ``initialize(coordinator, world, rank,
backend)`` and leaves it with ``abandon()``, or as a process over gloo
with ``leave()`` (gloo's teardown closes sockets and sends nothing).
Leaving must not talk to the old world: once a peer is dead, any shutdown handshake (a barrier, a
communicator's collective abort) can block or raise in the survivors.  So
``abandon`` never calls ``destroy_process_group`` or ``shutdown``: it
parks the old groups in a module-level list (a bounded leak, one world
per re-form, so that not even a destructor runs against a world with a
dead member) and clears c10d's bookkeeping, so the next ``initialize``
builds a fresh world.  torch's c10d keeps no cached device view, so
there is nothing like ``clear_backends`` to drop.

Backends are named by where the members live:

  * ``"threaded"``: members are threads of this process, each world one
    ``threaded.run_ranks`` call (the in-process gang, which names it).  The coordinator
    is an in-process rendezvous (``new_coordinator``: a ``HashStore``
    under a fresh ``threaded://`` name) and each entry into the world
    takes a fresh prefix of it, so no key of an earlier world is seen by
    a later one.  The world is dropped whole when the ``run_ranks`` call
    ends; ``abandon`` has nothing to park.
  * ``"nccl"`` (CUDA) and ``"gloo"`` (CPU), by the device
    (``backend_for``): one member per process, the coordinator a
    ``tcp://host:port`` address whose master ``TCPStore`` the process
    that picked it holds from ``new_coordinator`` to
    ``release_coordinator``, so no other socket can take the port in
    between (a port found free and closed again could be taken before a
    rank bound it).  Every rank joins it as a client, each entry under a
    fresh prefix as above.  This is the route for members hosted
    as processes (``gang.ProcessHost``), which takes gloo, also over CUDA
    tensors on a card the members share (NCCL runs no two ranks on one
    card).  ``WORLD_TIMEOUT_S`` bounds the formation and every
    collective of such a world.  A member process whose call failed
    ``leave``s its world: its connections close, so peers blocked in a
    collective with it raise at once instead of at the timeout.

Gloo over CUDA tensors: torch's gloo backend takes a CUDA tensor itself,
copying it to a host buffer, reducing or exchanging it there over TCP and
copying the result back (its CUDA work); the port stages no collective
of its own.  On the H100 with torch 2.11 gloo took every collective the
port's paths issue on CUDA tensors (``all_reduce`` in f32, bf16 and
int64, ``broadcast``, ``all_gather``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``barrier``).  A ``{"dp": -1}`` train step
of a process-hosted ``Trainer`` issues only all-reduces (the flat
gradient, the global norm's sum, the loss's and the host-error flags')
and the checkpoint manager's barriers (``tests/
test_torch_port_proc_trainer_host.py`` pins that list on the CPU).
"""

from __future__ import annotations

import datetime
import threading
import uuid
from urllib.parse import urlsplit

import torch
import torch.distributed as dist

THREADED = "threaded://"

# the rendezvous this process holds, by coordinator: an in-process
# ``HashStore`` (threaded) or the master ``TCPStore`` of a tcp address
_stores: dict = {}
_stores_lock = threading.Lock()
# worlds left by abandon(): never shut down, never destroyed
_abandoned_worlds: list = []
# the bound on forming a world and, for a world of processes, on each of
# its collectives
WORLD_TIMEOUT_S = 120.0


def backend_for(device) -> str:
    """The backend of members in their own processes on ``device``:
    ``"nccl"`` on CUDA, ``"gloo"`` on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=WORLD_TIMEOUT_S)


def new_coordinator(backend: str, host: str = "127.0.0.1") -> str:
    """A fresh rendezvous for a world of ``backend``, held by this
    process until ``release_coordinator``: a new in-process store
    (``threaded://<name>``), or the master ``TCPStore`` of a port the
    system picks on ``host`` (``tcp://host:port``)."""
    if backend == "threaded":
        name, store = THREADED + uuid.uuid4().hex, dist.HashStore()
    else:
        store = dist.TCPStore(host, 0, is_master=True,
                              wait_for_workers=False, timeout=_timeout())
        name = f"tcp://{host}:{store.port}"
    with _stores_lock:
        _stores[name] = store
    return name


def release_coordinator(coordinator: str) -> None:
    """Drop a rendezvous no world will enter again; a tcp address's port
    is closed with its master store."""
    with _stores_lock:
        _stores.pop(coordinator, None)


def _entry_store(base, rank: int):
    """``base`` under a fresh prefix for this entry into its world:
    every rank enters each world of a coordinator once, in order, so its
    own count names the entry without a handshake, and no key of an
    earlier world is seen by a later one."""
    entry = base.add(f"entries/{rank}", 1)
    return dist.PrefixStore(f"world{entry}/", base)


def initialize(coordinator: str, world: int, rank: int,
               backend: str) -> str:
    """Join the world of ``world`` ranks at ``coordinator`` as ``rank``:
    ``dist.init_process_group`` on this thread (threaded) or process,
    whose collectives (a process world's) wait at most
    ``WORLD_TIMEOUT_S``.  A tcp address is joined as a client of its
    holder's store, rank 0 too.  Returns the backend."""
    if backend == "threaded":
        with _stores_lock:
            base = _stores.get(coordinator)
        if base is None:
            raise RuntimeError(f"no in-process rendezvous {coordinator!r}")
        dist.init_process_group("threaded", rank=rank, world_size=world,
                                store=_entry_store(base, rank))
    else:
        url = urlsplit(coordinator)
        base = dist.TCPStore(url.hostname, url.port, is_master=False,
                             timeout=_timeout())
        dist.init_process_group(backend, store=_entry_store(base, rank),
                                world_size=world, rank=rank,
                                timeout=_timeout())
    return backend


def leave() -> None:
    """Leave this process's world and close its connections
    (``destroy_process_group``), so that peers waiting in a collective
    with this process raise at once.  Nothing to do when no world is
    initialised."""
    if dist.is_initialized():
        dist.destroy_process_group()


def abandon() -> None:
    """Leave this process's world with no barrier and no shutdown: its
    groups are parked, c10d's bookkeeping is cleared.  Nothing to do
    when no world is initialised."""
    if not dist.is_initialized():
        return
    c10d = dist.distributed_c10d
    w = c10d._world
    _abandoned_worlds.append(list(w.pg_map))
    c10d._update_default_pg(None)
    for name in ("pg_map", "pg_names", "pg_group_ranks",
                 "pg_backend_config", "pg_to_tag", "tags_to_pg",
                 "pg_coalesce_state"):
        table = getattr(w, name, None)
        if table is not None:
            table.clear()
    unregister = getattr(c10d, "_unregister_all_process_groups", None)
    if unregister is not None:
        unregister()
    w.group_count = 0


__all__ = ["THREADED", "WORLD_TIMEOUT_S", "backend_for", "new_coordinator",
           "release_coordinator", "initialize", "leave", "abandon"]
