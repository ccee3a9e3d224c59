"""A gang member's ``torch.distributed`` world: formed from a
coordinator, left without a handshake.  The port's counterpart of the
elastic half of ``ray_tpu/parallel/jax_compat.py``
(``distributed_initialize``, ``distributed_abandon``, ``clear_backends``).

A member joins a world with ``initialize(coordinator, world, rank,
backend)`` and leaves it with ``abandon()``.  Leaving must not talk to the
old world: once a peer is dead, any shutdown handshake (a barrier, a
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
    ``tcp://host:port`` address chosen by rank 0.  This is
    the route for members hosted as processes; the in-process gang does
    not take it (NCCL runs no two ranks on one card).
"""

from __future__ import annotations

import socket
import threading
import uuid

import torch
import torch.distributed as dist

THREADED = "threaded://"

# in-process rendezvous by coordinator name
_stores: dict = {}
_stores_lock = threading.Lock()
# worlds left by abandon(): never shut down, never destroyed
_abandoned_worlds: list = []


def backend_for(device) -> str:
    """The backend of members in their own processes on ``device``:
    ``"nccl"`` on CUDA, ``"gloo"`` on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def new_coordinator(backend: str, host: str = "127.0.0.1") -> str:
    """A fresh rendezvous for a world of ``backend``, chosen by its rank
    0: a new in-process store (``threaded://<name>``), or a free port on
    ``host`` (``tcp://host:port``)."""
    if backend == "threaded":
        name = THREADED + uuid.uuid4().hex
        with _stores_lock:
            _stores[name] = dist.HashStore()
        return name
    return f"tcp://{host}:{_free_port()}"


def release_coordinator(coordinator: str) -> None:
    """Forget an in-process rendezvous no world will enter again."""
    with _stores_lock:
        _stores.pop(coordinator, None)


def initialize(coordinator: str, world: int, rank: int,
               backend: str) -> str:
    """Join the world of ``world`` ranks at ``coordinator`` as ``rank``:
    ``dist.init_process_group`` on this thread (threaded) or process.
    Returns the backend."""
    if backend == "threaded":
        with _stores_lock:
            base = _stores.get(coordinator)
        if base is None:
            raise RuntimeError(f"no in-process rendezvous {coordinator!r}")
        # every rank enters each world of this coordinator once, in
        # order, so its own count names the entry without a handshake
        entry = base.add(f"entries/{rank}", 1)
        store = dist.PrefixStore(f"world{entry}/", base)
        dist.init_process_group("threaded", rank=rank, world_size=world,
                                store=store)
    else:
        dist.init_process_group(backend, init_method=coordinator,
                                world_size=world, rank=rank)
    return backend


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


__all__ = ["THREADED", "backend_for", "new_coordinator",
           "release_coordinator", "initialize", "abandon"]
