"""The port's own training session: ``report`` and ``get_checkpoint``.

A minimal thread-local copy of ``ray_tpu/train/session.py``'s single-host
session, used by ``Trainer.fit`` when the port runs alone (as on the
card).  On a mesh each rank runs its own session (the state is per
thread, so threaded ranks each have theirs) and knows its place in the
world (``get_world_rank``, ``get_world_size``).  A host that runs the
port's ``Trainer.train_loop`` under its own trainer passes its
session's ``report`` and ``get_checkpoint`` instead.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint


@dataclass
class _SessionState:
    results: list = field(default_factory=list)
    latest_checkpoint: Optional[Checkpoint] = None
    checkpoint_cb: Optional[Callable[[dict], Any]] = None
    world_rank: int = 0
    world_size: int = 1


_local = threading.local()


def _state() -> _SessionState:
    st = getattr(_local, "session", None)
    if st is None:
        raise RuntimeError(
            "no active train session: session calls are valid only inside "
            "a train loop run by Trainer.fit")
    return st


def _start(checkpoint_cb=None, latest_checkpoint=None, world_rank: int = 0,
           world_size: int = 1) -> _SessionState:
    st = _SessionState(checkpoint_cb=checkpoint_cb,
                       latest_checkpoint=latest_checkpoint,
                       world_rank=world_rank, world_size=world_size)
    _local.session = st
    return st


def _end():
    _local.session = None


def report(metrics: dict, *, checkpoint: Optional[dict] = None) -> None:
    """Record this step's metrics and, when given, save ``checkpoint``
    (a payload dict) through the trainer's checkpoint manager."""
    st = _state()
    entry = dict(metrics)
    if checkpoint is not None and st.checkpoint_cb is not None:
        entry["_checkpoint_path"] = st.checkpoint_cb(checkpoint)
    st.results.append(entry)


def get_checkpoint() -> Optional[Checkpoint]:
    """The checkpoint this attempt resumes from, if any."""
    return _state().latest_checkpoint


def get_world_rank() -> int:
    """This rank's index in the trainer's world (0 on one device)."""
    return _state().world_rank


def get_world_size() -> int:
    """The number of ranks the trainer runs on (1 on one device)."""
    return _state().world_size
