"""The identity of the replica being built on this thread.

The port's own copy of ``ray_tpu/serve/controller.py``'s
``ReplicaContext``, ``get_replica_context`` and the thread-local a
controller sets while it constructs a replica body.  ``GPTServer`` reads
it to name its engines ``<replica_tag>[:<model>]`` and label their
``metrics_snapshot`` series with ``deployment`` and ``replica``.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Iterator, Optional


@dataclass
class ReplicaContext:
    """Identity of the replica currently being constructed."""
    deployment: str
    replica_tag: str


_replica_ctx = threading.local()


def get_replica_context() -> Optional[ReplicaContext]:
    """The ReplicaContext while a replica body is being constructed on
    this thread (None outside replica construction)."""
    return getattr(_replica_ctx, "ctx", None)


@contextlib.contextmanager
def replica_context(deployment: str, tag: str) -> Iterator[ReplicaContext]:
    """Construct replica bodies on this thread as replica ``tag`` of
    ``deployment``: ``with replica_context("v1", "v1#0"):
    dep.build_replica()``."""
    _replica_ctx.ctx = ctx = ReplicaContext(deployment, tag)
    try:
        yield ctx
    finally:
        _replica_ctx.ctx = None
