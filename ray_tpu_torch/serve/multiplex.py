"""Model multiplexing: N model variants behind one deployment, LRU-loaded
per replica.

The port's own copy of ``ray_tpu/serve/fleet/multiplex.py``.  A replica
holds at most ``capacity`` variants resident (an inference engine and
its KV pool each); a request names its variant, and a miss loads it on
the replica that was routed to, evicting the least recently used variant
when at capacity (its engine shuts down, releasing the pool).

The multiplexer is generic over a ``loader(model_id, spec) -> body`` /
``unloader(body)`` pair; ``GPTServer(variants=...)`` wires it to one
InferenceEngine per variant.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from concurrent.futures import Future
from typing import Any, Callable, Optional

from ray_tpu_torch.serve.qos import ReplicaDeadError


class UnknownModelError(ValueError):
    """Request named a variant that is not in the deployment catalog."""


class ModelMultiplexer:
    """Per-replica LRU of loaded model variants.

    ``get(model_id)`` returns the loaded body, loading or evicting as
    needed.  The load runs outside the lock behind a per-model future:
    concurrent misses for one variant share one load (two engines for one
    variant would double the pool), while hits, ``loaded_models()`` /
    ``loaded_bodies()`` (the router's probe surface) and health checks
    never wait on a load.
    """

    # bound on a follower waiting for another request's load
    LOAD_TIMEOUT_S = 120.0

    def __init__(self, catalog: dict,
                 loader: Callable[[str, Any], Any],
                 unloader: Optional[Callable[[Any], None]] = None,
                 capacity: int = 2):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if not catalog:
            raise ValueError("empty model catalog")
        self.catalog = dict(catalog)       # model_id -> loader spec
        self.capacity = int(capacity)
        self._loader = loader
        self._unloader = unloader
        self._lock = threading.Lock()
        self._loaded: "OrderedDict[str, Any]" = OrderedDict()
        self._loading: dict = {}           # model_id -> Future
        self._down = False
        self.loads = 0
        self.evictions = 0

    def default_model(self) -> str:
        return next(iter(self.catalog))

    def loaded_models(self) -> list[str]:
        with self._lock:
            return list(self._loaded)

    def loaded_bodies(self) -> list:
        with self._lock:
            return list(self._loaded.values())

    def get(self, model_id: Optional[str]) -> Any:
        """Resident body for ``model_id`` (None = the catalog's first),
        loading or evicting as needed."""
        if model_id is None:
            model_id = self.default_model()
        if model_id not in self.catalog:
            raise UnknownModelError(
                f"unknown model {model_id!r} (catalog: "
                f"{sorted(self.catalog)})")
        with self._lock:
            if self._down:
                raise ReplicaDeadError("multiplexer is shut down")
            body = self._loaded.get(model_id)
            if body is not None:
                self._loaded.move_to_end(model_id)
                return body
            fut = self._loading.get(model_id)
            leader = fut is None
            if leader:
                fut = self._loading[model_id] = Future()
        if not leader:
            # share the load in flight, bounded: a wedged loader fails
            # its followers with a timeout
            return fut.result(timeout=self.LOAD_TIMEOUT_S)
        try:
            body = self._loader(model_id, self.catalog[model_id])
        except BaseException as e:
            with self._lock:
                self._loading.pop(model_id, None)
            fut.set_exception(e)
            raise
        evicted = None
        with self._lock:
            self._loading.pop(model_id, None)
            unload_now = self._down        # lost the race with unload_all
            if not unload_now:
                if len(self._loaded) >= self.capacity:
                    _, evicted = self._loaded.popitem(last=False)
                    self.evictions += 1
                self._loaded[model_id] = body
                self.loads += 1
        if unload_now:
            if self._unloader is not None:
                self._unloader(body)
            err = ReplicaDeadError("multiplexer is shut down")
            fut.set_exception(err)
            raise err
        fut.set_result(body)
        if evicted is not None and self._unloader is not None:
            self._unloader(evicted)        # outside the lock: may be slow
        return body

    def unload_all(self) -> None:
        with self._lock:
            self._down = True
            bodies = list(self._loaded.values())
            self._loaded.clear()
        if self._unloader is not None:
            for b in bodies:
                self._unloader(b)

    def stats(self) -> dict:
        with self._lock:
            return {
                "catalog": sorted(self.catalog),
                "loaded": list(self._loaded),
                "loading": list(self._loading),
                "capacity": self.capacity,
                "loads": self.loads,
                "evictions": self.evictions,
            }
