"""The flight recorder's gate and the part of the recorder the inference
engine writes: one ``engine_request`` event per finished request.

The port's own copy of the gate in ``ray_tpu/core/flight_recorder.py``
(``_active``, ``active``, ``enable``, ``disable``) and of
``FlightRecorder.note_ingress`` / ``export_ingress``.  A host that
imports both packages may instead install the JAX package's recorder
here (``flight_recorder._active = rec``): the events are the same dicts,
so its timeline renders them unchanged.

With no recorder armed each hook costs one global load
(``_active is None``).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Optional

# The armed recorder.  Hooks read this module attribute directly, so the
# disabled path costs one global load.
_active: Optional[Any] = None


def active() -> Optional[Any]:
    return _active


def enable(**kw) -> "FlightRecorder":
    """Arm a recorder in this process (idempotent)."""
    global _active
    if _active is None:
        _active = FlightRecorder(**kw)
    return _active


def disable() -> None:
    global _active
    _active = None


class FlightRecorder:
    """A bounded ring of the events the engine notes."""

    def __init__(self, keep_ingress: int = 8192):
        self._lock = threading.Lock()
        self.ingress: deque = deque(maxlen=keep_ingress)

    def note_ingress(self, event: dict) -> None:
        with self._lock:
            self.ingress.append(dict(event))

    def export_ingress(self) -> list:
        with self._lock:   # the engine's loop threads append
            return list(self.ingress)
