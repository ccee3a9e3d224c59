"""Request quality-of-service vocabulary of the serving path: priority
classes and the replica errors the engine raises.

The port's own copy of ``ray_tpu/serve/qos.py``'s priorities and
replica errors (the prefix-plane errors come with the slice that ports
the cluster prefix cache).
"""

from __future__ import annotations

# priority classes: lower admits first.  The engine's admission orders by
# (priority, arrival).
PRIORITY_INTERACTIVE = 0
PRIORITY_BATCH = 1

_PRIORITY_NAMES = {"interactive": PRIORITY_INTERACTIVE,
                   "batch": PRIORITY_BATCH}


def parse_priority(value) -> int:
    """"interactive"/"batch"/int -> priority class.  Unknown strings
    raise so a typo'd class is a clean client error, not a silently-
    batch request."""
    if value is None:
        return PRIORITY_BATCH
    if isinstance(value, str):
        try:
            return _PRIORITY_NAMES[value.lower()]
        except KeyError:
            raise ValueError(
                f"unknown priority {value!r} (expected one of "
                f"{sorted(_PRIORITY_NAMES)})") from None
    return int(value)


class ReplicaDeadError(RuntimeError):
    """The serving replica died with this request queued or in flight.
    Retriable: the request had no observable side effects.  The engine's
    EngineStoppedError subclasses this."""


class EngineDrainingError(ReplicaDeadError):
    """The serving replica is draining (planned scale-down): it finishes
    what it already holds but admits nothing new.  A caller re-routes
    the request; it is not a failure."""
