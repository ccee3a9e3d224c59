"""Request quality-of-service vocabulary of the serving path: priority
classes and the replica errors the engine raises.

The port's own copy of ``ray_tpu/serve/qos.py``'s priorities, replica
errors and the cluster prefix plane's error vocabulary.
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


class PrefixTransferError(RuntimeError):
    """Base of the cluster prefix plane's failures.  Every subclass means
    the same to the caller: the remote adoption is off, recompute the
    prefix locally.  A prefix transfer failure is never a request
    error; the type says why (purge a stale directory entry, or count a
    failed fetch)."""


class StalePrefixGeneration(PrefixTransferError):
    """The holder's block pool was reset since the prefix was published:
    its generation moved on, so the advertised blocks no longer hold the
    advertised tokens.  The caller purges the directory entry."""


class PrefixUnavailable(PrefixTransferError):
    """The holder no longer caches the requested prefix (evicted under
    pool pressure), has no prefix index, or the geometry does not match.
    Benign: the adopter recomputes locally."""


class PrefixInstallPressure(PrefixTransferError):
    """The adopter found no blocks for the fetched prefix without
    preempting live requests: adoption never preempts real work for
    hoped-for reuse.  The fetched bytes are dropped."""
