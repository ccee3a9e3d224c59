"""An in-process stand-in for the runtime calls of RLlib's actor arms:
``init``, ``shutdown``, ``is_initialized``, ``remote``, ``get``, ``wait``,
``put`` and ``kill``.

The JAX package runs rollout workers, learners, replay shards,
collectors and evaluation tasks on its core runtime (``ray_tpu.remote``).
The port has no runtime, so those arms run here, in the calling process:

- an actor (``remote(cls).remote(...)``) is built and called on a daemon
  thread of its own; its method calls run one at a time, in the order
  they were submitted, as a Ray actor's do;
- a task (``remote(fn).remote(...)``) runs on a pool of
  ``TASK_THREADS`` daemon threads;
- ``put`` returns a ref to the value itself (no copy, no store), so an
  actor that keeps what it is given copies it;
- a ref passed as a top-level argument is resolved before the call;
- an exception raised in an actor or a task is raised again at ``get``;
- every wait is bounded: ``get`` and ``wait`` by their ``timeout``
  (``GET_TIMEOUT_S`` when none is given: then ``wait`` raises rather
  than return short), ``kill`` and ``shutdown`` join their threads
  within ``JOIN_TIMEOUT_S`` and raise if one still runs.

There is no scheduling, no resource, no process and no object store.
Without ``init()``, ``.remote(...)`` raises, as the JAX package's runtime
does uninitialised.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future
from concurrent.futures import wait as futures_wait
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Optional

GET_TIMEOUT_S = 600.0
JOIN_TIMEOUT_S = 30.0
TASK_THREADS = 4
THREAD_PREFIX = "actors:"


class ActorDiedError(RuntimeError):
    """A call to an actor that ``kill`` or ``shutdown`` stopped."""


class GetTimeoutError(TimeoutError):
    """``get`` waited its whole timeout for a ref."""


class ObjectRef:
    """A value, or the future result of a call."""

    __slots__ = ("_future",)

    def __init__(self, future: Future):
        self._future = future


def _resolve(v):
    return (v._future.result(timeout=GET_TIMEOUT_S)
            if isinstance(v, ObjectRef) else v)


class _Lane:
    """A call queue served by ``n`` daemon threads (one thread: the calls
    run in submission order)."""

    def __init__(self, name: str, n: int):
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._closed = False
        self._threads = [threading.Thread(
            target=self._serve, name=f"{THREAD_PREFIX}{name}:{i}",
            daemon=True) for i in range(n)]
        for t in self._threads:
            t.start()

    def submit(self, fn, args, kwargs) -> ObjectRef:
        fut: Future = Future()
        with self._lock:
            if self._closed:
                fut.set_exception(ActorDiedError("the actor or task pool "
                                                 "was stopped"))
            else:
                self._q.put((fut, fn, args, kwargs))
        return ObjectRef(fut)

    def _serve(self):
        while (item := self._q.get()) is not None:
            fut, fn, args, kwargs = item
            if self._closed:
                fut.set_exception(ActorDiedError("stopped before the call "
                                                 "ran"))
                continue
            fut.set_running_or_notify_cancel()
            try:
                out = fn(*[_resolve(a) for a in args],
                         **{k: _resolve(v) for k, v in kwargs.items()})
            except BaseException as e:  # raised again at get
                fut.set_exception(e)
            else:
                fut.set_result(out)

    def close(self) -> None:
        """Fail the queued calls, end the threads after the running call,
        and raise if one is still running after ``JOIN_TIMEOUT_S``."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for _ in self._threads:
                self._q.put(None)
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
        alive = [t.name for t in self._threads if t.is_alive()]
        if alive:
            raise RuntimeError(f"threads still running {JOIN_TIMEOUT_S} s "
                               f"after being stopped: {alive}")


class _Runtime:
    def __init__(self):
        self.tasks = _Lane("task", TASK_THREADS)
        self.actors: list = []


_rt: Optional[_Runtime] = None
_rt_lock = threading.Lock()


def _runtime() -> _Runtime:
    if _rt is None:
        raise RuntimeError("ray_tpu_torch.core.actors is not initialized — "
                           "call actors.init()")
    return _rt


def init() -> None:
    global _rt
    with _rt_lock:
        if _rt is not None:
            raise RuntimeError("ray_tpu_torch.core.actors is already "
                               "initialized")
        _rt = _Runtime()


def is_initialized() -> bool:
    return _rt is not None


def shutdown() -> None:
    """Stop every actor and the task pool (each join bounded); the first
    error of a join is raised once all were tried."""
    global _rt
    with _rt_lock:
        rt, _rt = _rt, None
    if rt is None:
        return
    errors = []
    for lane in [a._lane for a in rt.actors] + [rt.tasks]:
        try:
            lane.close()
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]


class ActorHandle:
    """``handle.method.remote(*args)`` -> an ``ObjectRef``.  The instance
    is built by the first call on the actor's thread; if that raises,
    every later call raises the same error."""

    def __init__(self, cls, args, kwargs):
        self._cls = cls
        self._lane = _Lane(cls.__name__, 1)
        self._built = self._lane.submit(cls, args, kwargs)

    def __getattr__(self, name: str):
        if name.startswith("_") or not callable(getattr(self._cls, name,
                                                        None)):
            raise AttributeError(f"{self._cls.__name__} has no method "
                                 f"{name!r}")

        def call(*args, **kwargs):
            return getattr(self._built._future.result(), name)(*args,
                                                               **kwargs)
        return _Remote(lambda *a, **kw: self._lane.submit(call, a, kw))


class _Remote:
    def __init__(self, submit):
        self.remote = submit


def remote(cls_or_fn):
    """A class -> ``.remote(*args)`` builds an actor; a function ->
    ``.remote(*args)`` runs a task.  Either raises unless initialised."""
    if isinstance(cls_or_fn, type):
        def build(*args, **kwargs):
            rt = _runtime()
            handle = ActorHandle(cls_or_fn, args, kwargs)
            rt.actors.append(handle)
            return handle
        return _Remote(build)
    return _Remote(lambda *args, **kwargs: _runtime().tasks.submit(
        cls_or_fn, args, kwargs))


def put(value) -> ObjectRef:
    _runtime()
    fut: Future = Future()
    fut.set_result(value)
    return ObjectRef(fut)


def get(refs, *, timeout: Optional[float] = None):
    """A ref's value, or a list's in list order; the error of a failed
    call is raised again.  All within ``timeout`` seconds together
    (``GET_TIMEOUT_S`` when None)."""
    many = isinstance(refs, (list, tuple))
    timeout = GET_TIMEOUT_S if timeout is None else timeout
    deadline = time.monotonic() + timeout
    out = []
    for r in (refs if many else [refs]):
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() takes ObjectRefs, not {type(r)}")
        try:
            out.append(r._future.result(
                timeout=max(0.0, deadline - time.monotonic())))
        except FutureTimeout:
            raise GetTimeoutError(f"get() timed out after {timeout} s") \
                from None
    return out if many else out[0]


def wait(refs, *, num_returns: int = 1, timeout: Optional[float] = None):
    """-> ``(ready, not_ready)``, both in the order of ``refs``: the first
    ``num_returns`` refs (in that order) whose calls have ended, a failed
    call counting as ready, or with a ``timeout`` whatever is ready when
    it passes.  With ``timeout=None`` the wait is bounded by
    ``GET_TIMEOUT_S``, after which it raises ``GetTimeoutError``."""
    refs = list(refs)
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds number of refs")
    for r in refs:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"wait() takes ObjectRefs, not {type(r)}")
    limit = GET_TIMEOUT_S if timeout is None else timeout
    deadline = time.monotonic() + limit
    while True:
        ready = [r for r in refs if r._future.done()]
        if len(ready) >= num_returns:
            ready = ready[:num_returns]
            break
        left = deadline - time.monotonic()
        if left <= 0:
            if timeout is None:
                raise GetTimeoutError(f"wait() timed out after {limit} s")
            break
        futures_wait({r._future for r in refs if not r._future.done()},
                     timeout=left, return_when=FIRST_COMPLETED)
    chosen = {id(r) for r in ready}
    return ready, [r for r in refs if id(r) not in chosen]


def kill(handle: ActorHandle) -> None:
    """Stop an actor: its queued calls fail with ``ActorDiedError``, the
    running one finishes, its thread is joined (bounded)."""
    if _rt is not None and handle in _rt.actors:
        _rt.actors.remove(handle)
    handle._lane.close()
