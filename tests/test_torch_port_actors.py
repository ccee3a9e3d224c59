"""The port's in-process stand-in for the runtime calls of RLlib's actor
arms (``ray_tpu_torch.core.actors``): an actor's calls run in the order
they were submitted on its own thread, refs passed as top-level
arguments resolve, an error raised in an actor or a task is raised again
at ``get``, ``get`` fails fast at its timeout, ``wait`` keeps the order
of its refs and is bounded, ``kill`` and ``shutdown`` leave no live
thread and fail the calls still queued, and without ``init()``
``.remote(...)`` raises, as the JAX package's runtime does
uninitialised.  Ape-X's ``cleanup`` stops every actor even when one kill
raises."""

import sys
import threading
import time

import pytest

from ray_tpu_torch.core import actors


def live_threads() -> list:
    return [t.name for t in threading.enumerate()
            if t.name.startswith(actors.THREAD_PREFIX)]


class Counter:
    def __init__(self, start):
        self.log = [start]

    def push(self, v):
        self.log.append(v)
        return len(self.log)

    def history(self):
        return list(self.log)

    def fail(self):
        raise ValueError("raised in the actor")

    def block(self, ev):
        return ev.wait(10)


class Broken:
    def __init__(self):
        raise KeyError("raised in the constructor")

    def ping(self):
        return "pong"


@pytest.fixture
def rt():
    actors.init()
    try:
        yield actors
    finally:
        actors.shutdown()
        assert live_threads() == []


def test_calls_run_in_submission_order(rt):
    c = rt.remote(Counter).remote(0)
    refs = [c.push.remote(i) for i in range(1, 200)]
    assert rt.get(refs) == list(range(2, 201))
    assert rt.get(c.history.remote()) == list(range(200))


def test_refs_resolve_as_top_level_arguments(rt):
    c = rt.remote(Counter).remote(rt.put(7))
    first = c.push.remote(rt.put("x"))
    mul = rt.remote(lambda a, b: a * b)
    # a call's ref as an argument waits for that call; refs nested in
    # a list are passed as refs
    twice = mul.remote(first, 2)
    nested = rt.get(rt.remote(lambda xs: xs).remote([first]))
    assert rt.get(twice) == 4 and isinstance(nested[0], actors.ObjectRef)
    assert rt.get(c.history.remote()) == [7, "x"]
    assert rt.get([mul.remote(i, rt.put(3)) for i in range(6)]) == [
        0, 3, 6, 9, 12, 15]


def test_errors_are_raised_again_at_get(rt):
    c = rt.remote(Counter).remote(0)
    with pytest.raises(ValueError, match="raised in the actor"):
        rt.get(c.fail.remote())
    assert rt.get(c.push.remote(1)) == 2       # the actor lives on

    def task(x):
        raise ArithmeticError(f"task {x}")
    with pytest.raises(ArithmeticError, match="task 3"):
        rt.get([rt.remote(lambda: 1).remote(),
                rt.remote(task).remote(3)])
    b = rt.remote(Broken).remote()
    for _ in range(2):
        with pytest.raises(KeyError, match="raised in the constructor"):
            rt.get(b.ping.remote())
    with pytest.raises(AttributeError, match="no method 'nope'"):
        c.nope
    with pytest.raises(TypeError):
        rt.get([3])


def test_a_timeout_fails_fast(rt):
    ev = threading.Event()
    c = rt.remote(Counter).remote(0)
    ref = c.block.remote(ev)
    t0 = time.monotonic()
    with pytest.raises(actors.GetTimeoutError):
        rt.get(ref, timeout=0.05)
    assert time.monotonic() - t0 < 2.0
    ev.set()
    assert rt.get(ref, timeout=10) is True


def test_kill_fails_queued_calls_and_joins_the_thread(rt):
    ev = threading.Event()
    c = rt.remote(Counter).remote(0)
    other = rt.remote(Counter).remote(0)
    running = c.block.remote(ev)
    queued = c.push.remote(1)
    deadline = time.monotonic() + 10
    while not running._future.running() and time.monotonic() < deadline:
        time.sleep(0.001)          # the call has started before the kill
    killer = threading.Thread(target=rt.kill, args=(c,))
    killer.start()
    while not c._lane._closed and time.monotonic() < deadline:
        pass
    ev.set()                       # the running call finishes
    killer.join(10)
    assert not killer.is_alive()
    assert rt.get(running) is True
    with pytest.raises(actors.ActorDiedError):
        rt.get(queued)
    with pytest.raises(actors.ActorDiedError):
        rt.get(c.push.remote(2))
    assert [n for n in live_threads() if ":Counter:" in n] == [
        f"{actors.THREAD_PREFIX}Counter:0"]        # the other one
    assert rt.get(other.push.remote(1)) == 2
    rt.kill(c)                                     # a second kill: no-op


def test_shutdown_leaves_no_thread_and_uninitialised_remote_raises():
    assert not actors.is_initialized()
    with pytest.raises(RuntimeError, match="not initialized"):
        actors.remote(Counter).remote(0)
    with pytest.raises(RuntimeError, match="not initialized"):
        actors.remote(len).remote([1])
    with pytest.raises(RuntimeError, match="not initialized"):
        actors.put(1)
    actors.init()
    try:
        with pytest.raises(RuntimeError, match="already initialized"):
            actors.init()
        c = actors.remote(Counter).remote(0)
        refs = [c.push.remote(i) for i in range(5)]
        task = actors.remote(sum).remote([1, 2])
        assert actors.get(task) == 3
        assert len(live_threads()) == actors.TASK_THREADS + 1
    finally:
        actors.shutdown()
    assert live_threads() == [] and not actors.is_initialized()
    for r in refs:                     # done before, or failed at, shutdown
        assert r._future.done()
    with pytest.raises(actors.ActorDiedError):
        actors.get(c.push.remote(9))
    actors.shutdown()                  # idempotent


def test_concurrent_submitters_lose_no_call(rt):
    """More actors and submitting threads than cores, the interpreter
    switching threads every microsecond: every call runs exactly once,
    each submitter's calls in its order, and a kill racing the submitters
    leaves no call pending."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        cs = [rt.remote(Counter).remote(None) for _ in range(12)]
        victim = rt.remote(Counter).remote(None)

        def submit(k):
            return [(c.push.remote((k, i)), victim.push.remote((k, i)))
                    for i in range(100) for c in cs]
        with_refs = []
        threads = [threading.Thread(target=lambda k=k: with_refs.append(
            submit(k))) for k in range(4)]
        for t in threads:
            t.start()
        rt.kill(victim)
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        for refs in with_refs:
            rt.get([r for r, _ in refs])
            for _, v in refs:
                assert v._future.done()
        for c in cs:
            log = rt.get(c.history.remote())[1:]
            assert len(log) == 4 * 100
            for k in range(4):
                assert [i for kk, i in log if kk == k] == list(range(100))
    finally:
        sys.setswitchinterval(switch)


def test_wait_keeps_order_and_counts_failed_calls_as_ready(rt):
    evs = [threading.Event() for _ in range(4)]
    cs = [rt.remote(Counter).remote(0) for _ in range(4)]
    refs = [c.block.remote(ev) for c, ev in zip(cs, evs)]
    failed = cs[0].fail.remote()          # queued behind refs[0]
    for i in (3, 1):
        evs[i].set()
    ready, rest = rt.wait(refs, num_returns=2)
    assert ready == [refs[1], refs[3]] and rest == [refs[0], refs[2]]
    # num_returns caps ready (in the order of refs), not_ready keeps the rest
    ready, rest = rt.wait(refs, num_returns=1, timeout=10)
    assert ready == [refs[1]] and rest == [refs[0], refs[2], refs[3]]
    evs[0].set()
    ready, rest = rt.wait([failed, refs[2]], num_returns=1, timeout=10)
    assert ready == [failed] and rest == [refs[2]]
    with pytest.raises(ValueError, match="raised in the actor"):
        rt.get(failed)
    with pytest.raises(ValueError, match="num_returns exceeds"):
        rt.wait(refs, num_returns=5)
    with pytest.raises(TypeError):
        rt.wait([3])
    evs[2].set()
    ready, rest = rt.wait(refs, num_returns=4, timeout=10)
    assert ready == refs and rest == []


def test_wait_returns_short_at_its_timeout_and_none_is_bounded(
        rt, monkeypatch):
    ev = threading.Event()
    c = rt.remote(Counter).remote(0)
    blocked, done = c.block.remote(ev), rt.put(1)
    t0 = time.monotonic()
    ready, rest = rt.wait([blocked, done], num_returns=2, timeout=0.05)
    assert time.monotonic() - t0 < 2.0
    assert ready == [done] and rest == [blocked]
    monkeypatch.setattr(actors, "GET_TIMEOUT_S", 0.05)
    t0 = time.monotonic()
    with pytest.raises(actors.GetTimeoutError, match="wait"):
        rt.wait([blocked, done], num_returns=2)
    assert time.monotonic() - t0 < 2.0
    ev.set()
    assert rt.wait([blocked], timeout=10) == ([blocked], [])


def test_apex_cleanup_stops_every_actor_when_a_kill_raises(rt,
                                                           monkeypatch):
    from ray_tpu_torch.rllib import apex

    algo = apex.ApexDQNConfig(env="CartPole-v1", num_rollout_workers=2,
                              num_replay_shards=2, num_envs_per_worker=2,
                              device="cpu", seed=0).build()
    assert algo._distributed
    handles = algo.collectors + algo.shards
    kill, tried = actors.kill, []

    def first_raises(h):
        tried.append(h)
        if len(tried) == 1:
            raise RuntimeError("threads still running after being stopped")
        kill(h)
    monkeypatch.setattr(actors, "kill", first_raises)
    algo.cleanup()
    assert tried == handles
    assert all(h._lane._closed for h in handles[1:])
    assert rt._runtime().actors == [handles[0]]
