"""A tp rank that dies or fails alone (``inference/tp.py``) is stopped,
with its peers, by rank threads only: no thread outside the threaded
world wakes a collective of it.  The engine's loop thread used to wake
the ranks waiting in a collective itself (``TPExecutor._died``) while the
ranks unwound, and under a loaded test pool that corrupted the heap: a
``'Condition' object has no attribute '_lock'`` in the next wake, then a
segfault in the garbage collector (``tp_death_stress.py`` reproduces it
on a checkout from before the fix).  The wake is now left to the rank threads:
a dead rank's thread as it ends, or a rank that reads the stop sentinel.

The same two failures as ``tests/test_torch_port_tp_serve.py`` and
``tests/test_torch_port_tp_slot_serve.py`` (``rank_dies``: rank 1's body
raises ``SystemExit``; ``rank_fails_alone``: it raises ``RuntimeError``
while rank 0 waits in a collective), on the paged and the slot engine
of ``GPTConfig.tiny`` at tp2 on the CPU.  The tp-serving files hold the
replies token-exact to the JAX package; this one needs no reference."""

import threading

import pytest
import torch

from ray_tpu_torch.inference import EngineConfig, GPTServer, tp
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.parallel import threaded

TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32, max_seq=64)
ENGINES = {"paged": (dict(max_slots=2, kv_block_size=8, prefill_chunk=16),
                     "chunk"),
           "slot": (dict(paged=False, max_slots=2), "step")}


@pytest.fixture(scope="module")
def params():
    return tgpt.init_params(TCFG, 0, device="cpu")


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("how", ["rank_dies", "rank_fails_alone"])
def test_only_rank_threads_wake_the_collectives(engine, how, params,
                                                monkeypatch):
    monkeypatch.setattr(tp, "FAILURE_GRACE_S", 0.2)
    wakers = []
    wake = threaded._wake_all

    def recorded(group_cls):
        wakers.append(threading.current_thread().name)
        wake(group_cls)

    monkeypatch.setattr(threaded, "_wake_all", recorded)
    geometry, body = ENGINES[engine]
    srv = GPTServer(TCFG, EngineConfig(**geometry), params=params,
                    device="cpu", mesh={"tp": 2})
    eng = srv.engine
    try:
        assert srv({"prompt": [1, 2, 3], "max_tokens": 2})["n"] == 2

        def arm(ctx):
            if ctx.rank != 1:
                return

            def fail(*a):
                if how == "rank_dies":
                    raise SystemExit("rank 1 dies")
                raise RuntimeError("rank 1 fails alone")
            ctx.engines[eng.name].bodies[body] = fail

        eng._ranks.executor.on_ranks(arm)
        with pytest.raises(tp.TPRanksDead):
            srv({"prompt": [4, 5, 6], "max_tokens": 4})
        eng._thread.join(timeout=60)
        assert not eng._thread.is_alive() and not eng._ranks.alive
    finally:
        srv.teardown()
    assert tp._executor is None
    assert wakers and set(wakers) <= {"rank0", "rank1"}, wakers
