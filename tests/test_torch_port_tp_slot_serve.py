"""``GPTServer`` on the slot engine of a tp mesh, and the slot engine's
failures there, on the CPU: the weights, prompts and references of
``tests/test_torch_port_tp_slot.py`` (JAX's ``init_params`` bridged;
every reply held to the port's ``generate``, which that file holds to
the JAX slot engine on the same mesh).

- ``GPTServer(paged=False, mesh=)`` serves token-exact on tp2 and tp4;
- the slot cache on a mesh (``KVCacheManager(mesh=)``) under the same
  writes as one device's, its bytes counted over every rank;
- the dense step on tp ranks (``make_decode_step(cfg, tp=)``) against the
  step on one device: logits within 1e-5, each rank's cache its heads;
- a step failure on every rank fails its request and zeroes every rank's
  cache, and the next reply is token-exact;
- a rank that dies or fails alone leaves the engine stopped
  (``TPRanksDead``), never hung;
- an MoE config is refused before a rank builds its step.
No subprocess, no sleep."""

import numpy as np
import pytest
import torch

from _torch_port_ranks import ranks
from ray_tpu_torch.inference import (EngineConfig, GPTServer,
                                     InferenceEngine, KVCacheManager,
                                     MoEDecodeUnsupported, make_decode_step,
                                     tp)
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.parallel import DEFAULT_LLM_RULES, create_mesh
from test_torch_port_tp_slot import (  # noqa: F401 (the fixtures)
    MAX_NEW, PROMPTS, SLOT, TCFG, _no_executor_left, _port, model)


@pytest.mark.parametrize("n", [2, 4])
def test_gpt_server_slot_engine_on_tp(model, n):
    _, params, want = model
    srv = GPTServer(TCFG, EngineConfig(**SLOT), params=params, device="cpu",
                    mesh={"tp": n})
    try:
        for p, w in zip(PROMPTS[:3], want):
            out = srv({"prompt": p, "max_tokens": MAX_NEW})
            assert out["tokens"] == w
        st = srv.fleet_stats()
        assert st["mesh_devices"] == st["tp_shards"] == n
        assert srv.health()
    finally:
        srv.teardown()


def test_slot_cache_on_a_mesh_matches_one_device(model):
    """``KVCacheManager(mesh=)`` of a tp2 slot engine and a one-device
    one under the same full-width writes: the same host stripes, every
    rank its heads, the bytes of the whole cache, half of them a rank,
    and ``reset_arrays`` zeroes every rank's shard."""
    _, params, _ = model
    rng = np.random.default_rng(0)
    L, h, hd = TCFG.n_layers, TCFG.n_heads, TCFG.head_dim
    k, v = (torch.from_numpy(rng.standard_normal((L, h, 40, hd)).astype(
        np.float32)) for _ in range(2))
    eng = _port(params, 2)
    try:
        one = KVCacheManager(TCFG, 2, max_seq=64, device="cpu")
        for cache in (one, eng.cache):
            cache.write_prefill(1, k, v)
        for got, w in zip(eng.cache.read_slots([1, 0]),
                          one.read_slots([1, 0])):
            np.testing.assert_array_equal(got, w)
        shards = eng._ranks.executor.on_ranks(
            lambda ctx: ctx.engines["slot"].pool.kv.clone())
        for r, kv in enumerate(shards):
            np.testing.assert_array_equal(
                kv.numpy(), one._shard.kv[:, :, :, 2 * r:2 * r + 2].numpy())
        st, ost = eng.cache.stats(), one.stats()
        assert eng.cache.k is None
        assert st["bytes_total"] == ost["bytes_total"] \
            == 2 * one.k.numel() * 4
        assert st["bytes_per_device"] == st["bytes_total"] // 2
        assert (st["tp_shards"], ost["tp_shards"]) == (2, 1)
        eng.cache.reset_arrays()
        assert [float(kv.abs().sum()) for kv in eng._ranks.executor.on_ranks(
            lambda ctx: ctx.engines["slot"].pool.kv)] == [0.0, 0.0]
    finally:
        eng.shutdown()


@pytest.mark.parametrize("n", [2, 4])
def test_slot_decode_step_on_tp_ranks_matches_one_device(model, n):
    _, params, _ = model
    rng = np.random.default_rng(n)
    L, h, hd, S, b = TCFG.n_layers, TCFG.n_heads, TCFG.head_dim, 64, 3
    caches = [torch.from_numpy(rng.standard_normal((L, b, h, S, hd)).astype(
        np.float32)) for _ in range(2)]
    tokens = torch.tensor([5, 9, 300])
    positions = torch.tensor([4, 0, 17])
    active = torch.tensor([True, False, True])
    wk, wv = (c.clone() for c in caches)
    want = make_decode_step(TCFG)(params, wk, wv, tokens, positions, active)

    def rank(r):
        mesh = create_mesh({"tp": n}, device="cpu")
        local, shard = tp.local_params(params, TCFG, mesh, DEFAULT_LLM_RULES)
        hl = h // n
        k, v = (c[:, :, r * hl:(r + 1) * hl].clone() for c in caches)
        logits = make_decode_step(TCFG, tp=shard)(local, k, v, tokens,
                                                  positions, active)
        return logits, k, v

    for r, (logits, k, v) in enumerate(ranks(rank, n)):
        np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=1e-5,
                                   rtol=0)
        hl = h // n
        np.testing.assert_allclose(k.numpy(), wk[:, :, r * hl:(r + 1) * hl],
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(v.numpy(), wv[:, :, r * hl:(r + 1) * hl],
                                   atol=1e-6, rtol=0)


def test_a_step_failure_on_every_rank_resets_every_ranks_cache(model):
    _, params, want = model
    eng = _port(params, 2)
    try:
        assert eng.generate(PROMPTS[0], max_new=MAX_NEW, timeout=120) \
            == want[0]

        def arm(ctx):
            st = ctx.engines["slot"]
            real = st.bodies["step"]

            def failing(*args):
                st.bodies["step"] = real
                raise RuntimeError("injected tp step failure")
            st.bodies["step"] = failing

        eng._ranks.executor.on_ranks(arm)
        with pytest.raises(RuntimeError, match="injected tp step failure"):
            eng.generate(PROMPTS[1], max_new=MAX_NEW, timeout=120)
        assert [float(kv.abs().sum()) for kv in eng._ranks.executor.on_ranks(
            lambda ctx: ctx.engines["slot"].pool.kv)] == [0.0, 0.0]
        assert eng.stats()["free_slots"] == 2
        assert eng.generate(PROMPTS[1], max_new=MAX_NEW, timeout=120) \
            == want[1]
    finally:
        eng.shutdown()


@pytest.mark.parametrize("how", ["rank_dies", "rank_fails_alone"])
def test_dead_ranks_leave_the_slot_engine_stopped_never_hung(
        how, model, monkeypatch):
    """A rank that dies (its thread ends) or whose step raises while the
    other waits for it in a collective stops every rank: the request in
    flight fails with ``TPRanksDead``, the engine stops and the server's
    ``health()`` is False.  The grace a lone failure is given is cut to
    0.2 s here."""
    _, params, _ = model
    monkeypatch.setattr(tp, "FAILURE_GRACE_S", 0.2)
    srv = GPTServer(TCFG, EngineConfig(**SLOT), params=params, device="cpu",
                    mesh={"tp": 2})
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
            ctx.engines[eng.name].bodies["step"] = fail

        eng._ranks.executor.on_ranks(arm)
        with pytest.raises(tp.TPRanksDead):
            srv({"prompt": [4, 5, 6], "max_tokens": 4})
        eng._thread.join(timeout=60)
        assert not eng._thread.is_alive()
        assert not srv.health() and srv.fleet_stats()["stopped"]
        assert not eng._ranks.alive
    finally:
        srv.teardown()


def test_a_slot_engine_for_moe_is_refused_on_a_mesh():
    cfg = tgpt.GPTConfig.tiny_moe(max_seq=64)
    with pytest.raises(MoEDecodeUnsupported):
        InferenceEngine(tgpt.init_params(cfg, 0, device="cpu"), cfg,
                        EngineConfig(**SLOT), device="cpu", mesh={"tp": 2})
