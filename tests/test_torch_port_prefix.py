"""The engine and replica half of the port's cluster prefix plane against
the JAX package on the CPU, on ``GPTConfig.tiny`` in f32 with
``max_seq=64`` and one set of weights (JAX's ``init_params`` bridged
through numpy).

The scenarios of tests/test_prefix_cluster.py's engine-level contract,
on the port's engine: extract validates block alignment, the pool
generation and the index's coverage; install round-trips and is
idempotent; a geometry mismatch is rejected; under block pressure
install evicts only unreferenced cached prefixes and never preempts,
and every block is accounted for after it; the ops are rejected after
shutdown.  Beside them: an extracted payload equals JAX's
``gpt.forward(..., return_kv=True)`` K/V for the prefix (atol 1e-5),
an adopter's stream equals JAX's ``gpt.generate``, a failed step's pool
reset bumps the generation, and ``GPTServer.prefix_*`` through its
closed and draining gate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.inference import (BlockPool, EngineConfig,
                                     EngineDrainingError, EngineStoppedError,
                                     GPTServer, InferenceEngine)
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.serve.qos import (PrefixInstallPressure,
                                     PrefixTransferError, PrefixUnavailable,
                                     ReplicaDeadError, StalePrefixGeneration)

JCFG = jgpt.GPTConfig.tiny(dtype=jnp.float32, max_seq=64)
TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32, max_seq=64)
TOKS = [1, 2, 3, 4, 5, 6, 7, 8]            # two blocks of 4
_jax_generate = jax.jit(jgpt.generate,
                        static_argnames=("cfg", "max_new", "temperature"))


@pytest.fixture(scope="module")
def model():
    jparams = jax.jit(jgpt.init_params, static_argnums=0)(
        JCFG, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jparams, params


def _ref_tokens(jparams, prompt, max_new):
    out = _jax_generate(jparams, JCFG, jnp.asarray([prompt], jnp.int32),
                        max_new=max_new, temperature=0.0)
    return np.asarray(out)[0, len(prompt):].tolist()


def _engine(params, **kw):
    return InferenceEngine(params, TCFG, EngineConfig(
        **{"max_slots": 2, "kv_block_size": 4, **kw}), device="cpu")


def _warm_engine(params, **kw):
    """An engine that served TOKS + [9]: its index holds TOKS' blocks."""
    eng = _engine(params, **kw)
    eng.generate(TOKS + [9], max_new=4, timeout=60)
    return eng


def _audit(eng):
    """Every used block is held by the prefix index alone."""
    st = eng.pool.stats()
    assert st["blocks_used"] == eng.trie.cached_blocks, st


def test_errors_are_the_prefix_plane_vocabulary():
    for err in (StalePrefixGeneration, PrefixUnavailable,
                PrefixInstallPressure):
        assert issubclass(err, PrefixTransferError)
    assert issubclass(PrefixTransferError, RuntimeError)
    assert issubclass(EngineStoppedError, ReplicaDeadError)


def test_block_pool_read_and_write_blocks_round_trip():
    """``write_blocks_at`` then ``read_blocks`` gives the bytes back, in
    the [L, T, h, bs, hd] layout, cast to the pool's dtype (a bf16 pool
    reads back as its exact f32 upcast); other blocks are untouched;
    ``generation`` moves only on reset."""
    rng = np.random.default_rng(0)
    k, v = (rng.standard_normal((2, 3, 4, 4, 16)).astype(np.float32)
            for _ in range(2))
    for dtype in (torch.float32, torch.bfloat16):
        pool = BlockPool(TCFG, 20, 4, dtype=dtype, device="cpu")
        assert pool.generation == 0
        pool.write_blocks_at([5, 2, 9], k, v)
        got = pool.read_blocks([5, 2, 9])
        for g, new, whole in zip(got, (k, v), (pool.k, pool.v)):
            assert g.shape == (2, 3, 4, 4, 16) and g.dtype == np.float32
            want = torch.from_numpy(new).to(dtype)
            assert torch.equal(whole[:, [5, 2, 9]], want)
            assert torch.equal(torch.from_numpy(g), want.float())
            untouched = [b for b in range(21) if b not in (5, 2, 9)]
            assert not whole[:, untouched].any()
        pool.reset()
        assert pool.generation == 1 and pool.stats()["generation"] == 1
        assert not pool.k.any() and not pool.v.any()


def test_extract_validates_generation_and_coverage(model):
    _, params = model
    eng = _warm_engine(params)
    try:
        out = eng.prefix_extract(TOKS, eng.pool.generation)
        assert out["n_tokens"] == 8 and out["block_size"] == 4
        assert out["generation"] == eng.pool.generation == 0
        assert out["k"].shape == out["v"].shape == (2, 2, 4, 4, 16)
        # a stale generation is a typed refusal, not bytes
        with pytest.raises(StalePrefixGeneration):
            eng.prefix_extract(TOKS, eng.pool.generation + 1)
        # a prefix the index does not hold whole is unavailable
        with pytest.raises(PrefixUnavailable):
            eng.prefix_extract([91, 92, 93, 94], eng.pool.generation)
        with pytest.raises(PrefixUnavailable):
            eng.prefix_extract(TOKS + [9, 10, 11, 12], eng.pool.generation)
        # unaligned asks are refused before the loop thread sees them
        with pytest.raises(PrefixUnavailable):
            eng.prefix_extract([1, 2, 3], eng.pool.generation)
        with pytest.raises(PrefixUnavailable):
            eng.prefix_extract(TOKS[:6], eng.pool.generation)
        # extraction keeps no reference
        _audit(eng)
    finally:
        eng.shutdown()


def test_extracted_payload_equals_jax_forward_kv(model):
    """The holder's K/V for the prefix are JAX's prefill K/V for it,
    [L, 1, h, 8, hd] reshaped to blocks: [L, T, h, bs, hd]."""
    jparams, params = model
    eng = _warm_engine(params)
    try:
        out = eng.prefix_extract(TOKS, eng.pool.generation)
    finally:
        eng.shutdown()
    _, (k, v) = jax.jit(
        lambda p, t: jgpt.forward(p, t, JCFG, return_kv=True))(
            jparams, jnp.asarray([TOKS], jnp.int32))
    for got, want in ((out["k"], k), (out["v"], v)):
        want = np.asarray(want)[:, 0].reshape(2, 4, 2, 4, 16) \
            .transpose(0, 2, 1, 3, 4)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_install_round_trip_and_idempotence(model):
    jparams, params = model
    src = _warm_engine(params)
    dst = _engine(params)
    try:
        payload = src.prefix_extract(TOKS, src.pool.generation)
        r = dst.prefix_install(TOKS, payload)
        assert r == {"installed": 2, "already": False}
        # a second install finds the chain in place
        assert dst.prefix_install(TOKS, payload) == {"installed": 0,
                                                     "already": True}
        _audit(dst)
        assert dst.trie.cached_blocks == 2
        # the installed blocks serve an admission hit, token-exact
        out = dst.generate(TOKS + [9], max_new=4, timeout=60)
        assert out == _ref_tokens(jparams, TOKS + [9], 4)
        st = dst.stats()
        assert st["prefix_hit_tokens"] >= 8
        assert st["full_prefills"] == 0
        # the adopter's own publication is recorded for export
        assert [r["tokens"] for r in dst.prefix_export()] == [TOKS]
    finally:
        src.shutdown()
        dst.shutdown()


def test_install_geometry_mismatch_rejected(model):
    _, params = model
    src = _warm_engine(params)
    dst = _engine(params)
    try:
        payload = src.prefix_extract(TOKS, src.pool.generation)
        with pytest.raises(PrefixUnavailable, match="geometry"):
            dst.prefix_install(TOKS, dict(payload, block_size=8))
        with pytest.raises(PrefixUnavailable, match="shape"):
            dst.prefix_install(TOKS, dict(payload, k=payload["k"][:, :1]))
        with pytest.raises(PrefixUnavailable, match="block-aligned"):
            dst.prefix_install(TOKS[:6], payload)
        other = _engine(params, kv_block_size=8)
        try:
            with pytest.raises(PrefixUnavailable, match="geometry"):
                other.prefix_install(TOKS, payload)
        finally:
            other.shutdown()
        assert dst.pool.n_free == dst.pool.n_blocks
    finally:
        src.shutdown()
        dst.shutdown()


def test_install_under_block_pressure_never_preempts(model):
    """A 4-block pool cannot take a 6-block prefix: the install raises
    the typed pressure error, gives back every block it took and leaves
    the pool as it was."""
    _, params = model
    toks = list(range(1, 25))                    # 24 tokens, 6 blocks
    src = _warm_engine(params)
    dst = _engine(params, n_blocks=4, max_seq=16)
    try:
        src.generate(toks + [30], max_new=2, timeout=60)
        payload = src.prefix_extract(toks, src.pool.generation)
        free_before = dst.pool.n_free
        with pytest.raises(PrefixInstallPressure):
            dst.prefix_install(toks, payload)
        assert dst.pool.n_free == free_before
        _audit(dst)
        assert all(dst.pool.refcount(b) == 0 for b in range(5))
    finally:
        src.shutdown()
        dst.shutdown()


def test_install_evicts_cached_prefixes_but_not_live_rows(model):
    """An adopter whose free blocks are spent evicts unreferenced cached
    prefixes for the install; a live request's blocks are never taken."""
    jparams, params = model
    src = _warm_engine(params)
    dst = _engine(params, n_blocks=6, max_seq=24, max_slots=1)
    try:
        payload = src.prefix_extract(TOKS, src.pool.generation)
        # a finished request leaves 3 cached blocks; a live one takes the
        # other 3 and grows to 4, so the install must evict cached ones
        dst.generate(list(range(40, 48)) + [1], max_new=2, timeout=60)
        assert dst.trie.cached_blocks == 3
        live = dst.submit(list(range(20, 32)), max_new=4)
        next(live.stream(timeout=60))
        r = dst.prefix_install(TOKS, payload)
        assert r == {"installed": 2, "already": False}
        assert live.result(timeout=60) == _ref_tokens(
            jparams, list(range(20, 32)), 4)
        assert dst.stats()["preemptions"] == 0
        _audit(dst)
        assert dst.generate(TOKS + [9], max_new=4, timeout=60) == \
            _ref_tokens(jparams, TOKS + [9], 4)
    finally:
        src.shutdown()
        dst.shutdown()


def test_step_failure_reset_bumps_generation(model):
    """A failed step resets the pool: its generation moves on, so the
    prefix published before it is refused as stale."""
    _, params = model
    eng = _warm_engine(params)
    try:
        old = eng.pool.generation
        published = eng.prefix_export()
        assert [r["generation"] for r in published] == [old]
        real = eng._step
        boom = {"armed": True}

        def failing(*a):
            if boom.pop("armed", False):
                raise RuntimeError("injected step failure")
            return real(*a)

        eng._step = failing
        with pytest.raises(RuntimeError, match="injected step"):
            eng.generate([5, 6, 7], max_new=3, timeout=60)
        assert eng.pool.generation == old + 1
        with pytest.raises(StalePrefixGeneration):
            eng.prefix_extract(TOKS, old)
        with pytest.raises(PrefixUnavailable):      # the index was cleared
            eng.prefix_extract(TOKS, eng.pool.generation)
    finally:
        eng.shutdown()


def test_export_drains_a_bounded_outbox(model):
    _, params = model
    eng = _engine(params, max_seq=64, n_blocks=40)
    try:
        assert eng.prefix_export() == []
        eng.generate(TOKS + [9], max_new=2, timeout=60)
        recs = eng.prefix_export()
        assert len(recs) == 1 and recs[0]["tokens"] == TOKS
        assert recs[0]["block_size"] == 4 and len(recs[0]["blocks"]) == 2
        assert recs[0]["engine"] == eng.name
        assert eng.prefix_export() == []
        for i in range(70):
            eng._note_prefix_published(np.array([i] * 4), [1])
        recs = eng.prefix_export()
        assert len(recs) == 64 and recs[0]["tokens"] == [6] * 4
    finally:
        eng.shutdown()


def test_ops_rejected_after_shutdown(model):
    _, params = model
    eng = _warm_engine(params)
    eng.shutdown()
    with pytest.raises(EngineStoppedError):
        eng.prefix_extract(TOKS, eng.pool.generation)
    with pytest.raises(EngineStoppedError):
        eng.prefix_install(TOKS, {"k": np.zeros((2, 2, 4, 4, 16)),
                                  "v": np.zeros((2, 2, 4, 4, 16)),
                                  "block_size": 4})


def test_queued_op_on_a_dying_engine_resolves_stopped(model):
    _, params = model
    eng = _engine(params)
    eng.shutdown()
    box = {"done": False, "result": None, "error": None}
    eng._ops.append((lambda: 1, box))
    eng._drain_pending()
    assert box["done"] and isinstance(box["error"], EngineStoppedError)
    assert eng._ops == []


def test_slot_engine_has_no_prefix_plane(model):
    _, params = model
    eng = InferenceEngine(params, TCFG, EngineConfig(max_slots=2,
                                                     paged=False),
                          device="cpu")
    try:
        assert eng.prefix_export() == []
        with pytest.raises(PrefixUnavailable, match="prefix index"):
            eng.prefix_extract(TOKS, 0)
    finally:
        eng.shutdown()


def test_gpt_server_prefix_plane_closed_and_draining(model):
    jparams, params = model
    ec = EngineConfig(max_slots=2, kv_block_size=4)
    holder = GPTServer(TCFG, ec, params=params, device="cpu")
    adopter = GPTServer(TCFG, ec, params=params, device="cpu")
    try:
        holder({"prompt": TOKS + [9], "max_tokens": 4})
        recs = holder.prefix_export()
        assert [r["tokens"] for r in recs] == [TOKS]
        payload = holder.prefix_extract("any-model", TOKS,
                                        recs[0]["generation"])
        assert adopter.prefix_install(None, TOKS, payload)["installed"] == 2
        reply = adopter({"prompt": TOKS + [9], "max_tokens": 4})
        assert reply["tokens"] == _ref_tokens(jparams, TOKS + [9], 4)
        holder.drain()
        with pytest.raises(EngineDrainingError):
            holder.prefix_extract(None, TOKS, recs[0]["generation"])
        with pytest.raises(EngineDrainingError):
            holder.prefix_install(None, TOKS, payload)
        holder.teardown()
        assert holder.prefix_export() == []
        with pytest.raises(EngineStoppedError):
            holder.prefix_extract(None, TOKS, recs[0]["generation"])
        with pytest.raises(EngineStoppedError):
            holder.prefix_install(None, TOKS, payload)
    finally:
        holder.teardown()
        adopter.teardown()
