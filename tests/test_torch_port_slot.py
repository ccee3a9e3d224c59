"""The port's slot engine (``EngineConfig(paged=False)``) against the JAX
package on the CPU, on one set of weights: ``GPTConfig.tiny`` in f32
with ``max_seq=64``, ``init_params`` of the JAX package bridged through
numpy.

The slot decode step is held to JAX's ``make_decode_step`` on the same
cache and inputs (logits and caches within 1e-4, a parked slot's stripe
bit-unchanged); ``attention(impl="xla_fused")`` to JAX's within 1e-5.
Greedy engine streams must equal JAX's ``gpt.generate``, in the
scenarios of tests/test_inference.py: queueing and slot reuse, EOS
eviction, cancellation, and a prefill or step failure."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.inference import decode as jdecode
from ray_tpu.models import gpt as jgpt
from ray_tpu.ops.attention import attention as jattention
from ray_tpu_torch.inference import (EngineConfig, GPTServer,
                                     InferenceEngine, KVCacheManager,
                                     make_decode_step)
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.ops.attention import attention as tattention

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-4
JCFG = jgpt.GPTConfig.tiny(dtype=jnp.float32, max_seq=64)
TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32, max_seq=64)
# one compiled program per (batch, prompt length, max_new)
_jax_generate = jax.jit(jgpt.generate,
                        static_argnames=("cfg", "max_new", "temperature"))


@pytest.fixture(scope="module")
def model():
    jparams = jgpt.init_params(JCFG, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jparams, params


def _jax_streams(jparams, jobs):
    """JAX ``generate``'s greedy continuation of each (prompt, max_new),
    one batched call per (prompt length, max_new)."""
    groups = {}
    for i, (p, m) in enumerate(jobs):
        groups.setdefault((len(p), m), []).append(i)
    out = [None] * len(jobs)
    for (n, m), idx in groups.items():
        toks = _jax_generate(jparams, JCFG,
                             jnp.asarray([jobs[i][0] for i in idx], jnp.int32),
                             max_new=m, temperature=0.0)
        for r, i in enumerate(idx):
            out[i] = np.asarray(toks)[r, n:].tolist()
    return out


def _slot_engine(params, **kw):
    return InferenceEngine(params, TCFG, EngineConfig(paged=False, **kw),
                           device="cpu")


# ------------------------------------------------------------ slot pool


def test_cache_manager_alloc_free_exhaustion():
    mgr = KVCacheManager(TCFG, n_slots=2, max_seq=32, device="cpu")
    a, b = mgr.alloc(), mgr.alloc()
    assert {a, b} == {0, 1}
    assert mgr.alloc() is None          # exhausted: the caller queues
    assert mgr.n_free == 0 and mgr.n_active == 2
    mgr.free(a)
    assert mgr.n_free == 1
    assert mgr.alloc() == a
    mgr.free(b)
    with pytest.raises(ValueError):     # double free
        mgr.free(b)


def test_cache_manager_bounds_and_prefill_padding():
    with pytest.raises(ValueError):
        KVCacheManager(TCFG, n_slots=0, device="cpu")
    with pytest.raises(ValueError):     # wider than the wpe table
        KVCacheManager(TCFG, n_slots=1, max_seq=TCFG.max_seq + 1,
                       device="cpu")
    mgr = KVCacheManager(TCFG, n_slots=4, max_seq=32, device="cpu")
    st = mgr.stats()
    assert st["bytes_total"] == 2 * mgr.k.numel() * 4       # f32
    assert st["free_slots"] == 4 and st["max_seq"] == 32
    # a short prefill lands at the head of the stripe, zero-padded
    shape = (TCFG.n_layers, TCFG.n_heads, 20, TCFG.head_dim)
    k_new, v_new = torch.ones(shape), torch.full(shape, 2.0)
    mgr.k.fill_(7.0)
    mgr.write_prefill(1, k_new, v_new)
    assert torch.equal(mgr.k[:, 1, :, :20], k_new)
    assert torch.equal(mgr.v[:, 1, :, :20], v_new)
    assert not mgr.k[:, 1, :, 20:].any() and not mgr.v[:, 1, :, 20:].any()
    assert bool((mgr.k[:, 0] == 7.0).all())                 # other slots
    mgr.reset_arrays()
    assert not mgr.k.any() and not mgr.v.any()


# ------------------------------------------------------------ step body


def test_slot_decode_step_matches_jax(model):
    """The same cache and inputs, one slot parked: logits and both caches
    agree, and the parked slot's stripe is bit-unchanged."""
    jparams, params = model
    rng = np.random.default_rng(3)
    L, h, S, hd = TCFG.n_layers, TCFG.n_heads, TCFG.max_seq, TCFG.head_dim
    b = 3
    kc, vc = (rng.standard_normal((L, b, h, S, hd)).astype(np.float32)
              for _ in range(2))
    tokens = np.array([5, 77, 300])
    positions = np.array([10, 40, 63])
    active = np.array([True, False, True])

    jstep = jdecode.make_decode_step(JCFG)
    jl, jk, jv = jstep(jparams, jnp.asarray(kc), jnp.asarray(vc),
                       jnp.asarray(tokens, jnp.int32),
                       jnp.asarray(positions, jnp.int32), jnp.asarray(active))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    step = make_decode_step(TCFG)
    logits = step(params, tk, tv, torch.from_numpy(tokens),
                  torch.from_numpy(positions), torch.from_numpy(active))
    assert logits.shape == (b, TCFG.vocab_size)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)
    assert torch.equal(tk[:, 1], torch.from_numpy(kc[:, 1]))
    assert torch.equal(tv[:, 1], torch.from_numpy(vc[:, 1]))
    # the active slots changed at their own position only
    changed = (tk != torch.from_numpy(kc)).any(dim=(0, 2, 4))    # [b, S]
    assert changed.nonzero().tolist() == [[0, 10], [2, 63]]


XLA_FUSED_CASES = [(sq, skv, causal) for sq, skv in
                   ((32, 32), (16, 48), (48, 16)) for causal in (True, False)]


def _qkv(seed, sq, skv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 4, sq, 16)).astype(np.float32),
            *(rng.standard_normal((2, 4, skv, 16)).astype(np.float32)
              for _ in range(2)))


@pytest.fixture(scope="module")
def xla_fused_want():
    """JAX's xla_fused output for every case, from ONE jit."""
    args = [_qkv(i, sq, skv) for i, (sq, skv, _) in enumerate(XLA_FUSED_CASES)]

    @jax.jit
    def run(args):
        return [jattention(q, k, v, causal=c, impl="xla_fused")
                for (q, k, v), (_, _, c) in zip(args, XLA_FUSED_CASES)]

    return [np.asarray(o) for o in run(args)]


@pytest.mark.parametrize("case", range(len(XLA_FUSED_CASES)),
                         ids=lambda i: "q{}kv{}-causal{}".format(
                             *XLA_FUSED_CASES[i]))
def test_xla_fused_matches_jax(xla_fused_want, case):
    sq, skv, causal = XLA_FUSED_CASES[case]
    q, k, v = (torch.from_numpy(a) for a in _qkv(case, sq, skv))
    got = tattention(q, k, v, causal=causal, impl="xla_fused")
    np.testing.assert_allclose(got.numpy(), xla_fused_want[case],
                               atol=1e-5, rtol=0)


def test_xla_fused_refuses_masks():
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="xla_fused"):
        tattention(q, q, q, mask=torch.ones((1, 1, 8, 8), dtype=torch.bool),
                   impl="xla_fused")
    with pytest.raises(ValueError, match="xla_fused"):
        tattention(q, q, q, kv_lengths=torch.tensor([8]), impl="xla_fused")


# --------------------------------------------------------------- engine


def test_slot_engine_queues_and_reuses_slots(model):
    """More requests than slots: all finish with JAX's greedy tokens,
    each admission is one full-width prefill, the slots come back."""
    jparams, params = model
    prompts = [[i + 1, i + 2] for i in range(5)]
    eng = _slot_engine(params, max_slots=2)
    try:
        with eng._cond:     # (re-entrant) queue all five before admitting
            hs = [eng.submit(p, max_new=4) for p in prompts]
        got = [h.result(timeout=60) for h in hs]
        st = eng.stats()
    finally:
        eng.shutdown()
    assert got == _jax_streams(jparams, [(p, 4) for p in prompts])
    assert st["paged"] is False and st["speculate"] is None
    assert st["free_slots"] == st["max_slots"] == 2
    assert st["full_prefills"] == 5 and st["chunk_prefills"] == 0
    assert st["requests_completed"] == 5 and st["generated_tokens"] == 20
    assert st["tokens_per_step"] == 1.0 and st["row_tokens"] == 15
    assert st["peak_active_requests"] == 2
    assert st["cache_bytes"] == 2 * 2 * TCFG.n_layers * TCFG.n_heads \
        * TCFG.max_seq * TCFG.head_dim * 4
    assert "blocks_total" not in st and "preemptions" not in st


def test_gpt_server_serves_on_the_slot_engine(model):
    jparams, params = model
    prompt = [3, 1, 4, 1, 5]
    srv = GPTServer(TCFG, EngineConfig(max_slots=2, paged=False),
                    params=params, device="cpu")
    try:
        reply = srv({"prompt": prompt, "max_tokens": 10})
        assert srv.engine_stats()["paged"] is False
    finally:
        srv.teardown()
    assert reply["tokens"] == _jax_streams(jparams, [(prompt, 10)])[0]
    assert reply["n"] == 10


def test_slot_engine_eos_eviction_frees_slot(model):
    jparams, params = model
    ref = _jax_streams(jparams, [([7, 8, 9], 8)])[0]
    eng = _slot_engine(params, max_slots=2, eos_token=ref[0])
    try:
        assert eng.generate([7, 8, 9], max_new=8, timeout=60) == [ref[0]]
        st = eng.stats()
        assert st["active_slots"] == 0 and st["free_slots"] == 2
        assert eng.generate([7, 8, 9], max_new=8, timeout=60) == [ref[0]]
    finally:
        eng.shutdown()


def test_slot_engine_cancels_waiting_and_active(model):
    """cancel() drops a queued request before admission and evicts an
    active one; the freed slot serves live work."""
    jparams, params = model
    eng = _slot_engine(params, max_slots=1)
    try:
        ra = eng.submit([1, 2, 3], max_new=40)
        first = next(ra.stream(timeout=60))       # ra holds the only slot
        rb = eng.submit([4, 5, 6], max_new=40)    # parked: no free slot
        rb.cancel()
        ra.cancel()
        part = ra.result(timeout=60)
        assert rb.result(timeout=60) == []
        assert 1 <= len(part) < 40 and part[0] == first
        assert eng.stats()["free_slots"] == 1
        live = eng.generate([7, 8], max_new=3, timeout=60)
    finally:
        eng.shutdown()
    ref_a, ref_live = _jax_streams(jparams, [([1, 2, 3], 40), ([7, 8], 3)])
    assert part == ref_a[:len(part)]
    assert live == ref_live


def test_slot_prefill_failure_is_isolated(model):
    """A failed prefill fails ONE request and returns its slot; the
    engine keeps serving."""
    jparams, params = model
    eng = _slot_engine(params, max_slots=2)
    try:
        real_prefill = eng._prefill
        boom = {"armed": True}

        def failing_prefill(params_, tokens):
            if boom.pop("armed", False):
                raise RuntimeError("injected prefill failure")
            return real_prefill(params_, tokens)

        eng._prefill = failing_prefill
        bad = eng.submit([1, 2], max_new=4)
        with pytest.raises(RuntimeError, match="injected prefill"):
            bad.result(timeout=60)
        assert eng.stats()["free_slots"] == 2
        out = eng.generate([3, 4], max_new=4, timeout=60)
    finally:
        eng.shutdown()
    assert out == _jax_streams(jparams, [([3, 4], 4)])[0]


def test_slot_step_failure_fails_inflight_and_recovers(model):
    """A failed decode step fails the in-flight requests, zeroes the
    cache and frees every slot; the engine keeps serving."""
    jparams, params = model
    eng = _slot_engine(params, max_slots=2)
    try:
        real_step = eng._step
        boom = {"armed": True}

        def failing_step(*a):
            if boom.pop("armed", False):
                raise RuntimeError("injected step failure")
            return real_step(*a)

        eng._step = failing_step
        bad = eng.submit([1, 2], max_new=8)
        with pytest.raises(RuntimeError, match="injected step"):
            bad.result(timeout=60)
        assert eng.stats()["free_slots"] == 2
        assert not eng.cache.k.any()
        out = eng.generate([3, 4], max_new=4, timeout=60)
    finally:
        eng.shutdown()
    assert out == _jax_streams(jparams, [([3, 4], 4)])[0]
