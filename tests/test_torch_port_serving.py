"""The port's serving slice against the JAX package on the CPU: the same
bridged weights and the same requests through ``ray_tpu``'s paged
engine and through ``ray_tpu_torch``'s GPTServer / engine.  Greedy f32
tokens must equal both the JAX engine's and the port's full-recompute
``generate``, and every block reference must be returned at the end.

Scenario 1 is a cold long prompt (``2n > max_seq``) on an idle engine:
the full-width prefill, whose attention is the flash path.  Scenario 2
is chunked prefill with a shared-prefix hit and block-pressure
preemption, mirroring tests/test_paged_cache.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.inference import EngineConfig as JEngineConfig
from ray_tpu.inference import InferenceEngine as JInferenceEngine
from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.inference import (BlockPool, EngineConfig, GPTServer,
                                     InferenceEngine, RadixIndex)
from ray_tpu_torch.inference import decode as tdecode
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FLASH = dict(attn_impl="flash", attn_block_q=64, attn_block_k=64)
ENGINE = dict(max_slots=4, kv_block_size=16, prefill_chunk=32)


@pytest.fixture(scope="module")
def model():
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32, **FLASH)
    tcfg = tgpt.GPTConfig.tiny(dtype=torch.float32, **FLASH)
    jparams = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, params


def _generate(params, cfg, prompt, max_new):
    out = tgpt.generate(params, cfg, torch.tensor([prompt]), max_new,
                        temperature=0.0)
    return out[0, len(prompt):].tolist()


def _jax_engine_tokens(jparams, jcfg, jobs, **engine_kw):
    eng = JInferenceEngine(jparams, jcfg, JEngineConfig(**engine_kw))
    try:
        hs = [eng.submit(p, max_new=m) for p, m in jobs]
        return [h.result(timeout=300) for h in hs]
    finally:
        eng.shutdown()


def _assert_refs_returned(engine):
    """Every block is either free or held by the prefix index alone;
    evicting the index returns the pool to all-free, refcounts 0."""
    st = engine.stats()
    assert st["active_slots"] == 0
    assert st["blocks_free"] + st["prefix_cached_blocks"] == \
        st["blocks_total"]
    if engine.trie is not None:
        engine.trie.evict(st["blocks_total"])
    pool = engine.pool
    assert pool.n_free == pool.n_blocks
    assert all(pool.refcount(b) == 0 for b in range(pool.n_blocks + 1))


def test_cold_long_prompt_takes_full_width_prefill(model):
    jcfg, tcfg, jparams, params = model
    rng = np.random.default_rng(11)
    long_p = rng.integers(0, tcfg.vocab_size, 70).tolist()  # 2*70 > 128
    short_p = rng.integers(0, tcfg.vocab_size, 9).tolist()
    jobs = [(long_p, 8), (short_p, 6)]
    srv = GPTServer(tcfg, EngineConfig(**ENGINE), params=params,
                    device="cpu")
    try:
        replies = [srv({"prompt": p, "max_tokens": m}) for p, m in jobs]
        st = srv.engine_stats()
        assert st["full_prefills"] == 1 and st["chunk_prefills"] >= 1
        _assert_refs_returned(srv.engine)
    finally:
        srv.teardown()
    want = _jax_engine_tokens(jparams, jcfg, jobs, **ENGINE)
    for (p, m), reply, w in zip(jobs, replies, want):
        assert reply["tokens"] == w == _generate(params, tcfg, p, m)
        assert reply["n"] == m
        assert all(type(t) is int for t in reply["tokens"])
        assert isinstance(reply["ttft_s"], float)


def test_chunked_prefill_prefix_hit_and_preemption(model):
    jcfg, tcfg, jparams, params = model
    rng = np.random.default_rng(12)
    head = rng.integers(0, tcfg.vocab_size, 16).tolist()   # one block
    shared = [head + rng.integers(0, tcfg.vocab_size, 7).tolist(),
              head + rng.integers(0, tcfg.vocab_size, 12).tolist()]
    crowd = [rng.integers(0, tcfg.vocab_size, int(n)).tolist()
             for n in rng.integers(14, 30, 4)]
    # 4 usable blocks of 16 hold one 64-token sequence: four concurrent
    # 40-token sequences must preempt
    kw = dict(ENGINE, max_seq=64, n_blocks=4)
    eng = InferenceEngine(params, tcfg, EngineConfig(**kw), device="cpu")
    try:
        got_shared = [eng.generate(p, max_new=6, timeout=300)
                      for p in shared]
        assert eng.stats()["prefix_hit_tokens"] >= 16
        with eng._cond:     # (re-entrant) queue all four before admitting
            hs = [eng.submit(p, max_new=16) for p in crowd]
        got_crowd = [h.result(timeout=300) for h in hs]
        st = eng.stats()
        assert st["preemptions"] > 0
        assert st["full_prefills"] == 0
        _assert_refs_returned(eng)
    finally:
        eng.shutdown()
    jobs = [(p, 6) for p in shared] + [(p, 16) for p in crowd]
    want = _jax_engine_tokens(jparams, jcfg, jobs, **kw)
    for (p, m), g, w in zip(jobs, got_shared + got_crowd, want):
        assert g == w == _generate(params, tcfg, p, m)


def test_streaming_reply_and_drain(model):
    _, tcfg, _, params = model
    srv = GPTServer(tcfg, EngineConfig(**ENGINE), params=params,
                    device="cpu")
    try:
        chunks = list(srv({"prompt": "hello port", "max_tokens": 4,
                           "stream": True}))
        assert [c["index"] for c in chunks[:-1]] == [0, 1, 2, 3]
        assert chunks[-1]["done"] and chunks[-1]["n"] == 4
        srv.drain()
        with pytest.raises(Exception, match="draining"):
            srv({"prompt": [1, 2], "max_tokens": 2})
    finally:
        srv.teardown()


def test_sampled_request_uses_its_own_generator(model):
    _, tcfg, _, params = model
    eng = InferenceEngine(params, tcfg, EngineConfig(**ENGINE), device="cpu")
    try:
        a = eng.generate([3, 4, 5], max_new=5, temperature=1.0, seed=7)
        b = eng.generate([3, 4, 5], max_new=5, temperature=1.0, seed=7)
        assert a == b and len(a) == 5
    finally:
        eng.shutdown()


def test_copy_on_write_keeps_cached_tail(model):
    _, tcfg, _, params = model
    pool = BlockPool(tcfg, n_blocks=8, block_size=16, device="cpu")
    trie = RadixIndex(pool)
    a, b = pool.alloc(), pool.alloc()
    pool.k[:, a] = 1.5
    trie.insert(np.arange(20), [a, b])           # one full + a tail leaf
    pool.decref(a)
    pool.decref(b)
    ids, hit = trie.match(np.arange(30))
    assert (ids, hit) == ([a, b], 20)
    dst = pool.alloc()
    pool.copy_block(a, dst)
    assert torch.equal(pool.k[:, dst], pool.k[:, a])
    for bid in ids + [dst]:
        pool.decref(bid)
    assert trie.evict(8) == 2 and pool.n_free == 8


def test_decode_step_scatter_matches_jax_layout(model):
    """The one-scatter commit lands each row's K/V at (table[pos // bs],
    pos % bs) in every layer, and only there."""
    _, tcfg, _, params = model
    bs, T = 16, 8
    step = tdecode.make_paged_decode_step(tcfg, block_size=bs, n_table=T)
    shape = (tcfg.n_layers, 10, tcfg.n_heads, bs, tcfg.head_dim)
    kp, vp = torch.zeros(shape), torch.zeros(shape)
    tables = torch.zeros((2, T), dtype=torch.long)
    tables[0, :2] = torch.tensor([3, 5])
    tables[1, :1] = torch.tensor([7])
    positions = torch.tensor([17, 4])
    logits = step(params, kp, vp, tables, torch.tensor([9, 11]), positions,
                  torch.tensor([True, True]))
    assert logits.shape == (2, tcfg.vocab_size)
    written = (kp.abs().sum(dim=(0, 2, 4)) > 0).nonzero().tolist()
    assert written == [[5, 1], [7, 4]]
