"""The port's tensor-parallel serving against the JAX package's sharded
engine on the CPU: ``GPTConfig.tiny`` (and ``tiny_moe(capacity_factor=
4.0)``) in f32 with ``max_seq=64``, one set of weights (numpy draws in
the tree of JAX's ``init_params``) on both sides.  The port's tp ranks
are threads of this process (the engine's executor,
``ray_tpu_torch.inference.tp``); the JAX side runs on ``{tp: n}`` meshes
of conftest's 8 virtual CPU devices, as tests/test_sharded_decode.py
builds them.

The prefill on a mesh (``gpt.forward(mesh=, return_kv=True)``) is held to
JAX's sharded forward: logits, and each rank's heads of the K/V, within
1e-5.  Then test_sharded_decode.py's scenarios on the port's tp engine:
prefix reuse and chunked prefill at tp2 and tp4, preemption, n-gram and
self speculation, MoE, and recovery from a step failure.  Every greedy
reply is token-exact against JAX's ``generate``, which
test_sharded_decode.py holds the JAX sharded engine to in the same
scenarios; tests/test_torch_port_tp_serve.py runs the JAX sharded engine
itself on one traffic beside the port's (a cold full-width prefill,
n-gram drafts, prefix reuse), since its compiles would take this file
past its time budget.  Prompt lengths and widths repeat, so JAX compiles
few programs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate

from ray_tpu.models import gpt as jgpt
from ray_tpu.parallel.mesh import create_mesh as jcreate_mesh
from ray_tpu_torch.inference import EngineConfig, InferenceEngine
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.parallel import create_mesh

from _torch_port_ranks import ranks
from _torch_port_trees import weights

torch.backends.cuda.matmul.allow_tf32 = False

JCFG = jgpt.GPTConfig.tiny(dtype=jnp.float32, max_seq=64)
TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32, max_seq=64)
JMOE = jgpt.GPTConfig.tiny_moe(capacity_factor=4.0, max_seq=64)
TMOE = tgpt.GPTConfig.tiny_moe(capacity_factor=4.0, max_seq=64)
ATOL = 1e-5
PAGED = dict(max_slots=2, kv_block_size=8, prefill_chunk=16)
WARM = [7, 3, 1, 4, 1, 5, 9, 2, 6]
SHORT = [9, 8, 7, 6, 5, 4]
_jax_generate = jax.jit(jgpt.generate,
                        static_argnames=("cfg", "max_new", "temperature"))
_streams: dict = {}


def _bridge(jcfg, seed):
    """Numpy draws in the tree of JAX's ``init_params`` (running it costs
    seconds), as JAX arrays and as the port's tensors."""
    tree = weights(jgpt.init_params, jcfg, seed)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            convert.params_from_numpy(tree, device="cpu"))


@pytest.fixture(scope="module")
def model():
    return _bridge(JCFG, 0)


@pytest.fixture(scope="module")
def moe_model():
    return _bridge(JMOE, 3)


def _jax_mesh(n):
    return jcreate_mesh({"tp": n}, devices=jax.devices("cpu")[:n])


def _ref(jparams, jobs, jcfg=JCFG):
    """JAX ``generate``'s greedy continuation of each (prompt, max_new):
    one batched call per (prompt length, max_new) not seen before."""
    todo = {}
    for p, m in jobs:
        if (jcfg, tuple(p), m) not in _streams:
            todo.setdefault((len(p), m), set()).add(tuple(p))
    for (n, m), group in todo.items():
        group = sorted(group)
        toks = np.asarray(_jax_generate(jparams, jcfg,
                                        jnp.asarray(group, jnp.int32),
                                        max_new=m, temperature=0.0))
        for r, p in enumerate(group):
            _streams[(jcfg, p, m)] = toks[r, n:].tolist()
    return [_streams[(jcfg, tuple(p), m)] for p, m in jobs]


def _tp_engine(params, n, cfg=TCFG, **ec):
    return InferenceEngine(params, cfg, EngineConfig(**{**PAGED, **ec}),
                           device="cpu", mesh={"tp": n})


def _serve(eng, jobs):
    """Submit every (prompt, max_new) at once; the replies in order."""
    handles = [eng.submit(p, max_new=m) for p, m in jobs]
    return [h.result(timeout=120) for h in handles]


def _assert_no_block_leak(st):
    assert st["blocks_free"] + st["prefix_cached_blocks"] \
        == st["blocks_total"], f"block leak: {st}"


def _rank_pools(eng):
    """Every rank's pool shard of ``eng``: (shape, sum of |values|)."""
    def look(ctx):
        kv = ctx.engines[eng.name].pool.kv
        return tuple(kv.shape), float(kv.abs().sum())
    return eng._ranks.executor.on_ranks(look)


# ------------------------------------------------- the prefill on a mesh


@pytest.mark.parametrize("n", [2, 4])
def test_prefill_on_tp_mesh_matches_jax_sharded_forward(n, model):
    """``gpt.forward(mesh=, return_kv=True)`` on n threaded ranks: the
    gathered logits, and each rank's K/V (its heads, never gathered:
    [L, b, h/n, s, hd] placed Shard(2) over tp), within 1e-5 of JAX's
    forward on a {tp: n} mesh.  (MoE's prefill on a tp mesh is held to
    JAX's ``generate`` in ``test_tp_moe_parity``.)"""
    jcfg, tcfg = JCFG, TCFG
    jparams, params = model
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 32))
    jmesh = _jax_mesh(n)
    with jmesh:
        jlogits, (jk, jv) = jax.jit(lambda p, t: jgpt.forward(
            p, t, jcfg, mesh=jmesh, return_kv=True))(
                jparams, jnp.asarray(tokens, jnp.int32))
    jlogits, jk, jv = (np.asarray(a) for a in (jlogits, jk, jv))

    def rank(r):
        mesh = create_mesh({"tp": n}, device="cpu")
        tok = DTensor.from_local(torch.from_numpy(tokens), mesh,
                                 [Replicate()])
        with torch.no_grad():
            logits, (k, v) = tgpt.forward(params, tok, tcfg, mesh=mesh,
                                          return_kv=True)
        return (logits.full_tensor().numpy(), k.to_local().numpy(),
                v.to_local().numpy(), tuple(k.placements))

    hl = jcfg.n_heads // n
    for r, (logits, k, v, placements) in enumerate(ranks(rank, n)):
        assert k.shape == (jcfg.n_layers, 2, hl, 32, jcfg.head_dim)
        assert [p.is_shard(2) for p in placements] == [True]
        np.testing.assert_allclose(logits, jlogits, atol=ATOL, rtol=0)
        heads = slice(r * hl, (r + 1) * hl)
        np.testing.assert_allclose(k, jk[:, :, heads], atol=ATOL, rtol=0)
        np.testing.assert_allclose(v, jv[:, :, heads], atol=ATOL, rtol=0)


# ------------------------------------------------ sharded greedy parity


@pytest.mark.parametrize("n", [2, 4])
def test_tp_parity_prefix_and_chunked(n, model):
    """test_sharded_decode.py's prefix and chunked scenario: a cold
    40-token prompt (2n > max_seq: one full-width prefill on the mesh), a
    warm prompt twice (prefix reuse: the host's tables adopt heads-split
    blocks), then two 24-token prompts at once (the chunked prefill
    interleaved with decode).  Every reply equals JAX's ``generate``."""
    jparams, params = model
    rng = np.random.default_rng(7)
    cold = [(rng.integers(0, 512, 40).tolist(), 8)]
    longs = [(rng.integers(0, 512, 24).tolist(), 8) for _ in range(2)]
    want = _ref(jparams, cold + [(WARM, 8)] + longs)
    eng = _tp_engine(params, n)
    try:
        got = _serve(eng, cold)
        got += [eng.generate(WARM, max_new=8, timeout=120),
                eng.generate(WARM, max_new=8, timeout=120)]
        got += _serve(eng, longs)
        st = eng.stats()
    finally:
        eng.shutdown()
    assert got == want[:2] + want[1:]
    assert st["prefix_hit_tokens"] > 0 and st["chunk_prefills"] > 0
    assert st["full_prefills"] == 1
    _assert_no_block_leak(st)


def test_tp_parity_under_preemption(model):
    """Block pressure on a tp mesh (6 blocks of 8 under five concurrent
    20-token sequences): requests are preempted and resume with their
    emitted tokens folded into the prompt, every stream token-exact; the
    preemption logic is host-side and unaware of shards."""
    jparams, params = model
    rng = np.random.default_rng(1)
    jobs = [(rng.integers(0, 512, 12).tolist(), 8) for _ in range(5)]
    eng = _tp_engine(params, 2, max_slots=4, max_seq=32, n_blocks=6)
    try:
        got = _serve(eng, jobs)
        st = eng.stats()
    finally:
        eng.shutdown()
    assert got == _ref(jparams, jobs)
    assert st["preemptions"] > 0
    _assert_no_block_leak(st)


@pytest.mark.parametrize("mode,n", [("ngram", 2), ("ngram", 4),
                                    ("self", 2)])
def test_tp_parity_speculative(mode, n, model):
    """Draft-then-verify on a tp mesh: the widened verify step (and the
    self-draft burst, writing layers < draft_layers of every rank's pool)
    run over each rank's heads; the greedy accept rule keeps the stream
    token-exact."""
    jparams, params = model
    p = [5, 6, 7, 5, 6, 7, 5, 6, 7] if mode == "ngram" else SHORT
    spec = dict(speculate=mode, speculate_k=4)
    if mode == "self":
        spec["draft_layers"] = 1
    eng = _tp_engine(params, n, **spec)
    try:
        got = eng.generate(p, max_new=8, timeout=120)
        st = eng.stats()
    finally:
        eng.shutdown()
    assert got == _ref(jparams, [(p, 8)])[0]
    assert st["spec_drafted_tokens"] > 0
    _assert_no_block_leak(st)


def test_tp_moe_parity(moe_model):
    """MoE on a tp mesh: each rank runs every expert on its block of the
    hidden dim (the router whole, the experts' outputs completed over tp
    before the combine), in the chunked prefill and the decode step, and
    in the full-width prefill's ``_sharded_moe`` at ep 1; token-exact
    against the training forward's oracle while capacity never binds."""
    jparams, params = moe_model
    jobs = [(SHORT, 8), (list(range(40, 80)), 8)]
    eng = _tp_engine(params, 2, cfg=TMOE)
    try:
        got = _serve(eng, jobs[:1]) + _serve(eng, jobs[1:])
        st = eng.stats()
    finally:
        eng.shutdown()
    assert got == _ref(jparams, jobs, JMOE)
    assert st["full_prefills"] == 1 and st["chunk_prefills"] >= 1


def test_tp_recovery_resets_every_rank(model):
    """test_sharded_decode.py's recovery: a step that fails on every rank
    fails the in-flight request; every rank's pool shard is zeroed at its
    shape ([2, L, N+1, h/2, bs, hd]), every block is free, the generation
    moves on, and the engine serves on token-exact.  The same holds when
    the engine's own step call fails before it reaches the ranks (the
    JAX test's patched ``_step``)."""
    jparams, params = model
    want = _ref(jparams, [(SHORT, 8)])[0]
    shape = (2, 2, 17, 2, 8, 16)
    eng = _tp_engine(params, 2)
    try:
        assert eng.generate(SHORT, max_new=8, timeout=120) == want
        assert [sh for sh, _ in _rank_pools(eng)] == [shape] * 2

        def arm(ctx):
            st = ctx.engines[eng.name]
            real = st.bodies["step"]

            def failing(*a):
                st.bodies["step"] = real
                raise RuntimeError("injected sharded step failure")
            st.bodies["step"] = failing

        eng._ranks.executor.on_ranks(arm)
        bad = eng.submit([1, 2], max_new=8)
        with pytest.raises(RuntimeError, match="injected sharded"):
            bad.result(timeout=60)
        st = eng.stats()
        assert st["blocks_free"] == st["blocks_total"]
        assert eng.pool.generation == 1
        assert _rank_pools(eng) == [(shape, 0.0)] * 2
        assert eng.generate(SHORT, max_new=8, timeout=120) == want

        real_step = eng._step
        boom = {"armed": True}

        def failing_step(*a):
            if boom.pop("armed", False):
                raise RuntimeError("injected engine step failure")
            return real_step(*a)

        eng._step = failing_step
        bad = eng.submit([1, 2], max_new=8)
        with pytest.raises(RuntimeError, match="injected engine step"):
            bad.result(timeout=60)
        assert eng.pool.generation == 2
        assert eng.generate(SHORT, max_new=8, timeout=120) == want
    finally:
        eng.shutdown()
