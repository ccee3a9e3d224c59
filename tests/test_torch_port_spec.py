"""The port's speculative decoding against the JAX package on the CPU, on
one set of weights: ``GPTConfig.tiny`` in f32 with ``max_seq=64``,
``init_params`` of the JAX package bridged through numpy.

``ngram_propose`` must equal JAX's exactly.  The verify step and the
self-draft burst are held to JAX's on one pool, tables and inputs, with
dead lanes and an inactive row: live lanes' logits within 1e-4, drafts
equal, and the pools after the call within 1e-4 at every block but the
scratch block.  Greedy engine streams must equal JAX's ``gpt.generate``
in the scenarios of tests/test_speculative.py: both drafters under
prefix reuse and chunked prefill, preemption while a speculative charge
is held, verify-step failure, the construction-time boundary, sampled
rows beside greedy ones, and the accounting and metrics series."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.inference import decode as jdecode
from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.inference import (EngineConfig, InferenceEngine,
                                     SpeculationUnsupported,
                                     make_paged_draft_step,
                                     make_spec_verify_step, metrics_snapshot,
                                     ngram_propose)
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-4
JCFG = jgpt.GPTConfig.tiny(dtype=jnp.float32, max_seq=64)
TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32, max_seq=64)
REP = [1, 2, 3, 4] * 6                    # the n-gram drafter's gold
# one compiled program per (batch, prompt length, max_new)
_jax_generate = jax.jit(jgpt.generate,
                        static_argnames=("cfg", "max_new", "temperature"))
_streams: dict = {}


@pytest.fixture(scope="module")
def model():
    jparams = jgpt.init_params(JCFG, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jparams, params


@pytest.fixture(scope="module")
def deep_model(model):
    """A 4-layer tiny model (the 2-layer one's layers, then the same two
    reversed): a draft burst two layers deep, so the second layer's K/V
    hold the first layer's attention over the burst."""
    jparams, _ = model
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32, max_seq=64, n_layers=4)
    tcfg = tgpt.GPTConfig.tiny(dtype=torch.float32, max_seq=64, n_layers=4)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tree["layers"] = {k: np.concatenate([a, a[::-1]])
                      for k, a in tree["layers"].items()}
    deep = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, deep, convert.params_from_numpy(tree, device="cpu")


def _jax_streams(jparams, jobs):
    """JAX ``generate``'s greedy continuation of each (prompt, max_new),
    one batched call per (prompt length, max_new) not seen before."""
    todo = {}
    for p, m in jobs:
        if (tuple(p), m) not in _streams:
            todo.setdefault((len(p), m), set()).add(tuple(p))
    for (n, m), group in todo.items():
        group = sorted(group)
        toks = np.asarray(_jax_generate(jparams, JCFG,
                                        jnp.asarray(group, jnp.int32),
                                        max_new=m, temperature=0.0))
        for r, p in enumerate(group):
            _streams[(p, m)] = toks[r, n:].tolist()
    return [_streams[(tuple(p), m)] for p, m in jobs]


def _spec_cfg(mode, **kw):
    base = dict(max_slots=4, kv_block_size=8, prefill_chunk=16,
                speculate=mode, speculate_k=4)
    if mode == "self":
        base["draft_layers"] = 1
    base.update(kw)
    return EngineConfig(**base)


def _engine(params, engine_cfg, **kw):
    return InferenceEngine(params, TCFG, engine_cfg, device="cpu", **kw)


def _assert_no_block_leak(st):
    assert st["blocks_free"] + st["prefix_cached_blocks"] \
        == st["blocks_total"], f"block leak: {st}"


# ------------------------------------------------------- n-gram drafter


def test_ngram_propose_matches_repeated_pattern():
    ctx = np.array([7, 1, 2, 3, 9, 1, 2, 3], np.int32)
    assert ngram_propose(ctx, 3).tolist() == [9, 1, 2]


def test_ngram_propose_prefers_longest_match_and_latest_site():
    ctx = np.array([1, 2, 5, 3, 2, 6, 3, 2], np.int32)
    assert ngram_propose(ctx, 2).tolist() == [6, 3]


def test_ngram_propose_no_match_is_empty():
    assert ngram_propose(np.array([1, 2, 3, 4, 5], np.int32), 4).size == 0
    assert ngram_propose(np.array([1], np.int32), 4).size == 0
    assert ngram_propose(np.array([], np.int32), 4).size == 0


def test_ngram_propose_caps_at_k_and_history_end():
    assert ngram_propose(np.array([1, 2, 1, 2, 1, 2], np.int32), 2).size <= 2
    prop = ngram_propose(np.array([5, 6, 7, 5, 6], np.int32), 8)
    assert prop.tolist() == [7, 5, 6]


def test_ngram_propose_equals_jax_on_random_contexts():
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(0, 40))
        ctx = rng.integers(0, int(rng.integers(2, 9)), n).astype(np.int32)
        k = int(rng.integers(0, 9))
        m = int(rng.integers(1, 5))
        got = ngram_propose(ctx, k, max_ngram=m)
        want = jdecode.ngram_propose(ctx, k, max_ngram=m)
        assert got.dtype == want.dtype and got.tolist() == want.tolist(), \
            (ctx.tolist(), k, m)


# --------------------------------------------------------- step bodies

BS, T = 8, 8                 # block size, table width: S = 64
N_BLOCKS = 1 + 4 * T         # scratch block 0, then T blocks a row
TABLES = np.arange(1, N_BLOCKS).reshape(4, T)


def _pools(seed, n_layers=TCFG.n_layers):
    rng = np.random.default_rng(seed)
    shape = (n_layers, N_BLOCKS, TCFG.n_heads, BS, TCFG.head_dim)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


def test_spec_verify_step_matches_jax(model):
    """Row 0 all lanes live, row 1 two dead lanes, row 2 inactive, row 3
    lanes past S dead."""
    jparams, params = model
    W = 5
    kp, vp = _pools(1)
    tokens = np.random.default_rng(2).integers(0, TCFG.vocab_size, (4, W))
    positions = np.array([13, 30, 5, 61])
    active = np.array([True, True, False, True])
    n_tokens = np.array([5, 3, 1, 5])
    live = (np.arange(W)[None] < n_tokens[:, None]) & active[:, None] \
        & (positions[:, None] + np.arange(W)[None] < T * BS)

    jverify = jdecode.make_spec_verify_step(JCFG, width=W, block_size=BS,
                                            n_table=T)
    jl, jk, jv = jverify(
        jparams, jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(TABLES, jnp.int32), jnp.asarray(tokens, jnp.int32),
        jnp.asarray(positions, jnp.int32), jnp.asarray(active),
        jnp.asarray(n_tokens, jnp.int32))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    verify = make_spec_verify_step(TCFG, width=W, block_size=BS, n_table=T)
    logits = verify(params, tk, tv, torch.from_numpy(TABLES),
                    torch.from_numpy(tokens), torch.from_numpy(positions),
                    torch.from_numpy(active), torch.from_numpy(n_tokens))
    assert logits.shape == (4, W, TCFG.vocab_size)
    assert live.sum() == 11
    np.testing.assert_allclose(logits.numpy()[live], np.asarray(jl)[live],
                               atol=ATOL, rtol=0)
    assert torch.isfinite(logits).all()          # dead lanes: never NaN
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy()[:, 1:],
                                   np.asarray(want)[:, 1:], atol=ATOL, rtol=0)
    # every live lane was written, at every layer, and nothing else
    changed = (tk[:, 1:] != torch.from_numpy(kp[:, 1:])).any(dim=(0, 2, 4))
    want_changed = sorted(
        [int(TABLES[r, p // BS]) - 1, p % BS]
        for r, j in zip(*np.nonzero(live)) for p in [positions[r] + j])
    assert changed.nonzero().tolist() == want_changed


def test_paged_draft_step_matches_jax(deep_model):
    """Row 0 drafts 4, row 1 2, row 2 sits the burst out, row 3 reaches S
    after 2; drafts agree, the pools agree at layers < draft_layers for
    live lanes, and layers >= draft_layers stay untouched."""
    jcfg, tcfg, jparams, params = deep_model
    D, K = 2, 4
    kp, vp = _pools(3, n_layers=tcfg.n_layers)
    tokens = np.array([17, 250, 3, 499])
    positions = np.array([13, 30, 5, 62])
    want = np.array([4, 2, 0, 4])
    valid = (np.arange(K)[None] < want[:, None]) \
        & (positions[:, None] + np.arange(K)[None] < T * BS)

    jdraft = jdecode.make_paged_draft_step(jcfg, draft_layers=D, k=K,
                                           block_size=BS, n_table=T)
    jd, jk, jv = jdraft(
        jparams, jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(TABLES, jnp.int32), jnp.asarray(tokens, jnp.int32),
        jnp.asarray(positions, jnp.int32), jnp.asarray(want, jnp.int32))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    draft = make_paged_draft_step(tcfg, draft_layers=D, k=K, block_size=BS,
                                  n_table=T)
    drafts = draft(params, tk, tv, torch.from_numpy(TABLES),
                   torch.from_numpy(tokens), torch.from_numpy(positions),
                   torch.from_numpy(want))
    assert drafts.shape == (4, K)
    assert valid.sum() == 8
    assert drafts.numpy()[valid].tolist() == np.asarray(jd)[valid].tolist()
    for got, ref, orig in ((tk, jk, kp), (tv, jv, vp)):
        np.testing.assert_allclose(got.numpy()[:D, 1:],
                                   np.asarray(ref)[:D, 1:], atol=ATOL, rtol=0)
        assert torch.equal(got[D:], torch.from_numpy(orig[D:]))
    changed = (tk[:D, 1:] != torch.from_numpy(kp[:D, 1:])).any(dim=(2, 4))
    assert changed.sum(dim=(1, 2)).tolist() == [8] * D


def test_draft_depth_outside_the_model_is_unsupported():
    for depth in (0, TCFG.n_layers):
        with pytest.raises(SpeculationUnsupported, match="draft_layers"):
            make_paged_draft_step(TCFG, draft_layers=depth, k=4,
                                  block_size=BS, n_table=T)
    with pytest.raises(SpeculationUnsupported, match="k must be"):
        make_paged_draft_step(TCFG, draft_layers=1, k=0, block_size=BS,
                              n_table=T)


# ------------------------------------------------------------ engine


@pytest.mark.parametrize("mode", ["ngram", "self"])
def test_spec_parity_prefix_reuse_and_chunked_prefill(model, mode):
    """Greedy draft-then-verify under paging, prefix reuse and chunked
    prefill, cold then warm: JAX's tokens, while actually speculating."""
    jparams, params = model
    rng = np.random.default_rng(7)
    head = rng.integers(0, TCFG.vocab_size, 24).tolist()     # 3 blocks
    prompts = ([head + rng.integers(0, TCFG.vocab_size, n).tolist()
                for n in (3, 6, 9)]
               + [REP] + [rng.integers(0, TCFG.vocab_size, 40).tolist()])
    eng = _engine(params, _spec_cfg(mode))
    try:
        got = []
        for _wave in ("cold", "warm"):
            hs = [eng.submit(p, max_new=8) for p in prompts]
            got.append([h.result(timeout=60) for h in hs])
        st = eng.stats()
    finally:
        eng.shutdown()
    want = _jax_streams(jparams, [(p, 8) for p in prompts])
    assert got == [want, want]
    assert st["speculate"] == mode and st["paged"] is True
    assert st["spec_passes"] > 0
    assert st["spec_drafted_tokens"] > 0
    assert st["spec_accepted_tokens"] > 0
    assert st["prefix_hit_tokens"] > 0          # the warm wave adopted heads
    assert st["tokens_per_step"] > 1.0
    assert st["row_tokens"] > st["row_steps"]
    _assert_no_block_leak(st)


def test_spec_parity_under_preemption_refunds_charge(model):
    """Block pressure preempts rows that hold a speculative charge: the
    charge joined the row's chain, so the preemption refunds it; streams
    stay exact and the pool audits clean."""
    jparams, params = model
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, TCFG.vocab_size, n).tolist()
               for n in (8, 14, 20, 8, 14, 20)]
    eng = _engine(params, EngineConfig(
        max_slots=4, max_seq=32, kv_block_size=8, n_blocks=6,
        prefill_chunk=16, speculate="self", draft_layers=1, speculate_k=4))
    excess = _check_rollbacks(eng, 8)
    try:
        with eng._cond:     # (re-entrant) queue all six before admitting
            hs = [eng.submit(p, max_new=12) for p in prompts]
        got = [h.result(timeout=60) for h in hs]
        st = eng.stats()
    finally:
        eng.shutdown()
    assert got == _jax_streams(jparams, [(p, 12) for p in prompts])
    assert st["preemptions"] > 0
    assert st["spec_drafted_tokens"] > 0
    assert excess and max(excess) <= 0
    _assert_no_block_leak(st)


def _check_rollbacks(eng, bs):
    """Wrap ``eng._spec_rollback`` to record, after each call, how many
    blocks the row holds past its next write position (and whether its
    table has an entry past its chain): both must be 0."""
    excess = []
    real_rollback = eng._spec_rollback

    def checked_rollback(row):
        real_rollback(row)
        n = len(eng._row_blocks[row])
        excess.append(n - (int(eng._positions[row]) // bs + 1))
        excess.append(int(eng._tables[row, n:].any()))

    eng._spec_rollback = checked_rollback
    return excess


def test_rejected_drafts_keep_parity_and_roll_back(model, monkeypatch):
    """A drafter whose every proposal is wrong: each pass verifies, emits
    the plain step's token, and hands back the blocks charged for the
    rejected lanes."""
    jparams, params = model
    from ray_tpu_torch.inference import engine as tengine

    monkeypatch.setattr(tengine, "ngram_propose",
                        lambda ctx, k: np.full(k, TCFG.vocab_size - 1))
    prompts = [REP, list(reversed(REP))]
    eng = _engine(params, _spec_cfg("ngram"))
    excess = _check_rollbacks(eng, 8)
    try:
        with eng._cond:
            hs = [eng.submit(p, max_new=12) for p in prompts]
        got = [h.result(timeout=60) for h in hs]
        st = eng.stats()
    finally:
        eng.shutdown()
    assert got == _jax_streams(jparams, [(p, 12) for p in prompts])
    assert all(t != TCFG.vocab_size - 1 for g in got for t in g)
    assert st["spec_drafted_tokens"] > 0 and st["spec_accepted_tokens"] == 0
    assert st["spec_accept_rate"] == 0.0 and st["tokens_per_step"] == 1.0
    assert excess and max(excess) <= 0
    _assert_no_block_leak(st)


@pytest.mark.parametrize("n_drafting", [1, 2])
def test_speculation_waits_for_half_the_batch(model, monkeypatch,
                                              n_drafting):
    """The batch-coverage gate: three rows decode together (one-chunk
    prompts, prefilled in one pass below half occupancy); with one of
    them drafting no pass speculates, with two passes do."""
    jparams, params = model
    from ray_tpu_torch.inference import engine as tengine

    rng = np.random.default_rng(4)
    prompts = [REP[:12] + rng.integers(0, TCFG.vocab_size, 4).tolist()
               for _ in range(3)]
    drafting = {tuple(p) for p in prompts[:n_drafting]}
    real_propose = tengine.ngram_propose
    monkeypatch.setattr(
        tengine, "ngram_propose",
        lambda ctx, k: (real_propose(ctx, k) if tuple(ctx[:16]) in drafting
                        else np.empty(0, np.int32)))
    eng = _engine(params, _spec_cfg("ngram", max_slots=8))
    try:
        with eng._cond:
            hs = [eng.submit(p, max_new=6) for p in prompts]
        got = [h.result(timeout=60) for h in hs]
        st = eng.stats()
    finally:
        eng.shutdown()
    assert got == _jax_streams(jparams, [(p, 6) for p in prompts])
    if n_drafting == 1:
        assert st["spec_passes"] == 0 and st["spec_drafted_tokens"] == 0
    else:
        assert st["spec_passes"] > 0
        assert all(h.spec_drafted > 0 for h in hs[:2])
        assert hs[2].spec_drafted == 0


def test_spec_verify_failure_recovers_pool_and_prefix(model):
    """A failed verify step takes the plain step's recovery path: the
    in-flight request fails, the pool is zeroed, the prefix index
    cleared, and the engine keeps serving."""
    jparams, params = model
    want = _jax_streams(jparams, [(REP, 4)])[0]
    eng = _engine(params, _spec_cfg("ngram"))
    try:
        assert eng.generate(REP, max_new=4, timeout=60) == want
        real_verify = eng._verify
        boom = {"armed": True}

        def failing_verify(*a):
            if boom.pop("armed", False):
                raise RuntimeError("injected verify failure")
            return real_verify(*a)

        eng._verify = failing_verify
        bad = eng.submit(REP, max_new=8)
        with pytest.raises(RuntimeError, match="injected verify"):
            bad.result(timeout=60)
        st = eng.stats()
        assert st["prefix_cached_blocks"] == 0
        assert st["blocks_free"] == st["blocks_total"]
        assert not eng.pool.k.any()
        assert eng.generate(REP, max_new=4, timeout=60) == want
    finally:
        eng.shutdown()


def test_speculation_unsupported_is_typed_and_construction_time(model):
    _, params = model
    with pytest.raises(SpeculationUnsupported, match="paged engine"):
        _engine(params, EngineConfig(max_slots=2, paged=False,
                                     speculate="ngram"))
    for depth in (0, TCFG.n_layers):
        with pytest.raises(SpeculationUnsupported):
            _engine(params, _spec_cfg("self", draft_layers=depth))
    with pytest.raises(ValueError, match="speculate must be"):
        _engine(params, EngineConfig(max_slots=2, speculate="medusa"))
    with pytest.raises(ValueError, match="speculate_k"):
        _engine(params, _spec_cfg("ngram", speculate_k=0))
    # the value is checked before the engine kind, the kind before k
    with pytest.raises(ValueError, match="speculate must be") as e:
        _engine(params, EngineConfig(paged=False, speculate="medusa",
                                     speculate_k=0))
    assert not isinstance(e.value, SpeculationUnsupported)
    with pytest.raises(SpeculationUnsupported):
        _engine(params, EngineConfig(paged=False, speculate="self",
                                     speculate_k=0))
    assert issubclass(SpeculationUnsupported, ValueError)


def test_temperature_rows_fall_back_transparently(model):
    """Sampled rows ride the verify pass one token a step and never draft,
    while greedy neighbours in the same batch stay exact."""
    jparams, params = model
    rev = list(reversed(REP))
    eng = _engine(params, _spec_cfg("ngram"))
    try:
        with eng._cond:
            greedy1 = eng.submit(REP, max_new=8)
            sampled = eng.submit([9, 8, 7, 6, 5], max_new=8,
                                 temperature=0.9, seed=3)
            greedy2 = eng.submit(rev, max_new=8)
        got = [greedy1.result(timeout=60), greedy2.result(timeout=60)]
        out = sampled.result(timeout=60)
        st = eng.stats()
    finally:
        eng.shutdown()
    assert got == _jax_streams(jparams, [(REP, 8), (rev, 8)])
    assert len(out) == 8 and all(0 <= t < TCFG.vocab_size for t in out)
    assert sampled.spec_drafted == 0 and sampled.spec_accepted == 0
    assert greedy1.spec_drafted > 0
    _assert_no_block_leak(st)


def test_spec_metrics_and_per_request_accounting(model):
    """stats() and metrics_snapshot expose the accept rate and tokens per
    step; each request carries its own accounting and token stamps; a
    plain paged engine reads exactly one token per step."""
    jparams, params = model
    want = _jax_streams(jparams, [(REP, 8)])[0]
    eng = _engine(params, _spec_cfg("ngram"), labels={"replica": "r0"})
    plain = _engine(params, EngineConfig(max_slots=4, kv_block_size=8,
                                         prefill_chunk=16))
    try:
        req = eng.submit(REP, max_new=8)
        assert req.result(timeout=60) == want
        assert plain.generate(REP, max_new=8, timeout=60) == want
        assert 0 < req.spec_accepted <= req.spec_drafted
        assert len(req.token_times) == 8
        assert req.token_times == sorted(req.token_times)
        assert req.token_times[0] == req.first_token_s
        assert isinstance(req.created_wall, float)
        st, pst = eng.stats(), plain.stats()
        assert st["spec_accept_rate"] == \
            st["spec_accepted_tokens"] / st["spec_drafted_tokens"] > 0.0
        assert st["tokens_per_step"] > 1.0
        assert st["mesh_devices"] == 1 and st["tp_shards"] == 1
        assert pst["tokens_per_step"] == 1.0 and pst["row_steps"] == 7
        assert pst["speculate"] is None and pst["spec_passes"] == 0
        series = {name: values for name, _, _, values in metrics_snapshot()}
        key = (("engine", eng.name), ("replica", "r0"))
        pkey = (("engine", plain.name),)
        assert series["ray_tpu_inference_spec_accept_rate"][key] == \
            st["spec_accept_rate"]
        assert series["ray_tpu_inference_spec_accepted_tokens_total"][key] \
            == st["spec_accepted_tokens"] > 0
        assert series["ray_tpu_inference_tokens_per_step"][key] > 1.0
        assert series["ray_tpu_inference_tokens_per_step"][pkey] == 1.0
        assert series["ray_tpu_inference_mesh_devices"][pkey] == 1.0
    finally:
        eng.shutdown()
        plain.shutdown()
