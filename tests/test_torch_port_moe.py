"""The port's mixture-of-experts GPT against the JAX package on the CPU.

The same numpy inputs (from a seed) go through ``ray_tpu`` and through
``ray_tpu_torch``, in f32 on ``GPTConfig.tiny_moe`` (4 experts, top-2):

- ``_moe_mlp`` at capacity factors 0.5 (capacity binds: tokens are
  dropped), 1.25 and 4.0, top-1 and top-2: output and aux loss;
- the config's validation, the MoE params' leaf shapes and the bridge;
- ``forward(return_aux=True)``, ``loss_fn`` and its grads, and the remat
  policies against no remat;
- a three-step ``make_train_step`` trajectory against optax's AdamW, with
  the router's top-k choices held equal at every step, so that a
  near-tie flip reads as a flip and not as a tolerance miss;
- the chunk-prefill and verify step bodies against JAX's on one pool at
  capacity factor 0.5, where routing the pad and dead lanes as JAX does
  decides which tokens drop;
- the paged engine and both speculating engines, greedy token-exact
  against JAX's ``gpt.generate`` at capacity factor 4.0 (capacity never
  binds, so per-window routing equals the full forward's), and the slot
  path's construction-time ``MoEDecodeUnsupported``.

Tolerances: ``_moe_mlp`` atol = rtol = 1e-5; the model's loss rtol 1e-5
and grads atol 1e-5, rtol 1e-4 (tests/test_torch_port_train.py's
bounds); the trajectory's loss and grad_norm rel 1e-4 and its params
atol 1e-5, save the few elements whose nonzero gradient fell below
AdamW's eps at some step (at most 1e-4 of them), held to 2 lr a step;
remat against
no remat atol 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.inference import decode as jdecode
from ray_tpu.inference.decode import MoEDecodeUnsupported as JMoEUnsupported
from ray_tpu.models import gpt as jgpt
from ray_tpu.parallel.sharding import DEFAULT_LLM_RULES
from ray_tpu.train.step import make_train_step as jmake_train_step
from ray_tpu_torch.inference import (EngineConfig, InferenceEngine,
                                     MoEDecodeUnsupported,
                                     make_chunk_prefill_fn, make_decode_step,
                                     make_spec_verify_step)
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.train import adamw, make_train_step

MLP_TOL = dict(atol=1e-5, rtol=1e-5)
# (capacity_factor, expert_top_k) of the _moe_mlp cases
ROUTING = [(0.5, 1), (0.5, 2), (1.25, 1), (1.25, 2), (4.0, 1), (4.0, 2)]
Y_SHAPE = (3, 40, 64)              # [groups, tokens per group, d_model]


def _jcfg(**kw):
    return jgpt.GPTConfig.tiny_moe(**{"max_seq": 64, **kw})


def _tcfg(**kw):
    return tgpt.GPTConfig.tiny_moe(**{"max_seq": 64, **kw})


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


# ------------------------------------------------------------- _moe_mlp


@pytest.fixture(scope="module")
def mlp_cases():
    """One numpy input and layer for every routing case, and the JAX
    package's (out, aux) for each, all in one jit."""
    rng = np.random.default_rng(0)
    E, d, f = 4, 64, 128
    y = rng.standard_normal(Y_SHAPE).astype(np.float32)
    lp = {"w_router": rng.standard_normal((d, E)).astype(np.float32),
          "w_up": (rng.standard_normal((E, d, f)) * 0.1).astype(np.float32),
          "b_up": (rng.standard_normal((E, f)) * 0.1).astype(np.float32),
          "w_down": (rng.standard_normal((E, f, d)) * 0.1)
          .astype(np.float32),
          "b_down": (rng.standard_normal((E, d)) * 0.1).astype(np.float32)}

    def run(y, lp):
        return {case: jgpt._moe_mlp(
            y, lp, _jcfg(capacity_factor=case[0], expert_top_k=case[1]),
            None, DEFAULT_LLM_RULES) for case in ROUTING}

    want = jax.jit(run)(jnp.asarray(y),
                        jax.tree_util.tree_map(jnp.asarray, lp))
    return y, lp, {c: (np.asarray(o), float(a)) for c, (o, a) in want.items()}


def _routing(y, w_router, k):
    """The port's round-by-round expert choices, [k, G, n] (numpy)."""
    remaining = torch.softmax(y.float() @ w_router.float(), dim=-1)
    out = []
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)
        out.append(idx)
        remaining = remaining * (1.0 - (idx[..., None] == torch.arange(
            remaining.shape[-1])).float())
    return torch.stack(out).numpy()


@pytest.mark.parametrize("cf,k", ROUTING,
                         ids=[f"cf{c}-top{k}" for c, k in ROUTING])
def test_moe_mlp_matches_jax(mlp_cases, cf, k):
    y, lp, want = mlp_cases
    out, aux = tgpt._moe_mlp(
        torch.from_numpy(y), {n: torch.from_numpy(a) for n, a in lp.items()},
        _tcfg(capacity_factor=cf, expert_top_k=k))
    assert out.shape == Y_SHAPE and out.dtype == torch.float32
    assert aux.dim() == 0 and aux.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want[(cf, k)][0], **MLP_TOL)
    np.testing.assert_allclose(aux.item(), want[(cf, k)][1], **MLP_TOL)


def test_moe_mlp_drops_tokens_when_capacity_binds(mlp_cases):
    """At capacity factor 0.5 some tokens get no expert: their output is
    exactly 0 (the residual carries them), as in the JAX package."""
    y, lp, want = mlp_cases
    out, _ = tgpt._moe_mlp(
        torch.from_numpy(y), {n: torch.from_numpy(a) for n, a in lp.items()},
        _tcfg(capacity_factor=0.5, expert_top_k=1))
    dropped = (out == 0).all(dim=-1)
    assert 0 < int(dropped.sum()) < dropped.numel()
    assert np.array_equal(dropped.numpy(),
                          (want[(0.5, 1)][0] == 0).all(axis=-1))
    # top-1 at C = ceil(0.5 * 40 / 4) = 5 slots per expert and group
    choice = _routing(torch.from_numpy(y), torch.from_numpy(lp["w_router"]),
                      1)[0]
    kept = sum(min(5, int((choice[g] == e).sum()))
               for g in range(Y_SHAPE[0]) for e in range(4))
    assert int((~dropped).sum()) == kept


@pytest.mark.parametrize("kw,match", [
    (dict(expert_top_k=0), "expert_top_k"),
    (dict(expert_top_k=5), "expert_top_k"),
    (dict(capacity_factor=0.0), "capacity_factor"),
    (dict(capacity_factor=-1.0), "capacity_factor")])
def test_config_validation_matches_jax(kw, match):
    with pytest.raises(ValueError, match=match) as got:
        _tcfg(**kw)
    with pytest.raises(ValueError) as want:
        _jcfg(**kw)
    assert str(got.value) == str(want.value)


def test_tiny_moe_config():
    cfg = _tcfg()
    assert (cfg.n_experts, cfg.expert_top_k, cfg.dtype) == \
        (4, 2, torch.float32)
    assert _tcfg(n_experts=8).n_experts == 8
    assert tgpt.param_logical_axes(cfg) == jgpt.param_logical_axes(_jcfg())
    dense = tgpt.GPTConfig.tiny(tie_embeddings=False)
    assert tgpt.param_logical_axes(dense) == jgpt.param_logical_axes(
        jgpt.GPTConfig.tiny(tie_embeddings=False))


# ------------------------------------------------------------- the model


@pytest.fixture(scope="module")
def moe_model():
    """The JAX package's tiny_moe params (max_seq 64) and the same bytes
    in the port's numpy tree."""
    jparams = jax.jit(jgpt.init_params, static_argnums=0)(
        _jcfg(), jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, tree


def test_init_params_leaf_shapes_match_jax(moe_model):
    jparams, _ = moe_model
    params = tgpt.init_params(_tcfg(), 0, device="cpu")
    got = jax.tree_util.tree_map(lambda t: tuple(t.shape), params)
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    assert got == want
    L, E, d, f = 2, 4, 64, 128
    assert got["layers"]["w_router"] == (L, d, E)
    assert got["layers"]["w_up"] == (L, E, d, f)
    assert got["layers"]["w_down"] == (L, E, f, d)
    assert not params["layers"]["b_up"].any()
    assert not params["layers"]["b_down"].any()
    # the residual projection's std is 0.02 / sqrt(2 L)
    std = params["layers"]["w_down"].std().item()
    assert std == pytest.approx(0.02 / np.sqrt(2 * L), rel=0.05)
    assert torch.equal(tgpt.init_params(_tcfg(), 0, device="cpu")
                       ["layers"]["w_router"], params["layers"]["w_router"])


def test_bridge_round_trip_is_bit_exact(moe_model):
    _, tree = moe_model
    back = convert.params_to_numpy(convert.params_from_numpy(tree, "cpu"))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


class JaxReference:
    """JAX's forward logits and aux, its loss and grads, and the top-k
    expert choices of every layer, [L, k, G, n], at b2 s32 on one batch:
    one jit, called again with each step's params by the trajectory."""

    def __init__(self):
        cfg = _jcfg()
        self.toks = _tokens(1, 2, 33, cfg.vocab_size)
        self._seen = []
        orig = jgpt._moe_mlp

        def spy(y, lp, cfg, mesh, rules):
            remaining = jax.nn.softmax(jnp.einsum(
                "gnd,de->gne", y.astype(jnp.float32),
                lp["w_router"].astype(jnp.float32)), axis=-1)
            rounds = []
            for _ in range(cfg.expert_top_k):
                idx = jnp.argmax(remaining, axis=-1)
                rounds.append(idx)
                remaining = remaining * (1.0 - jax.nn.one_hot(
                    idx, cfg.n_experts, dtype=jnp.float32))
            jax.debug.callback(lambda r: self._seen.append(np.asarray(r)),
                               jnp.stack(rounds), ordered=True)
            return orig(y, lp, cfg, mesh, rules)

        def run(p, t):
            # runs while tracing only: the spy sees the forward's layers
            jgpt._moe_mlp = spy
            try:
                logits, aux = jgpt.forward(p, t[:, :-1], cfg,
                                           return_aux=True)
            finally:
                jgpt._moe_mlp = orig
            loss, grads = jax.value_and_grad(
                functools.partial(jgpt.loss_fn, cfg=cfg))(p, {"tokens": t})
            return logits, aux, loss, grads

        self._run = jax.jit(run)

    def __call__(self, jparams):
        self._seen.clear()
        logits, aux, loss, grads = jax.block_until_ready(
            self._run(jparams, jnp.asarray(self.toks)))
        jax.effects_barrier()
        return (np.asarray(logits), float(aux), float(loss),
                [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)],
                np.stack(self._seen))


@pytest.fixture(scope="module")
def jax_ref():
    return JaxReference()


@pytest.fixture(scope="module")
def jax_reference(moe_model, jax_ref):
    """``jax_ref`` at the initial params: (toks, logits, aux, loss,
    grads)."""
    return (jax_ref.toks,) + jax_ref(moe_model[0])[:4]


def _port_value_and_grad(tree, toks, cfg):
    params = convert.params_from_numpy(tree, device="cpu")
    leaves = jax.tree_util.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = tgpt.loss_fn(params, {"tokens": torch.from_numpy(toks).long()},
                        cfg)
    return loss.item(), [g.numpy() for g in torch.autograd.grad(loss,
                                                                 leaves)]


def test_forward_with_aux_matches_jax(moe_model, jax_reference):
    _, tree = moe_model
    toks, want_logits, want_aux, _, _ = jax_reference
    params = convert.params_from_numpy(tree, device="cpu")
    with torch.no_grad():
        logits, aux = tgpt.forward(params,
                                   torch.from_numpy(toks[:, :-1]).long(),
                                   _tcfg(), return_aux=True)
        plain = tgpt.forward(params, torch.from_numpy(toks[:, :-1]).long(),
                             _tcfg())
        _, aux_kv, (k, v) = tgpt.forward(
            params, torch.from_numpy(toks[:, :-1]).long(), _tcfg(),
            return_aux=True, return_kv=True)
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(aux.item(), want_aux, rtol=1e-5)
    assert torch.equal(plain, logits) and aux_kv.item() == aux.item()
    assert k.shape == v.shape == (2, 2, 4, 32, 16)


def test_dense_forward_aux_is_zero():
    cfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    params = tgpt.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(_tokens(2, 1, 8, cfg.vocab_size)).long()
    with torch.no_grad():
        logits, aux = tgpt.forward(params, toks, cfg, return_aux=True)
    assert aux == 0.0 and logits.shape == (1, 8, cfg.vocab_size)


def test_loss_and_grads_match_jax(moe_model, jax_reference):
    _, tree = moe_model
    toks, _, _, want_loss, want = jax_reference
    loss, grads = _port_value_and_grad(tree, toks, _tcfg())
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert len(grads) == len(want) == 16
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4)
    # the router learns through the gates and the aux loss
    names = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_leaves_with_path(tree)]
    assert np.abs(grads[names.index("['layers']['w_router']")]).max() > 0


@pytest.mark.parametrize("policy", [None, "dots", "dots_flash"],
                         ids=["full", "dots", "dots_flash"])
def test_remat_policies_match_no_remat(moe_model, jax_reference, policy):
    _, tree = moe_model
    toks = jax_reference[0]
    want_loss, want = _port_value_and_grad(tree, toks, _tcfg())
    loss, grads = _port_value_and_grad(
        tree, toks, _tcfg(remat=True, remat_policy=policy))
    assert loss == pytest.approx(want_loss, abs=1e-6)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)


def _port_choices(params, toks, cfg, monkeypatch):
    seen = []
    orig = tgpt._moe_mlp

    def spy(y, lp, cfg):
        seen.append(_routing(y, lp["w_router"], cfg.expert_top_k))
        return orig(y, lp, cfg)

    monkeypatch.setattr(tgpt, "_moe_mlp", spy)
    with torch.no_grad():
        tgpt.forward(params, torch.from_numpy(toks).long(), cfg)
    monkeypatch.setattr(tgpt, "_moe_mlp", orig)
    return np.stack(seen)


def test_train_step_trajectory_matches_optax(moe_model, jax_ref,
                                             monkeypatch):
    """Three steps of AdamW(3e-4, weight_decay=0.1) on one repeated batch
    at b2 s32; before every step both packages route the batch alike."""
    jparams, tree = moe_model
    jcfg, tcfg = _jcfg(), _tcfg()
    toks = jax_ref.toks

    j_init, j_step = jmake_train_step(
        lambda p, b: jgpt.loss_fn(p, b, jcfg),
        optax.adamw(3e-4, weight_decay=0.1))
    jstate = j_init(jparams)
    jbatch = {"tokens": jnp.asarray(toks)}

    t_init, t_step = make_train_step(
        lambda p, b: tgpt.loss_fn(p, b, tcfg), adamw(3e-4, weight_decay=0.1))
    state = t_init(convert.params_from_numpy(tree, device="cpu"))
    batch = {"tokens": torch.from_numpy(toks).long()}

    steps, lr, eps = 3, 3e-4, 1e-8
    noise = None           # elements whose gradient was ever in (0, eps)
    for i in range(steps):
        got = _port_choices(state.params, toks[:, :-1], tcfg, monkeypatch)
        *_, grads, want = jax_ref(jstate.params)
        assert got.shape == want.shape == (2, 2, 2, 32)
        assert np.array_equal(got, want), f"routing differs before step {i}"
        small = [(np.abs(g) < eps) & (g != 0) for g in grads]
        noise = small if noise is None else [
            a | b for a, b in zip(noise, small)]
        jstate, jm = j_step(jstate, jbatch)
        state, m = t_step(state, batch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       rtol=1e-4, err_msg=f"step {i} {key}")
    # AdamW moves an element by lr * g / (|g| + eps): where 0 < |g| < eps
    # (a gradient that cancels to f32 rounding noise) it scales that
    # noise by lr / eps, so those few elements are held only to the
    # most two trajectories can drift apart, 2 lr a step (a gradient of
    # exactly 0, as for wpe rows past the batch, moves nothing)
    got = jax.tree_util.tree_leaves(convert.params_to_numpy(state.params))
    want = jax.tree_util.tree_leaves(jstate.params)
    assert sum(int(n.sum()) for n in noise) <= 1e-4 * sum(
        n.size for n in noise)
    for g, w, n in zip(got, want, noise):
        diff = np.abs(g - np.asarray(w))
        assert diff[~n].max(initial=0) <= 1e-5
        assert diff[n].max(initial=0) <= 2 * lr * steps


# --------------------------------------------------------- step bodies

BS, T = 8, 8                 # block size, table width: S = 64 = max_seq
N_BLOCKS = 1 + 4 * T         # scratch block 0, then T blocks a row
TABLES = np.arange(1, N_BLOCKS).reshape(4, T)


@pytest.mark.parametrize("kind", ["chunk", "verify"])
def test_step_bodies_match_jax_where_capacity_binds(moe_model, kind):
    """At capacity factor 0.5 a step's token window drops tokens, so which
    lanes it routes changes what comes out: the chunk window's pad lanes
    and the verify window's dead lanes are routed as JAX routes them.
    Live lanes' logits and the pools (but the scratch block) within
    1e-4, the bound of tests/test_torch_port_spec.py's step bodies."""
    jparams, tree = moe_model
    jcfg, tcfg = _jcfg(capacity_factor=0.5), _tcfg(capacity_factor=0.5)
    params = convert.params_from_numpy(tree, device="cpu")
    rng = np.random.default_rng(3)
    kp, vp = (rng.standard_normal((2, N_BLOCKS, 4, BS, 16))
              .astype(np.float32) for _ in range(2))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    if kind == "chunk":
        # 11 prompt tokens at positions 21..31, then 5 pad lanes (token 0)
        C, start = 16, 21
        tokens = np.zeros(C, np.int64)
        tokens[:11] = rng.integers(1, tcfg.vocab_size, 11)
        live = np.arange(C) < 11
        jl, jk, jv = jdecode.make_chunk_prefill_fn(
            jcfg, chunk=C, block_size=BS, n_table=T)(
                jparams, jnp.asarray(kp), jnp.asarray(vp),
                jnp.asarray(TABLES[0], jnp.int32),
                jnp.asarray(tokens, jnp.int32), jnp.int32(start))
        logits = make_chunk_prefill_fn(tcfg, chunk=C, block_size=BS,
                                       n_table=T)(
            params, tk, tv, torch.from_numpy(TABLES[0]),
            torch.from_numpy(tokens), start)
    else:
        # row 0 all lanes live, row 1 two dead lanes, row 2 inactive,
        # row 3 lanes past S dead
        W = 5
        tokens = rng.integers(0, tcfg.vocab_size, (4, W))
        positions = np.array([13, 30, 5, 61])
        active = np.array([True, True, False, True])
        n_tokens = np.array([5, 3, 1, 5])
        live = (np.arange(W)[None] < n_tokens[:, None]) & active[:, None] \
            & (positions[:, None] + np.arange(W)[None] < T * BS)
        jl, jk, jv = jdecode.make_spec_verify_step(
            jcfg, width=W, block_size=BS, n_table=T)(
                jparams, jnp.asarray(kp), jnp.asarray(vp),
                jnp.asarray(TABLES, jnp.int32),
                jnp.asarray(tokens, jnp.int32),
                jnp.asarray(positions, jnp.int32), jnp.asarray(active),
                jnp.asarray(n_tokens, jnp.int32))
        logits = make_spec_verify_step(tcfg, width=W, block_size=BS,
                                       n_table=T)(
            params, tk, tv, torch.from_numpy(TABLES),
            torch.from_numpy(tokens), torch.from_numpy(positions),
            torch.from_numpy(active), torch.from_numpy(n_tokens))
    np.testing.assert_allclose(logits.numpy()[live], np.asarray(jl)[live],
                               atol=1e-4, rtol=0)
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy()[:, 1:],
                                   np.asarray(want)[:, 1:], atol=1e-4,
                                   rtol=0)


# ------------------------------------------------------------- serving

SERVE_J = _jcfg(capacity_factor=4.0)
SERVE_T = _tcfg(capacity_factor=4.0)
REP = [1, 2, 3, 4] * 6                    # the n-gram drafter's gold
_jax_generate = jax.jit(jgpt.generate,
                        static_argnames=("cfg", "max_new", "temperature"))


@pytest.fixture(scope="module")
def serve_model(moe_model):
    """The model's weights at capacity factor 4.0, and JAX ``generate``'s
    greedy continuations of the three 24-token prompts the engine tests
    serve (one batched call)."""
    jparams, tree = moe_model
    params = convert.params_from_numpy(tree, device="cpu")
    prompts = [REP, list(range(5, 29)), [3, 1, 4, 1, 5, 9, 2, 6] * 3]
    toks = np.asarray(_jax_generate(jparams, SERVE_J,
                                    jnp.asarray(prompts, jnp.int32),
                                    max_new=12, temperature=0.0))
    return params, {tuple(p): row[24:].tolist()
                    for p, row in zip(prompts, toks)}


@pytest.mark.parametrize("spec", [None, "ngram", "self"],
                         ids=["paged", "ngram", "self"])
def test_paged_engines_match_jax_generate(serve_model, spec):
    """Three requests at once through chunked prefill (chunks of 16) and
    paged decode, speculating or not: every stream equals JAX's."""
    params, want = serve_model
    kw = {}
    if spec is not None:
        kw = dict(speculate=spec, speculate_k=4)
        if spec == "self":
            kw["draft_layers"] = 1
    eng = InferenceEngine(params, SERVE_T, EngineConfig(
        max_slots=4, kv_block_size=8, prefill_chunk=16, **kw),
        device="cpu")
    try:
        handles = {p: eng.submit(list(p), max_new=12) for p in want}
        for p, h in handles.items():
            assert h.result(timeout=120) == want[p], p
        st = eng.stats()
        assert st["blocks_free"] + st["prefix_cached_blocks"] \
            == st["blocks_total"]
        if spec == "ngram":
            assert st["spec_accepted_tokens"] > 0
        if spec == "self":
            assert st["spec_drafted_tokens"] > 0
    finally:
        eng.shutdown()


def test_slot_path_raises_moe_decode_unsupported_at_construction(
        serve_model):
    params, _ = serve_model
    with pytest.raises(MoEDecodeUnsupported) as got:
        InferenceEngine(params, SERVE_T,
                        EngineConfig(max_slots=2, paged=False), device="cpu")
    msg = str(got.value)
    assert "slot" in msg and "paged" in msg
    assert issubclass(MoEDecodeUnsupported, NotImplementedError)
    with pytest.raises(MoEDecodeUnsupported):
        make_decode_step(SERVE_T)
    with pytest.raises(JMoEUnsupported):
        from ray_tpu.inference.decode import make_decode_step as jstep
        jstep(SERVE_J)
