"""The port's training slice against the JAX package on the CPU.

The same numpy inputs (from a seed) go through ``ray_tpu`` and through
``ray_tpu_torch``:

- the flash backward: the port's plain version (what its CUDA kernels are
  held against on the card) against ``jax.vjp`` of the JAX package's
  ``flash_attention``, which on 128-aligned tiles runs the Pallas backward
  in interpret mode and on ragged shapes its plain scan;
- autograd through the port's flash op against ``jax.grad``;
- ``loss_fn`` and its grads on ``GPTConfig.tiny`` with flash attention;
- a five-step ``make_train_step`` trajectory with AdamW against optax;
- the remat policies, and how often each runs the flash forward.

Tolerances, all in f32 unless noted: attention grads atol = rtol = 1e-4
(f32 sums over a few hundred terms, in another order); the bf16 case at
tests/test_ops.py's grad bounds (mean abs < 1e-3, atol = rtol = 0.1);
model grads atol 1e-5, rtol 1e-4; the trajectory's loss and grad_norm
within rel 1e-4 at every step and its params within atol 1e-5 after five
steps; remat against no remat within atol 1e-6 (the same ops recomputed,
bit-equal in practice)."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.train.step import make_train_step as jmake_train_step
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.train import adamw, make_train_step

# the packages re-export functions under their modules' names, so the
# modules themselves come from importlib
jax_flash = importlib.import_module("ray_tpu.ops.flash_attention")
port_flash = importlib.import_module("ray_tpu_torch.ops.flash_attention")

TOL = dict(atol=1e-4, rtol=1e-4)
FLASH = dict(attn_impl="flash", attn_block_q=128, attn_block_k=128)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in shapes)


def _port_backward(q, k, v, do, causal, dtype):
    """The port's plain forward, then its plain backward, blocks 128."""
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in (q, k, v, do))
    out, lse = port_flash.flash_attention_with_lse(
        q, k, v, causal=causal, block_q=128, block_k=128)
    return [g.float().numpy() for g in
            port_flash.flash_attention_backward_reference(
                q, k, v, out, lse, do, causal=causal, block_q=128,
                block_k=128)]


# ------------------------------------------------------ attention backward

# name -> (q_len, kv_len, causal, dtype), all [1, 2, len, 64] with blocks
# 128.  The aligned cases run the Pallas backward in interpret mode; the
# ragged and cross-length ones are off its tiles and take JAX's plain scan.
CASES = {
    "causal": (256, 256, True, "float32"),
    "noncausal": (256, 256, False, "float32"),
    "ragged96": (96, 96, True, "float32"),
    "cross64x192": (64, 192, True, "float32"),
    "bf16": (256, 256, True, "bfloat16"),
}


@pytest.fixture(scope="module")
def attention_cases():
    """Each case's numpy q, k, v, do and the JAX package's (dq, dk, dv)
    for cotangent do, as f32 numpy.  One jit for all of them: compiling
    the Pallas interpreter once per case costs more than the tests."""
    inputs = {}
    for i, (name, (sq, skv, _, _)) in enumerate(CASES.items()):
        inputs[name] = _arrays(10 + i, (1, 2, sq, 64), (1, 2, skv, 64),
                               (1, 2, skv, 64), (1, 2, sq, 64))

    def grads(arrays):
        out = {}
        for name, (_, _, causal, dtype) in CASES.items():
            q, k, v, do = (a.astype(dtype) for a in arrays[name])
            _, vjp = jax.vjp(functools.partial(
                jax_flash.flash_attention, causal=causal, block_q=128,
                block_k=128), q, k, v)
            out[name] = vjp(do)
        return out

    want = jax.jit(grads)(jax.tree_util.tree_map(jnp.asarray, inputs))
    return {name: (inputs[name], [np.asarray(g, np.float32)
                                  for g in want[name]])
            for name in CASES}


@pytest.mark.parametrize("name", ["causal", "noncausal", "ragged96",
                                  "cross64x192"])
def test_backward_reference_matches_jax(attention_cases, name):
    (q, k, v, do), want = attention_cases[name]
    got = _port_backward(q, k, v, do, CASES[name][2], torch.float32)
    for d, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"d{d}")


def test_backward_reference_bf16_matches_pallas(attention_cases):
    (q, k, v, do), want = attention_cases["bf16"]
    got = _port_backward(q, k, v, do, True, torch.bfloat16)
    for g, w in zip(got, want):
        assert np.mean(np.abs(g - w)) < 1e-3
        np.testing.assert_allclose(g, w, atol=0.1, rtol=0.1)


@pytest.mark.parametrize("name", ["causal", "noncausal"])
def test_autograd_through_flash_matches_jax_grad(attention_cases, name):
    """d/dq,k,v of sum(out * do) through the port's op equals the JAX
    vjp with cotangent do."""
    (q, k, v, do), want = attention_cases[name]
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = port_flash.flash_attention(qt, kt, vt, causal=CASES[name][2],
                                     block_q=128, block_k=128)
    (out * torch.from_numpy(do)).sum().backward()
    for d, t, w in zip("qkv", (qt, kt, vt), want):
        np.testing.assert_allclose(t.grad.numpy(), w, **TOL,
                                   err_msg=f"d{d}")


def test_backward_reference_rows_without_keys_get_zero_grads():
    """Causal with q_len > kv_len: the first rows see no key (lse -inf).
    Their output and dq are 0 and nothing turns NaN; the JAX kernel
    writes a finite -1e30 lse there instead, so this is the port's own
    convention."""
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(
        14, (1, 2, 96, 64), (1, 2, 64, 64), (1, 2, 64, 64), (1, 2, 96, 64)))
    out, lse = port_flash.flash_attention_with_lse(q, k, v, block_q=32,
                                                   block_k=32)
    assert torch.isinf(lse[:, :, :32]).all()
    dq, dk, dv = port_flash.flash_attention_backward_reference(
        q, k, v, out, lse, do, block_q=32, block_k=32)
    assert all(torch.isfinite(g).all() for g in (dq, dk, dv))
    assert (dq[:, :, :32] == 0).all() and (dq[:, :, 32:] != 0).any()


def test_backward_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(
        15, *[(1, 1, 64, 64)] * 4))
    lse = delta = torch.zeros(1, 1, 64)
    for launch in (port_flash._launch_bwd_kv, port_flash._launch_bwd_dq):
        with pytest.raises(ValueError, match="CUDA"):
            launch(q, k, v, do, lse, delta, 0.125, True)


def test_backward_kernel_inputs_copy_only_what_the_kernels_cannot_read():
    """Both dtypes go to the tensor-core kernels' 16-byte copies
    (``_aligned``)."""
    b, s, h, hd = 2, 16, 2, 64
    for dtype in (torch.bfloat16, torch.float32):
        # the model's q, k, v views of one qkv projection and the
        # cotangent autograd hands over, a transposed [b, s, h, d] view
        qkv = torch.zeros((b, s, 3 * h * hd), dtype=dtype)
        q, k, v = (t.reshape(b, s, h, hd).transpose(1, 2)
                   for t in qkv.split(h * hd, dim=-1))
        do = torch.zeros((b, s, h, hd), dtype=dtype).transpose(1, 2)
        got = port_flash._bwd_inputs(q, k, v, do)
        assert all(g is t for g, t in zip(got, (q, k, v, do)))
        # a contiguous do at a 1-element offset, and one whose head dim
        # is not contiguous
        shifted = torch.arange(b * h * s * hd + 1, dtype=dtype)[1:].view(
            b, h, s, hd)
        strided = torch.arange(b * h * s * hd, dtype=dtype).view(
            b, h, hd, s).transpose(-1, -2)
        for bad in (shifted, strided):
            got = port_flash._bwd_inputs(q, k, v, bad)
            assert all(g is t for g, t in zip(got[:3], (q, k, v)))
            assert torch.equal(got[3], bad)
            assert got[3].stride(-1) == 1
            assert got[3] is not bad
            assert port_flash._cp_async_aligned(got[3])


# ------------------------------------------------------------- the model

@pytest.fixture(scope="module")
def model():
    """Both packages' tiny flash configs and one set of weights drawn with
    numpy (N(0, 0.02), norm scales 1), in the shared stacked layout."""
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32, **FLASH)
    tcfg = tgpt.GPTConfig.tiny(dtype=torch.float32, **FLASH)
    rng = np.random.default_rng(0)

    def draw(name, t):
        if "scale" in name:
            return np.ones(t.shape, np.float32)
        return (rng.standard_normal(t.shape) * 0.02).astype(np.float32)

    shapes = tgpt.init_params(tcfg, 0, device="cpu")
    tree = {k: ({n: draw(n, t) for n, t in v.items()}
                if isinstance(v, dict) else draw(k, v))
            for k, v in shapes.items()}
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, tree


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def _port_value_and_grad(tree, toks, tcfg):
    params = convert.params_from_numpy(tree, device="cpu")
    leaves = jax.tree_util.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = tgpt.loss_fn(params, {"tokens": torch.from_numpy(toks).long()},
                        tcfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), [g.numpy() for g in grads]


@pytest.fixture(scope="module")
def jax_value_and_grads(model):
    """JAX's loss and grads at s128 (the Pallas forward and backward,
    blocks 128) and s40 (the Pallas forward at blocks of 40 and the
    plain-scan backward), in one jit."""
    jcfg, _, jparams, _ = model
    toks = {s: _tokens(s, 2, s + 1, jcfg.vocab_size) for s in (128, 40)}
    vg = jax.value_and_grad(functools.partial(jgpt.loss_fn, cfg=jcfg))
    out = jax.jit(lambda p, t: {s: vg(p, {"tokens": t[s]}) for s in t})(
        jparams, jax.tree_util.tree_map(jnp.asarray, toks))
    return {s: (toks[s], float(out[s][0]),
                [np.asarray(g) for g in jax.tree_util.tree_leaves(out[s][1])])
            for s in toks}


@pytest.mark.parametrize("seq", [128, 40], ids=["s128", "s40"])
def test_loss_and_grads_match_jax(model, jax_value_and_grads, seq):
    _, tcfg, _, tree = model
    toks, want_loss, want = jax_value_and_grads[seq]
    loss, grads = _port_value_and_grad(tree, toks, tcfg)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert len(grads) == len(want) == 15
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4)


def test_train_step_trajectory_matches_optax(model):
    """Five steps of AdamW(3e-4, weight_decay=0.1) on one repeated batch
    at b2 s128, the configuration of bench.py cut to the tiny model."""
    jcfg, tcfg, jparams, tree = model
    toks = _tokens(5, 2, 129, jcfg.vocab_size)

    j_init, j_step = jmake_train_step(
        lambda p, b: jgpt.loss_fn(p, b, jcfg),
        optax.adamw(3e-4, weight_decay=0.1))
    jstate = j_init(jparams)
    jbatch = {"tokens": jnp.asarray(toks)}

    t_init, t_step = make_train_step(
        lambda p, b: tgpt.loss_fn(p, b, tcfg), adamw(3e-4, weight_decay=0.1))
    state = t_init(convert.params_from_numpy(tree, device="cpu"))
    batch = {"tokens": torch.from_numpy(toks).long()}

    for i in range(5):
        jstate, jm = j_step(jstate, jbatch)
        state, m = t_step(state, batch)
        assert m["loss"].dim() == 0 and m["grad_norm"].dim() == 0
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       rtol=1e-4, err_msg=f"step {i} {key}")
    assert int(state.step) == int(jstate.step) == 5
    got = jax.tree_util.tree_leaves(convert.params_to_numpy(state.params))
    want = jax.tree_util.tree_leaves(jstate.params)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def no_remat_grads(model):
    _, tcfg, _, tree = model
    toks = _tokens(21, 2, 129, tcfg.vocab_size)
    return toks, _port_value_and_grad(tree, toks, tcfg)


# (remat, remat_policy, flash forwards per step in units of n_layers)
@pytest.mark.parametrize("remat,policy,per_layer", [
    (False, None, 1), (True, None, 2), (True, "dots", 2),
    (True, "dots_flash", 1)], ids=["off", "full", "dots", "dots_flash"])
def test_remat_policies_match_no_remat(model, no_remat_grads, monkeypatch,
                                       remat, policy, per_layer):
    """Each policy gives remat=False's grads.  On the CPU the flash op
    runs its plain versions; counting them shows what the policy saves:
    the forward runs 2L times under full remat and "dots" (recomputed in
    the backward) and L times under "dots_flash" and without remat, as
    the JAX package's kernel does on the TPU; the backward L times."""
    _, tcfg, _, tree = model
    toks, (want_loss, want) = no_remat_grads
    calls = {"fwd": 0, "bwd": 0}

    def counted(fn, key):
        def run(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(port_flash, "flash_attention_reference",
                        counted(port_flash.flash_attention_reference, "fwd"))
    monkeypatch.setattr(
        port_flash, "flash_attention_backward_reference",
        counted(port_flash.flash_attention_backward_reference, "bwd"))
    cfg = tgpt.GPTConfig.tiny(dtype=torch.float32, remat=remat,
                              remat_policy=policy, **FLASH)
    loss, grads = _port_value_and_grad(tree, toks, cfg)
    assert calls == {"fwd": per_layer * cfg.n_layers, "bwd": cfg.n_layers}
    assert loss == pytest.approx(want_loss, abs=1e-6)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)


def test_init_fn_leaves_callers_params_untouched(model):
    _, tcfg, _, tree = model
    params = convert.params_from_numpy(tree, device="cpu")
    before = convert.params_to_numpy(params)
    init_fn, step_fn = make_train_step(
        lambda p, b: tgpt.loss_fn(p, b, tcfg), adamw(1e-2))
    state = init_fn(params)
    toks = torch.from_numpy(_tokens(3, 2, 33, tcfg.vocab_size)).long()
    state, _ = step_fn(state, {"tokens": toks})
    after = convert.params_to_numpy(params)
    for a, b in zip(jax.tree_util.tree_leaves(before),
                    jax.tree_util.tree_leaves(after)):
        assert a.tobytes() == b.tobytes()
    assert not any(t.requires_grad for t in jax.tree_util.tree_leaves(params))
    moved = convert.params_to_numpy(state.params)["wte"]
    assert not np.array_equal(moved, before["wte"])


def test_make_train_step_refuses_a_mesh():
    """make_train_step takes a mesh now (tests/test_torch_port_parallel*
    hold it to the JAX package), and so does the 1F1B step
    (tests/test_torch_port_pipeline_gpt.py); what still raises is a 1F1B
    schedule with fewer microbatches than stages, as the JAX package's
    ``build_1f1b_schedule`` refuses it, before any collective."""
    from types import SimpleNamespace

    from ray_tpu_torch.train.step import train_step_1f1b

    pp4 = SimpleNamespace(mesh_dim_names=("pp",), shape=(4,))
    with pytest.raises(ValueError, match="1F1B needs microbatches"):
        train_step_1f1b(tgpt.GPTConfig.tiny(pp_microbatches=2), pp4,
                        batch_n=8, seq=16)
