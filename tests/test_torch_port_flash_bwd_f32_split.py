"""The f32 flash backward's arithmetic on Hopper's tensor cores, written
out in plain torch on the CPU and held against the JAX package.

``csrc/flash_bwd.cu``'s f32 routes (``tf32x3::bwd_kv``, ``tf32x3::bwd_dq``)
take every product as three TF32 products of split operands: S and dP in
k-steps of 8 dims, each step in a fresh sum, the probabilities
p = 2^((s scale - lse) log2 e), ds = p (dp - delta) scale, and dV, dK, dQ
summed tile by tile with p and ds split like any other operand.  The
kernels run only on the card; here the same arithmetic
(``_torch_port_tf32.split_backward``, after the split forward
``split_attention``) goes through torch in f32 on the same numpy inputs
as the JAX package's backward: ``jax.vjp`` of
``ray_tpu.ops.flash_attention.flash_attention``, whose Pallas kernels run
in interpret mode on the aligned cases and whose plain scan takes the
ragged ones.  Tolerance: 1e-4 (1 + max |ref|) on dq, dk and dv, the f32
routes' bound on the card."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_tf32 import split_attention, split_backward

jax_flash = importlib.import_module("ray_tpu.ops.flash_attention")
port_flash = importlib.import_module("ray_tpu_torch.ops.flash_attention")

# name: (b, h, q_len, kv_len, d, causal, q and k scale).  The JAX package
# takes its Pallas backward where both lengths are whole 128-row blocks,
# its plain scan elsewhere
CASES = {
    "q256kv256d64": (1, 2, 256, 256, 64, True, 1.0),
    "q256kv256d64_noncausal": (1, 2, 256, 256, 64, False, 1.0),
    "cross_q128kv384d64": (1, 2, 128, 384, 64, True, 1.0),
    "q128kv256d128": (1, 1, 128, 256, 128, True, 1.0),
    "q128kv128d256_noncausal": (1, 1, 128, 128, 256, False, 1.0),
    "q256kv256d64_qk_x4": (1, 2, 256, 256, 64, True, 4.0),
    "ragged_q96kv200d64": (1, 2, 96, 200, 64, True, 1.0),
    "ragged_q96kv200d64_noncausal": (1, 2, 96, 200, 64, False, 1.0),
    "ragged_q77kv77d64": (1, 2, 77, 77, 64, True, 1.0),
    "ragged_q130kv300d128": (1, 1, 130, 300, 128, True, 1.0),
    "ragged_q100kv130d256_noncausal": (1, 1, 100, 130, 256, False, 1.0),
}


def _inputs(seed, b, h, sq, skv, d, qk_scale):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32) * qk_scale
    k = rng.standard_normal((b, h, skv, d)).astype(np.float32) * qk_scale
    v = rng.standard_normal((b, h, skv, d)).astype(np.float32)
    do = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    return q, k, v, do


@pytest.fixture(scope="module")
def jax_grads():
    """{name: (numpy q, k, v, do; the JAX package's dq, dk, dv)} from ONE
    jit of every case's vjp (compiling the Pallas interpreter once per
    case would cost more than the tests)."""
    inputs = {name: _inputs(40 + i, *c[:5], c[6])
              for i, (name, c) in enumerate(CASES.items())}

    def grads(arrays):
        out = {}
        for name, (_, _, _, _, _, causal, _) in CASES.items():
            q, k, v, do = arrays[name]
            _, vjp = jax.vjp(functools.partial(
                jax_flash.flash_attention, causal=causal, block_q=128,
                block_k=128), q, k, v)
            out[name] = vjp(do)
        return out

    want = jax.jit(grads)(jax.tree_util.tree_map(jnp.asarray, inputs))
    return {name: (inputs[name], [np.asarray(g) for g in want[name]])
            for name in CASES}


def _split_grads(q, k, v, do, causal, score_products=3):
    q, k, v, do = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = split_attention(q, k, v, causal)
    return split_backward(q, k, v, out, lse, do, causal, score_products)


def _err(got, want):
    """(max abs error, the bound 1e-4 (1 + max |ref|))"""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max(), 1e-4 * (1 + np.abs(want).max())


@pytest.mark.parametrize("name", list(CASES))
def test_split_tf32_backward_matches_jax_vjp(jax_grads, name):
    (q, k, v, do), want = jax_grads[name]
    got = _split_grads(q, k, v, do, CASES[name][5])
    for d, g, w in zip("qkv", got, want):
        err, bound = _err(g.numpy(), w)
        assert err <= bound, f"d{d}: {err} > {bound}"
    if CASES[name][6] == 4.0:
        reach = np.abs(q[0, 0] @ k[0, 0].T).max() * q.shape[-1] ** -0.5
        assert reach > 30   # the logits reach well past +-30


def test_one_tf32_product_for_scores_errs_8x_more_than_the_split():
    """S and dP from one TF32 product each (about 1e-3 of each operand),
    every other product split, against float64 attention: dp - delta
    cancels, so the scores' error reaches every ds.  It misses the bound
    or errs at least 8x more than the split."""
    q, k, v, do = _inputs(50, 1, 2, 256, 256, 64, 4.0)
    q64, k64, v64, do64 = (torch.from_numpy(a).double() for a in (q, k, v, do))
    leaves = [t.clone().requires_grad_() for t in (q64, k64, v64)]
    s = (leaves[0] @ leaves[1].transpose(-1, -2)) * 64 ** -0.5
    s = s.masked_fill(torch.ones(256, 256, dtype=torch.bool).triu(1),
                      float("-inf"))
    want = torch.autograd.grad(torch.softmax(s, dim=-1) @ leaves[2], leaves,
                               do64)
    errs, bounds = {}, []
    for products in (1, 3):
        got = _split_grads(q, k, v, do, True, products)
        pairs = [_err(g.double().numpy(), w.numpy())
                 for g, w in zip(got, want)]
        errs[products] = max(e for e, _ in pairs)
        bounds = [b for _, b in pairs]
    assert errs[3] <= min(bounds), errs
    assert errs[1] > min(bounds) or errs[1] >= 8 * errs[3], errs


def test_rows_without_keys_get_zero_gradients():
    """Causal with q_len > kv_len: the first rows see no key (lse -inf).
    The split arithmetic chooses their p = 0, so their dq is 0 and
    nothing turns NaN; every gradient agrees with the port's plain f32
    backward within the bound."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(
        51, 1, 2, 200, 96, 64, 1.0))
    out, lse = split_attention(q, k, v, True)
    assert torch.isinf(lse[:, :, :104]).all()
    got = split_backward(q, k, v, out, lse, do, True)
    assert all(torch.isfinite(g).all() for g in got)
    assert (got[0][:, :, :104] == 0).all() and (got[0][:, :, 104:] != 0).any()
    want = port_flash.flash_attention_backward_reference(
        q, k, v, out, lse, do, block_q=64, block_k=64)
    for d, g, w in zip("qkv", got, want):
        err, bound = _err(g.numpy(), w.numpy())
        assert err <= bound, f"d{d}: {err} > {bound}"
