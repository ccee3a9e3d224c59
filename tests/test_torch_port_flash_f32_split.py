"""The f32 flash forward's arithmetic on Hopper's tensor cores, written
out in plain torch on the CPU and held against the JAX package.

``csrc/flash_fwd.cu``'s f32 route (``tf32x3::fwd``) splits every f32
operand x into hi = rna(x) and lo = rna(x - hi), TF32 values rounded to
nearest with ties away from zero (``cvt.rna.tf32.f32``), and takes each
product as lo*hi + hi*lo + hi*hi with f32 accumulation, for S = Q K^T
and for O += P V.  The kernel itself runs only on the card; here the same
arithmetic (its tiles, its online softmax in base 2, its split of the
probabilities) goes through torch in f32 on the same numpy inputs as the
JAX package's Pallas forward (interpret mode) and ``mha_reference``.
Tolerance: 1e-4 abs on out and on lse (rows that see a key), the f32
route's bound on the card."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_tf32 import rna_tf32, split, split_attention

jax_flash = importlib.import_module("ray_tpu.ops.flash_attention")
jax_attention = importlib.import_module("ray_tpu.ops.attention")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-4
SERVING = (1, 12, 1024, 1024, 64)   # b, h, q_len, kv_len, d: the f32 prefill

# (b, h, q_len, kv_len, d, block_q, block_k): tests/test_torch_port_ops.py's
# FLASH_CASES at d 64, then d 128 and 256
PALLAS_CASES = [
    (2, 4, 256, 256, 64, 128, 128),
    (1, 2, 128, 384, 64, 128, 128),
    (1, 2, 64, 128, 64, 32, 32),
    (1, 2, 200, 200, 64, 128, 128),
    (1, 1, 96, 96, 64, 32, 64),
    (1, 2, 128, 192, 128, 64, 64),
    (1, 1, 64, 100, 256, 32, 32),
]


def _inputs(seed, b, h, sq, skv, d, qk_scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32) * qk_scale
    k = rng.standard_normal((b, h, skv, d)).astype(np.float32) * qk_scale
    v = rng.standard_normal((b, h, skv, d)).astype(np.float32)
    return q, k, v


def _jax_reference(q, k, v, causal):
    """mha_reference's out and the lse of its masked logits, both JAX."""
    out = jax_attention.mha_reference(q, k, v, causal=causal)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
    sq, sk = s.shape[-2:]
    if causal:
        s = jnp.where(jnp.arange(sk)[None, :]
                      > jnp.arange(sq)[:, None] + (sk - sq), -jnp.inf, s)
    return out, jax.nn.logsumexp(s, axis=-1)


@pytest.fixture(scope="module")
def jax_refs():
    """Every JAX reference of this file from ONE jit (compiling the
    Pallas interpreter once per case would cost more than the tests):
    {key: (inputs, out, lse)}."""
    cases = {}
    for i, (b, h, sq, skv, d, bq, bk) in enumerate(PALLAS_CASES):
        for causal in (True, False):
            cases[("pallas", i, causal)] = (
                _inputs(10 + i, b, h, sq, skv, d), causal, (bq, bk))
    for qk_scale in (1.0, 4.0):
        cases[("mha", qk_scale)] = (
            _inputs(30, *SERVING, qk_scale=qk_scale), True, None)

    def refs(arrays):
        out = {}
        for key, (_, causal, blocks) in cases.items():
            q, k, v = arrays[key]
            if blocks is None:
                out[key] = _jax_reference(q, k, v, causal)
            else:
                o, lse = jax_flash.flash_attention_with_lse(
                    q, k, v, causal=causal, block_q=blocks[0],
                    block_k=blocks[1])
                # the Pallas lse is [bh, sq, 128] broadcast over lanes
                out[key] = (o, lse[..., 0].reshape(q.shape[:3]))
        return out

    got = jax.jit(refs)({key: tuple(jnp.asarray(a) for a in c[0])
                         for key, c in cases.items()})
    return {key: (cases[key][0], cases[key][1], np.asarray(o),
                  np.asarray(lse)) for key, (o, lse) in got.items()}


def _held(inputs, causal, want_o, want_lse):
    q, k, v = (torch.from_numpy(a) for a in inputs)
    out, lse = split_attention(q, k, v, causal)
    np.testing.assert_allclose(out.numpy(), want_o, atol=ATOL, rtol=0)
    live = np.isfinite(want_lse) & (want_lse > -1e29)
    assert np.array_equal(np.isfinite(lse.numpy()), live)
    np.testing.assert_allclose(lse.numpy()[live], want_lse[live], atol=ATOL,
                               rtol=0)
    return out, lse


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", range(len(PALLAS_CASES)),
                         ids=lambda i: "q{}kv{}d{}".format(
                             *PALLAS_CASES[i][2:5]))
def test_split_tf32_forward_matches_pallas(jax_refs, case, causal):
    _held(*jax_refs[("pallas", case, causal)])


@pytest.mark.parametrize("qk_scale", [1.0, 4.0], ids=["unit", "qk_x4"])
def test_split_tf32_forward_matches_mha_reference_at_serving_shape(
        jax_refs, qk_scale):
    inputs, causal, want_o, want_lse = jax_refs[("mha", qk_scale)]
    _held(inputs, causal, want_o, want_lse)
    if qk_scale == 4.0:
        q, k = inputs[0].astype(np.float64), inputs[1].astype(np.float64)
        reach = np.abs(q[0, :2] @ k[0, :2].transpose(0, 2, 1)).max() / 8
        assert reach > 30   # the logits reach well past +-30


def test_one_tf32_product_errs_8x_more_than_the_split():
    # against float64 attention at the serving shape: one TF32 product
    # keeps ~3 decimal digits of each operand, the split ~6
    q, k, v = _inputs(31, *SERVING)
    q64, k64, v64 = (torch.from_numpy(a).double() for a in (q, k, v))
    s = (q64 @ k64.transpose(-1, -2)) * 64 ** -0.5
    s = s.masked_fill(torch.ones(1024, 1024, dtype=torch.bool).triu(1),
                      float("-inf"))
    want = torch.softmax(s, dim=-1) @ v64
    errs = {}
    for products in (1, 3):
        out, _ = split_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 True, products)
        errs[products] = (out.double() - want).abs().max().item()
    assert errs[3] < ATOL / 10
    assert errs[1] >= 8 * errs[3], errs


def _rna_float64(x: np.ndarray) -> np.ndarray:
    """Round each f32 value's significand to 11 bits (TF32's 10 stored
    ones), ties away from zero, in float64 arithmetic: |x| = f 2^e with
    f in [0.5, 1), so floor(|f| 2^11 + 1/2) 2^(e-11)."""
    f, e = np.frexp(x.astype(np.float64))
    mag = np.floor(np.abs(f) * 2.0 ** 11 + 0.5)
    return (np.sign(f) * np.ldexp(mag, e - 11)).astype(np.float32)


def test_rna_tf32_matches_float64_rounding_on_edge_values():
    ulp = 2.0 ** -10                     # TF32's spacing in [1, 2)
    base = [1.0, 1.0 + ulp / 2,          # a tie: away from zero, up
            1.0 + 3 * ulp / 2,           # a tie between two odd steps
            1.0 + ulp / 2 - 2.0 ** -23,  # just below a tie: down
            1.0 + ulp / 2 + 2.0 ** -23,  # just above: up
            2.0 - 2.0 ** -23,            # below a power of two: carries
            2.0 - ulp / 2, 2.0 - ulp,    # rounds up to 2, stays
            0.5 - 2.0 ** -25, 0.75, 3.0 + 2.0 ** -9,
            2.0 ** -126, 2.0 ** -100 * (1 + ulp / 2), 2.0 ** 100 * 1.5,
            np.pi, 1e-3, 12345.678, 0.0]
    rng = np.random.default_rng(7)
    x = np.concatenate([base, rng.standard_normal(4096)
                        * 10.0 ** rng.uniform(-20, 20, 4096)]).astype(
                            np.float32)
    x = np.concatenate([x, -x])          # negatives mirror: magnitude
    got = rna_tf32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _rna_float64(x))
    assert got[1] == np.float32(1.0 + ulp) and got[3] == 1.0
    assert got[2] == np.float32(1.0 + 2 * ulp) and got[5] == 2.0
    # the split: x - hi is exact in f32, and hi + lo is x within 2^-22 |x|
    t = torch.from_numpy(x)
    hi, lo = split(t)
    exact = x.astype(np.float64) - hi.numpy().astype(np.float64)
    np.testing.assert_array_equal((t - hi).numpy().astype(np.float64), exact)
    resid = np.abs(exact - lo.numpy().astype(np.float64))
    assert (resid <= 2.0 ** -22 * np.abs(x.astype(np.float64))).all()
    assert ((hi.numpy().view(np.uint32) & 0x1FFF) == 0).all()
    assert ((lo.numpy().view(np.uint32) & 0x1FFF) == 0).all()
