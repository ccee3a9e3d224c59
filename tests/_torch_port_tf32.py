"""The flash kernels' split-TF32 arithmetic (``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu``, their f32 routes) written out in plain torch f32,
shared by the port's split-TF32 tests.  Not a test module.

Each f32 operand x is split into hi = rna(x) and lo = rna(x - hi), TF32
values rounded to nearest with ties away from zero (``cvt.rna.tf32.f32``),
and each product is taken as lo*hi + hi*lo + hi*hi with f32
accumulation."""

import torch

LOG2E = 1.4426950408889634


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: on the int32 view, add half of
    the dropped 13 bits' range to the magnitude and clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    """x = hi + lo + e: hi = rna(x), lo = rna(x - hi); x - hi is exact."""
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def tf32_matmul(a, b, products: int = 3):
    """a @ b from TF32 operands with f32 accumulation: the split's three
    products, small terms first, or one product of the rounded operands."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    if products == 1:
        return a_hi @ b_hi
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def split_attention(q, k, v, causal: bool, products: int = 3):
    """The f32 route's forward on [b, h, s, d] f32 tensors: key tiles of
    64 (d 64) or 32 (d 128, 256), an online softmax in base 2 on the raw
    scores, weights 2^((s - m) scale log2 e), each tile's P V folded into
    O as alpha O + P V, the probabilities split before P V and summed
    unsplit into l.  Returns (out, lse); a row that sees no key gets out 0
    and lse -inf.  torch's f32 matmuls round their sums to nearest; the
    kernel's tensor core truncates them, which its fresh accumulators (one
    per k-step of S, one per tile of P V) keep to a few f32 roundings."""
    b, h, sq, d = q.shape
    kv_len = k.shape[2]
    scale = d ** -0.5
    sl2 = scale * LOG2E
    bk = 64 if d == 64 else 32
    rows = torch.arange(sq)[:, None] + (kv_len - sq)
    m = torch.full((b, h, sq), float("-inf"))
    l = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, d))
    for k0 in range(0, kv_len, bk):
        kb, vb = k[:, :, k0:k0 + bk], v[:, :, k0:k0 + bk]
        s = tf32_matmul(q, kb.transpose(-1, -2), products)
        if causal:
            cols = torch.arange(k0, k0 + kb.shape[2])[None, :]
            s = s.masked_fill(cols > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(m_new == float("-inf"), 0.0, m_new)
        alpha = torch.exp2((m - m_safe) * sl2)
        p = torch.exp2((s - m_safe[..., None]) * sl2)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + tf32_matmul(p, vb, products)
        m = m_new
    live = l > 0
    safe = torch.where(live, l, 1.0)
    out = torch.where(live[..., None], acc / safe[..., None], 0.0)
    lse = torch.where(live, m * scale + torch.log(safe), float("-inf"))
    return out, lse


def blocked_split_matmul(a, b, tile: int, products: int = 3):
    """a @ b ([..., m, K] @ [..., K, n]) as the backward kernels sum it:
    the contraction in k-steps of 8, each step's products (lo*hi, hi*lo,
    hi*hi, or hi*hi alone) added in turn to a fresh sum over ``tile``
    consecutive k (one k-step for the scores, a q or key tile for the
    gradients), the tiles' sums added in order with round-to-nearest."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    K = a.shape[-1]
    for t0 in range(0, K, tile):
        c = torch.zeros_like(out)
        for k0 in range(t0, min(t0 + tile, K), 8):
            ks = slice(k0, k0 + 8)
            if products == 3:
                c = c + a_lo[..., ks] @ b_hi[..., ks, :]
                c = c + a_hi[..., ks] @ b_lo[..., ks, :]
            c = c + a_hi[..., ks] @ b_hi[..., ks, :]
        out = out + c
    return out


def split_backward(q, k, v, out, lse, do, causal: bool,
                   score_products: int = 3):
    """The f32 routes of flash_bwd_kv and flash_bwd_dq on [b, h, s, d] f32
    tensors, from the forward's ``out`` and ``lse``: delta = rowsum(do *
    out); S and dP over k-steps of 8 dims, each four steps' split
    products in a fresh sum (``score_products`` 1 takes them as one TF32
    product);
    p = 2^((s scale - lse) log2 e), chosen 0 where masked (a row without
    keys has lse -inf); ds = p (dp - delta) scale; dV = P^T dO and dK =
    dS^T Q summed in q tiles, dQ = dS K in key tiles, of 2048 / d rows
    (the kernels' ring stages), every operand split.  The kernel forms
    s scale - lse in one rounding (an FMA), torch in two.  Returns
    (dq, dk, dv)."""
    b, h, sq, d = q.shape
    kv_len = k.shape[2]
    scale = d ** -0.5
    tile = 2048 // d
    delta = (do * out).sum(dim=-1)
    s = blocked_split_matmul(q, k.transpose(-1, -2), 32, score_products)
    dp = blocked_split_matmul(do, v.transpose(-1, -2), 32, score_products)
    p = torch.exp2((s * scale - lse[..., None]) * LOG2E)
    if causal:
        rows = torch.arange(sq)[:, None] + (kv_len - sq)
        p = torch.where(torch.arange(kv_len)[None, :] > rows, 0.0, p)
    ds = (p * (dp - delta[..., None])) * scale
    dv = blocked_split_matmul(p.transpose(-1, -2), do, tile)
    dk = blocked_split_matmul(ds.transpose(-1, -2), q, tile)
    dq = blocked_split_matmul(ds, k, tile)
    return dq, dk, dv
