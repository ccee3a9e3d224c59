"""Flash attention forward: the hand-written Hopper kernel and its plain
version.

Counterpart of ``ray_tpu/ops/flash_attention.py`` (``_flash_fwd``,
``flash_attention``, ``flash_attention_with_lse``).  On a CUDA tensor
the wrapper launches ``csrc/flash_fwd.cu`` (the port of the Pallas
``_fwd_kernel``) or raises; on a CPU tensor it runs
``flash_attention_reference``, the same blocked online softmax written in
torch.  There is no fallback from one to the other.

Layout is the JAX package's: ``[batch, heads, seq, head_dim]``.  Causal
rows sit at the tail of kv (offset ``kv_len - q_len``), as in
``mha_reference``.  The lse is returned as ``[batch, heads, q_len]`` f32
(the Pallas kernel's ``[bh, sq, 128]`` lane broadcast was a TPU layout).

Backward through the CUDA path raises ``NotImplementedError``: the two
backward kernels are ported with the training slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

# kernel launches on CUDA tensors since the count was last reset; the
# smoke run zeroes it before driving the serving path and reads it after
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)


def _scale_for(q, scale):
    return (q.shape[-1] ** -0.5) if scale is None else scale


def flash_attention_reference(q, k, v, *, scale: Optional[float] = None,
                              causal: bool = True, block_q: int = 512,
                              block_k: int = 512):
    """The kernel's plain version: blocked online softmax in torch, f32
    inside, ``block_q x block_k`` tiles (the config's TPU tile sizes).
    Returns ``(out [b, h, sq, d] in q's dtype, lse [b, h, sq] f32)``.
    A row with no visible key (causal with q_len > kv_len) gives out 0
    and lse -inf."""
    b, h, sq, d = q.shape
    kv_len = k.shape[2]
    s = _scale_for(q, scale)
    bq, bk = min(block_q, sq), min(block_k, kv_len)
    qf, kf, vf = q.float(), k.float(), v.float()
    off = kv_len - sq
    out = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    neg_inf = float("-inf")
    for q0 in range(0, sq, bq):
        qb = qf[:, :, q0:q0 + bq]
        nq = qb.shape[2]
        rows = torch.arange(q0, q0 + nq, device=q.device) + off
        n_tiles = -(-kv_len // bk)
        if causal:
            last = q0 + nq - 1 + off
            n_tiles = min(n_tiles, 0 if last < 0 else last // bk + 1)
        m = torch.full((b, h, nq), neg_inf, device=q.device)
        l = torch.zeros((b, h, nq), device=q.device)
        acc = torch.zeros((b, h, nq, d), device=q.device)
        for j in range(n_tiles):
            k0 = j * bk
            kb, vb = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
            sc = (qb @ kb.transpose(-1, -2)) * s
            if causal:
                cols = torch.arange(k0, k0 + kb.shape[2], device=q.device)
                sc = sc.masked_fill(cols[None, :] > rows[:, None], neg_inf)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            # rows with no visible key yet subtract 0, keeping exp finite
            m_safe = torch.where(m_new == neg_inf, 0.0, m_new)
            alpha = torch.exp(m - m_safe)
            p = torch.exp(sc - m_safe[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + p @ vb
            m = m_new
        live = l > 0
        out[:, :, q0:q0 + nq] = torch.where(
            live[..., None], acc / torch.where(live, l, 1.0)[..., None], 0.0)
        lse[:, :, q0:q0 + nq] = torch.where(
            live, m + torch.log(torch.where(live, l, 1.0)), neg_inf)
    return out.to(q.dtype), lse


def _launch(q, k, v, scale: float, causal: bool, need_lse: bool):
    """Check the inputs, allocate the outputs, launch the kernel once."""
    global launches
    from ray_tpu_torch.ops import _build

    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash kernel inputs must all be CUDA tensors")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash kernel takes float32 or bfloat16 "
                         f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"expected [b, h, s, d] q and equal-shape k, v; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, d = q.shape
    kv_len = k.shape[2]
    if k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on batch, heads or head_dim")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel head_dim must be one of "
                         f"{_HEAD_DIMS}, got {d}")
    if sq == 0 or kv_len == 0:
        raise ValueError("flash kernel needs q_len >= 1 and kv_len >= 1")
    # the kernel indexes rows by (batch, head, row) strides and needs
    # only the head dim contiguous: q/k/v split out of one qkv
    # projection go in without a copy
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if need_lse else None)
    strides = (ctypes.c_longlong * 9)(*(st for t in (q, k, v)
                                        for st in t.stride()[:3]))
    lib = _build.load("flash_fwd")
    if lib.flash_fwd.argtypes is None:
        _bind(lib)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_fwd(
            _DTYPE_CODES[q.dtype], d, ctypes.c_void_p(q.data_ptr()),
            ctypes.c_void_p(k.data_ptr()), ctypes.c_void_p(v.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(lse.data_ptr() if lse is not None else None),
            b, h, sq, kv_len, strides, ctypes.c_float(scale), int(causal),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed ({rc}): "
                           f"{lib.flash_fwd_error_string(rc).decode()}")
    launches += 1
    return out, lse


def _bind(lib) -> None:
    lib.flash_fwd.restype = ctypes.c_int
    lib.flash_fwd.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    lib.flash_fwd_error_string.restype = ctypes.c_char_p
    lib.flash_fwd_error_string.argtypes = [ctypes.c_int]


class _FlashFwd(torch.autograd.Function):
    """The CUDA kernel as an autograd node whose backward is not ported
    yet (``_bwd_kv_kernel``/``_bwd_dq_kernel`` come with training)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, need_lse):
        out, lse = _launch(q, k, v, scale, causal, need_lse)
        if lse is not None:
            ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "flash attention backward on CUDA is not ported yet; train "
            "with attn_impl='reference' until the backward kernels land")


def _flash_fwd(q, k, v, scale, causal, block_q, block_k, need_lse):
    s = _scale_for(q, scale)
    if q.is_cuda:
        return _FlashFwd.apply(q, k, v, s, causal, need_lse)
    if k.is_cuda or v.is_cuda:
        raise ValueError("q, k and v must lie on one device")
    out, lse = flash_attention_reference(q, k, v, scale=s, causal=causal,
                                         block_q=block_q, block_k=block_k)
    return out, (lse if need_lse else None)


def flash_attention(q, k, v, *, scale: Optional[float] = None,
                    causal: bool = True, block_q: int = 512,
                    block_k: int = 512):
    """Fused attention, [batch, heads, seq, head_dim] layout.  The CUDA
    kernel picks its own tiles (64 x 64); ``block_q``/``block_k`` shape
    the plain version's tiles on the CPU."""
    return _flash_fwd(q, k, v, scale, causal, block_q, block_k, False)[0]


def flash_attention_with_lse(q, k, v, *, scale: Optional[float] = None,
                             causal: bool = True, block_q: int = 512,
                             block_k: int = 512):
    """Fused attention returning ``(out, lse)``; lse is ``[b, h, sq]``
    f32 and carries no gradient."""
    out, lse = _flash_fwd(q, k, v, scale, causal, block_q, block_k, True)
    return out, lse.detach()
