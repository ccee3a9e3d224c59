"""Flash attention, forward and backward: the hand-written Hopper kernels
and their plain versions.

Counterpart of ``ray_tpu/ops/flash_attention.py`` (``_flash_fwd``,
``_bwd_rule``/``_bwd_pallas``, ``flash_attention``,
``flash_attention_with_lse``).  The forward and the backward are
``torch.library`` custom ops, ``ray_tpu_torch::flash_fwd`` and
``ray_tpu_torch::flash_bwd``, tied together with ``register_autograd``
(the counterpart of the JAX package's ``custom_vjp``).  Being ops, they
are what a selective-checkpoint policy sees: ``models/gpt.py`` saves or
recomputes the forward's ``(out, lse)`` by the op's name.

On CUDA tensors the forward launches ``csrc/flash_fwd.cu`` (the port of
the Pallas ``_fwd_kernel``) and the backward launches
``csrc/flash_bwd.cu``: ``flash_bwd_kv`` (of ``_bwd_kv_kernel``) then
``flash_bwd_dq`` (of ``_bwd_dq_kernel``), after ``delta = rowsum(do * o)``
as a torch reduction, which the JAX package also computes outside its
kernels.  Each kernel runs bf16 on the tensor cores, and f32 on them
too, each operand split into two TF32 values and each product taken as
three TF32 products, which keeps f32's accuracy by design (so no TF32
switch of torch's is read).  On CPU tensors the ops run the
plain versions, ``flash_attention_reference`` and
``flash_attention_backward_reference``: the same blocked recompute
written in torch.  There is no route from one to the other: a CUDA
input launches or raises.

Layout is the JAX package's: ``[batch, heads, seq, head_dim]``.  Causal
rows sit at the tail of kv (offset ``kv_len - q_len``), as in
``mha_reference``.  The lse is ``[batch, heads, q_len]`` f32 (the Pallas
kernel's ``[bh, sq, 128]`` lane broadcast was a TPU layout); a row that
sees no key has lse -inf (the JAX kernel writes -1e30) and gets zero
output and zero gradient.  Every shape takes the same kernels: ragged
lengths are masked inside them, where the JAX package sends shapes off
its 128-aligned tiles to a plain scan.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch
from torch import Tensor

# kernel launches on CUDA tensors since the count was last reset, one
# counter per kernel; the smoke run zeroes them before driving a path and
# reads them after.  ``launches`` counts the forward kernel.  Ranks run as
# threads of one process add to them under ``_count_lock``; each thread
# also keeps its own counts by kernel and shape (``thread_launches``).
launches = 0
bwd_kv_launches = 0
bwd_dq_launches = 0
_count_lock = threading.Lock()
_thread = threading.local()


def _count(kernel: str, shape) -> None:
    """One launch of ``kernel`` ("fwd", "bwd_kv" or "bwd_dq") at q's
    ``shape``."""
    global launches, bwd_kv_launches, bwd_dq_launches
    with _count_lock:
        if kernel == "fwd":
            launches += 1
        elif kernel == "bwd_kv":
            bwd_kv_launches += 1
        else:
            bwd_dq_launches += 1
    log = thread_launches()
    key = (kernel, tuple(shape))
    log[key] = log.get(key, 0) + 1


def thread_launches() -> dict:
    """This thread's launches, ``{(kernel, q shape): n}``, since it last
    called ``reset_thread_launches`` (or since it started)."""
    if not hasattr(_thread, "log"):
        _thread.log = {}
    return _thread.log


def reset_thread_launches() -> None:
    _thread.log = {}

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


# -- backward: plain versions ------------------------------------------------

def _delta(out, do):
    """delta = rowsum(do * o) in f32, [b, h, sq]: the JAX package's
    preprocess outside the backward kernels."""
    return (do.float() * out.float()).sum(dim=-1).contiguous()


def _recompute_p_ds(qb, dob, kb, vb, lse_b, delta_b, rows, cols, scale,
                    causal, dtype):
    """p and ds for one (q block, kv block) pair, both rounded to the
    input dtype (and held in f32) as the kernels round them before their
    products.  ``rows`` are the block's global rows plus the causal
    offset, ``cols`` its global key positions."""
    s = (qb @ kb.transpose(-1, -2)) * scale
    p = torch.exp(s - lse_b[..., None])
    if causal:
        # a row that sees no key (lse -inf) is masked whole, so the
        # exp(+inf) there is never kept
        p = p.masked_fill(cols[None, :] > rows[:, None], 0.0)
    dp = dob @ vb.transpose(-1, -2)
    ds = (p * (dp - delta_b[..., None])) * scale
    return p.to(dtype).float(), ds.to(dtype).float()


def _bwd_kv_reference(q, k, v, do, lse, delta, scale, causal, block_q,
                      block_k):
    """Plain version of ``flash_bwd_kv``: dk, dv in the input dtype, f32
    accumulation over q blocks from the first that reaches the diagonal."""
    b, h, sq, d = q.shape
    kv_len = k.shape[2]
    bq, bk = min(block_q, sq), min(block_k, kv_len)
    off = kv_len - sq
    qf, dof, kf, vf = q.float(), do.float(), k.float(), v.float()
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    for k0 in range(0, kv_len, bk):
        kb, vb = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        cols = torch.arange(k0, k0 + kb.shape[2], device=q.device)
        acc_k = torch.zeros(kb.shape, device=q.device)
        acc_v = torch.zeros(kb.shape, device=q.device)
        first = max(0, (k0 - off) // bq) if causal else 0
        for q0 in range(first * bq, sq, bq):
            qb, dob = qf[:, :, q0:q0 + bq], dof[:, :, q0:q0 + bq]
            rows = torch.arange(q0, q0 + qb.shape[2], device=q.device) + off
            p, ds = _recompute_p_ds(qb, dob, kb, vb, lse[:, :, q0:q0 + bq],
                                    delta[:, :, q0:q0 + bq], rows, cols,
                                    scale, causal, q.dtype)
            acc_v += p.transpose(-1, -2) @ dob
            acc_k += ds.transpose(-1, -2) @ qb
        dk[:, :, k0:k0 + bk] = acc_k.to(k.dtype)
        dv[:, :, k0:k0 + bk] = acc_v.to(v.dtype)
    return dk, dv


def _bwd_dq_reference(q, k, v, do, lse, delta, scale, causal, block_q,
                      block_k):
    """Plain version of ``flash_bwd_dq``: dq in the input dtype, f32
    accumulation over kv blocks up to the diagonal."""
    b, h, sq, d = q.shape
    kv_len = k.shape[2]
    bq, bk = min(block_q, sq), min(block_k, kv_len)
    off = kv_len - sq
    qf, dof, kf, vf = q.float(), do.float(), k.float(), v.float()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for q0 in range(0, sq, bq):
        qb, dob = qf[:, :, q0:q0 + bq], dof[:, :, q0:q0 + bq]
        nq = qb.shape[2]
        rows = torch.arange(q0, q0 + nq, device=q.device) + off
        n_tiles = -(-kv_len // bk)
        if causal:
            last = q0 + nq - 1 + off
            n_tiles = min(n_tiles, 0 if last < 0 else last // bk + 1)
        acc = torch.zeros(qb.shape, device=q.device)
        for j in range(n_tiles):
            k0 = j * bk
            kb, vb = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
            cols = torch.arange(k0, k0 + kb.shape[2], device=q.device)
            _, ds = _recompute_p_ds(qb, dob, kb, vb, lse[:, :, q0:q0 + bq],
                                    delta[:, :, q0:q0 + bq], rows, cols,
                                    scale, causal, q.dtype)
            acc += ds @ kb
        dq[:, :, q0:q0 + nq] = acc.to(q.dtype)
    return dq


def flash_attention_backward_reference(q, k, v, out, lse, do, *,
                                       scale: Optional[float] = None,
                                       causal: bool = True,
                                       block_q: int = 512,
                                       block_k: int = 512):
    """The backward kernels' plain version: ``_bwd_rule``'s blocked
    recompute in torch.  ``out`` and ``lse`` are the forward's, ``do``
    the output's cotangent.  Returns ``(dq, dk, dv)`` in the inputs'
    dtypes."""
    s = _scale_for(q, scale)
    delta = _delta(out, do)
    dk, dv = _bwd_kv_reference(q, k, v, do, lse, delta, s, causal, block_q,
                               block_k)
    dq = _bwd_dq_reference(q, k, v, do, lse, delta, s, causal, block_q,
                           block_k)
    return dq, dk, dv


# -- the CUDA kernels ----------------------------------------------------------

def _check(q, k, v):
    """Raise unless q, k, v are what the kernels take."""
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


def _check_grad_inputs(q, do, lse, delta):
    """Raise unless do, lse and delta fit q for the backward kernels."""
    if not (do.is_cuda and lse.is_cuda and delta.is_cuda):
        raise ValueError("flash kernel inputs must all be CUDA tensors")
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must match q: got {tuple(do.shape)} "
                         f"{do.dtype} for {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != q.shape[:3] or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 "
                             f"{tuple(q.shape[:3])}, got {tuple(t.shape)} "
                             f"{t.dtype}")


def _cp_async_aligned(t) -> bool:
    """Whether the tensor-core kernels' 16-byte ``cp.async`` copies can
    read ``t`` in place: a 16-byte-aligned base, a contiguous head dim and
    (batch, head, row) strides that are whole 16-byte chunks (8 bf16 or 4
    f32 elements).  The model's q, k, v (strided views split from one qkv
    projection) qualify."""
    per_chunk = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0 and t.stride(-1) == 1
            and all(st % per_chunk == 0 for st in t.stride()[:3]))


def _aligned(*ts):
    """The inputs as the tensor-core kernels read them: each one that
    ``_cp_async_aligned`` refuses is copied into a fresh contiguous
    tensor (``clone``, not ``contiguous``: a contiguous view at an odd
    offset would come back from ``contiguous`` as it was)."""
    return tuple(t if _cp_async_aligned(t)
                 else t.clone(memory_format=torch.contiguous_format)
                 for t in ts)


def _strides(*ts):
    return (ctypes.c_longlong * (3 * len(ts)))(
        *(st for t in ts for st in t.stride()[:3]))


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _launch(q, k, v, scale: float, causal: bool, need_lse: bool):
    """Check the inputs, allocate the outputs, launch the forward kernel
    once."""
    from ray_tpu_torch.ops import _build

    _check(q, k, v)
    b, h, sq, d = q.shape
    # both dtypes run on the tensor cores, fed by 16-byte copies
    q, k, v = _aligned(q, k, v)
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if need_lse else None)
    lib = _build.load("flash_fwd")
    if lib.flash_fwd.argtypes is None:
        _bind_fwd(lib)
    with torch.cuda.device(q.device):
        rc = lib.flash_fwd(
            _DTYPE_CODES[q.dtype], d, _ptr(q), _ptr(k), _ptr(v), _ptr(out),
            _ptr(lse), b, h, sq, k.shape[2], _strides(q, k, v),
            ctypes.c_float(scale), int(causal), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed ({rc}): "
                           f"{lib.flash_fwd_error_string(rc).decode()}")
    _count("fwd", q.shape)
    return out, lse


def _bwd_lib():
    from ray_tpu_torch.ops import _build

    lib = _build.load("flash_bwd")
    if lib.flash_bwd_kv.argtypes is None:
        _bind_bwd(lib)
    return lib


def _bwd_inputs(q, k, v, do):
    """q, k, v and do as the backward kernels read them: both dtypes run
    on the tensor cores, fed by 16-byte copies (``_aligned``).  The
    model's qkv views and the cotangent autograd hands over (a transposed
    view of ``[b, s, h, d]``) pass uncopied."""
    return _aligned(q, k, v, do)


def _launch_bwd_kv(q, k, v, do, lse, delta, scale: float, causal: bool):
    """Launch ``flash_bwd_kv`` once; returns ``(dk, dv)``, contiguous, in
    the inputs' dtype."""
    _check(q, k, v)
    _check_grad_inputs(q, do, lse, delta)
    b, h, sq, d = q.shape
    q, k, v, do = _bwd_inputs(q, k, v, do)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_kv(
            _DTYPE_CODES[q.dtype], d, _ptr(q), _ptr(k), _ptr(v), _ptr(do),
            _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv), b, h, sq,
            k.shape[2], _strides(q, k, v, do), ctypes.c_float(scale),
            int(causal), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_bwd_kv launch failed ({rc}): "
                           f"{lib.flash_bwd_error_string(rc).decode()}")
    _count("bwd_kv", q.shape)
    return dk, dv


def _launch_bwd_dq(q, k, v, do, lse, delta, scale: float, causal: bool):
    """Launch ``flash_bwd_dq`` once; returns dq, contiguous, in the
    inputs' dtype."""
    _check(q, k, v)
    _check_grad_inputs(q, do, lse, delta)
    b, h, sq, d = q.shape
    q, k, v, do = _bwd_inputs(q, k, v, do)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dq(
            _DTYPE_CODES[q.dtype], d, _ptr(q), _ptr(k), _ptr(v), _ptr(do),
            _ptr(lse), _ptr(delta), _ptr(dq), b, h, sq, k.shape[2],
            _strides(q, k, v, do), ctypes.c_float(scale), int(causal),
            _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dq launch failed ({rc}): "
                           f"{lib.flash_bwd_error_string(rc).decode()}")
    _count("bwd_dq", q.shape)
    return dq


def _bind_fwd(lib) -> None:
    lib.flash_fwd.restype = ctypes.c_int
    lib.flash_fwd.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    lib.flash_fwd_error_string.restype = ctypes.c_char_p
    lib.flash_fwd_error_string.argtypes = [ctypes.c_int]


def _bind_bwd(lib) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    tail = [i32, i32, i32, i32, ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_float, i32, ptr]
    lib.flash_bwd_kv.restype = i32
    lib.flash_bwd_kv.argtypes = [i32, i32] + [ptr] * 8 + tail
    lib.flash_bwd_dq.restype = i32
    lib.flash_bwd_dq.argtypes = [i32, i32] + [ptr] * 7 + tail
    lib.flash_bwd_error_string.restype = ctypes.c_char_p
    lib.flash_bwd_error_string.argtypes = [i32]
    lib.flash_bwd_smem_bytes.restype = i32
    lib.flash_bwd_smem_bytes.argtypes = [i32, i32]


# -- the ops -----------------------------------------------------------------

def _one_device(*ts):
    if any(t.is_cuda for t in ts):
        raise ValueError("flash attention inputs must lie on one device")


@torch.library.custom_op("ray_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: Tensor, k: Tensor, v: Tensor, scale: float,
                  causal: bool, block_q: int, block_k: int,
                  need_lse: bool) -> tuple[Tensor, Tensor]:
    """``(out, lse)``; on CUDA without ``need_lse`` the kernel writes no
    lse and the second output is empty."""
    if q.is_cuda:
        out, lse = _launch(q, k, v, scale, causal, need_lse)
        return out, (lse if lse is not None
                     else torch.empty(0, device=q.device))
    _one_device(k, v)
    return flash_attention_reference(q, k, v, scale=scale, causal=causal,
                                     block_q=block_q, block_k=block_k)


@torch.library.custom_op("ray_tpu_torch::flash_bwd", mutates_args=())
def _flash_bwd_op(q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor,
                  do: Tensor, scale: float, causal: bool, block_q: int,
                  block_k: int) -> tuple[Tensor, Tensor, Tensor]:
    """``(dq, dk, dv)`` from the forward's inputs, ``out`` and ``lse``."""
    if q.is_cuda:
        delta = _delta(out, do)
        dk, dv = _launch_bwd_kv(q, k, v, do, lse, delta, scale, causal)
        return _launch_bwd_dq(q, k, v, do, lse, delta, scale, causal), dk, dv
    _one_device(k, v, out, lse, do)
    return flash_attention_backward_reference(
        q, k, v, out, lse, do, scale=scale, causal=causal, block_q=block_q,
        block_k=block_k)


def _fwd_setup(ctx, inputs, output):
    q, k, v, scale, causal, block_q, block_k, _ = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.args = (scale, causal, block_q, block_k)


def _fwd_backward(ctx, d_out, _d_lse):
    # lse is an auxiliary output (stop_gradient in the JAX package); its
    # cotangent is not used
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = torch.ops.ray_tpu_torch.flash_bwd(q, k, v, out, lse, d_out,
                                                   *ctx.args)
    return dq, dk, dv, None, None, None, None, None


torch.library.register_autograd("ray_tpu_torch::flash_fwd", _fwd_backward,
                                setup_context=_fwd_setup)

# what a checkpoint policy names to keep the forward's outputs
FLASH_FWD_OP = torch.ops.ray_tpu_torch.flash_fwd.default


def _flash_fwd(q, k, v, scale, causal, block_q, block_k, need_lse):
    # the backward needs the lse whenever a gradient will flow
    need_lse = need_lse or (torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v)))
    return torch.ops.ray_tpu_torch.flash_fwd(
        q, k, v, _scale_for(q, scale), causal, block_q, block_k, need_lse)


def flash_attention(q, k, v, *, scale: Optional[float] = None,
                    causal: bool = True, block_q: int = 512,
                    block_k: int = 512):
    """Fused attention, [batch, heads, seq, head_dim] layout, with a
    gradient.  The CUDA kernels pick their own tiles; ``block_q``/
    ``block_k`` shape the plain versions' tiles on the CPU."""
    return _flash_fwd(q, k, v, scale, causal, block_q, block_k, False)[0]


def flash_attention_with_lse(q, k, v, *, scale: Optional[float] = None,
                             causal: bool = True, block_q: int = 512,
                             block_k: int = 512):
    """Fused attention returning ``(out, lse)``; lse is ``[b, h, sq]``
    f32 and carries no gradient."""
    out, lse = _flash_fwd(q, k, v, scale, causal, block_q, block_k, True)
    return out, lse.detach()
