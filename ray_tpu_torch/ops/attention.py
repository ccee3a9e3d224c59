"""Multi-head attention entry point with hardware dispatch.

Counterpart of ``ray_tpu/ops/attention.py``.  ``attention(q, k, v)``
picks the hand-written flash kernel for CUDA tensors whose shapes fit
its tiles and that carry no custom mask or per-row kv lengths, and the
plain reference everywhere else.  ``[batch, heads, seq, head_dim]``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch.ops.flash_attention import _scale_for, flash_attention


def mha_reference(q, k, v, *, causal: bool = True,
                  scale: Optional[float] = None,
                  mask: Optional[torch.Tensor] = None,
                  kv_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain softmax attention, f32 logits whatever the input dtype.

    ``kv_lengths`` [b] limits each batch row to its own valid kv prefix
    (key position < kv_lengths[b]); ``mask`` is broadcast against the
    [b, h, q, k] logits.  Causal uses the (k_len - q_len) offset.  Rows
    must keep at least one key or the softmax is NaN."""
    s = _scale_for(q, scale)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * s
    neg_inf = float("-inf")
    q_len, k_len = logits.shape[-2], logits.shape[-1]
    if causal:
        idx_q = torch.arange(q_len, device=q.device)[:, None] + (k_len - q_len)
        idx_k = torch.arange(k_len, device=q.device)[None, :]
        logits = logits.masked_fill(~(idx_q >= idx_k), neg_inf)
    if kv_lengths is not None:
        valid = (torch.arange(k_len, device=q.device)[None, :]
                 < kv_lengths[:, None])                   # [b, k]
        logits = logits.masked_fill(~valid[:, None, None, :], neg_inf)
    if mask is not None:
        logits = logits.masked_fill(~mask, neg_inf)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def paged_attention(q, k_pool, v_pool, block_tables, *,
                    kv_lengths: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Block-table attention over one layer's paged pool.

    q [b, h, q_len, hd]; k_pool/v_pool [n_blocks, h, block_size, hd];
    block_tables [b, n_table] int (position-ordered; unused entries point
    at scratch block 0, hidden by the masks).  Gathers each row's blocks
    into ``[b, h, n_table * block_size, hd]`` and runs the reference."""
    b = q.shape[0]
    n_tab = block_tables.shape[1]
    h, bs, hd = k_pool.shape[1], k_pool.shape[2], k_pool.shape[3]

    def gather(pool):
        g = pool[block_tables]                       # [b, T, h, bs, hd]
        return g.permute(0, 2, 1, 3, 4).reshape(b, h, n_tab * bs, hd)

    return mha_reference(q, gather(k_pool), gather(v_pool), causal=False,
                         scale=scale, mask=mask, kv_lengths=kv_lengths)


def attention(q, k, v, *, causal: bool = True,
              scale: Optional[float] = None,
              mask: Optional[torch.Tensor] = None,
              kv_lengths: Optional[torch.Tensor] = None,
              impl: Optional[str] = None,
              block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """Dispatching attention.  ``impl``: "flash", "reference",
    "xla_fused", or None = flash for tile-friendly CUDA tensors with no
    mask or kv_lengths (the JAX package's condition, with CUDA in the
    TPU's place).  "xla_fused" is the JAX package's library route
    (``jax.nn.dot_product_attention``); its counterpart here is torch's
    ``scaled_dot_product_attention``, no kernel of this package."""
    if impl is None:
        tile_ok = (q.shape[-2] % 128 == 0 and k.shape[-2] % 128 == 0
                   and q.shape[-1] in (64, 128, 256))
        impl = ("flash" if q.is_cuda and tile_ok and mask is None
                and kv_lengths is None else "reference")
    if impl == "flash":
        if mask is not None or kv_lengths is not None:
            raise ValueError(
                "flash impl has no custom-mask / kv_lengths support; use "
                "impl='reference' (causal masking is built in)")
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               block_q=block_q, block_k=block_k)
    if impl == "reference":
        return mha_reference(q, k, v, causal=causal, scale=scale, mask=mask,
                             kv_lengths=kv_lengths)
    if impl == "xla_fused":
        if mask is not None or kv_lengths is not None:
            raise ValueError("xla_fused impl has no custom-mask / "
                             "kv_lengths support")
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")
