"""Incremental (KV-cache) decode for the GPT over the paged block pool.

Port of ``ray_tpu/inference/decode.py``'s paged path:

  * ``make_prefill_fn`` -- the full-width prefill: ``gpt.forward`` with
    ``return_kv`` over the padded prompt.  Its attention is the Hopper
    flash kernel on the card (12 launches for GPT-2 124M).
  * ``make_chunk_prefill_fn`` -- a fixed-width window of the prompt runs
    one forward against the pool, each query row masked to its own
    causal horizon, so earlier chunks and an adopted prefix take part as
    in a full forward.
  * ``make_paged_decode_step`` -- one token for every row at once,
    attention over each row's gathered block table masked to its valid
    prefix.

Every step body reads one layer's pool slice inside the layer loop and
writes the new K/V to the pool in ONE scatter after the loop (the shape
the JAX package settled on; carrying the pool through the loop copied it
whole).  Where JAX donated the pool to the jitted step, the port writes
the pool tensors in place.  All bodies mirror ``gpt._transformer_layer``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ray_tpu_torch.models import gpt
from ray_tpu_torch.models.gpt import GPTConfig
from ray_tpu_torch.ops.attention import attention


def _mlp_block(y, lp, cfg: GPTConfig):
    """The step bodies' dense MLP, mirroring gpt._transformer_layer.
    y [b, s, d] -> [b, s, d]."""
    if cfg.n_experts:
        raise NotImplementedError("MoE decode is not ported yet")
    u = y @ lp["w_up"].to(cfg.dtype) + lp["b_up"].to(cfg.dtype)
    u = F.gelu(u, approximate="tanh")
    return u @ lp["w_down"].to(cfg.dtype) + lp["b_down"].to(cfg.dtype)


def _qkv_heads(x, lp, cfg: GPTConfig):
    """Pre-LN qkv projection: x [b, s, d] -> q, k, v [b, s, d] each."""
    y = gpt._layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
    qkv = y @ lp["wqkv"].to(cfg.dtype)
    return qkv.split(cfg.d_model, dim=-1)


def _finish_layer(x, o, lp, cfg: GPTConfig):
    """Output projection, residual, MLP: o [b, s, d] attention output."""
    x = x + (o @ lp["wo"].to(cfg.dtype) + lp["bo"].to(cfg.dtype))
    y = gpt._layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
    return x + _mlp_block(y, lp, cfg)


def make_prefill_fn(cfg: GPTConfig):
    """(params, tokens [b, S]) -> (logits [b, S, V], k, v [L, b, h, S, hd])."""

    @torch.no_grad()
    def prefill(params, tokens):
        logits, (k, v) = gpt.forward(params, tokens, cfg, return_kv=True)
        return logits, k, v

    return prefill


def make_paged_decode_step(cfg: GPTConfig, *, block_size: int,
                           n_table: int):
    """One-token step over the whole row batch against the block pool.

    (params, k_pool, v_pool [L, N, h, bs, hd], tables [b, T] long,
     tokens [b] long, positions [b] long, active [b] bool)
        -> logits [b, vocab] f32, the pools updated in place

    Each row's current token K/V lands at ``(tables[row, pos // bs],
    pos % bs)``; inactive rows are redirected to the scratch block.  The
    engine copy-on-writes shared tails first, so active rows never
    collide in the scatter."""
    h, hd, bs, T = cfg.n_heads, cfg.head_dim, int(block_size), int(n_table)

    @torch.no_grad()
    def step(params, k_pool, v_pool, tables, tokens, positions, active):
        b = tokens.shape[0]
        x = (params["wte"][tokens] + params["wpe"][positions])
        x = x[:, None, :].to(cfg.dtype)                   # [b, 1, d]
        rows = torch.arange(b, device=tokens.device)
        zero = torch.zeros_like(positions)
        bidx = torch.where(active, tables[rows, positions // bs], zero)
        off = torch.where(active, positions % bs, zero)
        kv_len = torch.where(active, positions + 1, zero + 1)  # >=1: no NaN

        def gather(pool):                                 # -> [b, h, S, hd]
            g = pool[tables]                              # [b, T, h, bs, hd]
            return g.permute(0, 2, 1, 3, 4).reshape(b, h, T * bs, hd)

        ks, vs = [], []
        for li in range(cfg.n_layers):
            lp = gpt.layer_params(params, li)
            q, k, v = _qkv_heads(x, lp, cfg)
            kh, vh = k.reshape(b, h, hd), v.reshape(b, h, hd)
            # insert the current token's K/V at its own position in the
            # gathered context: key order stays position-major
            ctx_k, ctx_v = gather(k_pool[li]), gather(v_pool[li])
            ctx_k[rows, :, positions, :] = kh.to(ctx_k.dtype)
            ctx_v[rows, :, positions, :] = vh.to(ctx_v.dtype)
            o = attention(q.reshape(b, 1, h, hd).transpose(1, 2), ctx_k,
                          ctx_v, causal=False, kv_lengths=kv_len,
                          impl="reference")
            o = o.transpose(1, 2).reshape(b, 1, cfg.d_model)
            x = _finish_layer(x, o, lp, cfg)
            ks.append(kh)
            vs.append(vh)
        # [L, b, h, hd] -> [b, L, h, hd]: one in-place scatter per pool
        # (the advanced indices are split by a slice, so their dim leads)
        k_pool[:, bidx, :, off, :] = torch.stack(ks, 1).to(k_pool.dtype)
        v_pool[:, bidx, :, off, :] = torch.stack(vs, 1).to(v_pool.dtype)
        return gpt._head(params, x, cfg)[:, 0, :]

    return step


def make_chunk_prefill_fn(cfg: GPTConfig, *, chunk: int, block_size: int,
                          n_table: int):
    """Fixed-width prefill chunk against the block pool.

    (params, k_pool, v_pool [L, N, h, bs, hd], table [T] long,
     tokens [C] long, start int)
        -> logits [C, vocab] f32, the pools updated in place

    Covers positions ``start .. start+C``.  Rows past the table's span
    write to the scratch block and to a dummy context column (S) that
    every real row's causal mask excludes; pad rows past the prompt
    compute garbage that lands in masked positions."""
    h, hd = cfg.n_heads, cfg.head_dim
    bs, C, T = int(block_size), int(chunk), int(n_table)
    S = T * bs

    @torch.no_grad()
    def chunk_fn(params, k_pool, v_pool, table, tokens, start):
        dev = tokens.device
        pos = int(start) + torch.arange(C, device=dev)    # [C]
        oob = pos >= S
        wpe_pos = pos.clamp(0, cfg.max_seq - 1)
        x = (params["wte"][tokens] + params["wpe"][wpe_pos])
        x = x[None, :, :].to(cfg.dtype)                   # [1, C, d]
        zero = torch.zeros_like(pos)
        safe = torch.where(oob, zero, pos)
        bidx = torch.where(oob, zero, table[safe // bs])
        off = torch.where(oob, zero, pos % bs)
        wcol = torch.where(oob, zero + S, pos)
        mask = (torch.arange(S + 1, device=dev)[None, :]
                <= pos[:, None])[None, None]              # [1, 1, C, S+1]

        def gather(pool):                                 # -> [1, h, S+1, hd]
            g = pool[table]                               # [T, h, bs, hd]
            g = g.permute(1, 0, 2, 3).reshape(h, S, hd)
            return F.pad(g, (0, 0, 0, 1))[None]

        ks, vs = [], []
        for li in range(cfg.n_layers):
            lp = gpt.layer_params(params, li)
            q, k, v = _qkv_heads(x, lp, cfg)
            kh = k.reshape(C, h, hd).transpose(0, 1)      # [h, C, hd]
            vh = v.reshape(C, h, hd).transpose(0, 1)
            ctx_k, ctx_v = gather(k_pool[li]), gather(v_pool[li])
            ctx_k[:, :, wcol, :] = kh.to(ctx_k.dtype)
            ctx_v[:, :, wcol, :] = vh.to(ctx_v.dtype)
            o = attention(q.reshape(1, C, h, hd).transpose(1, 2), ctx_k,
                          ctx_v, causal=False, mask=mask, impl="reference")
            o = o.transpose(1, 2).reshape(1, C, cfg.d_model)
            x = _finish_layer(x, o, lp, cfg)
            ks.append(kh)
            vs.append(vh)
        # [L, h, C, hd] -> [C, L, h, hd]: one in-place scatter per pool
        # through the table (out-of-range rows land in the scratch block)
        k_pool[:, bidx, :, off, :] = \
            torch.stack(ks).permute(2, 0, 1, 3).to(k_pool.dtype)
        v_pool[:, bidx, :, off, :] = \
            torch.stack(vs).permute(2, 0, 1, 3).to(v_pool.dtype)
        return gpt._head(params, x, cfg)[0]               # [C, V]

    return chunk_fn
