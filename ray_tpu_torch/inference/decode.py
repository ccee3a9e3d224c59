"""Incremental (KV-cache) decode for the GPT: the paged path with its
speculative verify and self-draft steps, and the slot path.

Port of ``ray_tpu/inference/decode.py``:

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
  * ``make_spec_verify_step`` -- the paged step widened to W = k + 1
    lanes a row: lane 0 is the row's current token, lanes 1.. drafted
    continuations, each query masked to its own causal horizon, so lane
    j's logits are the next-token logits given the drafted prefix.
  * ``make_paged_draft_step`` -- the truncated-layer self-draft burst: k
    greedy tokens through the first ``draft_layers`` layers straight
    into the head.  Layer l's K/V depend only on layers below it, so the
    burst writes the real pool at layers < draft_layers.
  * ``ngram_propose`` -- the host-side prompt-lookup drafter.
  * ``make_decode_step`` -- the slot engine's step over the
    ``[L, n_slots, h, S, hd]`` stripes, masked per row by kv length (on
    a tp rank its heads' stripes).  Dense configs only: an MoE config
    raises ``MoEDecodeUnsupported`` when the step is built.

Tensor parallelism (``tp``, a ``TPShard``; None on one device): every
body runs on one tp rank's shards, Megatron style, as the JAX package's
bodies run under GSPMD with the pool split by ``POOL_AXES``.  The qkv
projection and the MLP's up projection are split by column (each rank
holds the q, k and v columns of its own heads), attention runs over the
rank's heads of the pool, ``wo`` and ``w_down`` are split by row and
their partial sums are completed by an all-reduce over tp (summed in
f32 and rounded once), and the head is vocab-parallel, its logits
gathered over tp, so every rank ends a body with the whole logits and
takes the same argmax.  The embedding table stays whole on every rank.
The pool writes are local: the scatter's block and offset axes are not
split.  ``inference/tp.py`` holds the ranks that run these bodies.

The paged bodies read one layer's pool slice inside the layer loop and
write the new K/V to the pool in ONE scatter after the loop (the shape
the JAX package settled on; carrying the pool through the loop copied it
whole).  Where JAX donated the pool to the jitted step, the port writes
the pool tensors in place.  All bodies mirror
``gpt._transformer_layer``; an MoE config's paged bodies route each
step's token window through ``gpt._moe_mlp``.  The step bodies run plain attention: the
JAX package has no Pallas kernel for them either.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch.models import gpt
from ray_tpu_torch.models.gpt import GPTConfig
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.parallel.collectives import allgather, allreduce

# logical axes of the pool [L, N+1, heads, bs, hd]: the heads dim is the
# split one, so every rank holds every block with its own heads, and the
# block ids, tables, refcounts and copy-on-write stay on the host,
# unaware of shards.  The layers dim is not "layers": the pool is never
# split over pp.
POOL_AXES = (None, None, "heads", None, "kv")


@dataclass(frozen=True)
class TPShard:
    """One tp rank's part of a step body: the mesh whose "tp" dim the
    collectives run over, this rank's number of heads, and which
    products are split over tp (the rules may leave the MLP's hidden dim
    or the vocab whole).  The body's params are the rank's shards
    (``inference.tp.local_params``)."""
    mesh: DeviceMesh
    heads: int
    split_heads: bool
    split_mlp: bool
    split_vocab: bool


def _row_sum(t, tp: Optional[TPShard], split: bool):
    """A row-parallel product's partial sums completed over tp: summed in
    f32 and rounded once to ``t``'s dtype.  ``t`` itself on one device or
    when the contracted dim is whole."""
    if tp is None or not split:
        return t
    return allreduce(t.float(), "tp", mesh=tp.mesh).to(t.dtype)


def _head(params, x, cfg: GPTConfig, tp: Optional[TPShard]):
    """The head: ``gpt._head`` on one device; on a tp rank its block of
    the vocab (``params["w_head"]``, [d, V/tp]), the logits gathered over
    tp."""
    if tp is None:
        return gpt._head(params, x, cfg)
    x = gpt._layer_norm(x, params["ln_f_scale"], params["ln_f_bias"])
    logits = (x @ params["w_head"].to(cfg.dtype)).float()
    if tp.split_vocab:
        logits = allgather(logits, "tp", axis=-1, mesh=tp.mesh)
    return logits


class MoEDecodeUnsupported(NotImplementedError):
    """The slot decode path has no MoE support (it is the dense
    baseline; the paged engine serves MoE through ``gpt._moe_mlp``).
    Raised when the slot step is built, so a slot engine over an MoE
    config fails at construction, never mid-decode."""

    def __init__(self, cfg: GPTConfig):
        super().__init__(
            f"the slot decode path has no MoE support (n_experts="
            f"{cfg.n_experts}); serve this config with the paged engine "
            f"(EngineConfig.paged=True, which routes experts per token "
            f"window through gpt._moe_mlp), or with a dense MLP "
            f"(n_experts=0)")


class SpeculationUnsupported(ValueError):
    """Speculative decoding was asked of a configuration that has no
    speculation path: the slot engine, a bad ``speculate_k``-sized burst,
    or a self-draft depth outside ``[1, n_layers)``.  Raised at engine
    construction, never mid-decode.  ``temperature > 0`` requests are no
    error: they decode one token a step on a speculating engine."""


def _mlp_block(y, lp, cfg: GPTConfig, tp: Optional[TPShard] = None):
    """The step bodies' MLP, as in gpt._transformer_layer: dense, or for
    an MoE config the expert dispatch of ``gpt._moe_mlp`` over the step's
    whole token window, pad and dead lanes included as in the JAX
    package, with the aux loss dropped.  Routing is per token, but
    capacity is per window and row (C = ceil(cf * k * s_window / E)), so
    the steps agree token for token with the full-sequence forward while
    capacity never binds (capacity_factor >= n_experts / expert_top_k).
    On a tp rank the hidden dim (each expert's) is this rank's block.
    y [b, s, d] -> [b, s, d]."""
    if cfg.n_experts:
        if tp is None:
            return gpt._moe_mlp(y, lp, cfg)[0]
        return _moe_mlp_tp(y, lp, cfg, tp)
    if tp is None:
        return gpt._mlp(y, lp, cfg)
    dt = cfg.dtype
    u = F.gelu(y @ lp["w_up"].to(dt) + lp["b_up"].to(dt), approximate="tanh")
    return _row_sum(u @ lp["w_down"].to(dt), tp, tp.split_mlp) \
        + lp["b_down"].to(dt)


def _moe_mlp_tp(y, lp, cfg: GPTConfig, tp: TPShard):
    """``gpt._moe_mlp``'s output on a tp rank: every rank routes the
    window alike (the router is whole), runs every expert on its block of
    the hidden dim, and the experts' outputs are completed over tp before
    the bias and the combine, which then run as on one device."""
    dt = cfg.dtype
    combine, _, _ = gpt._route(y, lp["w_router"], cfg)
    dispatch = (combine > 0).to(dt)
    expert_in = torch.einsum("gnec,gnd->gecd", dispatch, y.to(dt))
    hid = torch.einsum("gecd,edf->gecf", expert_in, lp["w_up"].to(dt)) \
        + lp["b_up"].to(dt)[None, :, None, :]
    hid = F.gelu(hid, approximate="tanh")
    out_e = _row_sum(torch.einsum("gecf,efd->gecd", hid,
                                  lp["w_down"].to(dt)), tp, tp.split_mlp) \
        + lp["b_down"].to(dt)[None, :, None, :]
    return torch.einsum("gnec,gecd->gnd", combine.to(dt), out_e)


def _qkv_heads(x, lp, cfg: GPTConfig):
    """Pre-LN qkv projection: x [b, s, d] -> q, k, v [b, s, h * hd] each
    (h the heads this body runs: all, or a tp rank's)."""
    y = gpt._layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
    qkv = y @ lp["wqkv"].to(cfg.dtype)
    return qkv.split(qkv.shape[-1] // 3, dim=-1)


def _finish_layer(x, o, lp, cfg: GPTConfig, tp: Optional[TPShard] = None):
    """Output projection, residual, MLP: o [b, s, h * hd] attention
    output (a tp rank's heads: the projection's sum is completed over
    tp before the bias)."""
    po = _row_sum(o @ lp["wo"].to(cfg.dtype), tp,
                  tp is not None and tp.split_heads)
    x = x + (po + lp["bo"].to(cfg.dtype))
    y = gpt._layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
    return x + _mlp_block(y, lp, cfg, tp)


def _n_heads(cfg: GPTConfig, tp: Optional[TPShard]) -> int:
    return cfg.n_heads if tp is None else tp.heads


def make_prefill_fn(cfg: GPTConfig):
    """(params, tokens [b, S]) -> (logits [b, S, V], k, v [L, b, h, S, hd])."""

    @torch.no_grad()
    def prefill(params, tokens):
        logits, (k, v) = gpt.forward(params, tokens, cfg, return_kv=True)
        return logits, k, v

    return prefill


def _gather_table(pool, tables):
    """One layer's pool [N, h, bs, hd] gathered through ``tables`` [b, T]
    -> [b, h, T * bs, hd], position-major."""
    b, T = tables.shape
    h, bs, hd = pool.shape[1], pool.shape[2], pool.shape[3]
    g = pool[tables]                                  # [b, T, h, bs, hd]
    return g.permute(0, 2, 1, 3, 4).reshape(b, h, T * bs, hd)


def make_decode_step(cfg: GPTConfig, *, tp: Optional[TPShard] = None):
    """The slot engine's one-token step over the whole slot batch.

    (params, k_cache, v_cache [L, b, h, S, hd], tokens [b] long,
     positions [b] long, active [b] bool)
        -> logits [b, vocab] f32, the caches updated in place

    Each active slot's current token K/V lands at ``positions[slot]``;
    parked slots are left bit-unchanged (their position's old value is
    written back).  Attention covers ``[0, positions[slot]]`` of the
    slot's stripe (one key for parked slots: never NaN).  With ``tp``
    the caches hold the rank's heads and the body runs on the rank's
    shards (the module note), as the JAX step runs under GSPMD on a
    mesh.  Raises MoEDecodeUnsupported for an MoE config."""
    if cfg.n_experts:
        raise MoEDecodeUnsupported(cfg)
    h, hd = _n_heads(cfg, tp), cfg.head_dim

    @torch.no_grad()
    def step(params, k_cache, v_cache, tokens, positions, active):
        b = tokens.shape[0]
        rows = torch.arange(b, device=tokens.device)
        # parked slots write their position-0 value back and attend key 0
        # (their logits are garbage the caller ignores)
        pos = torch.where(active, positions, torch.zeros_like(positions))
        kv_len = torch.where(active, positions + 1, torch.ones_like(pos))
        wpe_pos = positions.clamp(0, cfg.max_seq - 1)
        x = (params["wte"][tokens] + params["wpe"][wpe_pos])
        x = x[:, None, :].to(cfg.dtype)                   # [b, 1, d]
        keep = active[:, None, None]
        for li in range(cfg.n_layers):
            lp = gpt.layer_params(params, li)
            q, k, v = _qkv_heads(x, lp, cfg)
            ck, cv = k_cache[li], v_cache[li]             # [b, h, S, hd]
            ck[rows, :, pos, :] = torch.where(
                keep, k.reshape(b, h, hd).to(ck.dtype), ck[rows, :, pos, :])
            cv[rows, :, pos, :] = torch.where(
                keep, v.reshape(b, h, hd).to(cv.dtype), cv[rows, :, pos, :])
            o = attention(q.reshape(b, 1, h, hd).transpose(1, 2), ck, cv,
                          causal=False, kv_lengths=kv_len, impl="reference")
            o = o.transpose(1, 2).reshape(b, 1, h * hd)
            x = _finish_layer(x, o, lp, cfg, tp)
        return _head(params, x, cfg, tp)[:, 0, :]

    return step


def make_paged_decode_step(cfg: GPTConfig, *, block_size: int,
                           n_table: int, tp: Optional[TPShard] = None):
    """One-token step over the whole row batch against the block pool.

    (params, k_pool, v_pool [L, N, h, bs, hd], tables [b, T] long,
     tokens [b] long, positions [b] long, active [b] bool)
        -> logits [b, vocab] f32, the pools updated in place

    Each row's current token K/V lands at ``(tables[row, pos // bs],
    pos % bs)``; inactive rows are redirected to the scratch block.  The
    engine copy-on-writes shared tails first, so active rows never
    collide in the scatter.  With ``tp`` the pools hold the rank's
    heads."""
    h, hd, bs = _n_heads(cfg, tp), cfg.head_dim, int(block_size)

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
        ks, vs = [], []
        for li in range(cfg.n_layers):
            lp = gpt.layer_params(params, li)
            q, k, v = _qkv_heads(x, lp, cfg)
            kh, vh = k.reshape(b, h, hd), v.reshape(b, h, hd)
            # insert the current token's K/V at its own position in the
            # gathered context: key order stays position-major
            ctx_k = _gather_table(k_pool[li], tables)     # [b, h, S, hd]
            ctx_v = _gather_table(v_pool[li], tables)
            ctx_k[rows, :, positions, :] = kh.to(ctx_k.dtype)
            ctx_v[rows, :, positions, :] = vh.to(ctx_v.dtype)
            o = attention(q.reshape(b, 1, h, hd).transpose(1, 2), ctx_k,
                          ctx_v, causal=False, kv_lengths=kv_len,
                          impl="reference")
            o = o.transpose(1, 2).reshape(b, 1, h * hd)
            x = _finish_layer(x, o, lp, cfg, tp)
            ks.append(kh)
            vs.append(vh)
        # [L, b, h, hd] -> [b, L, h, hd]: one in-place scatter per pool
        # (the advanced indices are split by a slice, so their dim leads)
        k_pool[:, bidx, :, off, :] = torch.stack(ks, 1).to(k_pool.dtype)
        v_pool[:, bidx, :, off, :] = torch.stack(vs, 1).to(v_pool.dtype)
        return _head(params, x, cfg, tp)[:, 0, :]

    return step


def make_chunk_prefill_fn(cfg: GPTConfig, *, chunk: int, block_size: int,
                          n_table: int, tp: Optional[TPShard] = None):
    """Fixed-width prefill chunk against the block pool.

    (params, k_pool, v_pool [L, N, h, bs, hd], table [T] long,
     tokens [C] long, start int)
        -> logits [C, vocab] f32, the pools updated in place

    Covers positions ``start .. start+C``.  Rows past the table's span
    write to the scratch block and to a dummy context column (S) that
    every real row's causal mask excludes; pad rows past the prompt
    compute garbage that lands in masked positions.  With ``tp`` the
    pools hold the rank's heads."""
    h, hd = _n_heads(cfg, tp), cfg.head_dim
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
            return F.pad(_gather_table(pool, table[None]), (0, 0, 0, 1))

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
            o = o.transpose(1, 2).reshape(1, C, h * hd)
            x = _finish_layer(x, o, lp, cfg, tp)
            ks.append(kh)
            vs.append(vh)
        # [L, h, C, hd] -> [C, L, h, hd]: one in-place scatter per pool
        # through the table (out-of-range rows land in the scratch block)
        k_pool[:, bidx, :, off, :] = \
            torch.stack(ks).permute(2, 0, 1, 3).to(k_pool.dtype)
        v_pool[:, bidx, :, off, :] = \
            torch.stack(vs).permute(2, 0, 1, 3).to(v_pool.dtype)
        return _head(params, x, cfg, tp)[0]               # [C, V]

    return chunk_fn


def _scratch_column(tables):
    """``tables`` [b, T] with one more column pointing at scratch block 0:
    the gathered context gains S .. S+bs-1, where dead lanes write."""
    return F.pad(tables, (0, 1))


def make_spec_verify_step(cfg: GPTConfig, *, width: int, block_size: int,
                          n_table: int, tp: Optional[TPShard] = None):
    """Speculative verify: the paged decode step widened to W = ``width``
    lanes a row.

    (params, k_pool, v_pool [L, N, h, bs, hd], tables [b, T] long,
     tokens [b, W] long, positions [b] long, active [b] bool,
     n_tokens [b] long)
        -> logits [b, W, vocab] f32, the pools updated in place

    ``tokens[row, 0]`` is the row's current token at ``positions[row]``
    (the plain step's input); lanes 1.. are drafted continuations at
    positions+1, +2, ...  ``n_tokens`` in [1, W] counts a row's real
    lanes.  Dead lanes (past ``n_tokens``, of inactive rows, or at
    ``pos >= S``) write the scratch block and the dummy context column S
    and attend key 0 only: garbage logits the caller ignores, never NaN.
    Each live lane's K/V is inserted into the gathered context at its
    own position and its query masked to keys <= its position, so lane
    0's logits are the plain step's and lane j's are the next-token
    logits given the drafted prefix.  Every lane lands in ONE scatter;
    rejected lanes leave K/V past the row's committed length, which the
    masks hide until decode overwrites it.  With ``tp`` the pools hold
    the rank's heads."""
    h, hd = _n_heads(cfg, tp), cfg.head_dim
    bs, W, T = int(block_size), int(width), int(n_table)
    S = T * bs

    @torch.no_grad()
    def verify(params, k_pool, v_pool, tables, tokens, positions, active,
               n_tokens):
        b = tokens.shape[0]
        dev = tokens.device
        rows = torch.arange(b, device=dev)[:, None]        # [b, 1]
        lanes = torch.arange(W, device=dev)[None, :]       # [1, W]
        pos = positions[:, None] + lanes                    # [b, W]
        live = (lanes < n_tokens[:, None]) & active[:, None] & (pos < S)
        wpe_pos = pos.clamp(0, cfg.max_seq - 1)
        x = (params["wte"][tokens] + params["wpe"][wpe_pos]).to(cfg.dtype)
        zero = torch.zeros_like(pos)
        safe = torch.where(live, pos, zero)
        bidx = torch.where(live, tables[rows, safe // bs], zero)
        off = torch.where(live, pos % bs, zero)
        # dead lanes write context column S (the appended scratch entry);
        # every live query's horizon (<= S-1) excludes the scratch region
        wcol = torch.where(live, pos, zero + S)
        hor = torch.where(live, pos, zero)                 # >= 1 key: no NaN
        tbl = _scratch_column(tables)
        mask = (torch.arange(S + bs, device=dev)[None, None, :]
                <= hor[:, :, None])[:, None]               # [b, 1, W, S+bs]
        ks, vs = [], []
        for li in range(cfg.n_layers):
            lp = gpt.layer_params(params, li)
            q, k, v = _qkv_heads(x, lp, cfg)
            kh, vh = k.reshape(b, W, h, hd), v.reshape(b, W, h, hd)
            ctx_k = _gather_table(k_pool[li], tbl)        # [b, h, S+bs, hd]
            ctx_v = _gather_table(v_pool[li], tbl)
            # value layout [b, W, h, hd]: the advanced indices are split
            # by a slice, so their dims lead
            ctx_k[rows, :, wcol, :] = kh.to(ctx_k.dtype)
            ctx_v[rows, :, wcol, :] = vh.to(ctx_v.dtype)
            o = attention(q.reshape(b, W, h, hd).transpose(1, 2), ctx_k,
                          ctx_v, causal=False, mask=mask, impl="reference")
            o = o.transpose(1, 2).reshape(b, W, h * hd)
            x = _finish_layer(x, o, lp, cfg, tp)
            ks.append(kh)
            vs.append(vh)
        # [L, b, W, h, hd] -> [b, W, L, h, hd]: one in-place scatter per
        # pool (dead lanes all hit scratch block 0, offset 0)
        k_pool[:, bidx, :, off, :] = \
            torch.stack(ks).permute(1, 2, 0, 3, 4).to(k_pool.dtype)
        v_pool[:, bidx, :, off, :] = \
            torch.stack(vs).permute(1, 2, 0, 3, 4).to(v_pool.dtype)
        return _head(params, x, cfg, tp)                   # [b, W, V]

    return verify


def make_paged_draft_step(cfg: GPTConfig, *, draft_layers: int, k: int,
                          block_size: int, n_table: int,
                          tp: Optional[TPShard] = None):
    """Truncated-layer self-draft burst: ``k`` greedy draft tokens a row,
    each through the first ``draft_layers`` layers, the head and an
    argmax that feeds the next.

    (params, k_pool, v_pool [L, N, h, bs, hd], tables [b, T] long,
     tokens [b] long, positions [b] long, want [b] long)
        -> drafts [b, k] long, the pools updated in place at layers
           < draft_layers

    Row r drafts ``want[r]`` tokens (0 sits the burst out); columns past
    ``want[r]`` are garbage.  A row whose ``want`` is spent keeps its
    token and position.  Step j reads the burst's earlier tokens from a
    side buffer inserted into the gathered context at their true
    positions (the pool hears of the burst only at the end, in one
    scatter of layers < draft_layers and lanes < want).  Those K/V equal
    what the full model writes there, and the verify pass rewrites every
    drafted position at all layers.  Raises SpeculationUnsupported unless
    ``1 <= draft_layers < n_layers`` and ``k >= 1``.  With ``tp`` the
    pools hold the rank's heads; the gathered logits give every rank the
    same drafts."""
    h, hd, bs = _n_heads(cfg, tp), cfg.head_dim, int(block_size)
    D, K, T = int(draft_layers), int(k), int(n_table)
    S = T * bs
    if not (1 <= D < cfg.n_layers):
        raise SpeculationUnsupported(
            f"draft_layers must be in [1, n_layers) = [1, "
            f"{cfg.n_layers}), got {D}")
    if K < 1:
        raise SpeculationUnsupported(f"draft burst k must be >= 1, "
                                     f"got {K}")

    @torch.no_grad()
    def draft(params, k_pool, v_pool, tables, tokens, positions, want):
        b = tokens.shape[0]
        dev = tokens.device
        rows = torch.arange(b, device=dev)[:, None]        # [b, 1]
        lanes = torch.arange(K, device=dev)[None, :]       # [1, K]
        tbl = _scratch_column(tables)
        cur, pos = tokens, positions
        bk = torch.zeros((D, b, K, h, hd), dtype=cfg.dtype, device=dev)
        bv = torch.zeros_like(bk)
        drafts = []
        for j in range(K):
            live = (want > j) & (pos < S)
            x = (params["wte"][cur]
                 + params["wpe"][pos.clamp(0, cfg.max_seq - 1)])
            x = x[:, None, :].to(cfg.dtype)               # [b, 1, d]
            # burst token i sits at positions + i; tokens not drafted yet
            # (i > j) and dead rows land in the scratch column S
            bpos = (pos - j)[:, None] + lanes              # [b, K]
            bvalid = (lanes <= j) & live[:, None] & (bpos < S)
            wcol = torch.where(bvalid, bpos, torch.full_like(bpos, S))
            kv_len = torch.where(live, pos + 1, torch.ones_like(pos))
            for li in range(D):
                lp = gpt.layer_params(params, li)
                q, kk, v = _qkv_heads(x, lp, cfg)
                bk[li, :, j] = kk.reshape(b, h, hd).to(bk.dtype)
                bv[li, :, j] = v.reshape(b, h, hd).to(bv.dtype)
                ctx_k = _gather_table(k_pool[li], tbl)    # [b, h, S+bs, hd]
                ctx_v = _gather_table(v_pool[li], tbl)
                ctx_k[rows, :, wcol, :] = bk[li].to(ctx_k.dtype)
                ctx_v[rows, :, wcol, :] = bv[li].to(ctx_v.dtype)
                o = attention(q.reshape(b, 1, h, hd).transpose(1, 2), ctx_k,
                              ctx_v, causal=False, kv_lengths=kv_len,
                              impl="reference")
                o = o.transpose(1, 2).reshape(b, 1, h * hd)
                x = _finish_layer(x, o, lp, cfg, tp)
            nxt = torch.argmax(_head(params, x, cfg, tp)[:, 0, :], dim=-1)
            cur = torch.where(live, nxt, cur)
            pos = pos + live.long()
            drafts.append(nxt)
        # ONE scatter commits the burst's K/V for layers < D and lanes <
        # want (dead lanes collide harmlessly in the scratch block);
        # layers >= D keep their committed content
        bpos = positions[:, None] + lanes
        valid = (lanes < want[:, None]) & (bpos < S)
        zero = torch.zeros_like(bpos)
        safe = torch.where(valid, bpos, zero)
        bidx = torch.where(valid, tbl[rows, safe // bs], zero).reshape(-1)
        off = torch.where(valid, safe % bs, zero).reshape(-1)
        # value layout [b*K, D, h, hd]: block and offset lead
        k_pool[:D, bidx, :, off, :] = bk.permute(1, 2, 0, 3, 4).reshape(
            b * K, D, h, hd).to(k_pool.dtype)
        v_pool[:D, bidx, :, off, :] = bv.permute(1, 2, 0, 3, 4).reshape(
            b * K, D, h, hd).to(v_pool.dtype)
        return torch.stack(drafts, dim=1)                  # [b, K]

    return draft


def ngram_propose(context: np.ndarray, k: int,
                  max_ngram: int = 3) -> np.ndarray:
    """Prompt-lookup draft proposal: find the most recent EARLIER
    occurrence of the context's trailing n-gram (longest n first, n <=
    ``max_ngram``) and propose up to ``k`` of the tokens that followed
    it.  Host side, no weights.  Empty when nothing matches; the engine
    then decodes that row plainly."""
    n = int(len(context))
    if n < 2 or k < 1:
        return np.empty(0, np.int32)
    context = np.asarray(context, np.int32)
    for m in range(min(int(max_ngram), n - 1), 0, -1):
        pat = context[n - m:]
        # candidate starts s in [0, n-m-1]: the trailing n-gram itself
        # (s = n-m) is excluded, and every match has >= 1 follower
        win = np.stack([context[i:n - m + i] for i in range(m)], axis=1)
        hits = np.flatnonzero((win == pat).all(axis=1))
        if hits.size == 0:
            continue
        s = int(hits[-1])                 # most recent occurrence
        prop = context[s + m:s + m + k]
        if prop.size:
            return prop.astype(np.int32)
    return np.empty(0, np.int32)
