"""GPT: decoder-only transformer, the port of ``ray_tpu/models/gpt.py``.

Dense and mixture-of-experts models on one device.  Params are a plain
dict in the JAX package's stacked layout (``param_logical_axes``: every
per-layer leaf has a leading ``[n_layers]`` dim), so the bridge in
``models/convert.py`` needs no renaming; the layer loop is a Python loop
where JAX had ``lax.scan``.
Activations run in ``cfg.dtype``, params and the layer-norm / softmax /
logits math in f32.  Attention goes through ``ops.attention``, which
picks the Hopper flash kernels for tile-friendly CUDA inputs.

Training: ``loss_fn`` is next-token cross-entropy, and with ``cfg.remat``
each layer runs under ``torch.utils.checkpoint`` with the JAX package's
policies (``_remat_context``).

MoE (``n_experts > 0``): every layer's MLP is a top-k routed expert layer
in the GShard/Switch formulation (``_moe_mlp``; on a mesh
``_sharded_moe``, the experts split over ep); ``loss_fn`` adds the
load-balance aux loss.

The mesh arm (``forward``/``loss_fn`` with ``mesh=``, a ``DeviceMesh``
from ``parallel.mesh``): params and tokens are DTensors, the params are
placed by their logical axes and ``rules`` (``PARAM_AXES``), and the
activations are redistributed at the JAX package's
``with_sharding_constraint`` points.  Between two such points each
stretch of the layer runs on local shards (``parallel.spmd``):
column-parallel qkv and MLP-up projections, attention on each rank's
batch rows and heads (the Hopper kernels at the local shape, or ring
attention when the sequence is split over sp), row-parallel output
projections whose partial sums the next constraint completes, a
vocab-split embedding and a vocab-parallel cross-entropy.

A mesh with pp > 1 runs the layer stack as a GPipe pipeline
(``_forward_pipelined``, ``parallel.pipeline``), each stage on the mesh
without pp; the JAX package's refusals carry over (sp with pp, layers or
a batch the stages or microbatches do not divide, ``return_kv`` on a pp
mesh).  The prefill (``return_kv``) on a tp mesh returns each rank's
heads of the K/V as DTensors split over heads as the rules split
"heads", never gathered: the seed of the tp-sharded paged decode.  On a
mesh with another axis larger than 1 it raises ``NotImplementedError``
(only tp serving is ported).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Shard
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.flash_attention import FLASH_FWD_OP
from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.parallel import spmd
from ray_tpu_torch.parallel.collectives import allreduce, sum_partials
from ray_tpu_torch.parallel.mesh import mesh_shape, replicated
from ray_tpu_torch.parallel.pipeline import pipeline_apply, stage_mesh
from ray_tpu_torch.parallel.sharding import (DEFAULT_LLM_RULES, Rules,
                                             constrain, sharding_for)


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304          # gpt-2 vocab padded to a multiple of 128
    max_seq: int = 1024
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16      # activation dtype
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    remat_policy: Optional[str] = None
    tie_embeddings: bool = True
    attn_impl: Optional[str] = None  # None=auto, "flash", "reference"
    # the JAX package's TPU flash tile sizes; the CUDA kernel picks its
    # own tiles, the plain flash version on the CPU honours these
    attn_block_q: int = 512
    attn_block_k: int = 512
    pp_microbatches: Optional[int] = None
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    def __post_init__(self):
        if self.remat_policy not in (None, "dots", "dots_flash"):
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r}; expected "
                "None, 'dots', or 'dots_flash'")
        if self.n_experts:
            if not 1 <= self.expert_top_k <= self.n_experts:
                raise ValueError(
                    f"expert_top_k {self.expert_top_k} must be in "
                    f"[1, n_experts={self.n_experts}]")
            if self.capacity_factor <= 0:
                raise ValueError(
                    f"capacity_factor {self.capacity_factor} must be > 0")

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @staticmethod
    def gpt2_124m(**kw) -> "GPTConfig":
        return GPTConfig(**{**dict(d_model=768, n_heads=12, n_layers=12,
                                   d_ff=3072, max_seq=1024), **kw})

    @staticmethod
    def tiny(**kw) -> "GPTConfig":
        """Test-sized config."""
        return GPTConfig(**{**dict(vocab_size=512, max_seq=128, d_model=64,
                                   n_heads=4, n_layers=2, d_ff=128,
                                   remat=False), **kw})

    @staticmethod
    def tiny_moe(**kw) -> "GPTConfig":
        """Test-sized mixture-of-experts config."""
        return GPTConfig.tiny(**{**dict(n_experts=4, expert_top_k=2,
                                        dtype=torch.float32), **kw})


# -- params ----------------------------------------------------------------

# the JAX package's leaf names and logical axes; "layers" leaves carry a
# leading [n_layers] dim
PARAM_AXES = {
    "wte": ("vocab", "embed"),
    "wpe": (None, "embed"),
    "ln_f_scale": ("embed",),
    "ln_f_bias": ("embed",),
    "layers": {
        "ln1_scale": ("layers", "embed"),
        "ln1_bias": ("layers", "embed"),
        "wqkv": ("layers", "embed", "qkv"),
        "wo": ("layers", "heads", "embed"),
        "bo": ("layers", "embed"),
        "ln2_scale": ("layers", "embed"),
        "ln2_bias": ("layers", "embed"),
        "w_up": ("layers", "embed", "mlp"),
        "b_up": ("layers", "mlp"),
        "w_down": ("layers", "mlp", "embed"),
        "b_down": ("layers", "embed"),
    },
}

# MoE layers swap the dense MLP leaves for expert-stacked ones
MOE_MLP_AXES = {
    "w_router": ("layers", "embed", None),
    "w_up": ("layers", "expert", "embed", "mlp"),
    "b_up": ("layers", "expert", "mlp"),
    "w_down": ("layers", "expert", "mlp", "embed"),
    "b_down": ("layers", "expert", "embed"),
}


def param_logical_axes(cfg: GPTConfig) -> dict:
    """The params tree's logical axes for ``cfg``: ``PARAM_AXES``, with the
    expert-stacked MLP leaves for MoE and ``lm_head`` when untied."""
    axes = dict(PARAM_AXES)
    if cfg.n_experts:
        axes["layers"] = {**axes["layers"], **MOE_MLP_AXES}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def init_params(cfg: GPTConfig, seed: int = 0, *, device=None,
                generator: Optional[torch.Generator] = None) -> dict:
    """GPT-2 style init: N(0, 0.02), residual projections scaled by
    1/sqrt(2*n_layers), drawn from a ``torch.Generator`` on the target
    device (seeded with ``seed`` unless one is passed).  The draws differ
    from ``jax.random``'s; parity tests bridge one set of weights."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    d, L, f = cfg.d_model, cfg.n_layers, cfg.d_ff
    std = 0.02
    res_std = std / math.sqrt(2 * L)
    pd = cfg.param_dtype

    def norm(shape, s=std):
        t = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (t * s).to(pd)

    def zeros(shape):
        return torch.zeros(shape, dtype=pd, device=dev)

    def ones(shape):
        return torch.ones(shape, dtype=pd, device=dev)

    def mlp():
        if not cfg.n_experts:
            return {
                "w_up": norm((L, d, f)),
                "b_up": zeros((L, f)),
                "w_down": norm((L, f, d), res_std),
                "b_down": zeros((L, d)),
            }
        E = cfg.n_experts
        return {
            "w_router": norm((L, d, E)),
            "w_up": norm((L, E, d, f)),
            "b_up": zeros((L, E, f)),
            "w_down": norm((L, E, f, d), res_std),
            "b_down": zeros((L, E, d)),
        }

    # drawn in this order: wte, wpe, wqkv, wo, then the MLP's leaves
    params = {
        "wte": norm((cfg.vocab_size, d)),
        "wpe": norm((cfg.max_seq, d), 0.01),
        "ln_f_scale": ones((d,)),
        "ln_f_bias": zeros((d,)),
        "layers": {
            "ln1_scale": ones((L, d)),
            "ln1_bias": zeros((L, d)),
            "wqkv": norm((L, d, 3 * d)),
            "wo": norm((L, d, d), res_std),
            "bo": zeros((L, d)),
            "ln2_scale": ones((L, d)),
            "ln2_bias": zeros((L, d)),
            **mlp(),
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = norm((d, cfg.vocab_size))
    return params


def layer_params(params, i: int) -> dict:
    """Layer ``i``'s slice of the stacked ``params["layers"]``."""
    return {name: t[i] for name, t in params["layers"].items()}


# -- forward ---------------------------------------------------------------

def _layer_norm(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)   # population var
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _mlp(y, lp, cfg: GPTConfig):
    """The dense MLP: y [b, s, d] -> [b, s, d]."""
    u = y @ lp["w_up"].to(cfg.dtype) + lp["b_up"].to(cfg.dtype)
    u = F.gelu(u, approximate="tanh")      # jax.nn.gelu's default
    return u @ lp["w_down"].to(cfg.dtype) + lp["b_down"].to(cfg.dtype)


def _route(y, w_router, cfg: GPTConfig):
    """The router of ``_moe_mlp`` over whole groups: y [G, n, d] ->
    (combine [G, n, E, C] f32, the first round's one-hots [G, n, E], the
    router probabilities [G, n, E] f32)."""
    b, s, _ = y.shape                  # groups G = b, tokens/group n = s
    E, k = cfg.n_experts, cfg.expert_top_k
    C = max(1, int(math.ceil(cfg.capacity_factor * k * s / E)))
    dev = y.device
    experts = torch.arange(E, device=dev)
    slots = torch.arange(C, device=dev)

    logits = y.float() @ w_router.float()                # [G, n, E]
    probs = torch.softmax(logits, dim=-1)

    remaining = probs
    counts = torch.zeros((b, E), device=dev)   # per-group expert fill
    combine = torch.zeros((b, s, E, C), device=dev)
    gates_sum = torch.zeros((b, s), device=dev)
    top1 = None
    for i in range(k):
        idx = torch.argmax(remaining, dim=-1)             # [G, n]
        mask = (idx[..., None] == experts).float()        # [G, n, E]
        gate = (remaining * mask).sum(-1)                 # [G, n]
        # position of each token in its chosen expert's queue (0-based,
        # offset by earlier rounds' fill of this group's queues)
        pos = mask.cumsum(dim=1) - 1.0 + counts[:, None, :]
        posn = (pos * mask).sum(-1)                       # [G, n]
        keep = (posn < C).float()                         # capacity drop
        disp = (mask * keep[..., None])[..., None] \
            * (posn.long()[..., None] == slots).float()[..., None, :]
        combine = combine + gate[..., None, None] * disp  # [G, n, E, C]
        gates_sum = gates_sum + gate * keep
        counts = counts + (mask * keep[..., None]).sum(1)
        if i == 0:
            top1 = mask
        remaining = remaining * (1.0 - mask)
    # normalise the selected gates to sum to 1 per token (GShard)
    combine = combine / gates_sum.clamp_min(1e-9)[..., None, None]
    return combine, top1, probs


def _moe_mlp(y, lp, cfg: GPTConfig):
    """Top-k routed expert MLP, the GShard/Switch formulation with one
    group per batch row, step for step as the JAX package's ``_moe_mlp``
    (without a mesh).  Capacity is per group, ``C = max(1, ceil(cf * k *
    s / E))``; the dispatch and combine tensors are [G, s, E, C].  Round
    i routes each token to the argmax of its remaining router
    probabilities (the first maximum on ties), queues it behind the
    earlier rounds' fill of that expert, and drops it when the queue is
    full.  The one-hots compare with ``arange`` instead of calling
    ``F.one_hot``: a dropped token's position (>= C) gives an all-zero
    row as ``jax.nn.one_hot`` does, and nothing checks its input on the
    host.  Gradients flow through the gate values and the router
    probabilities only.  Returns (out [b, s, d], the Switch load-balance
    aux loss, a 0-d f32)."""
    E = cfg.n_experts
    combine, top1, probs = _route(y, lp["w_router"], cfg)
    dispatch = (combine > 0).to(cfg.dtype)                # [G, n, E, C]

    # Switch load-balance loss: E * sum_e f_e * P_e (f from the top-1
    # routing decision before the capacity drop, P the mean probability)
    aux = E * (top1.mean(dim=(0, 1)) * probs.mean(dim=(0, 1))).sum()

    dt = cfg.dtype
    expert_in = torch.einsum("gnec,gnd->gecd", dispatch, y.to(dt))
    hid = torch.einsum("gecd,edf->gecf", expert_in, lp["w_up"].to(dt)) \
        + lp["b_up"].to(dt)[None, :, None, :]
    hid = F.gelu(hid, approximate="tanh")
    out_e = torch.einsum("gecf,efd->gecd", hid, lp["w_down"].to(dt)) \
        + lp["b_down"].to(dt)[None, :, None, :]
    out = torch.einsum("gnec,gecd->gnd", combine.to(dt), out_e)
    return out, aux


def _transformer_layer(x, lp, cfg: GPTConfig, return_kv: bool = False):
    """One pre-LN block; x [b, s, d], lp = one layer's params.  Returns
    (x, the MoE aux loss: a Python 0.0 when dense); with ``return_kv`` also the
    per-head K/V ([b, h, s, hd] each), the seed of an incremental-decode
    cache."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim

    y = _layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
    qkv = y @ lp["wqkv"].to(cfg.dtype)
    q, k, v = qkv.split(cfg.d_model, dim=-1)

    def heads(t):  # [b, s, d] -> [b, h, s, hd] (a strided view)
        return t.reshape(b, s, h, hd).transpose(1, 2)

    kh, vh = heads(k), heads(v)
    o = attention(heads(q), kh, vh, causal=True, impl=cfg.attn_impl,
                  block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
    o = o.transpose(1, 2).reshape(b, s, cfg.d_model)
    o = o @ lp["wo"].to(cfg.dtype) + lp["bo"].to(cfg.dtype)
    x = x + o
    y = _layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
    if cfg.n_experts:
        dn, aux = _moe_mlp(y, lp, cfg)
    else:
        dn, aux = _mlp(y, lp, cfg), 0.0
    x = x + dn
    if return_kv:
        return x, aux, (kh, vh)
    return x, aux


def _embed(params, tokens, cfg: GPTConfig):
    s = tokens.shape[1]
    x = params["wte"][tokens] + params["wpe"][:s][None, :, :]
    return x.to(cfg.dtype)


def _head(params, x, cfg: GPTConfig):
    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"])
    w_out = params["wte"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ w_out.to(cfg.dtype)).float()


# what each remat policy keeps from a layer's forward for its backward;
# everything else is recomputed.  "dots" is the counterpart of
# dots_with_no_batch_dims_saveable: the 2-D projections (mm/addmm), not
# the batched attention products and not the flash forward.  In an MoE
# layer that keeps the router product; the dispatch, expert and combine
# einsums run as batched products (bmm) and are recomputed.  "dots_flash"
# also keeps the flash forward's (out, lse), so the backward never
# re-runs its kernel.  The JAX package needs an lse-returning flash
# variant with named outputs for that; here the flash forward is one op
# whichever function calls it, and the policy names the op.
_SAVED_OPS = {
    "dots": [torch.ops.aten.mm.default, torch.ops.aten.addmm.default],
    "dots_flash": [torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   FLASH_FWD_OP],
}


def _remat_context(cfg: GPTConfig):
    """The checkpoint's ``context_fn`` for ``cfg.remat_policy``."""
    ops = _SAVED_OPS.get(cfg.remat_policy)
    if ops is None:
        return noop_context_fn          # full recompute
    return functools.partial(create_selective_checkpoint_contexts, ops)


def forward(params, tokens, cfg: GPTConfig, *, mesh=None,
            rules: Rules = DEFAULT_LLM_RULES, return_aux: bool = False,
            return_kv: bool = False):
    """tokens [b, s] int -> logits [b, s, vocab] f32.  ``return_aux`` also
    returns the MoE load-balance aux loss summed over layers (a Python
    0.0 when dense); ``return_kv`` also returns ``(k, v)``, each [L, b, h, s, hd]:
    the prefill half of the incremental-decode path.  The result is
    ``logits``, ``(logits, aux)``, ``(logits, (k, v))`` or ``(logits,
    aux, (k, v))``.  With ``cfg.remat``, and a gradient to take, each
    layer is rematerialised in the backward pass as its ``remat_policy``
    says.  With ``mesh`` (the module note) params and tokens are
    DTensors on it and so are the logits: batch over the data axes, seq
    over sp, vocab over tp; the K/V of ``return_kv`` are placed
    (None, "batch", "heads", "seq", "kv")."""
    if mesh is not None:
        if return_kv and mesh_shape(mesh).get("pp", 1) > 1:
            raise NotImplementedError(
                "return_kv (inference prefill) is not supported on a "
                "pp mesh; prefill with dp/tp sharding instead")
        if return_kv:
            other = {a: n for a, n in mesh_shape(mesh).items()
                     if a != "tp" and n > 1}
            if other:
                raise NotImplementedError(
                    f"return_kv (the prefill) on a mesh with {other}: only "
                    f"the prefill of the tp-sharded decode is ported")
            logits, aux, kv = _sharded_forward(params, tokens, cfg, mesh,
                                               rules, return_kv=True)
            return (logits, aux, kv) if return_aux else (logits, kv)
        logits, aux = _sharded_forward(params, tokens, cfg, mesh, rules)
        return (logits, aux) if return_aux else logits
    x = _embed(params, tokens, cfg)
    if not return_kv:
        x, aux = stage_fn(cfg, None)(params["layers"], x)
        logits = _head(params, x, cfg)
        return (logits, aux) if return_aux else logits
    # the prefill keeps each layer's K/V; one unbind per stacked leaf
    layers = {name: t.unbind(0) for name, t in params["layers"].items()}
    aux = 0.0
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = {name: ts[i] for name, ts in layers.items()}
        x, a, (kh, vh) = _transformer_layer(x, lp, cfg, return_kv=True)
        ks.append(kh)
        vs.append(vh)
        if cfg.n_experts:
            aux = aux + a
    logits = _head(params, x, cfg)
    kv = (torch.stack(ks), torch.stack(vs))
    return (logits, aux, kv) if return_aux else (logits, kv)


def loss_fn(params, batch, cfg: GPTConfig, *, mesh=None,
            rules: Rules = DEFAULT_LLM_RULES):
    """Next-token cross-entropy, the mean of logsumexp - gold over f32
    logits, plus ``moe_aux_weight`` times the load-balance aux loss when
    the config is MoE.  batch = {"tokens": [b, s+1] int} or {"tokens":
    [b, s], "targets": [b, s]}.  On a mesh the batch holds DTensors
    (``train.step.shard_batch``) and the loss is a replicated 0-d
    DTensor."""
    tokens = batch["tokens"]
    if "targets" in batch:
        inp, tgt = tokens, batch["targets"]
    else:
        inp, tgt = tokens[:, :-1], tokens[:, 1:]
    if mesh is not None:
        logits, aux = forward(params, inp, cfg, mesh=mesh, rules=rules,
                              return_aux=True)
        ce = spmd.mean_nll(logits, tgt, mesh)
        if not cfg.n_experts:
            return ce
        return spmd.run(lambda c, a: c + cfg.moe_aux_weight * a, mesh,
                        replicated(mesh), ce, aux)
    logits, aux = forward(params, inp, cfg, return_aux=True)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         tgt.reshape(-1).long())
    return ce + cfg.moe_aux_weight * aux if cfg.n_experts else ce


# -- the mesh arm ----------------------------------------------------------

def _sharded_attention(qkv, n_heads: int, mesh, rules: Rules, attend,
                       seq: Optional[str] = "seq", mask=None,
                       return_kv: bool = False):
    """qkv [b, s, 3d] DTensor -> the attention output [b, s, d], split
    over heads as the rules split "heads".  q, k and v each take a third
    of the columns, which a split of the 3d columns does not follow, so
    qkv is gathered over them first; each rank then takes its heads and
    runs ``attend(q, k, v)`` on [b_local, h_local, s_local, hd] views
    (``attend(q, k, v, m)`` with its rows of a [b, s] ``mask``).
    ``seq=None`` gathers the sequence too, for attention that needs it
    whole.  ``return_kv`` also returns those k and v views, [b, h, s, hd]
    DTensors placed ("batch", "heads", seq, "kv")."""
    qkv = constrain(qkv, ("batch", seq, None), rules, mesh)
    b, s, three_d = qkv.shape
    d = three_d // 3
    hd = d // n_heads
    h0, hl = spmd.local_span(
        (b, n_heads, s, hd), mesh,
        sharding_for(("batch", "heads", seq, "kv"), rules, mesh), 1)

    def local(t, *m):
        bl, sl, _ = t.shape

        def heads(u):  # [b, s, d] -> this rank's [b, hl, s, hd] (a view)
            return u.reshape(bl, sl, n_heads, hd).transpose(1, 2)[
                :, h0:h0 + hl]

        q, k, v = t.split(d, dim=-1)
        kh, vh = heads(k), heads(v)
        o = attend(heads(q), kh, vh, *m)
        o = o.transpose(1, 2).reshape(bl, sl, hl * hd)
        return (o, kh, vh) if return_kv else o

    args = (qkv,) if mask is None else (
        qkv, constrain(mask, ("batch", None), rules, mesh))
    out = sharding_for(("batch", seq, "heads"), rules, mesh)
    if return_kv:
        kv = sharding_for(("batch", "heads", seq, "kv"), rules, mesh)
        out = (out, kv, kv)
    return spmd.run(local, mesh, out, *args)


def _sharded_layer(x, lp, cfg: GPTConfig, mesh, rules: Rules,
                   return_kv: bool = False):
    """``_transformer_layer`` on a mesh, x [b, s, d] a DTensor placed
    ("batch", "seq", "embed") and lp the layer's DTensors.  Returns (x,
    the MoE aux loss: a replicated 0-d DTensor, or 0.0 when dense); with
    ``return_kv`` also this rank's heads of the K/V
    (``_sharded_attention``)."""
    dt = cfg.dtype
    X = sharding_for(("batch", "seq", "embed"), rules, mesh)

    def ln_proj(x, scale, bias, w):
        return _layer_norm(x, scale, bias) @ w.to(dt)

    def residual(x, y, bias):
        return x + (y + bias.to(dt))

    def ln_up(x, scale, bias, w, b):
        return F.gelu(ln_proj(x, scale, bias, w) + b.to(dt),
                      approximate="tanh")

    if mesh_shape(mesh).get("sp", 1) > 1:
        def attend(q, k, v):
            return ring_attention(q, k, v, "sp", causal=True)
    else:
        def attend(q, k, v):
            return attention(q, k, v, causal=True, impl=cfg.attn_impl,
                             block_q=cfg.attn_block_q,
                             block_k=cfg.attn_block_k)

    qkv = spmd.run(ln_proj, mesh,
                   sharding_for(("batch", "seq", "qkv"), rules, mesh),
                   x, lp["ln1_scale"], lp["ln1_bias"], lp["wqkv"])
    o = _sharded_attention(qkv, cfg.n_heads, mesh, rules, attend,
                           return_kv=return_kv)
    kv = ()
    if return_kv:
        o, kh, vh = o
        kv = ((kh, vh),)
    o = constrain(spmd.dense(o, lp["wo"], mesh, dt),
                  ("batch", "seq", "embed"), rules, mesh)
    x = spmd.run(residual, mesh, X, x, o, lp["bo"])
    if cfg.n_experts:
        y = spmd.run(_layer_norm, mesh, X, x, lp["ln2_scale"],
                     lp["ln2_bias"])
        dn, aux = _sharded_moe(y, lp, cfg, mesh, rules)
        return (spmd.run(torch.add, mesh, X, x, dn), aux) + kv
    u = spmd.run(ln_up, mesh,
                 sharding_for(("batch", "seq", "mlp"), rules, mesh),
                 x, lp["ln2_scale"], lp["ln2_bias"], lp["w_up"], lp["b_up"])
    dn = constrain(spmd.dense(u, lp["w_down"], mesh, dt),
                   ("batch", "seq", "embed"), rules, mesh)
    return (spmd.run(residual, mesh, X, x, dn, lp["b_down"]), 0.0) + kv


def _sharded_moe(y, lp, cfg: GPTConfig, mesh, rules: Rules):
    """``_moe_mlp`` on a mesh: y [b, s, d] placed ("batch", "seq",
    "embed") -> (out placed alike, the aux loss replicated).  The JAX
    package's constraints place ``expert_in``, ``hid`` and ``out_e`` at
    ("batch", "expert", None, "embed" / "mlp") and split ``w_up`` and
    ``w_down`` over ep on the expert dim and over tp on mlp.  The batch
    is not split over ep, so every ep rank holds whole groups: each
    routes them (over every expert, sequences whole), dispatches to its
    own experts, and the combine is a partial sum over ep that the last
    constraint completes.  The aux loss's two means run over every
    group and token of the mesh (sums over the data axes), as on one
    device."""
    dt = cfg.dtype
    E = cfg.n_experts
    y = constrain(y, ("batch", None, "embed"), rules, mesh)
    b, s, _ = y.shape
    names = mesh.mesh_dim_names
    rows = [names[m] for m, p in enumerate(y.placements) if p.is_shard(0)]
    count = float(b * s)
    e0, n_e = spmd.local_span((E,), mesh, sharding_for(("expert",), rules,
                                                       mesh), 0)

    def route(y, w):
        combine, top1, probs = _route(y, w, cfg)
        f, p = top1.sum(dim=(0, 1)), probs.sum(dim=(0, 1))
        for ax in rows:
            f = allreduce(f, ax)
            p = sum_partials(p, ax)
        return combine, E * ((f / count) * (p / count)).sum()

    combine, aux = spmd.run(
        route, mesh, (sharding_for(("batch", None, None, None), rules, mesh),
                      replicated(mesh)), y, lp["w_router"])

    def up(c, y, w, bias):
        dispatch = (c[:, :, e0:e0 + n_e] > 0).to(dt)
        expert_in = torch.einsum("gnec,gnd->gecd", dispatch, y.to(dt))
        hid = torch.einsum("gecd,edf->gecf", expert_in, w.to(dt)) \
            + bias.to(dt)[None, :, None, :]
        return F.gelu(hid, approximate="tanh")

    H = sharding_for(("batch", "expert", None, "mlp"), rules, mesh)
    hid = spmd.run(up, mesh, H, combine, y, lp["w_up"], lp["b_up"])
    # the down projection sums over mlp: partial where tp splits it
    O = sharding_for(("batch", "expert", None, "embed"), rules, mesh)
    out_e = spmd.run(lambda h, w: torch.einsum("gecf,efd->gecd", h,
                                               w.to(dt)), mesh,
                     tuple(Partial() if h.is_shard(3) else o
                           for h, o in zip(H, O)), hid, lp["w_down"])
    out_e = constrain(out_e, ("batch", "expert", None, "embed"), rules, mesh)

    def combine_experts(c, o, bias):
        # the products of cfg.dtype operands summed in f32, as one
        # device's einsum accumulates them; the partial sums over ep stay
        # f32 and are rounded once, after the constraint adds them
        o = o + bias.to(dt)[None, :, None, :]
        return torch.einsum("gnec,gecd->gnd",
                            c[:, :, e0:e0 + n_e].to(dt).float(), o.float())

    G = sharding_for(("batch", None, "embed"), rules, mesh)
    out = spmd.run(combine_experts, mesh,
                   tuple(Partial() if o.is_shard(1) else g
                         for o, g in zip(O, G)), combine, out_e, lp["b_down"])
    X = sharding_for(("batch", "seq", "embed"), rules, mesh)
    return spmd.run(lambda t: t.to(dt), mesh, X,
                    constrain(out, ("batch", "seq", "embed"), rules,
                              mesh)), aux


def _sharded_embed(params, tokens, cfg: GPTConfig, mesh, rules: Rules):
    """tokens [b, s] DTensor -> x [b, s, d] placed ("batch", "seq",
    "embed") in ``cfg.dtype``."""
    dt = cfg.dtype
    X = sharding_for(("batch", "seq", "embed"), rules, mesh)
    b, s = tokens.shape
    ids = constrain(tokens, ("batch", "seq"), rules, mesh)
    # a vocab-split table gives a partial sum: the constraint completes it
    x = constrain(spmd.embed(params["wte"], ids, mesh),
                  ("batch", "seq", "embed"), rules, mesh)
    p0, _ = spmd.local_span((b, s, cfg.d_model), mesh, X, 1)
    return spmd.run(lambda x, wpe: (x + wpe[p0:p0 + x.shape[1]][None]).to(dt),
                    mesh, X, x, params["wpe"])


def _sharded_head(params, x, cfg: GPTConfig, mesh, rules: Rules):
    """x [b, s, d] -> logits [b, s, vocab] f32 placed ("batch", "seq",
    "vocab")."""
    dt = cfg.dtype

    def head(x, scale, bias, w):
        w = w.to(dt)
        w = w.T if cfg.tie_embeddings else w
        return (_layer_norm(x, scale, bias) @ w).float()

    w_out = params["wte"] if cfg.tie_embeddings else params["lm_head"]
    return spmd.run(head, mesh,
                    sharding_for(("batch", "seq", "vocab"), rules, mesh),
                    x, params["ln_f_scale"], params["ln_f_bias"], w_out)


def stage_fn(cfg: GPTConfig, mesh, rules: Rules = DEFAULT_LLM_RULES):
    """A block of layers, ``(layers, x, aux=0.0) -> (x, aux)``: ``layers``
    the block's stacked leaves and ``x`` [b, s, d], DTensors on ``mesh``
    (placed ("batch", "seq", "embed")), or plain tensors when ``mesh`` is
    None; ``aux`` gathers the MoE aux loss of each layer.  Each layer is
    rematerialised as ``cfg.remat_policy`` says when there is a gradient
    to take.  The whole stack, on one device or a mesh, and one pipeline
    stage."""
    if mesh is None:
        layer, extra = _transformer_layer, (cfg,)
    else:
        layer, extra = _sharded_layer, (cfg, mesh, rules)

    def run(layers, x, aux=0.0):
        n = next(iter(layers.values())).shape[0]
        remat = cfg.remat and torch.is_grad_enabled()
        for lp in spmd.layer_slices(layers, n, mesh):
            if remat:
                x, a = checkpoint(layer, x, lp, *extra, use_reentrant=False,
                                  context_fn=_remat_context(cfg))
            else:
                x, a = layer(x, lp, *extra)
            if cfg.n_experts:
                aux = aux + a
        return x, aux
    return run


def _sharded_forward(params, tokens, cfg: GPTConfig, mesh, rules: Rules,
                     return_kv: bool = False):
    """The forward on a mesh: tokens [b, s] DTensor -> (logits [b, s,
    vocab] f32 DTensor placed ("batch", "seq", "vocab"), the MoE aux
    loss summed over layers: a replicated 0-d DTensor, or 0.0 when
    dense).  A mesh with pp > 1 runs the layer stack as a GPipe pipeline
    (``_forward_pipelined``).  ``return_kv`` (no pp) also returns (k, v),
    [L, b, h, s, hd] DTensors placed (None, "batch", "heads", "seq",
    "kv")."""
    pp = mesh_shape(mesh).get("pp", 1)
    if pp > 1:
        # the JAX package's refusals, before any collective
        if mesh_shape(mesh).get("sp", 1) > 1:
            raise NotImplementedError(
                "sp and pp on the same mesh are not supported; shard long "
                "sequences with sp, deep stacks with pp")
        if cfg.n_layers % pp != 0:
            raise ValueError(f"n_layers {cfg.n_layers} not divisible by "
                             f"pp={pp}")
        M = cfg.pp_microbatches or 2 * pp
        if tokens.shape[0] % M != 0:
            raise ValueError(f"batch {tokens.shape[0]} not divisible by "
                             f"microbatches {M}")
    params = spmd.place_tree(params, param_logical_axes(cfg), rules, mesh)
    x = _sharded_embed(params, tokens, cfg, mesh, rules)
    if return_kv:
        x, aux, kv = _sharded_prefill_layers(params["layers"], x, cfg, mesh,
                                             rules)
        return _sharded_head(params, x, cfg, mesh, rules), aux, kv
    if pp > 1:
        x, aux = _forward_pipelined(params, x, cfg, mesh, rules)
    else:
        x, aux = stage_fn(cfg, mesh, rules)(params["layers"], x)
    return _sharded_head(params, x, cfg, mesh, rules), aux


def _sharded_prefill_layers(layers, x, cfg: GPTConfig, mesh, rules: Rules):
    """The layer stack of the prefill on a mesh: (x, aux, (k, v)), each of
    k and v every layer's heads-split K/V stacked on a new leading dim,
    each rank stacking its own shards."""
    aux, ks, vs = 0.0, [], []
    for lp in spmd.layer_slices(layers, cfg.n_layers, mesh):
        x, a, (kh, vh) = _sharded_layer(x, lp, cfg, mesh, rules,
                                        return_kv=True)
        ks.append(kh)
        vs.append(vh)
        if cfg.n_experts:
            aux = aux + a
    stacked = tuple(Shard(p.dim + 1) if p.is_shard() else p
                    for p in ks[0].placements)

    def stack(*ts):
        return torch.stack(ts)

    return x, aux, (spmd.run(stack, mesh, stacked, *ks),
                    spmd.run(stack, mesh, stacked, *vs))


def _forward_pipelined(params, x, cfg: GPTConfig, mesh, rules: Rules):
    """The layer stack as a GPipe pipeline over pp (``parallel.pipeline``):
    x [b, s, d] -> (x, aux).  The embedding and the head run outside it,
    on every pp rank, as the JAX package runs them under GSPMD; each
    stage runs its own block of layers on the mesh without pp.  With MoE
    the aux loss rides the activation's hand-off; the result is the
    per-microbatch means summed over the M microbatches, over M."""
    S = mesh_shape(mesh)["pp"]
    M = cfg.pp_microbatches or 2 * S
    x_mb = spmd.to_microbatches(x, M, mesh)
    body = stage_fn(cfg, stage_mesh(mesh), rules)
    if cfg.n_experts:
        outs, aux = pipeline_apply(body, x_mb, params["layers"], mesh=mesh,
                                   carry_aux=True)
        aux = aux / M
    else:
        outs = pipeline_apply(lambda lp, x: body(lp, x)[0], x_mb,
                              params["layers"], mesh=mesh)
        aux = 0.0
    return spmd.from_microbatches(outs, mesh), aux


def sample_token(logits, *, temperature: float = 1.0,
                 generator: Optional[torch.Generator] = None):
    """logits [..., vocab] f32 -> token ids [...] int64, shared by
    ``generate`` and the engine.  temperature 0.0 is exact argmax (ties
    break to the lowest index); otherwise softmax sampling from
    ``generator`` (required; it lives on the logits' device)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError("temperature > 0 sampling requires a generator")
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    out = torch.multinomial(flat, 1, generator=generator)
    return out.reshape(probs.shape[:-1])


@torch.no_grad()
def generate(params, cfg: GPTConfig, prompt, max_new: int, *,
             generator: Optional[torch.Generator] = None,
             temperature: float = 1.0):
    """Full-recompute decode, the oracle the engine's greedy output is
    held token-exact against.  prompt [b, s0] int; returns [b, s0+max_new].
    Every step re-runs the whole fixed-width sequence, as the JAX
    package's scan does.  Sampling (temperature > 0) without a
    ``generator`` draws from one seeded with 0 on the prompt's device, as
    the JAX package defaults to ``PRNGKey(0)``."""
    b, s0 = prompt.shape
    total = s0 + max_new
    if total > cfg.max_seq:
        raise ValueError(f"{total} exceeds max_seq {cfg.max_seq}")
    if generator is None and temperature > 0.0:
        generator = torch.Generator(device=prompt.device).manual_seed(0)
    toks = torch.zeros((b, total), dtype=torch.long, device=prompt.device)
    toks[:, :s0] = prompt
    for i in range(s0, total):
        logits = forward(params, toks, cfg)[:, i - 1, :]
        toks[:, i] = sample_token(logits, temperature=temperature,
                                  generator=generator)
    return toks


class GPT:
    """OO convenience wrapper over the functional API."""

    def __init__(self, cfg: GPTConfig):
        self.cfg = cfg

    def init(self, seed: int = 0, *, device=None):
        return init_params(self.cfg, seed, device=device)

    def apply(self, params, tokens, **kw):
        return forward(params, tokens, self.cfg, **kw)

    def loss(self, params, batch):
        return loss_fn(params, batch, self.cfg)
