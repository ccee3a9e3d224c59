"""BERT: bidirectional transformer encoder, the port of
``ray_tpu/models/bert.py``.

Params are a plain dict in the JAX package's stacked layout (every
``layers`` leaf has a leading ``[n_layers]`` dim, ``PARAM_AXES``), so
``models/convert.py`` bridges them byte for byte; the layer loop is a
Python loop where JAX had ``lax.scan``.  Post-LN blocks, tanh-form gelu
(``jax.nn.gelu``'s default), the f32 layer norm shared with the GPT.

Attention: a batch with no ``attention_mask`` goes through
``ops.attention``'s dispatch, non-causal, which picks the Hopper flash
kernels for CUDA inputs at s % 128 == 0 and a head dim of 64, 128 or
256; a padded batch takes plain attention with the mask ``[b, 1, 1, s]``
and launches no kernel.  With ``cfg.remat`` (a bool, as in JAX) each
layer runs under ``torch.utils.checkpoint`` and is recomputed in full in
the backward pass, so a training step runs the flash forward twice per
layer and each backward kernel once.

The mesh arm (``encode``/``loss_fn`` with ``mesh=``): as GPT's (see
``models/gpt.py``), the params and the batch are DTensors placed by their
logical axes and ``rules``, each stretch of a layer between two of the
JAX package's sharding constraints runs on local shards, attention runs
on each rank's heads and batch rows with the sequence whole (the JAX
package's plain attention on an sp mesh gathers it too), and the MLM
loss is a vocab-parallel cross-entropy.  A mesh with pp > 1 runs the
encoder stack as a GPipe pipeline (``parallel.pipeline``), the
embedding and the MLM head on every pp rank; as in the JAX package, an
``attention_mask`` there raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, noop_context_fn

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.convert import _leaves
# the shared f32 layer norm and the mesh arm's attention stretch
from ray_tpu_torch.models.gpt import _layer_norm, _sharded_attention
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.parallel import spmd
from ray_tpu_torch.parallel.mesh import mesh_shape
from ray_tpu_torch.parallel.pipeline import pipeline_apply, stage_mesh
from ray_tpu_torch.parallel.sharding import (DEFAULT_LLM_RULES, Rules,
                                             constrain, sharding_for)


@dataclass(frozen=True)
class BERTConfig:
    vocab_size: int = 30592          # bert-base vocab padded to 128
    max_seq: int = 512
    type_vocab: int = 2
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    ignore_index: int = -100         # label value meaning "not an MLM target"
    attn_impl: Optional[str] = None  # None=auto (flash on CUDA), "reference"
    pp_microbatches: Optional[int] = None  # kept for the config's shape

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @staticmethod
    def bert_base(**kw) -> "BERTConfig":
        return BERTConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "BERTConfig":
        return BERTConfig(**{**dict(vocab_size=512, max_seq=128, d_model=64,
                                    n_heads=4, n_layers=2, d_ff=128,
                                    remat=False, dtype=torch.float32), **kw})


PARAM_AXES = {
    "wte": ("vocab", "embed"),
    "wpe": (None, "embed"),
    "wtype": (None, "embed"),
    "ln_emb_scale": ("embed",),
    "ln_emb_bias": ("embed",),
    "layers": {
        "wqkv": ("layers", "embed", "qkv"),
        "wo": ("layers", "heads", "embed"),
        "bo": ("layers", "embed"),
        "ln1_scale": ("layers", "embed"),
        "ln1_bias": ("layers", "embed"),
        "w_up": ("layers", "embed", "mlp"),
        "b_up": ("layers", "mlp"),
        "w_down": ("layers", "mlp", "embed"),
        "b_down": ("layers", "embed"),
        "ln2_scale": ("layers", "embed"),
        "ln2_bias": ("layers", "embed"),
    },
    "mlm_dense_w": ("embed", "embed"),
    "mlm_dense_b": ("embed",),
    "mlm_ln_scale": ("embed",),
    "mlm_ln_bias": ("embed",),
    "mlm_bias": ("vocab",),
    "pooler_w": ("embed", "embed"),
    "pooler_b": ("embed",),
}


def param_logical_axes(cfg: BERTConfig) -> dict:
    return dict(PARAM_AXES)


def init_params(cfg: BERTConfig, seed: int = 0, *, device=None,
                generator: Optional[torch.Generator] = None) -> dict:
    """N(0, 0.02) weights, the two residual projections (``wo``,
    ``w_down``) scaled by 1/sqrt(2 n_layers), unit norm scales and zero
    biases, drawn from a ``torch.Generator`` on the target device (seeded
    with ``seed`` unless one is passed).  The draws differ from
    ``jax.random``'s; parity tests bridge one set of weights."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    d, L, f = cfg.d_model, cfg.n_layers, cfg.d_ff
    pd, std = cfg.param_dtype, 0.02

    def norm(shape, s=std):
        return (torch.randn(shape, generator=generator, device=dev)
                * s).to(pd)

    def zeros(shape):
        return torch.zeros(shape, dtype=pd, device=dev)

    def ones(shape):
        return torch.ones(shape, dtype=pd, device=dev)

    return {
        "wte": norm((cfg.vocab_size, d)),
        "wpe": norm((cfg.max_seq, d)),
        "wtype": norm((cfg.type_vocab, d)),
        "ln_emb_scale": ones((d,)),
        "ln_emb_bias": zeros((d,)),
        "layers": {
            "wqkv": norm((L, d, 3 * d)),
            "wo": norm((L, d, d), std / math.sqrt(2 * L)),
            "bo": zeros((L, d)),
            "ln1_scale": ones((L, d)),
            "ln1_bias": zeros((L, d)),
            "w_up": norm((L, d, f)),
            "b_up": zeros((L, f)),
            "w_down": norm((L, f, d), std / math.sqrt(2 * L)),
            "b_down": zeros((L, d)),
            "ln2_scale": ones((L, d)),
            "ln2_bias": zeros((L, d)),
        },
        "mlm_dense_w": norm((d, d)),
        "mlm_dense_b": zeros((d,)),
        "mlm_ln_scale": ones((d,)),
        "mlm_ln_bias": zeros((d,)),
        "mlm_bias": zeros((cfg.vocab_size,)),
        "pooler_w": norm((d, d)),
        "pooler_b": zeros((d,)),
    }


def _encoder_layer(x, lp, attn_mask, cfg: BERTConfig):
    """One post-LN block; x [b, s, d], lp = one layer's params."""
    b, s, _ = x.shape
    h, hd, dt = cfg.n_heads, cfg.head_dim, cfg.dtype
    qkv = x @ lp["wqkv"].to(dt)
    q, k, v = qkv.split(cfg.d_model, dim=-1)

    def heads(t):  # [b, s, d] -> [b, h, s, hd] (a strided view)
        return t.reshape(b, s, h, hd).transpose(1, 2)

    # dispatch (the flash kernel on CUDA) when there is no padding mask;
    # the masked path needs plain attention
    impl = "reference" if attn_mask is not None else cfg.attn_impl
    o = attention(heads(q), heads(k), heads(v), causal=False,
                  mask=attn_mask, impl=impl)
    o = o.transpose(1, 2).reshape(b, s, cfg.d_model)
    o = o @ lp["wo"].to(dt) + lp["bo"].to(dt)
    x = _layer_norm(x + o, lp["ln1_scale"], lp["ln1_bias"])      # post-LN

    u = x @ lp["w_up"].to(dt) + lp["b_up"].to(dt)
    u = F.gelu(u, approximate="tanh")      # jax.nn.gelu's default
    dn = u @ lp["w_down"].to(dt) + lp["b_down"].to(dt)
    return _layer_norm(x + dn, lp["ln2_scale"], lp["ln2_bias"])


def encode(params, tokens, cfg: BERTConfig, *,
           attention_mask: Optional[torch.Tensor] = None,
           token_type_ids: Optional[torch.Tensor] = None,
           mesh=None, rules: Rules = DEFAULT_LLM_RULES):
    """tokens [b, s] int -> hidden [b, s, d] (cfg.dtype).  The embedding
    sum runs in the params' dtype and is cast to ``cfg.dtype`` before its
    layer norm.  On a mesh everything is DTensors and so is the result,
    placed ("batch", "seq", "embed")."""
    if mesh is not None:
        return _sharded_encode(params, tokens, cfg, mesh, rules,
                               attention_mask, token_type_ids)
    s = tokens.shape[1]
    x = params["wte"][tokens.long()] + params["wpe"][:s][None, :, :]
    if token_type_ids is not None:
        x = x + params["wtype"][token_type_ids.long()]
    x = _layer_norm(x.to(cfg.dtype), params["ln_emb_scale"],
                    params["ln_emb_bias"])

    # [b, 1, 1, s] boolean mask broadcast over (h, q)
    attn_mask = None
    if attention_mask is not None:
        attn_mask = attention_mask[:, None, None, :].bool()

    # one unbind per stacked leaf: its backward stacks the per-layer
    # grads in one op
    layers = {name: t.unbind(0) for name, t in params["layers"].items()}
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = {name: ts[i] for name, ts in layers.items()}
        if remat:
            x = checkpoint(_encoder_layer, x, lp, attn_mask, cfg,
                           use_reentrant=False, context_fn=noop_context_fn)
        else:
            x = _encoder_layer(x, lp, attn_mask, cfg)
    return x


def mlm_logits(params, hidden, cfg: BERTConfig):
    """MLM head: dense + gelu + LN in the activation dtype, then the tied
    embedding projection, in f32 from the product on."""
    dt = hidden.dtype
    y = hidden @ params["mlm_dense_w"].to(dt) + params["mlm_dense_b"].to(dt)
    y = F.gelu(y, approximate="tanh")
    y = _layer_norm(y, params["mlm_ln_scale"], params["mlm_ln_bias"])
    logits = y @ params["wte"].to(dt).T
    return logits.float() + params["mlm_bias"].float()


def pool(params, hidden):
    """[CLS] pooler: tanh(dense(hidden[:, 0]))."""
    cls = hidden[:, 0, :]
    return torch.tanh(cls @ params["pooler_w"].to(cls.dtype)
                      + params["pooler_b"].to(cls.dtype))


def loss_fn(params, batch, cfg: BERTConfig, *, mesh=None,
            rules: Rules = DEFAULT_LLM_RULES):
    """Masked-LM cross-entropy, the mean over labelled positions (at
    least one).  batch = {"input_ids": [b, s] int, "labels": [b, s] int
    with ``ignore_index`` where not masked, optional "attention_mask" and
    "token_type_ids": [b, s]}.  On a mesh the batch holds DTensors and
    the loss is a replicated 0-d DTensor."""
    hidden = encode(params, batch["input_ids"], cfg,
                    attention_mask=batch.get("attention_mask"),
                    token_type_ids=batch.get("token_type_ids"),
                    mesh=mesh, rules=rules)
    if mesh is not None:
        logits = _sharded_mlm_logits(params, hidden, cfg, mesh, rules)
        return spmd.mean_nll(logits, batch["labels"], mesh,
                             ignore_index=cfg.ignore_index)
    logits = mlm_logits(params, hidden, cfg)
    labels = batch["labels"].long()
    valid = labels != cfg.ignore_index
    safe = torch.where(valid, labels, 0)
    gold = logits.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, torch.logsumexp(logits, dim=-1) - gold, 0.0)
    return nll.sum() / valid.sum().clamp_min(1)


# -- the mesh arm ----------------------------------------------------------

def _sharded_layer(x, lp, mask, cfg: BERTConfig, mesh, rules: Rules):
    """``_encoder_layer`` on a mesh: x [b, s, d] placed ("batch", "seq",
    "embed"), lp the layer's DTensors, mask the [b, s] attention mask
    DTensor or None."""
    dt = cfg.dtype
    X = sharding_for(("batch", "seq", "embed"), rules, mesh)

    def proj(x, w):
        return x @ w.to(dt)

    def post_ln(x, y, bias, scale, shift):
        return _layer_norm(x + (y + bias.to(dt)), scale, shift)

    def up(x, w, b):
        return F.gelu(x @ w.to(dt) + b.to(dt), approximate="tanh")

    qkv = spmd.run(proj, mesh,
                   sharding_for(("batch", "seq", "qkv"), rules, mesh),
                   x, lp["wqkv"])
    if mask is None:
        def attend(q, k, v):
            return attention(q, k, v, causal=False, impl=cfg.attn_impl)
    else:
        # the padded path: plain attention under this rank's rows of the
        # [b, s] mask, broadcast [b, 1, 1, s]
        def attend(q, k, v, m):
            return attention(q, k, v, causal=False,
                             mask=m[:, None, None, :].bool(),
                             impl="reference")
    o = _sharded_attention(qkv, cfg.n_heads, mesh, rules, attend, seq=None,
                           mask=mask)
    o = constrain(spmd.dense(o, lp["wo"], mesh, dt),
                  ("batch", "seq", "embed"), rules, mesh)
    x = spmd.run(post_ln, mesh, X, x, o, lp["bo"], lp["ln1_scale"],
                 lp["ln1_bias"])
    u = spmd.run(up, mesh, sharding_for(("batch", "seq", "mlp"), rules,
                                        mesh), x, lp["w_up"], lp["b_up"])
    dn = constrain(spmd.dense(u, lp["w_down"], mesh, dt),
                   ("batch", "seq", "embed"), rules, mesh)
    return spmd.run(post_ln, mesh, X, x, dn, lp["b_down"], lp["ln2_scale"],
                    lp["ln2_bias"])


def _sharded_encode(params, tokens, cfg: BERTConfig, mesh, rules: Rules,
                    attention_mask, token_type_ids):
    """``encode`` on a mesh; with pp > 1 the encoder stack is a GPipe
    pipeline (``parallel.pipeline``), the embedding outside it."""
    dt = cfg.dtype
    pp = mesh_shape(mesh).get("pp", 1)
    if pp > 1:
        # the JAX package's refusals, before any collective
        if attention_mask is not None:
            raise NotImplementedError(
                "attention_mask + pp pipeline is not supported yet; "
                "pad-free batches only on pp meshes")
        if cfg.n_layers % pp != 0:
            raise ValueError(
                f"n_layers {cfg.n_layers} not divisible by pp={pp}")
        M = cfg.pp_microbatches or 2 * pp
        if tokens.shape[0] % M != 0:
            raise ValueError(f"batch {tokens.shape[0]} not divisible by "
                             f"microbatches {M}")
    params = spmd.place_tree(params, PARAM_AXES, rules, mesh)
    X = sharding_for(("batch", "seq", "embed"), rules, mesh)
    b, s = tokens.shape
    ids = constrain(tokens, ("batch", "seq"), rules, mesh)
    # a vocab-split table gives a partial sum: the constraint completes it
    x = constrain(spmd.embed(params["wte"], ids, mesh),
                  ("batch", "seq", "embed"), rules, mesh)
    p0, _ = spmd.local_span((b, s, cfg.d_model), mesh, X, 1)

    def emb(x, wpe, scale, bias, *tt):
        x = x + wpe[p0:p0 + x.shape[1]][None]
        if tt:
            x = x + tt[0]
        return _layer_norm(x.to(dt), scale, bias)

    extra = ()
    if token_type_ids is not None:
        tt = constrain(token_type_ids, ("batch", "seq"), rules, mesh)
        extra = (constrain(spmd.embed(params["wtype"], tt, mesh),
                           ("batch", "seq", "embed"), rules, mesh),)
    x = spmd.run(emb, mesh, X, x, params["wpe"], params["ln_emb_scale"],
                 params["ln_emb_bias"], *extra)

    if pp > 1:
        x_mb = spmd.to_microbatches(x, M, mesh)
        outs = pipeline_apply(_stage_fn(cfg, stage_mesh(mesh), rules), x_mb,
                              params["layers"], mesh=mesh)
        return spmd.from_microbatches(outs, mesh)
    return _stage_fn(cfg, mesh, rules, attention_mask)(params["layers"], x)


def _stage_fn(cfg: BERTConfig, mesh, rules: Rules, mask=None):
    """A block of encoder layers, ``(layers, x) -> x``, on ``mesh``
    (DTensors) or on plain tensors when ``mesh`` is None (a pipeline
    stage on a pp-only mesh); each layer fully recomputed in the backward
    pass with ``cfg.remat``."""
    if mesh is None:
        layer, extra = _encoder_layer, (mask, cfg)
    else:
        layer, extra = _sharded_layer, (mask, cfg, mesh, rules)

    def run(layers, x):
        n = next(iter(layers.values())).shape[0]
        remat = cfg.remat and torch.is_grad_enabled()
        for lp in spmd.layer_slices(layers, n, mesh):
            if remat:
                x = checkpoint(layer, x, lp, *extra, use_reentrant=False,
                               context_fn=noop_context_fn)
            else:
                x = layer(x, lp, *extra)
        return x
    return run


def _sharded_mlm_logits(params, hidden, cfg: BERTConfig, mesh,
                        rules: Rules):
    """``mlm_logits`` on a mesh: [b, s, vocab] f32 placed ("batch",
    "seq", "vocab")."""
    params = spmd.place_tree(params, PARAM_AXES, rules, mesh)

    def head(h, w, b, scale, shift, wte, bias):
        dt = h.dtype
        y = F.gelu(h @ w.to(dt) + b.to(dt), approximate="tanh")
        y = _layer_norm(y, scale, shift)
        return (y @ wte.to(dt).T).float() + bias.float()

    return spmd.run(head, mesh,
                    sharding_for(("batch", "seq", "vocab"), rules, mesh),
                    hidden, params["mlm_dense_w"], params["mlm_dense_b"],
                    params["mlm_ln_scale"], params["mlm_ln_bias"],
                    params["wte"], params["mlm_bias"])


def num_params(params) -> int:
    return sum(t.numel() for t in _leaves(params))


class BERT:
    """OO convenience wrapper over the functional API."""

    def __init__(self, cfg: BERTConfig):
        self.cfg = cfg

    def init(self, seed: int = 0, *, device=None):
        return init_params(self.cfg, seed, device=device)

    def logical_axes(self):
        return param_logical_axes(self.cfg)

    def encode(self, params, tokens, **kw):
        return encode(params, tokens, self.cfg, **kw)

    def loss(self, params, batch, **kw):
        return loss_fn(params, batch, self.cfg, **kw)
