"""RL model catalog, the port of ``ray_tpu/models/zoo.py``: fcnet /
visionnet / LSTM / GTrXL trunks and the actor-critic heads the RL
policies consume.

Every net is a (params dict, forward function) pair in the JAX package's
layout, so ``models/convert.py`` bridges the params byte for byte.  The
recurrent state is an explicit carry: the LSTM runs a Python loop over
time where JAX runs ``lax.scan``, and its ``(h, c)`` carry threads
across windows.  Init functions take a ``torch.Generator`` where JAX
takes a key; the draws differ from ``jax.random``'s.

Numerics follow the JAX code: ``gelu`` is the tanh form and ``swish``
is silu; VisionNet's convs are SAME-padded (``resnet._conv``) on NHWC
input, a uint8 observation is scaled to f32 / 255, and the flatten
before ``fc`` is in NHWC order; the LSTM's gates split as i, f, g, o
with +1.0 on the forget gate before its sigmoid; GTrXL is pre-LN, causal
within its window on plain attention (no kernel: its head dim is 16),
with ReLU after ``wo`` and both MLP projections, and gates
``sigmoid(dense([x, y]) - 2.0)``.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.gpt import _layer_norm
from ray_tpu_torch.models.resnet import _conv
from ray_tpu_torch.ops.attention import attention

_ACTS = {"tanh": torch.tanh, "relu": torch.relu,
         "gelu": functools.partial(F.gelu, approximate="tanh"),
         "swish": F.silu}


def _dense_init(generator: torch.Generator, din: int, dout: int,
                scale: Optional[float] = None, dtype=torch.float32) -> dict:
    """w ~ N(0, scale) (He-normal when ``scale`` is None), b = 0, on the
    generator's device."""
    std = math.sqrt(2.0 / din) if scale is None else scale
    dev = generator.device
    return {"w": (torch.randn((din, dout), generator=generator, device=dev)
                  * std).to(dtype),
            "b": torch.zeros((dout,), dtype=dtype, device=dev)}


def _dense(p, x):
    return x @ p["w"] + p["b"]


# -- FCNet -----------------------------------------------------------------

@dataclass(frozen=True)
class FCNetConfig:
    in_dim: int
    hiddens: tuple = (256, 256)
    activation: str = "tanh"

    @property
    def out_dim(self) -> int:
        return self.hiddens[-1]


def fcnet_init(cfg: FCNetConfig, generator: torch.Generator) -> dict:
    dims = (cfg.in_dim, *cfg.hiddens)
    return {f"fc{i}": _dense_init(generator, dims[i], dims[i + 1])
            for i in range(len(dims) - 1)}


def fcnet_forward(params, x, cfg: FCNetConfig):
    act = _ACTS[cfg.activation]
    i = 0
    while f"fc{i}" in params:
        x = act(_dense(params[f"fc{i}"], x))
        i += 1
    return x


# -- VisionNet -------------------------------------------------------------

@dataclass(frozen=True)
class VisionNetConfig:
    """Atari-style CNN trunk.  NHWC in."""
    in_shape: tuple = (84, 84, 4)
    # (out_channels, kernel, stride) per conv layer
    conv_filters: tuple = ((16, 8, 4), (32, 4, 2))
    hidden: int = 256
    activation: str = "relu"

    @property
    def out_dim(self) -> int:
        return self.hidden


def visionnet_init(cfg: VisionNetConfig, generator: torch.Generator) -> dict:
    dev = generator.device
    params = {}
    h, w, cin = cfg.in_shape
    for i, (cout, k, s) in enumerate(cfg.conv_filters):
        params[f"conv{i}"] = (
            torch.randn((k, k, cin, cout), generator=generator, device=dev)
            * math.sqrt(2.0 / (k * k * cin)))
        h = -(-h // s)                   # SAME: ceil(n / s)
        w = -(-w // s)
        cin = cout
    params["fc"] = _dense_init(generator, h * w * cin, cfg.hidden)
    return params


def visionnet_forward(params, x, cfg: VisionNetConfig):
    """x [B, H, W, C] (uint8 or float) -> features [B, hidden]."""
    act = _ACTS[cfg.activation]
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
    for i, (_, _, s) in enumerate(cfg.conv_filters):
        x = act(_conv(x, params[f"conv{i}"], s))
    x = x.reshape(x.shape[0], -1)               # NHWC order
    return act(_dense(params["fc"], x))


# -- LSTM ------------------------------------------------------------------

@dataclass(frozen=True)
class LSTMNetConfig:
    in_dim: int
    cell_size: int = 256

    @property
    def out_dim(self) -> int:
        return self.cell_size


def lstm_init(cfg: LSTMNetConfig, generator: torch.Generator) -> dict:
    d, c = cfg.in_dim, cfg.cell_size
    return {"wx": _dense_init(generator, d, 4 * c, scale=math.sqrt(1.0 / d)),
            "wh": _dense_init(generator, c, 4 * c, scale=math.sqrt(1.0 / c))}


def lstm_initial_state(cfg: LSTMNetConfig, batch: int, *, device=None):
    z = torch.zeros((batch, cfg.cell_size), device=resolve_device(device))
    return (z, z)


def lstm_forward(params, x, carry, cfg: LSTMNetConfig):
    """x [B, T, D], carry (h, c) [B, cell] -> ([B, T, cell], carry).  The
    input projection of every step runs as one product before the loop."""
    h, c = carry
    gx = _dense(params["wx"], x)                            # [B, T, 4c]
    ys = []
    for t in range(x.shape[1]):
        gates = gx[:, t] + _dense(params["wh"], h)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, dim=1), (h, c)


# -- GTrXL -----------------------------------------------------------------

@dataclass(frozen=True)
class GTrXLConfig:
    """Gated Transformer-XL trunk over an observation window."""
    in_dim: int
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 128

    @property
    def out_dim(self) -> int:
        return self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def gtrxl_init(cfg: GTrXLConfig, generator: torch.Generator) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dev = generator.device
    params = {"embed": _dense_init(generator, cfg.in_dim, d)}
    for i in range(cfg.n_layers):
        params[f"layer{i}"] = {
            "ln1_scale": torch.ones((d,), device=dev),
            "ln1_bias": torch.zeros((d,), device=dev),
            "wqkv": _dense_init(generator, d, 3 * d, scale=0.02),
            "wo": _dense_init(generator, d, d, scale=0.02),
            "wg_attn": _dense_init(generator, 2 * d, d, scale=0.02),
            "ln2_scale": torch.ones((d,), device=dev),
            "ln2_bias": torch.zeros((d,), device=dev),
            "w_up": _dense_init(generator, d, f, scale=0.02),
            "w_down": _dense_init(generator, f, d, scale=0.02),
            "wg_mlp": _dense_init(generator, 2 * d, d, scale=0.02),
        }
    return params


def _gate(p, x, y):
    """Sigmoid gate (1 - g) x + g y, g = sigmoid(dense([x, y]) - 2.0):
    g is about 0.12 at init, so each block starts near the residual
    path."""
    g = torch.sigmoid(_dense(p, torch.cat([x, y], dim=-1)) - 2.0)
    return (1 - g) * x + g * y


def gtrxl_forward(params, x, cfg: GTrXLConfig):
    """x [B, T, in_dim] -> features [B, T, d_model].  Causal within the
    window (memory = the window itself; no cross-window cache)."""
    b, t, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    x = _dense(params["embed"], x)
    for i in range(cfg.n_layers):
        lp = params[f"layer{i}"]
        y = _layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
        q, k, v = _dense(lp["wqkv"], y).split(cfg.d_model, dim=-1)

        def heads(z):
            return z.reshape(b, t, h, hd).transpose(1, 2)

        o = attention(heads(q), heads(k), heads(v), causal=True,
                      impl="reference")
        o = o.transpose(1, 2).reshape(b, t, cfg.d_model)
        x = _gate(lp["wg_attn"], x, torch.relu(_dense(lp["wo"], o)))

        y = _layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
        u = torch.relu(_dense(lp["w_up"], y))
        x = _gate(lp["wg_mlp"], x, torch.relu(_dense(lp["w_down"], u)))
    return x


# -- actor-critic assembly -------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    """Catalog config: pick a trunk by name; ActorCritic attaches the
    heads."""
    kind: str = "fcnet"              # fcnet | visionnet | lstm | gtrxl
    obs_shape: tuple = (4,)
    num_actions: int = 2
    fcnet_hiddens: tuple = (256, 256)
    fcnet_activation: str = "tanh"
    conv_filters: tuple = ((16, 8, 4), (32, 4, 2))
    cell_size: int = 256
    attn_dim: int = 64
    attn_layers: int = 2


def _trunk_for(cfg: ModelConfig):
    if cfg.kind == "fcnet":
        c = FCNetConfig(int(np.prod(cfg.obs_shape)), cfg.fcnet_hiddens,
                        cfg.fcnet_activation)
        return c, fcnet_init, lambda p, x, c=c: fcnet_forward(p, x, c)
    if cfg.kind == "visionnet":
        c = VisionNetConfig(tuple(cfg.obs_shape), cfg.conv_filters)
        return c, visionnet_init, lambda p, x, c=c: visionnet_forward(p, x, c)
    if cfg.kind == "lstm":
        c = LSTMNetConfig(int(np.prod(cfg.obs_shape)), cfg.cell_size)
        return c, lstm_init, None   # recurrent: handled by caller
    if cfg.kind == "gtrxl":
        c = GTrXLConfig(int(np.prod(cfg.obs_shape)), cfg.attn_dim,
                        n_layers=cfg.attn_layers)
        return c, gtrxl_init, None  # sequence trunk: handled by caller
    raise ValueError(f"unknown model kind {cfg.kind!r}")


class ActorCritic:
    """Trunk + pi/V heads.

    apply(params, obs) -> (logits, value) for feedforward trunks;
    apply_seq(params, obs_seq, state) for lstm/gtrxl.
    """

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.trunk_cfg, self._trunk_init, self._trunk_fwd = _trunk_for(cfg)

    @property
    def is_recurrent(self) -> bool:
        return self.cfg.kind in ("lstm", "gtrxl")

    def init(self, seed: int = 0, *, device=None,
             generator: Optional[torch.Generator] = None) -> dict:
        """Trunk, then pi (scale 0.01) and vf (scale 1.0) heads, drawn in
        that order from one ``torch.Generator`` on the target device."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(int(seed))
        f = self.trunk_cfg.out_dim
        return {"trunk": self._trunk_init(self.trunk_cfg, generator),
                "pi": _dense_init(generator, f, self.cfg.num_actions,
                                  scale=0.01),
                "vf": _dense_init(generator, f, 1, scale=1.0)}

    def initial_state(self, batch: int, *, device=None):
        if self.cfg.kind == "lstm":
            return lstm_initial_state(self.trunk_cfg, batch, device=device)
        return None

    def apply(self, params, obs):
        """Feedforward path: obs [B, ...] -> (logits [B, A], value [B])."""
        if self.is_recurrent:
            raise ValueError(
                f"{self.cfg.kind} is recurrent/sequential — use "
                "apply_seq(params, obs[B, T, ...], state)")
        if self.cfg.kind == "visionnet":
            feats = visionnet_forward(params["trunk"], obs, self.trunk_cfg)
        else:
            feats = self._trunk_fwd(params["trunk"],
                                    obs.reshape(obs.shape[0], -1))
        logits = _dense(params["pi"], feats)
        value = _dense(params["vf"], feats)[:, 0]
        return logits, value

    def apply_seq(self, params, obs, state=None):
        """Sequence path: obs [B, T, ...] -> (logits [B, T, A], value
        [B, T], new_state).  An lstm with no ``state`` starts from zeros
        on the observations' device."""
        b, t = obs.shape[:2]
        if self.cfg.kind == "visionnet":
            feats = visionnet_forward(
                params["trunk"], obs.reshape(b * t, *self.cfg.obs_shape),
                self.trunk_cfg).reshape(b, t, -1)
            logits = _dense(params["pi"], feats)
            value = _dense(params["vf"], feats)[..., 0]
            return logits, value, state
        flat = obs.reshape(b, t, -1)
        if self.cfg.kind == "lstm":
            if state is None:
                state = self.initial_state(b, device=obs.device)
            feats, state = lstm_forward(params["trunk"], flat, state,
                                        self.trunk_cfg)
        elif self.cfg.kind == "gtrxl":
            feats = gtrxl_forward(params["trunk"], flat, self.trunk_cfg)
        else:
            feats = self._trunk_fwd(params["trunk"],
                                    flat.reshape(b * t, -1)).reshape(
                                        b, t, -1)
        logits = _dense(params["pi"], feats)
        value = _dense(params["vf"], feats)[..., 0]
        return logits, value, state
