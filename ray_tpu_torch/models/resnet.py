"""ResNet, the port of ``ray_tpu/models/resnet.py`` (ResNet-18/34/50 and a
test-sized config).

The API is the JAX package's: NHWC images in, HWIO conv kernels in the
params, functional ``(params, state)`` pairs whose state holds the
BatchNorm running statistics.  Each conv permutes at use: an NHWC tensor
seen as NCHW is already in channels-last memory, the layout cuDNN runs
without transposes, and the output permutes back to NHWC as a view.

Numerics follow the JAX code:

- ``"SAME"`` padding as XLA computes it, ``out = ceil(n / s)``, ``pad =
  max((out - 1) s + k - n, 0)``, ``pad // 2`` before and the rest after:
  a 3x3 stride-2 conv on an even input pads (0, 1), the 7x7 stride-2
  stem on 64x64 pads (2, 3).  The non-CIFAR max-pool is a 3x3 stride-2
  SAME window padded with -inf.
- BatchNorm in f32 over (N, H, W) with the biased variance; running
  stats move as ``m * old + (1 - m) * batch`` (``bn_momentum`` 0.9), the
  opposite convention to ``torch.nn.BatchNorm2d``'s momentum.  The new
  stats carry no gradient, as the JAX package's aux output carries none.
- Activations in ``cfg.dtype``, and the residual add too (the JAX code
  adds ``y + resid`` in ``cfg.dtype``; its module docstring says f32).
  The pooled head runs in f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.convert import _leaves


@dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 10
    stage_sizes: tuple = (2, 2, 2, 2)      # resnet-18
    num_filters: int = 64
    bottleneck: bool = False               # True for resnet-50/101/152
    cifar_stem: bool = True                # 3x3/s1 stem, no maxpool
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5

    @staticmethod
    def resnet18(**kw) -> "ResNetConfig":
        return ResNetConfig(**{**dict(stage_sizes=(2, 2, 2, 2)), **kw})

    @staticmethod
    def resnet34(**kw) -> "ResNetConfig":
        return ResNetConfig(**{**dict(stage_sizes=(3, 4, 6, 3)), **kw})

    @staticmethod
    def resnet50(**kw) -> "ResNetConfig":
        return ResNetConfig(**{**dict(stage_sizes=(3, 4, 6, 3),
                                      bottleneck=True), **kw})

    @staticmethod
    def tiny(**kw) -> "ResNetConfig":
        """Test-sized config."""
        return ResNetConfig(**{**dict(stage_sizes=(1, 1), num_filters=8,
                                      dtype=torch.float32), **kw})


# -- init ------------------------------------------------------------------

def _block_channels(cfg: ResNetConfig, stage: int) -> tuple:
    width = cfg.num_filters * (2 ** stage)
    return (width, width * 4) if cfg.bottleneck else (width, width)


def init_params(cfg: ResNetConfig, seed: int = 0, *, device=None,
                generator: Optional[torch.Generator] = None):
    """Returns (params, state): He-normal conv kernels (HWIO), BN scale 1
    and bias 0, running mean 0 and var 1, head N(0, 0.01), drawn from a
    ``torch.Generator`` on the target device (seeded with ``seed`` unless
    one is passed).  The draws differ from ``jax.random``'s; parity tests
    bridge one set of weights."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    pd = cfg.param_dtype

    def conv(kh, kw, cin, cout):
        std = math.sqrt(2.0 / (kh * kw * cin))
        return (torch.randn((kh, kw, cin, cout), generator=generator,
                            device=dev) * std).to(pd)

    def bn(c):
        return {"scale": torch.ones((c,), dtype=pd, device=dev),
                "bias": torch.zeros((c,), dtype=pd, device=dev)}

    def bn_state(c):
        return {"mean": torch.zeros((c,), device=dev),
                "var": torch.ones((c,), device=dev)}

    k = 3 if cfg.cifar_stem else 7
    params = {"stem_conv": conv(k, k, 3, cfg.num_filters),
              "stem_bn": bn(cfg.num_filters)}
    state = {"stem_bn": bn_state(cfg.num_filters)}

    cin = cfg.num_filters
    for s, n_blocks in enumerate(cfg.stage_sizes):
        width, cout = _block_channels(cfg, s)
        for b in range(n_blocks):
            name = f"stage{s}_block{b}"
            blk, bst = {}, {}
            if cfg.bottleneck:
                shapes = [(1, 1, cin, width), (3, 3, width, width),
                          (1, 1, width, cout)]
            else:
                shapes = [(3, 3, cin, width), (3, 3, width, cout)]
            for i, shape in enumerate(shapes):
                blk[f"conv{i}"] = conv(*shape)
                blk[f"bn{i}"] = bn(shape[-1])
                bst[f"bn{i}"] = bn_state(shape[-1])
            if cin != cout or (b == 0 and s > 0):
                blk["proj"] = conv(1, 1, cin, cout)
                blk["proj_bn"] = bn(cout)
                bst["proj_bn"] = bn_state(cout)
            params[name] = blk
            state[name] = bst
            cin = cout

    params["head"] = {
        "w": (torch.randn((cin, cfg.num_classes), generator=generator,
                          device=dev) * 0.01).to(pd),
        "b": torch.zeros((cfg.num_classes,), dtype=pd, device=dev)}
    return params, state


# -- forward ---------------------------------------------------------------

def _same_pad(n: int, k: int, s: int) -> tuple:
    """(before, after) padding of one spatial dim under XLA's "SAME"."""
    out = -(-n // s)
    pad = max((out - 1) * s + k - n, 0)
    return pad // 2, pad - pad // 2


def _pad_same(x, kh: int, kw: int, stride: int, value: float = 0.0):
    """x [N, H, W, C] padded for a kh x kw window at ``stride``."""
    top, bottom = _same_pad(x.shape[1], kh, stride)
    left, right = _same_pad(x.shape[2], kw, stride)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (0, 0, left, right, top, bottom), value=value)


def _conv(x, w, stride: int = 1):
    """SAME conv, x [N, H, W, Cin] and w [kh, kw, Cin, Cout] (HWIO) ->
    [N, H', W', Cout] in x's dtype."""
    kh, kw = w.shape[0], w.shape[1]
    x = _pad_same(x, kh, kw, stride)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 stride=stride)
    return y.permute(0, 2, 3, 1)


def _max_pool(x, k: int = 3, stride: int = 2):
    """SAME max-pool over H and W with -inf padding, x [N, H, W, C]."""
    x = _pad_same(x, k, k, stride, float("-inf"))
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, stride).permute(0, 2, 3, 1)


def _bn(x, p, st, cfg: ResNetConfig, train: bool):
    """BatchNorm over (N, H, W).  Returns (y, new_stats)."""
    xf = x.float()
    if train:
        mean = xf.mean(dim=(0, 1, 2))
        var = xf.var(dim=(0, 1, 2), correction=0)
        m = cfg.bn_momentum
        new = {"mean": (m * st["mean"] + (1 - m) * mean).detach(),
               "var": (m * st["var"] + (1 - m) * var).detach()}
    else:
        mean, var = st["mean"], st["var"]
        new = st
    y = (xf - mean) * torch.rsqrt(var + cfg.bn_eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype), new


def forward(params, state, x, cfg: ResNetConfig, *, train: bool = True):
    """x [N, H, W, 3] -> (logits [N, classes] f32, new_state)."""
    x = x.to(cfg.dtype)
    new_state = {}
    stride0 = 1 if cfg.cifar_stem else 2
    x = _conv(x, params["stem_conv"], stride0)
    x, new_state["stem_bn"] = _bn(x, params["stem_bn"], state["stem_bn"],
                                  cfg, train)
    x = torch.relu(x)
    if not cfg.cifar_stem:
        x = _max_pool(x)

    n_convs = 3 if cfg.bottleneck else 2
    strided = 1 if cfg.bottleneck else 0      # which conv takes the stride
    for s, n_blocks in enumerate(cfg.stage_sizes):
        for b in range(n_blocks):
            name = f"stage{s}_block{b}"
            blk, bst = params[name], state[name]
            nst = {}
            stride = 2 if (b == 0 and s > 0) else 1
            resid = y = x
            for i in range(n_convs):
                y = _conv(y, blk[f"conv{i}"], stride if i == strided else 1)
                y, nst[f"bn{i}"] = _bn(y, blk[f"bn{i}"], bst[f"bn{i}"],
                                       cfg, train)
                if i < n_convs - 1:
                    y = torch.relu(y)
            if "proj" in blk:
                resid = _conv(resid, blk["proj"], stride)
                resid, nst["proj_bn"] = _bn(resid, blk["proj_bn"],
                                            bst["proj_bn"], cfg, train)
            x = torch.relu(y + resid)
            new_state[name] = nst

    x = x.float().mean(dim=(1, 2))
    h = params["head"]
    logits = x @ h["w"].float() + h["b"].float()
    return logits, new_state


def loss_fn(params, state, batch, cfg: ResNetConfig, *, train: bool = True):
    """batch = {"x": [N, H, W, 3], "y": [N] int labels} ->
    (loss, (new_state, {"accuracy"}))."""
    logits, new_state = forward(params, state, batch["x"], cfg, train=train)
    y = batch["y"].long()
    gold = logits.gather(-1, y[:, None])[:, 0]
    loss = (torch.logsumexp(logits, dim=-1) - gold).mean()
    acc = (logits.argmax(-1) == y).float().mean()
    return loss, (new_state, {"accuracy": acc})


def num_params(params) -> int:
    return sum(t.numel() for t in _leaves(params))


class ResNet:
    """OO convenience wrapper over the functional API."""

    def __init__(self, cfg: ResNetConfig):
        self.cfg = cfg

    def init(self, seed: int = 0, *, device=None):
        return init_params(self.cfg, seed, device=device)

    def apply(self, params, state, x, **kw):
        return forward(params, state, x, self.cfg, **kw)

    def loss(self, params, state, batch, **kw):
        return loss_fn(params, state, batch, self.cfg, **kw)
