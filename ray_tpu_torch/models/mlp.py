"""MLP classifier, the port of ``ray_tpu/models/mlp.py``: the minimal
model for tests and examples.

Params are ``{"layer{i}": {"w": [din, dout], "b": [dout]}}`` in the JAX
package's layout, so ``models/convert.py`` bridges them byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ray_tpu_torch._device import resolve_device


@dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: tuple = (128, 128)
    out_dim: int = 10
    dtype: torch.dtype = torch.float32


def init_params(cfg: MLPConfig, seed: int = 0, *, device=None,
                generator: Optional[torch.Generator] = None) -> dict:
    """He-normal weights, zero biases, drawn from a ``torch.Generator`` on
    the target device (seeded with ``seed`` unless one is passed).  The
    draws differ from ``jax.random``'s; parity tests bridge one set of
    weights."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    dims = (cfg.in_dim, *cfg.hidden, cfg.out_dim)
    return {
        f"layer{i}": {
            "w": (torch.randn((dims[i], dims[i + 1]), generator=generator,
                              device=dev) * (2.0 / dims[i]) ** 0.5
                  ).to(cfg.dtype),
            "b": torch.zeros((dims[i + 1],), dtype=cfg.dtype, device=dev),
        }
        for i in range(len(dims) - 1)
    }


def forward(params, x, cfg: MLPConfig):
    n = len(params)
    for i in range(n):
        lp = params[f"layer{i}"]
        x = x @ lp["w"] + lp["b"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def _nll(logits, y):
    """Per-row logsumexp - gold logit, in the logits' dtype."""
    gold = logits.gather(-1, y.long()[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1) - gold


def loss_fn(params, batch, cfg: MLPConfig):
    """batch = {"x": [b, in_dim], "y": [b] int labels}"""
    return _nll(forward(params, batch["x"], cfg), batch["y"]).mean()


def accuracy(params, batch, cfg: MLPConfig):
    logits = forward(params, batch["x"], cfg)
    return (logits.argmax(-1) == batch["y"]).float().mean()


class MLP:
    def __init__(self, cfg: MLPConfig):
        self.cfg = cfg

    def init(self, seed: int = 0, *, device=None):
        return init_params(self.cfg, seed, device=device)

    def apply(self, params, x):
        return forward(params, x, self.cfg)

    def loss(self, params, batch):
        return loss_fn(params, batch, self.cfg)
