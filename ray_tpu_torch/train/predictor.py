"""Predictors: a checkpoint's params -> predictions on batches, the port
of ``ray_tpu/train/predictor.py``'s ``Predictor`` and ``JaxPredictor``.

Columns of numpy arrays go in and come out, so a host's batch predictor
(which only calls ``predict``) runs a port predictor unchanged over its
datasets.  A bf16 output comes back as float32: numpy has no bfloat16.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.train.checkpoint import from_host, is_bf16_leaf


class Predictor:
    """Base: subclasses implement predict(batch) -> batch (column dicts
    in, column dicts out)."""

    def predict(self, batch: dict) -> dict:
        raise NotImplementedError

    @classmethod
    def from_checkpoint(cls, checkpoint, **kw) -> "Predictor":
        raise NotImplementedError


class TorchPredictor(Predictor):
    """Wraps ``apply_fn(params, x) -> predictions`` (or a tuple whose
    first element is the predictions), run on ``device`` (None = the CUDA
    card) under ``torch.no_grad``.  ``feature_column`` is the input
    column; the output lands in ``output_column``; the other columns pass
    through.  ``params`` is a tree of tensors, or of numpy arrays as a
    checkpoint payload holds them."""

    def __init__(self, apply_fn: Callable, params: Any, *,
                 feature_column: str = "x",
                 output_column: str = "predictions", device=None):
        self.device = resolve_device(device)
        self._apply = apply_fn
        self._params = _on_device(params, self.device)
        self.feature_column = feature_column
        self.output_column = output_column

    @classmethod
    def from_checkpoint(cls, checkpoint, *, apply_fn: Callable,
                        **kw) -> "TorchPredictor":
        data = checkpoint.to_dict()
        return cls(apply_fn, data.get("params", data), **kw)

    def predict(self, batch: dict) -> dict:
        x = torch.as_tensor(np.asarray(batch[self.feature_column])).to(
            self.device)
        with torch.no_grad():
            out = self._apply(self._params, x)
        if isinstance(out, tuple):
            out = out[0]
        if out.dtype == torch.bfloat16:
            out = out.float()
        result = {k: v for k, v in batch.items()
                  if k != self.feature_column}
        result[self.output_column] = out.cpu().numpy()
        return result


def _on_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict) and not is_bf16_leaf(tree):
        return {k: _on_device(v, device) for k, v in tree.items()}
    return from_host(tree, device)
