"""Bridge between the JAX package's params pytree (as numpy arrays) and
the port's params dict.  Both use the same leaf names and the stacked
``[n_layers, ...]`` layout, so the bridge only moves bytes: the round
trip ``params_to_numpy(params_from_numpy(tree))`` is bit-exact."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device


def params_from_numpy(tree, device=None,
                      dtype: Optional[torch.dtype] = None) -> dict:
    """Nested dict of numpy arrays -> same nesting of torch tensors on
    ``device`` (None = the CUDA card).  ``dtype`` recasts floating leaves;
    by default each leaf keeps its own dtype."""
    dev = resolve_device(device)

    def conv(a):
        t = torch.from_numpy(np.array(a, copy=True))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return _map(conv, tree)


def params_to_numpy(params) -> dict:
    """The port's params -> nested dict of numpy arrays on the host."""
    return _map(lambda t: t.detach().cpu().numpy(), params)


def _map(fn, tree):
    return {k: (_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def _leaves(tree) -> list:
    """The tree's tensors in insertion order, depth first."""
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out
