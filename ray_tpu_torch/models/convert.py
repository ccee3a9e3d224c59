"""Bridge between the JAX package's params pytree (as numpy arrays) and
the port's params dict.  Both use the same leaf names and the stacked
``[n_layers, ...]`` layout, so the bridge only moves bytes: the round
trip ``params_to_numpy(params_from_numpy(tree))`` is bit-exact.

``optax_adam_to_torch`` and ``torch_adam_to_optax`` do the same for Adam's
state: optax's ``ScaleByAdamState(count, mu, nu)`` as numpy trees, and the
port's checkpoint layout ``{"count": int, "mu": tree, "nu": tree}`` (what
``train.step.state_to_host`` writes).  optax's count is torch's ``step``:
both count the updates made, and both correct the moments' bias with it
in the same way."""

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


def optax_adam_to_torch(opt_state) -> dict:
    """optax's Adam state (``ScaleByAdamState`` alone or inside the chain
    tuple that ``optax.adam``/``adamw`` keep, leaves numpy) -> the port's
    ``{"count", "mu", "nu"}``.  Read by field name, so optax need not be
    importable here."""
    node = _adam_node(opt_state)
    if node is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the "
                         f"optimizer state {type(opt_state).__name__}")
    return {"count": int(np.asarray(node.count)), "mu": node.mu,
            "nu": node.nu}


def torch_adam_to_optax(opt: dict, like):
    """The port's ``{"count", "mu", "nu"}`` -> the structure of ``like``
    (an optax Adam state, e.g. ``tx.init(params)``) with its
    ``ScaleByAdamState`` replaced by these values; count as int32, as
    optax keeps it."""
    def rebuild(node):
        if _is_adam(node):
            return node._replace(count=np.asarray(opt["count"], np.int32),
                                 mu=opt["mu"], nu=opt["nu"])
        if isinstance(node, tuple) and not hasattr(node, "_fields"):
            return tuple(rebuild(n) for n in node)
        return node
    if _adam_node(like) is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the "
                         f"template {type(like).__name__}")
    return rebuild(like)


def _is_adam(node) -> bool:
    return all(hasattr(node, f) for f in ("count", "mu", "nu"))


def _adam_node(state):
    if _is_adam(state):
        return state
    if isinstance(state, tuple):
        for n in state:
            found = _adam_node(n)
            if found is not None:
                return found
    return None


def _map(fn, tree):
    return {k: (_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def _pick(like, tree) -> dict:
    """``tree``'s values in ``like``'s nesting and key order (a JAX
    payload's dicts come back with their keys sorted)."""
    return {k: (_pick(v, tree[k]) if isinstance(v, dict) else tree[k])
            for k, v in like.items()}


def _leaves(tree) -> list:
    """The tree's tensors in insertion order, depth first."""
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out
