"""Bridge between the JAX package's params pytree (as numpy arrays) and
the port's params dict.  Both use the same leaf names and the stacked
``[n_layers, ...]`` layout, so the bridge only moves bytes: the round
trip ``params_to_numpy(params_from_numpy(tree))`` is bit-exact.

On a mesh (``params_from_numpy(..., mesh=, logical=)``) each leaf becomes
a DTensor placed by its logical axes, every rank copying only its own
block to its device (no scatter); ``params_to_numpy`` gathers DTensor
leaves back whole (``full_tensor``, a collective every rank must join).

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
from torch.distributed.tensor import DTensor, Replicate

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.parallel.sharding import (DEFAULT_LLM_RULES, Rules,
                                             local_shard, sharding_for)
from ray_tpu_torch.parallel.spmd import tree_leaves as _leaves
from ray_tpu_torch.parallel.spmd import tree_map as _map
from ray_tpu_torch.parallel.spmd import tree_unflatten as _unflatten


def params_from_numpy(tree, device=None,
                      dtype: Optional[torch.dtype] = None, *, mesh=None,
                      logical=None, rules: Rules = DEFAULT_LLM_RULES) -> dict:
    """Nested dict of numpy arrays -> same nesting of torch tensors on
    ``device`` (None = the CUDA card).  ``dtype`` recasts floating leaves;
    by default each leaf keeps its own dtype.  With ``mesh`` the leaves
    are DTensors on it, placed as ``logical`` (the model's logical axes,
    a tree like ``tree``) and ``rules`` say, replicated without
    ``logical``; the device is the mesh's."""
    def conv(a, axes=None):
        t = torch.from_numpy(np.array(a, copy=mesh is None))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        if mesh is None:
            return t.to(dev)
        pl = (sharding_for(axes, rules, mesh) if axes is not None
              else [Replicate()] * mesh.ndim)
        return local_shard(t, mesh, pl, device=dev)

    if mesh is None:
        dev = resolve_device(device)
        return _map(conv, tree)
    dev = torch.device(mesh.device_type)
    if logical is None:
        return _map(conv, tree)
    return _map2(conv, tree, logical)


def params_to_numpy(params) -> dict:
    """The port's params -> nested dict of numpy arrays on the host
    (DTensor leaves gathered whole)."""
    def conv(t):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        return t.detach().cpu().numpy()
    return _map(conv, params)


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


def _map2(fn, tree, other):
    """``fn(leaf, other's leaf)`` over ``tree``, ``other`` nested alike."""
    return {k: (_map2(fn, v, other[k]) if isinstance(v, dict)
                else fn(v, other[k])) for k, v in tree.items()}


def _pick(like, tree) -> dict:
    """``tree``'s values in ``like``'s nesting and key order (a JAX
    payload's dicts come back with their keys sorted)."""
    return {k: (_pick(v, tree[k]) if isinstance(v, dict) else tree[k])
            for k, v in like.items()}
