"""Logical-axis sharding rules, the port of ``ray_tpu/parallel/sharding.py``.

Parallelism is declared as a mapping from *logical* tensor axes ("batch",
"heads", "vocab", ...) to mesh axes.  ``spec_for`` gives, per tensor dim,
the mesh axes it is split over: the same tuple as the JAX package's
``PartitionSpec``.  ``sharding_for`` turns that into DTensor placements,
one per mesh dim, and ``constrain`` (the counterpart of
``with_sharding_constraint``) redistributes a DTensor to them, doing
nothing when it is already placed so.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)

from ray_tpu_torch.parallel.mesh import mesh_shape

# rules: logical axis name -> mesh axis (or tuple of mesh axes, or None)
Rules = dict[str, Union[str, tuple[str, ...], None]]

# transformer LLMs on a dp/fsdp/tp/sp mesh: batch over the data axes,
# heads/mlp/vocab over tp, sequence over sp; "embed" stays whole, so
# fsdp splits only the batch
DEFAULT_LLM_RULES: Rules = {
    "batch": ("dcn", "dp", "fsdp"),
    "seq": "sp",
    "embed": None,
    "mlp": "tp",
    "heads": "tp",
    "kv": None,
    "qkv": "tp",
    "vocab": "tp",
    "expert": "ep",
    # layer stacks shard over pp; _prune drops the rule on meshes
    # without a pp axis
    "layers": "pp",
    "stage": "pp",
}


def _prune(rule, mesh: DeviceMesh):
    """Drop mesh axes absent from ``mesh`` (or of size 1)."""
    shape = mesh_shape(mesh)
    if rule is None:
        return None
    if isinstance(rule, str):
        rule = (rule,)
    kept = tuple(a for a in rule if shape.get(a, 1) > 1)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def spec_for(logical_axes: Sequence[Optional[str]], rules: Rules,
             mesh: DeviceMesh) -> tuple:
    """Logical axes of one array -> per dim None, a mesh axis or a tuple
    of mesh axes (outermost first), as ``PartitionSpec`` holds them."""
    used: set = set()
    out = []
    for ax in logical_axes:
        if ax is None:
            out.append(None)
            continue
        rule = _prune(rules.get(ax), mesh)
        # a mesh axis may appear at most once in a spec
        if rule is not None:
            axes = (rule,) if isinstance(rule, str) else rule
            axes = tuple(a for a in axes if a not in used)
            used.update(axes)
            rule = axes if len(axes) > 1 else (axes[0] if axes else None)
        out.append(rule)
    return tuple(out)


def placements_for(spec: Sequence, mesh: DeviceMesh) -> tuple:
    """A ``spec_for`` tuple -> DTensor placements, one per mesh dim.  A
    dim split over several mesh axes is split outermost first in mesh-dim
    order, as ``PartitionSpec`` splits it in tuple order; a tuple out of
    the mesh's order has no such placement and raises."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"mesh axes {axes} of dim {dim} are not in "
                             f"the mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def sharding_for(logical_axes: Sequence[Optional[str]], rules: Rules,
                 mesh: DeviceMesh) -> tuple:
    return placements_for(spec_for(logical_axes, rules, mesh), mesh)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def tree_shardings(logical_tree: Any, rules: Rules,
                   mesh: DeviceMesh) -> Any:
    """Map a tree (nested dicts) whose leaves are tuples of logical axis
    names to the same tree of placements."""
    if _is_axes(logical_tree):
        return sharding_for(logical_tree, rules, mesh)
    return {k: tree_shardings(v, rules, mesh)
            for k, v in logical_tree.items()}


def infer_param_logical_axes(params: Any) -> Any:
    """Heuristic logical axes for a params tree when the model doesn't
    declare them: the largest dim of a >= 2-D leaf is "mlp", every other
    dim None."""
    def leaf_axes(x):
        if x.ndim < 2:
            return (None,) * x.ndim
        axes: list[Optional[str]] = [None] * x.ndim
        axes[int(max(range(x.ndim), key=lambda i: x.shape[i]))] = "mlp"
        return tuple(axes)

    if isinstance(params, torch.Tensor):
        return leaf_axes(params)
    return {k: infer_param_logical_axes(v) for k, v in params.items()}


def local_shard(x, mesh: DeviceMesh, placements: Sequence,
                device=None) -> DTensor:
    """A DTensor whose local tensor is this rank's block of ``x`` (the
    whole value, the same on every rank), cut out with no collective: a
    view of ``x`` where the block is one, or with ``device`` a copy of
    the block alone there."""
    placements = tuple(placements)
    shape, offset = compute_local_shape_and_global_offset(
        x.shape, mesh, placements)
    local = x
    for dim, (lo, n) in enumerate(zip(offset, shape)):
        if n != x.shape[dim]:
            local = local.narrow(dim, lo, n)
    if device is not None:
        local = local.to(device)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def place(x, mesh: DeviceMesh, placements: Sequence) -> DTensor:
    """``x`` on ``mesh`` with ``placements``: a DTensor is redistributed
    (nothing happens when it is placed so already); a plain tensor, the
    whole value on every rank, is cut into this rank's block locally."""
    placements = tuple(placements)
    if isinstance(x, DTensor):
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(mesh, placements)
    return local_shard(x, mesh, placements)


def constrain(x, logical_axes: Sequence[Optional[str]], rules: Rules,
              mesh: DeviceMesh):
    """``x`` placed as its logical axes say (``with_sharding_constraint``)."""
    return place(x, mesh, sharding_for(logical_axes, rules, mesh))
