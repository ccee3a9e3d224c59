"""Device meshes, the port of ``ray_tpu/parallel/mesh.py``.

A ``MeshSpec`` names the parallelism axes (dp/fsdp/tp/sp/ep/pp and the
cross-slice ``dcn`` axis) and ``create_mesh`` lays them over the ranks of
the default process group as a ``torch.distributed`` ``DeviceMesh`` whose
dim names follow ``AXIS_ORDER``.  Where the JAX package returns
``NamedSharding``s, ``batch_sharding`` and ``replicated`` return DTensor
placements, one per mesh dim.

Every rank of the world is in the mesh: each rank must create the
subgroups of every mesh dim, so a mesh of fewer ranks than the world (the
JAX package takes a prefix of the devices) raises here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from ray_tpu_torch._device import resolve_device

# Canonical axis names, outermost first:
#   dp    data parallel (batch split, gradients summed)
#   fsdp  batch split too; params shard over it only where a rule says so
#   tp    tensor parallel (heads / mlp / vocab)
#   sp    sequence parallel (ring attention over this axis)
#   ep    expert parallel (MoE experts)
#   pp    pipeline parallel (layer stages)
#   dcn   cross-slice data parallel
AXIS_ORDER = ("dcn", "pp", "dp", "fsdp", "ep", "sp", "tp")


@dataclass(frozen=True)
class MeshSpec:
    """Named axis sizes; -1 on at most one axis = fill with all ranks."""

    axes: dict[str, int] = field(default_factory=dict)

    def resolved(self, n_devices: int) -> dict[str, int]:
        axes = {k: v for k, v in self.axes.items() if v != 1 or k in ("dp",)}
        if not axes:
            axes = {"dp": -1}
        fills = [k for k, v in axes.items() if v == -1]
        if len(fills) > 1:
            raise ValueError(f"Only one axis may be -1, got {fills}")
        fixed = math.prod(v for v in axes.values() if v != -1)
        if fills:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed}")
            axes[fills[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"Mesh axes {axes} need {fixed} devices, have {n_devices}")
        # canonical order for a predictable layout
        return {k: axes[k] for k in AXIS_ORDER if k in axes} | {
            k: v for k, v in axes.items() if k not in AXIS_ORDER}


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs torch.distributed's default process group; call "
            "init_process_group (its address, world size and rank) first")
    return dist.get_world_size()


def _device_type(device) -> str:
    return resolve_device(device).type


def create_mesh(axes: Optional[dict[str, int]] = None, *,
                device=None) -> DeviceMesh:
    """A ``DeviceMesh`` over every rank of the default process group, its
    dims named and ordered as ``MeshSpec.resolved`` gives them.  Raises
    when the axes' product is not the world size (see the module note).
    ``device=None`` is the CUDA card; tests pass ``device="cpu"``."""
    world = _world_size()
    resolved = MeshSpec(dict(axes) if axes else {"dp": -1}).resolved(world)
    return init_device_mesh(_device_type(device), tuple(resolved.values()),
                            mesh_dim_names=tuple(resolved))


def create_hybrid_mesh(ici_axes: dict[str, int], dcn_size: int, *,
                       device=None) -> DeviceMesh:
    """Multi-slice mesh: ``dcn`` outermost over slices (contiguous blocks
    of ranks), the ICI axes within each."""
    world = _world_size()
    if world % dcn_size:
        raise ValueError(f"{world} ranks not divisible by dcn {dcn_size}")
    resolved = MeshSpec(dict(ici_axes)).resolved(world // dcn_size)
    return init_device_mesh(
        _device_type(device), (dcn_size,) + tuple(resolved.values()),
        mesh_dim_names=("dcn",) + tuple(resolved))


def mesh_shape(mesh: DeviceMesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """Axes over which the global batch is split."""
    return tuple(a for a in ("dcn", "dp", "fsdp") if a in mesh.mesh_dim_names)


def batch_sharding(mesh: DeviceMesh) -> tuple:
    """Placements for [batch, ...] host data entering the mesh: dim 0
    split over the data axes, outermost first."""
    axes = data_axes(mesh)
    return tuple(Shard(0) if a in axes else Replicate()
                 for a in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> tuple:
    return (Replicate(),) * mesh.ndim
