"""The single-host gang, the port of the in-process half of
``ray_tpu/parallel/gang.py`` (``GangConfig``, ``TpuGang``, ``form_gang``).

A gang is the mesh a trainer runs on.  Where the JAX package lays a
``Mesh`` over the devices of one process, the port lays a ``DeviceMesh``
over the ranks of the process's ``torch.distributed`` world (``-1`` on
one axis fills it): every rank forms the gang, SPMD, as torchrun would
start it.  ``put_batch`` is ``train.step.shard_batch``: each rank keeps
the rows of the host batch it owns.

Only one host is ported: ``num_hosts > 1`` (``GangMember``,
``MultiHostGang`` and elastic re-forming) raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ray_tpu_torch.parallel.mesh import create_mesh, mesh_shape


@dataclass
class GangConfig:
    mesh_axes: dict[str, int] = field(default_factory=lambda: {"dp": -1})
    num_hosts: int = 1
    device: Any = None           # the ranks' device type; None: the card


class TpuGang:
    """A formed gang on this process's world: ``mesh`` (a ``DeviceMesh``
    over every rank), ``run(fn, *args)`` and ``put_batch``."""

    def __init__(self, config: Optional[GangConfig] = None):
        self.config = config or GangConfig()
        if self.config.num_hosts != 1:
            raise NotImplementedError(
                f"a gang of {self.config.num_hosts} hosts is not ported: "
                f"only the single-host gang is (the multi-host gang, "
                f"GangMember and MultiHostGang, and elastic re-forming "
                f"are not)")
        self.mesh = create_mesh(self.config.mesh_axes,
                                device=self.config.device)
        self.num_hosts = 1

    @property
    def axis_sizes(self) -> dict[str, int]:
        return mesh_shape(self.mesh)

    @property
    def num_devices(self) -> int:
        return math.prod(self.mesh.shape)

    def run(self, fn: Callable, *args, **kwargs) -> Any:
        """``fn(*args, **kwargs)`` on this rank (every rank calls it:
        the mesh needs no context to be active)."""
        return fn(*args, **kwargs)

    def put_batch(self, batch: dict) -> dict:
        """A host batch (the global batch, the same on every rank) ->
        DTensors split over the data axes (``step.shard_batch``)."""
        from ray_tpu_torch.train.step import shard_batch

        return shard_batch(batch, self.mesh)

    def shutdown(self) -> None:
        pass


def form_gang(mesh_axes: Optional[dict[str, int]] = None, *,
              num_hosts: int = 1, device=None) -> TpuGang:
    """The gang of ``mesh_axes`` (default ``{"dp": -1}``) over this
    process's world; call it on every rank."""
    return TpuGang(GangConfig(mesh_axes=dict(mesh_axes or {"dp": -1}),
                              num_hosts=num_hosts, device=device))


__all__ = ["GangConfig", "TpuGang", "form_gang"]
