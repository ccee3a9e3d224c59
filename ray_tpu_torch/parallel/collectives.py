"""In-mesh collectives, the port of the compiled half of
``ray_tpu/parallel/collectives.py``.

The JAX package calls ``psum``/``all_gather``/``ppermute`` inside
``shard_map`` and XLA lowers them onto ICI.  Here they run over one mesh
dim's process group through ``torch.distributed``'s functional
collectives (NCCL on the card), on the local shards of a function that
``shard_fn`` or ``shard_call`` runs under ``local_map``, the counterpart
of ``shard_map``.  Inside such a function the mesh is implicit, as the
axis environment is in JAX; elsewhere pass ``mesh=``.

Gradients: ``permute`` has one (the hand-off backwards) and
``sum_partials`` one (the sum's gradient unchanged); the other
collectives carry none.  ``shard_call`` takes each replicated input's
gradient as partial over the mesh dims on which the function works on
parts (an input or an output split there), which is what a local
computation on shards gives, and DTensor sums it.  So a function run
there must make each of its outputs depend on the parts alike: where one
output is split over a dim and another replicated, run two functions.

The host-plane ``CollectiveGroup`` of the JAX package (numpy collectives
between actors, for control data) is not part of the port.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard)
from torch.distributed.tensor.experimental import local_map

from ray_tpu_torch.parallel.sharding import placements_for

REDUCE_OPS = ("sum", "mean", "max", "min", "prod")

_current = threading.local()   # the mesh of the shard_call running here

# torch 2.13 renamed these (the old names warn); the card's torch may
# have only the old ones
_all_gather = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
_reduce_scatter = getattr(funcol, "reduce_scatter_single",
                          funcol.reduce_scatter_tensor)


def _mesh_dim(axis_name: str, mesh: Optional[DeviceMesh]):
    mesh = mesh if mesh is not None else getattr(_current, "mesh", None)
    if mesh is None:
        raise RuntimeError(f"collective over {axis_name!r} outside "
                           "shard_fn/shard_call; pass mesh=")
    return mesh, mesh.mesh_dim_names.index(axis_name)


def _group(axis_name: str, mesh: Optional[DeviceMesh]) -> str:
    """The process group of one mesh dim, by name (resolving a group
    object or a (mesh, dim) pair costs far more per call)."""
    mesh, dim = _mesh_dim(axis_name, mesh)
    return mesh.get_group(dim).group_name


def _axis_size(axis_name: str, mesh: Optional[DeviceMesh]) -> int:
    mesh, dim = _mesh_dim(axis_name, mesh)
    return mesh.size(dim)


def _wait(t):
    return funcol.wait_tensor(t) if isinstance(
        t, funcol.AsyncCollectiveTensor) else t


def allreduce(x, axis_name: str, op: str = "sum", *,
              mesh: Optional[DeviceMesh] = None):
    """Reduce ``x`` over ``axis_name``; every shard gets the result."""
    g = _group(axis_name, mesh)
    if op in ("sum", "max", "min"):
        return _wait(funcol.all_reduce(x, op, g))
    if op == "mean":
        return _wait(funcol.all_reduce(x, "sum", g)) / _axis_size(axis_name,
                                                                   mesh)
    if op == "prod":
        return torch.exp(_wait(funcol.all_reduce(torch.log(x), "sum", g)))
    raise ValueError(f"op must be one of {REDUCE_OPS}")


def allgather(x, axis_name: str, axis: int = 0, tiled: bool = True, *,
              mesh: Optional[DeviceMesh] = None):
    """Shards concatenated (``tiled``) or stacked along ``axis``."""
    g = _group(axis_name, mesh)
    if not tiled:
        x = x.unsqueeze(axis)
    return _wait(_all_gather(x.contiguous(), axis % x.dim(), g))


def reducescatter(x, axis_name: str, axis: int = 0, *,
                  mesh: Optional[DeviceMesh] = None):
    """Sum over ``axis_name``, each shard keeping its block of ``axis``."""
    g = _group(axis_name, mesh)
    return _wait(_reduce_scatter(x.contiguous(), "sum",
                                              axis % x.dim(), g))


def axis_index(axis_name: str, *, mesh: Optional[DeviceMesh] = None) -> int:
    mesh, dim = _mesh_dim(axis_name, mesh)
    return mesh.get_local_rank(dim)


def broadcast(x, axis_name: str, root: int = 0, *,
              mesh: Optional[DeviceMesh] = None):
    """Every shard gets root's value."""
    idx = axis_index(axis_name, mesh=mesh)
    masked = x if idx == root else torch.zeros_like(x)
    return allreduce(masked, axis_name, "sum", mesh=mesh)


def _permute(x, src_dst, group, me: int):
    """``funcol.permute_tensor`` for a group given by name: one
    all-to-all in which this rank sends all of ``x`` (flat: the split
    sizes count elements of dim 0) to ``src_dst[me]`` and receives from
    the rank that sends to it."""
    n = x.numel()
    send = [n if dst == src_dst[me] else 0 for dst in range(len(src_dst))]
    recv = [n if src_dst[src] == me else 0 for src in range(len(src_dst))]
    flat = x.contiguous().view(-1)
    return _wait(funcol.all_to_all_single(flat, recv, send, group)).view(
        x.shape)


class _Permute(torch.autograd.Function):
    """A ring hand-off whose backward hands the cotangent back."""

    @staticmethod
    def forward(ctx, x, src_dst, group, me):
        inverse = [0] * len(src_dst)
        for src, dst in enumerate(src_dst):
            inverse[dst] = src
        ctx.inverse, ctx.group, ctx.me = inverse, group, me
        return _permute(x, src_dst, group, me)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.inverse, ctx.group, ctx.me), None, None, None


def permute(x, axis_name: str, perm: list[tuple[int, int]], *,
            mesh: Optional[DeviceMesh] = None):
    """Point-to-point shift (``ppermute``): shard ``src`` sends to shard
    ``dst`` for each pair.  ``perm`` must be a permutation of the axis."""
    g = _group(axis_name, mesh)
    n = _axis_size(axis_name, mesh)
    src_dst = [-1] * n
    for src, dst in perm:
        src_dst[src] = dst
    if sorted(src_dst) != list(range(n)):
        raise ValueError(f"perm {perm} is not a permutation of {n} shards")
    return _Permute.apply(x, src_dst, g, axis_index(axis_name, mesh=mesh))


def ring_perm(n: int, shift: int = 1) -> list[tuple[int, int]]:
    return [(i, (i + shift) % n) for i in range(n)]


class _SumReplicated(torch.autograd.Function):
    """Sum of per-shard partials whose result every shard then uses alike:
    the gradient of each partial is the result's gradient unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        return _wait(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_partials(x, axis_name: str, *, mesh: Optional[DeviceMesh] = None):
    """``allreduce`` sum with a gradient, for a sum of partials that every
    shard then uses alike (a vocab-parallel softmax's normaliser)."""
    return _SumReplicated.apply(x, _group(axis_name, mesh))


# -- running a function on local shards ------------------------------------

def _grad_placements(mesh: DeviceMesh, in_placements,
                     out_placements) -> tuple:
    """Per input, the placements of its gradient: an input replicated on
    a mesh dim over which the function works on parts (another input or
    an output is split there, or an output is a partial sum) gets a
    partial one, the sum over that dim of what each rank's part gives."""
    outs = (out_placements if isinstance(out_placements, tuple)
            else (out_placements,))
    split = [any(p is not None and p[m].is_shard() for p in in_placements)
             or any(p is not None and not p[m].is_replicate() for p in outs)
             for m in range(mesh.ndim)]
    return tuple(
        None if p is None else tuple(
            Partial() if split[m] and p[m].is_replicate() else p[m]
            for m in range(mesh.ndim))
        for p in in_placements)


def shard_call(fn: Callable, mesh: DeviceMesh, in_placements: Sequence,
               out_placements, *args):
    """Run ``fn`` on the local shards of ``args`` (``local_map``): each
    DTensor argument is first redistributed to its entry of
    ``in_placements`` (None for a non-tensor argument), and ``fn``'s
    local results come back as DTensors placed as ``out_placements``
    says (one sequence of placements, or a tuple of them, or None for a
    non-tensor, for several outputs).
    Collectives in ``fn`` find ``mesh`` without being passed it."""
    in_placements = tuple(None if p is None else tuple(p)
                          for p in in_placements)
    args = tuple(a.redistribute(mesh, p)
                 if isinstance(a, DTensor) and tuple(a.placements) != p
                 else a for a, p in zip(args, in_placements))

    def body(*local):
        prev = getattr(_current, "mesh", None)
        _current.mesh = mesh
        try:
            return fn(*local)
        finally:
            _current.mesh = prev

    if all(isinstance(p, Placement) for p in out_placements):
        out_placements = list(out_placements)       # one output
    else:
        out_placements = tuple(None if p is None else list(p)
                               for p in out_placements)
    return local_map(body, out_placements=out_placements,
                     in_placements=in_placements,
                     in_grad_placements=_grad_placements(
                         mesh, in_placements, out_placements),
                     device_mesh=mesh)(*args)


def shard_fn(mesh: DeviceMesh, in_specs, out_specs, fn=None):
    """Decorator sugar over ``shard_call`` with ``spec_for``-style specs
    (per dim None, a mesh axis or a tuple of them): ``shard_map``'s."""
    ins = tuple(None if s is None else placements_for(s, mesh)
                for s in in_specs)
    outs = (tuple(placements_for(s, mesh) for s in out_specs)
            if isinstance(out_specs, list) else
            placements_for(out_specs, mesh))   # a list: several outputs

    def wrap(f):
        def run(*args):
            return shard_call(f, mesh, ins, outs, *args)
        return run
    return wrap(fn) if fn is not None else wrap
