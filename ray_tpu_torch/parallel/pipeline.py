"""Pipeline parallelism: the GPipe microbatch schedule over the ``pp``
mesh axis, the port of ``ray_tpu/parallel/pipeline.py``.

The layer stack is split over ``pp`` (each stage holds a contiguous block
of layers, the "layers" logical axis), the batch into M microbatches, and
the schedule runs T = M + S - 1 ticks.  Each tick every stage applies its
block to the activation it holds, then hands it to the next stage
(``collectives.permute`` over the pp group with ``ring_perm(S)``: an
all-to-all with a backward).  Stage 0 injects microbatch
``min(t, M - 1)``; the last stage banks output ``t - (S - 1)`` once that
is >= 0.  Autograd through the ticks is the mirrored backward pipeline.

A stage's ranks form the mesh without its pp dim (``stage_mesh``); the
stage body runs there on DTensors, with its own dp/tp/sp collectives, as
the JAX package's stage runs with those axes in auto mode inside a
``shard_map`` manual over pp alone.  With pp the mesh's only dim a stage
runs on plain local tensors.

Every rank issues the same collectives in the same order, forward and
backward, whatever it computes: a functional collective's backward runs
only on a rank whose output reaches the loss, and a rank that skipped one
would leave the others waiting in it.  So every stage computes at every
tick (the bubble ticks on zeros or repeated inputs, as the reference's
scan does), stage 0 takes its input through ``torch.where`` (the hand-off
it ignores stays on its graph, with a zero cotangent), and the last
stage's outputs reach the other pp ranks through ``_FromLast``, whose
backward is local.  Each rank's graph then has the same shape, and
autograd walks it in the same order on every rank.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)

from ray_tpu_torch.parallel.collectives import (allreduce, axis_index,
                                                permute, ring_perm)
from ray_tpu_torch.parallel.mesh import mesh_shape
from ray_tpu_torch.parallel.sharding import place
from ray_tpu_torch.parallel.spmd import tree_map


def num_stages(mesh: DeviceMesh) -> int:
    return mesh_shape(mesh).get("pp", 1)


def stage_mesh(mesh: DeviceMesh, axis: str = "pp") -> Optional[DeviceMesh]:
    """The mesh a stage's ranks form: ``mesh`` without ``axis`` (None
    when ``axis`` is its only dim)."""
    rest = tuple(n for n in mesh.mesh_dim_names if n != axis)
    return mesh[rest] if rest else None


def contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def wrap(local, smesh: Optional[DeviceMesh], placements, shape):
    """A local tensor as a DTensor of global ``shape`` on the stage mesh
    (itself when the stage runs on plain tensors).  Differentiable: its
    backward completes the gradient to ``placements``."""
    if smesh is None:
        return local
    return DTensor.from_local(local, smesh, tuple(placements),
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def unwrap(t, smesh: Optional[DeviceMesh], placements):
    """A stage-mesh DTensor's local block, placed as ``placements``."""
    if smesh is None:
        return t
    return place(t, smesh, placements).to_local()


def drop_dim(seq, dim: int) -> tuple:
    return tuple(p for i, p in enumerate(seq) if i != dim)


def stage_shape(t: DTensor, mesh: DeviceMesh, dim: int) -> torch.Size:
    """``t``'s global shape with the dims split over mesh dim ``dim`` cut
    to this rank's block of them."""
    only = [Replicate()] * mesh.ndim
    only[dim] = t.placements[dim]
    shape, _ = compute_local_shape_and_global_offset(t.shape, mesh, only)
    return torch.Size(shape)


class _ToStage(torch.autograd.Function):
    """A DTensor on the mesh -> its local block as a DTensor on the stage
    mesh (plain without one), placed as on the mesh less the pp dim.  The
    backward hands the stage's gradient back to the mesh, with
    ``pp_grad`` on the pp dim and the stage gradient's own placements
    (partial sums included, for the step to reduce) on the others."""

    @staticmethod
    def forward(ctx, t, mesh, dim, smesh, pp_grad):
        ctx.mesh, ctx.dim, ctx.pp_grad = mesh, dim, pp_grad
        ctx.shape, ctx.rest = t.shape, drop_dim(t.placements, dim)
        local = t.to_local()
        if smesh is None:
            return local.view_as(local)
        return wrap(local, smesh, ctx.rest, stage_shape(t, mesh, ctx.dim))

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor):
            rest, g = tuple(g.placements), g.to_local()
        else:
            rest = ctx.rest
        pl = list(rest)
        pl.insert(ctx.dim, ctx.pp_grad)
        return DTensor.from_local(
            g.contiguous(), ctx.mesh, tuple(pl), run_check=False,
            shape=ctx.shape, stride=contiguous_stride(ctx.shape)), \
            None, None, None, None


def to_stage(t, mesh: DeviceMesh, axis: str = "pp"):
    """A DTensor on ``mesh`` as the stage sees it (``_ToStage``): layer
    stacks split over ``axis`` keep that split in their gradient; a
    tensor replicated over ``axis`` gets a partial one (each stage's
    share)."""
    dim = mesh.mesh_dim_names.index(axis)
    pp_grad = t.placements[dim]
    if pp_grad.is_replicate():
        pp_grad = Partial()
    return _ToStage.apply(t, mesh, dim, stage_mesh(mesh, axis), pp_grad)


def place_stacked(t, mesh: DeviceMesh, axis: str = "pp"):
    """A plain tensor (the whole value on every rank) as a DTensor split
    over ``axis`` on dim 0 and replicated elsewhere; a DTensor as it is."""
    if isinstance(t, DTensor):
        return t
    pl = [Replicate()] * mesh.ndim
    pl[mesh.mesh_dim_names.index(axis)] = Shard(0)
    return place(t, mesh, pl)


def place_replicated(t, mesh: DeviceMesh):
    if isinstance(t, DTensor):
        return t
    return place(t, mesh, [Replicate()] * mesh.ndim)


class _FromLast(torch.autograd.Function):
    """The last stage's value on every rank of the pp group.  Every pp
    rank computes the same from the result, so each gets the same
    cotangent: the last stage keeps its own, the others pass zeros (no
    collective: summing over pp would give the last stage S times its
    gradient)."""

    @staticmethod
    def forward(ctx, x, axis, mesh, last):
        ctx.last = last
        mine = x if last else torch.zeros_like(x)
        return allreduce(mine, axis, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None, None, None


def pipeline_apply(stage_fn: Callable, x_mb, stage_params: Any, *,
                   mesh: DeviceMesh, axis: str = "pp",
                   carry_aux: bool = False):
    """Run ``stage_fn`` as an S-stage pipeline over microbatched inputs.

    Args:
      stage_fn: ``(local_stage_params, x) -> x`` applies one stage's
        layer block, shapes unchanged (the residual stream).  With
        ``carry_aux``: ``(lp, x, aux) -> (x, aux)``, ``aux`` a scalar
        summed across stages that rides the activation's hand-off (the
        MoE load-balance loss).  Its arguments are DTensors on the stage
        mesh (``stage_mesh``), or plain tensors when ``axis`` is the
        mesh's only dim.
      x_mb: ``[M, mb, ...]`` microbatched activations, a DTensor on
        ``mesh`` replicated over ``axis`` (or a plain tensor, the whole
        value on every rank).
      stage_params: tree whose leaves have a leading layers dim split
        over ``axis`` (DTensors; plain tensors are split here).

    Returns the last stage's ``[M, mb, ...]`` outputs, placed as
    ``x_mb``, and with ``carry_aux`` the aux summed over microbatches and
    stages (a replicated 0-d DTensor).
    """
    S = mesh_shape(mesh).get(axis, 1)
    x_mb = place_replicated(x_mb, mesh)
    if S == 1:
        return _single_stage(stage_fn, x_mb, stage_params, mesh,
                             carry_aux=carry_aux)
    M = x_mb.shape[0]
    smesh = stage_mesh(mesh, axis)
    r = axis_index(axis, mesh=mesh)
    perm = ring_perm(S)
    lp = tree_map(lambda t: to_stage(place_stacked(t, mesh, axis), mesh,
                                     axis), stage_params)
    xs, x_pl = stage_microbatches(x_mb, mesh, axis)
    mb_shape = x_mb.shape[1:]
    first = torch.tensor(r == 0, device=xs.device)
    state = torch.zeros_like(xs[0])
    aux_state = torch.zeros((), device=xs.device)
    outs, banked = [], []
    rep = (Replicate(),) * (smesh.ndim if smesh is not None else 0)
    T = M + S - 1
    for t in range(T):
        x = wrap(torch.where(first, xs[min(t, M - 1)], state), smesh, x_pl,
                 mb_shape)
        if carry_aux:
            a = wrap(torch.where(first, 0.0, aux_state), smesh, rep, ())
            x, a = stage_fn(lp, x, a)
            a = unwrap(a, smesh, rep) if isinstance(a, torch.Tensor) \
                else torch.full((), float(a), device=xs.device)
        else:
            x = stage_fn(lp, x)
        x = unwrap(x, smesh, x_pl)
        if t >= S - 1:                  # microbatch t - (S - 1) completes
            outs.append(x)
            if carry_aux:
                banked.append(a)
        if t < T - 1:                   # the last hand-off has no taker
            state = permute(x, axis, perm, mesh=mesh)
            if carry_aux:
                aux_state = permute(a, axis, perm, mesh=mesh)
    last = r == S - 1
    out = _FromLast.apply(torch.stack(outs), axis, mesh, last)
    out = DTensor.from_local(out, mesh, x_mb.placements, run_check=False,
                             shape=x_mb.shape,
                             stride=contiguous_stride(x_mb.shape))
    if not carry_aux:
        return out
    total = _FromLast.apply(torch.stack(banked).sum(), axis, mesh, last)
    return out, DTensor.from_local(total, mesh, (Replicate(),) * mesh.ndim,
                                   run_check=False)


def stage_microbatches(x_mb, mesh: DeviceMesh, axis: str):
    """``x_mb`` [M, mb, ...] as the stage sees it: its local block (a
    plain tensor whose gradient is partial over ``axis``) and the
    placements of one microbatch on the stage mesh."""
    dim = mesh.mesh_dim_names.index(axis)
    if any(p.is_shard(0) for p in x_mb.placements):
        raise ValueError("the microbatch dim of x_mb is split")
    xs = to_stage(x_mb, mesh, axis)
    if not isinstance(xs, DTensor):
        return xs, ()
    return xs.to_local(), tuple(Shard(p.dim - 1) if p.is_shard() else p
                                for p in drop_dim(x_mb.placements, dim))


def _single_stage(stage_fn, x_mb, stage_params, mesh, carry_aux=False):
    """The degenerate pp=1 path: the stage over each microbatch in turn,
    on ``mesh`` itself."""
    x_pl = tuple(Shard(p.dim - 1) if p.is_shard() else p
                 for p in x_mb.placements)
    xs = x_mb.to_local()
    rep = (Replicate(),) * mesh.ndim
    outs, aux = [], torch.zeros((), device=xs.device)
    for i in range(x_mb.shape[0]):
        x = wrap(xs[i], mesh, x_pl, x_mb.shape[1:])
        if carry_aux:
            x, a = stage_fn(stage_params, x, wrap(torch.zeros_like(aux),
                                                  mesh, rep, ()))
            aux = aux + (unwrap(a, mesh, rep) if isinstance(a, torch.Tensor)
                         else a)
        else:
            x = stage_fn(stage_params, x)
        outs.append(unwrap(x, mesh, x_pl))
    out = DTensor.from_local(torch.stack(outs), mesh, x_mb.placements,
                             run_check=False, shape=x_mb.shape,
                             stride=contiguous_stride(x_mb.shape))
    if carry_aux:
        return out, DTensor.from_local(aux, mesh, rep, run_check=False)
    return out
