"""The 1F1B pipeline schedule: a fused forward and backward pass whose
activation footprint is O(S) microbatches, the port of
``ray_tpu/parallel/pipeline_1f1b.py``.

GPipe (``parallel/pipeline.py``) runs every forward, then autograd
replays them backwards, so each stage holds M microbatch inputs.  1F1B
(PipeDream-flush, Megatron's non-interleaved schedule) starts microbatch
i's backward as soon as it leaves the last stage, so a stage holds at
most S stashed inputs.  Autograd over one forward program cannot express
that; this is a manual value-and-grads pass.  Each tick a rank takes the
action its column of the schedule gives it (the ranks diverge for real):

  * F(i): stash microbatch i's input in slot ``i mod S``, run the stage
    (without a graph) and hand the output right; the last stage's F only
    stashes.
  * B(i): re-linearise the stage at the stashed input (a forward under
    ``enable_grad``, then ``torch.autograd.grad`` with the cotangent that
    arrived from the right), add its parameter gradients and hand the
    input's cotangent left.  The last stage folds in the loss tail and
    seeds the cotangent with 1/M.

Both wires are handed off every tick on every rank, as the reference's
two ``ppermute`` calls are, so every rank issues the same collectives in
the same order; a stage's own collectives run among its ranks, which
share its schedule column.  The schedule tables are simulated on the
host (``build_1f1b_schedule``, the reference's tables) and checked for
dependency and stash-slot safety.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate

from ray_tpu_torch.parallel.collectives import allreduce, axis_index, permute
from ray_tpu_torch.parallel.mesh import mesh_shape
from ray_tpu_torch.parallel.pipeline import (contiguous_stride, drop_dim,
                                             place_replicated, place_stacked,
                                             stage_mesh, stage_microbatches,
                                             stage_shape, unwrap, wrap)
from ray_tpu_torch.parallel.spmd import (tree_leaves, tree_map,
                                         tree_unflatten)


class Schedule(NamedTuple):
    """Static per-(tick, stage) action tables."""
    do_f: np.ndarray       # [T, S] bool
    f_mb: np.ndarray       # [T, S] int32
    do_b: np.ndarray       # [T, S] bool
    b_mb: np.ndarray       # [T, S] int32
    recv_f: np.ndarray     # [T, S] bool  - store arriving fwd hand-off
    recv_f_mb: np.ndarray  # [T, S] int32
    recv_b: np.ndarray     # [T, S] bool  - store arriving bwd hand-off
    recv_b_mb: np.ndarray  # [T, S] int32


def build_1f1b_schedule(S: int, M: int) -> Schedule:
    """Greedy simulation of the non-interleaved 1F1B schedule, with
    dependency and stash-slot safety checked (the reference's tables)."""
    if M < S:
        raise ValueError(f"1F1B needs microbatches >= stages ({M} < {S})")
    f_done = [[-1] * M for _ in range(S)]   # tick F(i) completed
    b_done = [[-1] * M for _ in range(S)]
    next_f = [0] * S
    next_b = [0] * S
    # per-stage action pattern: warmup forwards, then 1F1B, then drain
    warmup = [min(S - 1 - r, M) for r in range(S)]
    actions: list[list[tuple]] = [[] for _ in range(S)]

    t = 0
    while any(next_b[r] < M for r in range(S)) and t < 8 * (M + S):
        acts = []
        for r in range(S):
            act = None
            want_f = next_f[r] < M
            want_b = next_b[r] < M
            # steady state: after the warmup forwards, B before the next
            # F (that bounds liveness to S)
            prefer_b = want_b and next_f[r] >= warmup[r] + next_b[r]
            order = (("B", "F") if prefer_b or not want_f else ("F", "B"))
            for kind in order:
                if kind == "F" and want_f:
                    i = next_f[r]
                    ready = (r == 0 or (0 <= f_done[r - 1][i] < t))
                    # stash slot i%S must be free: B(i-S) already done
                    slot_free = i < S or b_done[r][i - S] >= 0
                    if ready and slot_free:
                        act = ("F", i)
                        break
                if kind == "B" and want_b:
                    i = next_b[r]
                    ready = (0 <= f_done[r][i] < t if r == S - 1
                             else 0 <= b_done[r + 1][i] < t)
                    if ready:
                        act = ("B", i)
                        break
            acts.append(act)
        for r, act in enumerate(acts):
            if act is None:
                continue
            kind, i = act
            if kind == "F":
                f_done[r][i] = t
                next_f[r] += 1
            else:
                b_done[r][i] = t
                next_b[r] += 1
        for r in range(S):
            actions[r].append(acts[r])
        t += 1
    if not all(next_b[r] == M for r in range(S)):
        raise RuntimeError("1F1B schedule stuck")
    T = t

    do_f = np.zeros((T, S), bool)
    f_mb = np.zeros((T, S), np.int32)
    do_b = np.zeros((T, S), bool)
    b_mb = np.zeros((T, S), np.int32)
    for r in range(S):
        for tt, act in enumerate(actions[r]):
            if act is None:
                continue
            kind, i = act
            if kind == "F":
                do_f[tt, r] = True
                f_mb[tt, r] = i
            else:
                do_b[tt, r] = True
                b_mb[tt, r] = i

    # hand-off receive tables: what arrives at tick t was sent at t-1
    recv_f = np.zeros((T, S), bool)
    recv_f_mb = np.zeros((T, S), np.int32)
    recv_b = np.zeros((T, S), bool)
    recv_b_mb = np.zeros((T, S), np.int32)
    for tt in range(1, T):
        for r in range(S):
            if r > 0 and do_f[tt - 1, r - 1]:
                recv_f[tt, r] = True
                recv_f_mb[tt, r] = f_mb[tt - 1, r - 1]
            if r < S - 1 and do_b[tt - 1, r + 1]:
                recv_b[tt, r] = True
                recv_b_mb[tt, r] = b_mb[tt - 1, r + 1]
    return Schedule(do_f, f_mb, do_b, b_mb,
                    recv_f, recv_f_mb, recv_b, recv_b_mb)


class _Grads:
    """Gradients of stage-mesh leaves summed over B actions, kept as local
    blocks with the placements of the first gradient each leaf got (the
    same on every stage, which all run the same stage function)."""

    def __init__(self, leaves: list):
        self.leaves = leaves
        self.sum = [torch.zeros_like(_local(t)) for t in leaves]
        self.placements = [getattr(t, "placements", None) for t in leaves]
        self._seen = [False] * len(leaves)

    def add(self, grads) -> None:
        for i, g in enumerate(grads):
            if isinstance(g, DTensor):
                if not self._seen[i]:
                    self.placements[i] = tuple(g.placements)
                elif tuple(g.placements) != self.placements[i]:
                    g = g.redistribute(g.device_mesh, self.placements[i])
                g = g.to_local()
            self._seen[i] = True
            self.sum[i] += g

    def completed(self) -> list:
        """The sums placed as their leaves (partial sums reduced over the
        stage's ranks)."""
        out = []
        for g, pl, t in zip(self.sum, self.placements, self.leaves):
            if isinstance(t, DTensor) and pl != tuple(t.placements):
                g = DTensor.from_local(g, t.device_mesh, pl, run_check=False,
                                       shape=t.shape, stride=t.stride())
                g = g.redistribute(t.device_mesh, t.placements).to_local()
            out.append(g)
        return out


def _stage_pl(t, dim):
    return drop_dim(t.placements, dim) if t.device_mesh.ndim > 1 else None


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _stage_leaf(t, mesh, dim, smesh):
    """A leaf of its own on the stage mesh holding ``t``'s local block."""
    local = t.to_local().detach()
    if smesh is None:
        return local.requires_grad_(True)
    return wrap(local, smesh, drop_dim(t.placements, dim),
                stage_shape(t, mesh, dim)).requires_grad_(True)


def _to_mesh(local, placements, mesh, dim, pp_placement, shape):
    """A local gradient block back on ``mesh``: ``placements`` (the stage
    mesh's; replicated when None) with ``pp_placement`` on the pp dim."""
    if placements is None:
        placements = (Replicate(),) * (mesh.ndim - 1)
    pl = list(placements)
    pl.insert(dim, pp_placement)
    return DTensor.from_local(local, mesh, tuple(pl), run_check=False,
                              shape=shape, stride=contiguous_stride(shape))


def pipeline_value_and_grads_1f1b(
        stage_fn: Callable, last_fn: Callable, x_mb, y_mb,
        stage_params: Any, last_params: Any, *, mesh, axis: str = "pp"):
    """The fused 1F1B training pass.

    Args:
      stage_fn: ``(local_stage_params, x) -> x``, one stage's block.
      last_fn: ``(last_params, x, y) -> scalar``, the loss tail (final
        norm, head, cross-entropy) of one microbatch, so that the total
        loss is the mean over microbatches.
      x_mb: [M, mb, ...] pipeline inputs (after the embedding), a DTensor
        on ``mesh`` replicated over ``axis`` (or the whole plain tensor).
      y_mb: [M, mb, ...] per-microbatch targets, placed alike.
      stage_params: tree of layer stacks split over ``axis`` on dim 0.
      last_params: the tail's params, replicated over ``axis``.
    ``stage_fn`` and ``last_fn`` get DTensors on the stage mesh
    (``pipeline.stage_mesh``), or plain tensors when ``axis`` is the
    mesh's only dim.

    Returns ``(loss, d_stage_params, d_last_params, d_x_mb)`` on
    ``mesh``: the loss replicated, each stage's layer gradients on its
    own ranks (split over ``axis``), the tail's and ``d_x_mb`` summed
    over ``axis``.  Gradients may be partial sums over the stage's data
    axes, as the backward of the mesh arm leaves them; feed ``d_x_mb`` to
    the embedding's backward.
    """
    S = mesh_shape(mesh)[axis]
    x_mb = place_replicated(x_mb, mesh)
    y_mb = place_replicated(y_mb, mesh)
    M = x_mb.shape[0]
    sched = build_1f1b_schedule(S, M)
    T = sched.do_f.shape[0]
    smesh = stage_mesh(mesh, axis)
    dim = mesh.mesh_dim_names.index(axis)
    r = axis_index(axis, mesh=mesh)
    last = r == S - 1
    fwd_perm = [(i, (i + 1) % S) for i in range(S)]
    bwd_perm = [((i + 1) % S, i) for i in range(S)]

    stacked = tree_map(lambda t: place_stacked(t, mesh, axis), stage_params)
    tail = tree_map(lambda t: place_replicated(t, mesh), last_params)
    s_leaves, t_leaves = tree_leaves(stacked), tree_leaves(tail)
    lp = tree_unflatten(stacked, [_stage_leaf(t, mesh, dim, smesh)
                              for t in s_leaves])
    tp = tree_unflatten(tail, [_stage_leaf(t, mesh, dim, smesh)
                           for t in t_leaves])
    lp_leaves, tp_leaves = tree_leaves(lp), tree_leaves(tp)
    with torch.no_grad():
        xs, x_pl = stage_microbatches(x_mb.detach(), mesh, axis)
        ys, y_pl = stage_microbatches(y_mb.detach(), mesh, axis)
    mb_shape, y_shape = x_mb.shape[1:], y_mb.shape[1:]

    stash = [torch.zeros_like(xs[0]) for _ in range(S)]
    dstash = [torch.zeros_like(xs[0]) for _ in range(S)]
    fwd_wire = torch.zeros_like(xs[0])
    bwd_wire = torch.zeros_like(xs[0])
    dP, dT = _Grads(lp_leaves), _Grads(tp_leaves)
    dX = torch.zeros_like(xs)
    loss = torch.zeros((), device=xs.device)
    inv_m = 1.0 / M

    for t in range(T):
        # 1. bank last tick's hand-offs into the slot stashes
        if sched.recv_f[t, r]:
            stash[sched.recv_f_mb[t, r] % S] = fwd_wire
        if sched.recv_b[t, r]:
            dstash[sched.recv_b_mb[t, r] % S] = bwd_wire

        # 2. forward action
        fwd_out = fwd_wire
        if sched.do_f[t, r]:
            i = int(sched.f_mb[t, r])
            x_in = xs[i] if r == 0 else stash[i % S]
            stash[i % S] = x_in
            fwd_out = x_in
            if not last:      # the last stage folds its compute into B
                with torch.no_grad():
                    fwd_out = unwrap(stage_fn(lp, wrap(x_in, smesh, x_pl,
                                                       mb_shape)),
                                     smesh, x_pl)

        # 3. backward action: re-linearise at the stashed input
        bwd_out = bwd_wire
        if sched.do_b[t, r]:
            i = int(sched.b_mb[t, r])
            x_leaf = stash[i % S].detach().requires_grad_(True)
            with torch.enable_grad():
                out = stage_fn(lp, wrap(x_leaf, smesh, x_pl, mb_shape))
                if last:
                    l_mb = last_fn(tp, out, wrap(ys[i], smesh, y_pl,
                                                 y_shape)) * inv_m
                    grads = torch.autograd.grad(
                        l_mb, lp_leaves + tp_leaves + [x_leaf],
                        materialize_grads=True)
                    dT.add(grads[len(lp_leaves):-1])
                    loss = loss + _local(l_mb).detach()
                else:
                    cot = wrap(dstash[i % S], smesh, x_pl, mb_shape)
                    grads = torch.autograd.grad(
                        out, lp_leaves + [x_leaf], grad_outputs=cot,
                        materialize_grads=True)
            dP.add(grads[:len(lp_leaves)])
            bwd_out = grads[-1]
            if r == 0:   # stage 0's input cotangent is the embedding's
                dX[i] = bwd_out

        # 4. hand-offs for the next tick, on every rank
        with torch.no_grad():
            fwd_wire = permute(fwd_out, axis, fwd_perm, mesh=mesh)
            bwd_wire = permute(bwd_out, axis, bwd_perm, mesh=mesh)

    # loss and tail grads live on the last stage, dX on stage 0: the sum
    # over the pp group replicates each; the layer grads stay local
    loss = allreduce(loss, axis, mesh=mesh)
    # the tail ran on the last stage alone: its gradients are completed
    # there, so that every stage holds them placed as the leaves
    d_tail = dT.completed() if last else dT.sum
    d_tail = [_to_mesh(allreduce(g, axis, mesh=mesh), _stage_pl(t, dim),
                       mesh, dim, Replicate(), t.shape)
              for g, t in zip(d_tail, t_leaves)]
    d_stage = [_to_mesh(g, pl, mesh, dim, s.placements[dim], s.shape)
               for g, pl, s in zip(dP.sum, dP.placements, s_leaves)]
    d_x = DTensor.from_local(allreduce(dX, axis, mesh=mesh), mesh,
                             x_mb.placements, run_check=False,
                             shape=x_mb.shape,
                             stride=contiguous_stride(x_mb.shape))
    loss = DTensor.from_local(loss, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)
    return (loss, tree_unflatten(stacked, d_stage),
            tree_unflatten(tail, d_tail), d_x)
