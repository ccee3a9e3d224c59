"""Building blocks of the models' mesh arms: each runs on local shards
through ``shard_call``, with its placements worked out here.

The JAX package lets GSPMD lay out every op between its sharding
constraints.  DTensor would do the same op by op, but its search for a
layout costs seconds per new pointwise op on a 3-axis mesh, and minutes
for a matmul whose batch and sequence dims are both split (dp x sp), on
the threaded ranks of the CPU tests.  So the models run each stretch
between two constraints as one local function (``shard_call``), the
DTensors between them carry the placements, and ``constrain`` is the
only place data moves.  This module holds the stretches the models
share: ``dense`` (a matmul: column-parallel, or row-parallel with a
partial-sum result), ``embed`` (a lookup in a vocab-split table),
``mean_nll`` (cross-entropy over vocab-split logits), ``layer_slices``
(a stacked leaf's per-layer DTensors), ``to_microbatches`` /
``from_microbatches`` (a pipeline's batch reshape) and ``place_tree``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)

from ray_tpu_torch.parallel.collectives import (allreduce, shard_call,
                                                sum_partials)
from ray_tpu_torch.parallel.sharding import Rules, place, sharding_for


def local_span(shape: Sequence[int], mesh: DeviceMesh, placements,
               dim: int) -> tuple[int, int]:
    """(offset, length) of this rank's block of ``dim`` of a tensor of
    global ``shape`` placed as ``placements``."""
    local, offset = compute_local_shape_and_global_offset(
        tuple(shape), mesh, tuple(placements))
    return offset[dim], local[dim]


def run(fn, mesh: DeviceMesh, out_placements, *args):
    """``shard_call`` with each argument taken as it is placed."""
    return shard_call(fn, mesh, [getattr(a, "placements", None)
                                 for a in args], out_placements, *args)


def layer_slices(layers: dict, n_layers: int,
                 mesh: Optional[DeviceMesh]) -> list:
    """``[{name: layer i of the stacked leaf}, ...]`` for stacked [L, ...]
    DTensors whose layer dim is whole (plain tensors when ``mesh`` is
    None): one local ``unbind`` per leaf, whose backward stacks the
    per-layer gradients.  (Indexing the stacked leaf inside each layer's
    functions instead, and summing its partial gradients once a step, ran
    the CPU tests' steps twice as slow.)"""
    out = {}
    for name, t in layers.items():
        if mesh is None:
            out[name] = t.unbind(0)
            continue
        pl = tuple(t.placements)
        if any(p.is_shard(0) for p in pl):
            raise ValueError("the layer dim of a stacked leaf is split")
        sliced = [Shard(p.dim - 1) if p.is_shard() else p for p in pl]
        out[name] = run(lambda a: a.unbind(0), mesh, (sliced,) * n_layers, t)
    return [{name: ts[i] for name, ts in out.items()}
            for i in range(n_layers)]


def to_microbatches(x, M: int, mesh: DeviceMesh):
    """x [b, ...] -> [M, b/M, ...] as ``x.reshape(M, b // M, ...)`` gives
    it (microbatch m holds rows [m b/M, (m+1) b/M)), each microbatch's
    rows split over the mesh dims that split x's batch (x's other splits
    kept).  The batch is gathered first: microbatch m's rows lie on
    every rank that splits it."""
    whole = [Replicate() if p.is_shard(0) else p for p in x.placements]
    out = [Shard(p.dim + 1) if p.is_shard() else p for p in x.placements]
    shape = (M, x.shape[0] // M) + tuple(x.shape[1:])
    lo, n = local_span(shape, mesh, out, 1)

    def local(t):
        return t.reshape((M, shape[1]) + tuple(t.shape[1:]))[
            :, lo:lo + n].contiguous()

    return shard_call(local, mesh, (whole,), out, x)


def from_microbatches(x_mb, mesh: DeviceMesh):
    """The inverse of ``to_microbatches``: [M, mb, ...] -> [M mb, ...],
    the rows split as the microbatches' rows were."""
    whole = [Replicate() if p.is_shard(1) else p for p in x_mb.placements]
    out = [Shard(p.dim - 1) if p.is_shard() else p for p in x_mb.placements]
    shape = (x_mb.shape[0] * x_mb.shape[1],) + tuple(x_mb.shape[2:])
    lo, n = local_span(shape, mesh, out, 0)

    def local(t):
        return t.reshape((shape[0],) + tuple(t.shape[2:]))[lo:lo + n]

    return shard_call(local, mesh, (whole,), out, x_mb)


def tree_map(fn, tree):
    """``fn`` over a nested dict's leaves (a bare leaf is a tree of one)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The tree's leaves in insertion order, depth first."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """``leaves`` (in ``tree_leaves`` order) in ``like``'s nesting."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def place_tree(tree, logical, rules: Rules, mesh: DeviceMesh):
    """Every leaf placed as its logical axes say (``place``: nothing
    moves for a leaf placed so already)."""
    return {k: (place_tree(v, logical[k], rules, mesh) if isinstance(v, dict)
                else place(v, mesh, sharding_for(logical[k], rules, mesh)))
            for k, v in tree.items()}


def dense(x, w, mesh: DeviceMesh, dtype: Optional[torch.dtype] = None):
    """``x [..., K] @ w [K, N]`` (``w`` cast to ``dtype``) on local
    shards.  Per mesh dim: x split over a leading dim keeps that split (w
    whole there); w split over N splits the result over N; a split of K
    on either side is matched on the other and gives a partial sum."""
    last = x.ndim - 1
    xp, wp, op = [], [], []
    for px, pw in zip(x.placements, w.placements):
        px = Replicate() if px.is_partial() else px
        if px.is_shard() and px.dim != last:
            xp.append(px), wp.append(Replicate()), op.append(px)
        elif px.is_shard(last) or pw.is_shard(0):
            xp.append(Shard(last)), wp.append(Shard(0)), op.append(Partial())
        elif pw.is_shard(1):
            xp.append(Replicate()), wp.append(pw), op.append(Shard(last))
        else:
            xp.append(Replicate()), wp.append(Replicate())
            op.append(Replicate())
    return shard_call(lambda a, b: a @ b.to(dtype or b.dtype), mesh,
                      (xp, wp), op, x, w)


def embed(table, ids, mesh: DeviceMesh):
    """``table[ids]`` for a [V, d] table and [b, s] ids.  Per mesh dim:
    ids split over b or s keep the split (the table whole there); a table
    split over V gives a partial sum, each rank looking up the ids of its
    block and adding zeros for the rest."""
    tp, ip, op = [], [], []
    for pt, pi in zip(table.placements, ids.placements):
        if pi.is_shard():
            tp.append(Replicate()), ip.append(pi), op.append(pi)
        elif pt.is_shard(0):
            tp.append(pt), ip.append(Replicate()), op.append(Partial())
        else:
            tp.append(Replicate()), ip.append(Replicate())
            op.append(Replicate())
    lo, n = local_span(table.shape, mesh, tp, 0)
    split = n < table.shape[0]

    def lookup(t, i):
        i = i.long() - lo
        if not split:
            return F.embedding(i, t)
        inside = (i >= 0) & (i < n)
        return torch.where(inside[..., None], F.embedding(i.clamp(0, n - 1),
                                                          t), 0.0)

    return shard_call(lookup, mesh, (tp, ip), op, table, ids)


def mean_nll(logits, targets, mesh: DeviceMesh, *,
             ignore_index: Optional[int] = None):
    """The mean of ``logsumexp(logits) - logits[target]`` over [b, s, V]
    f32 logits and [b, s] targets, a replicated 0-d DTensor.  With
    ``ignore_index`` the mean runs over the other targets (at least one).
    The vocab may be split over mesh dims (the max, the sum of
    exponentials and the gold logit are then reduced over them), and b
    and s over others (the sums are then reduced over those)."""
    last = logits.ndim - 1
    lp = tuple(Replicate() if p.is_partial() else p
               for p in logits.placements)
    names = mesh.mesh_dim_names
    vocab_axes = [names[m] for m, p in enumerate(lp) if p.is_shard(last)]
    row_axes = [names[m] for m, p in enumerate(lp)
                if p.is_shard() and not p.is_shard(last)]
    tp = tuple(Replicate() if p.is_shard(last) else p for p in lp)
    lo, n = local_span(logits.shape, mesh, lp, last)
    count = logits.shape[:last].numel()

    def local(lg, tg):
        tg = tg.long()
        if vocab_axes:
            nll = _split_vocab_nll(lg, tg, vocab_axes, lo, n)
        else:
            # the whole vocab here: the single-device loss's own op
            nll = F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                                  tg.reshape(-1), reduction="none",
                                  ignore_index=-100 if ignore_index is None
                                  else ignore_index).view(tg.shape)
        total, denom = nll.sum(), float(count)
        if ignore_index is not None:
            valid = tg != ignore_index
            total = torch.where(valid, nll, 0.0).sum()
            denom = valid.sum().float()
            for ax in row_axes:
                denom = allreduce(denom, ax, "sum")
            denom = denom.clamp_min(1.0)
        for ax in row_axes:
            total = sum_partials(total, ax)
        return total / denom

    return shard_call(local, mesh, (lp, tp), (Replicate(),) * mesh.ndim,
                      logits, targets)


def _split_vocab_nll(lg, tg, vocab_axes, lo: int, n: int):
    """Per-position nll of logits whose vocab is split over
    ``vocab_axes``, this rank holding [lo, lo + n): the max, the sum of
    exponentials and the gold logit reduced over those axes."""
    mx = lg.detach().amax(dim=-1)
    for ax in vocab_axes:
        mx = allreduce(mx, ax, "max")
    se = torch.exp(lg - mx[..., None]).sum(dim=-1)
    t = tg - lo
    inside = (t >= 0) & (t < n)
    gold = torch.where(inside, lg.gather(
        -1, t.clamp(0, n - 1)[..., None])[..., 0], 0.0)
    for ax in vocab_axes:
        se = sum_partials(se, ax)
        gold = sum_partials(gold, ax)
    return mx + torch.log(se) - gold
