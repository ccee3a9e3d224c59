"""The train-step factory, the port of ``ray_tpu/train/step.py``.

``make_train_step(loss_fn, tx)`` gives ``(init_fn, step_fn)`` as the JAX
package does.  Where JAX jits the step and donates its state, the port
runs it eagerly and updates the params and the optimizer state in place.
``adamw`` is ``optax.adamw``: torch's AdamW over the stacked leaves does
the same update (decoupled weight decay on every leaf, eps outside the
square root); ``adam`` is ``optax.adam`` the same way.

``state_to_host`` and ``load_state`` are the checkpoint's half of the
state: the params, Adam's moments (``{"count", "mu", "nu"}`` over the
params' tree, ``models.convert``'s layout) and the step, as numpy; on a
mesh the payload holds the whole leaves and each rank restores its own
blocks, so a checkpoint moves between one device and any mesh.
``device_batch`` puts a host batch on the device.

The mesh arm (``mesh=``, a ``DeviceMesh``): the params are DTensors
placed by ``params_logical`` and ``rules`` (every leaf replicated when no
logical axes are given: pure data parallelism), Adam's moments take the
params' placements (``state_shardings``), and ``shard_batch`` gives each
rank the rows of the batch it owns.  The gradients come back from the
backward partial over the axes that split the batch (and the sequence),
and are summed to the params' placements before the update; the update
itself is elementwise on each rank's shards.  A mesh with pp runs GPT
and BERT as a GPipe pipeline (their ``loss_fn``), each stage's layer
gradients on its own ranks; a leaf replicated over pp (the embedding,
the head) gets its gradient once, not once per stage.
``gpt_value_and_grads_1f1b`` and ``train_step_1f1b`` run GPT through the
1F1B schedule instead.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.data.feed import to_device
from ray_tpu_torch.models.convert import _leaves, _map, _pick, _unflatten
from ray_tpu_torch.parallel.collectives import allreduce
from ray_tpu_torch.parallel.mesh import batch_sharding, replicated
from ray_tpu_torch.parallel.sharding import (DEFAULT_LLM_RULES, Rules,
                                             constrain, local_shard, place,
                                             tree_shardings)
from ray_tpu_torch.train.checkpoint import _walk, host_tensor, to_host


@dataclass
class TrainState:
    """step (0-d int64 on the params' device), params (the model's nested
    dict of tensors) and opt_state (the optimizer over their leaves)."""
    step: torch.Tensor
    params: Any
    opt_state: torch.optim.Optimizer


def adamw(lr: float, *, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4):
    """``optax.adamw`` with its defaults: a constructor that takes the
    list of leaves and returns the optimizer."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(b1, b2),
                             eps=eps, weight_decay=weight_decay)


def adam(lr: float, *, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8):
    """``optax.adam`` with its defaults, as ``adamw`` is ``optax.adamw``."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(b1, b2),
                             eps=eps)


def shard_batch(batch: dict, mesh) -> dict:
    """A host batch (columns of numpy arrays, the same global batch on
    every rank) -> DTensors on ``mesh`` split over its data axes
    (``batch_sharding``): each rank copies only the rows it owns to its
    device, with no collective.  A 0-d column is replicated."""
    dev = torch.device(mesh.device_type)
    return {k: local_shard(torch.as_tensor(np.asarray(v)), mesh,
                           batch_sharding(mesh) if np.ndim(v)
                           else replicated(mesh), device=dev)
            for k, v in batch.items()}


def device_batch(batch: dict, device=None, *, mesh=None) -> dict:
    """A host batch (columns of numpy arrays) -> the same columns as
    tensors on ``device`` (None = the CUDA card), or on ``mesh`` as
    ``shard_batch`` places them."""
    if mesh is not None:
        return shard_batch(batch, mesh)
    return to_device(batch, resolve_device(device))


def state_shardings(mesh, params_logical: Any, rules: Rules = DEFAULT_LLM_RULES,
                    params: Any = None) -> "TrainState":
    """Placements of a ``TrainState`` on ``mesh``: the params' by their
    logical axes (all replicated without them, then ``params`` gives the
    tree), Adam's moments the same as the params they follow, the step
    and the count replicated."""
    if params_logical is not None:
        p_sh = tree_shardings(params_logical, rules, mesh)
    else:
        p_sh = _map(lambda _: replicated(mesh), params)
    rep = replicated(mesh)
    return TrainState(step=rep, params=p_sh,
                      opt_state={"count": rep, "mu": p_sh, "nu": p_sh})


def _fresh(t: DTensor) -> DTensor:
    """A DTensor leaf of its own: ``t``'s shard copied, same placement."""
    return DTensor.from_local(t.to_local().detach().clone(), t.device_mesh,
                              t.placements, run_check=False, shape=t.shape,
                              stride=t.stride())


def _sum_grads(grads: list, leaves: list) -> list:
    """The gradients placed as their params: the partial sums over the
    data (and sequence) axes that the backward leaves are summed, one
    all-reduce per mesh dim for all the leaves that share placements."""
    mesh = leaves[0].device_mesh
    names = mesh.mesh_dim_names
    out = [None] * len(grads)
    groups: dict = {}
    for i, (g, p) in enumerate(zip(grads, leaves)):
        want = tuple(p.placements)
        have = tuple(g.placements)
        if all(h == w or (h.is_partial() and w.is_replicate())
               for h, w in zip(have, want)):
            groups.setdefault((have, want), []).append(i)
        else:
            out[i] = g.redistribute(mesh, want)
    for (have, want), idx in groups.items():
        local = [grads[i].to_local() for i in idx]
        flat = torch.cat([t.reshape(-1) for t in local])
        for name, h in zip(names, have):
            if h.is_partial():
                flat = allreduce(flat, name, mesh=mesh)
        for i, part in zip(idx, flat.split([t.numel() for t in local])):
            out[i] = DTensor.from_local(
                part.view(grads[i].to_local().shape), mesh, want,
                run_check=False, shape=grads[i].shape,
                stride=grads[i].stride())
    return out


def _global_norm(grads: list) -> torch.Tensor:
    """``optax.global_norm`` over DTensor gradients: the f32 sums of
    squares of the local shards, summed over the mesh dims that split
    each, one all-reduce per dim for the leaves split alike."""
    mesh = grads[0].device_mesh
    groups: dict = {}
    for g in grads:
        split = tuple(p.is_shard() for p in g.placements)
        groups.setdefault(split, []).append(torch.linalg.vector_norm(
            g.to_local(), dtype=torch.float32).square())
    total = []
    for split, sq in groups.items():
        s = torch.stack(sq).sum()
        for name, is_split in zip(mesh.mesh_dim_names, split):
            if is_split:
                s = allreduce(s, name, mesh=mesh)
        total.append(s)
    return torch.sqrt(torch.stack(total).sum())


def _local(p):
    """The tensor the optimizer steps for params leaf ``p``: its local
    shard on a mesh (the DTensor's own storage), ``p`` itself else."""
    if isinstance(p, DTensor):
        with torch.no_grad():
            return p.to_local()
    return p


def _like(p, local: torch.Tensor):
    """``local`` (a moment of ``p``'s shard) as ``p`` is placed."""
    if not isinstance(p, DTensor):
        return local
    return DTensor.from_local(local, p.device_mesh, p.placements,
                              run_check=False, shape=p.shape,
                              stride=p.stride())


def adam_state(opt: torch.optim.Optimizer, params) -> dict:
    """An Adam/AdamW optimizer's state over ``params`` as
    ``{"count", "mu", "nu"}``, each moment a tree like ``params`` (live
    tensors: ``to_host`` copies them; DTensors placed as their params on
    a mesh, whose optimizer steps the local shards).  Before the first
    step the moments are zeros and the count 0."""
    def moment(key):
        def one(p):
            t = _local(p)
            return _like(p, opt.state[t][key] if t in opt.state
                         else torch.zeros_like(t))
        return _map(one, params)
    first = opt.state.get(_local(_leaves(params)[0]), {})
    return {"count": int(first["step"]) if "step" in first else 0,
            "mu": moment("exp_avg"), "nu": moment("exp_avg_sq")}


def _host_block(p, a) -> torch.Tensor:
    """Payload leaf ``a`` (the whole value) as a CPU tensor: on a mesh
    this rank's block of it, as ``p`` is placed (no collective)."""
    t = host_tensor(a)
    if isinstance(p, DTensor):
        t = local_shard(t, p.device_mesh, p.placements).to_local()
    return t


def load_adam_state(opt: torch.optim.Optimizer, params, payload: dict):
    """Fill ``opt``'s state from ``{"count", "mu", "nu"}`` (numpy or
    tensors, keyed like ``params``; the whole moments, of which each rank
    of a mesh takes its block) through ``load_state_dict``, which binds
    it to the optimizer's own leaves: they must be ``params``' leaves (on
    a mesh their local shards), in their order.  ``step`` stays a CPU
    tensor unless the optimizer is capturable or fused (torch moves it
    then)."""
    leaves = _leaves(params)
    bound = [p for g in opt.param_groups for p in g["params"]]
    if len(bound) != len(leaves) or any(
            a is not _local(b) for a, b in zip(bound, leaves)):
        raise ValueError("the optimizer is not bound to these params")
    mu, nu = (_leaves(_pick(params, payload[k])) for k in ("mu", "nu"))
    step = torch.tensor(float(payload["count"]), dtype=torch.float32)
    sd = opt.state_dict()
    sd["state"] = {i: {"step": step.clone(),
                       "exp_avg": _host_block(p, m),
                       "exp_avg_sq": _host_block(p, v)}
                   for i, (p, m, v) in enumerate(zip(leaves, mu, nu))}
    opt.load_state_dict(sd)


def _gathered(tree):
    """``tree`` with every DTensor leaf gathered whole (``full_tensor``,
    a collective: every rank calls this with the same tree, so the
    leaves are gathered in one order everywhere)."""
    return _walk(lambda x: x.full_tensor() if isinstance(x, DTensor)
                 else x, tree)


def state_to_host(state: "TrainState") -> dict:
    """The checkpoint payload of ``state``: ``{"params", "opt_state",
    "step"}`` as numpy, copied off the device before this returns (one
    pinned buffer, see ``checkpoint.to_host``).  On a mesh every params
    leaf and both Adam moments are gathered whole first (every rank must
    call this, in step), so the payload is the full tree, as the JAX
    package's checkpoint of a sharded state is."""
    tree = {"params": state.params,
            "opt_state": adam_state(state.opt_state, state.params)}
    with torch.no_grad():
        host = to_host(_gathered(tree))
    host["step"] = int(state.step)
    return host


@torch.no_grad()
def load_state(state: "TrainState", payload: dict) -> None:
    """Restore ``state`` in place from a payload of ``state_to_host`` (or
    of the JAX trainer once its ``opt_state`` went through
    ``optax_adam_to_torch``): every params leaf is overwritten with
    ``copy_`` (on a mesh each rank copies its own block of the whole
    host leaf into its shard, as the JAX trainer's ``put_like`` places a
    host leaf on a live leaf's sharding) and the optimizer's moments and
    count are loaded into its own state.  The leaves stay the tensors the
    optimizer steps; binding ``state.params`` to new tensors would leave
    it stepping the old ones.  A payload without ``opt_state`` keeps the
    optimizer's."""
    src = _leaves(_pick(state.params, payload["params"]))
    for p, a in zip(_leaves(state.params), src):
        _local(p).copy_(_host_block(p, a))
    if "opt_state" in payload:
        load_adam_state(state.opt_state, state.params, payload["opt_state"])
    state.step.fill_(int(payload.get("step", 0)))


def make_train_step(loss_fn: Callable, tx: Callable, *, mesh=None,
                    params_logical: Any = None,
                    rules: Rules = DEFAULT_LLM_RULES):
    """Build ``(init_fn, step_fn)``.

    loss_fn(params, batch) -> 0-d loss (closed over the model config; on
    a mesh pass the mesh and rules inside, as the JAX package does).
    tx(leaves) -> a ``torch.optim.Optimizer``, e.g. ``adamw(3e-4)``.
    init_fn(params) -> TrainState over a copy of ``params``: the caller's
    tensors are left as they are (the JAX package copies them because its
    step donates the state).  On a mesh the copy is placed as
    ``state_shardings`` says: ``params`` may be plain tensors (the whole
    value on every rank: each rank keeps its shard) or DTensors.
    step_fn(state, batch) -> (state, {"loss", "grad_norm"}): value and
    grad, then the optimizer's in-place update.  Both metrics are 0-d
    device tensors (grad_norm is ``optax.global_norm``, the f32 L2 norm
    over all leaves, over every shard on a mesh), the same on every rank,
    and the step makes no host sync.
    """
    def placed(params, sh):
        return {k: (placed(v, sh[k]) if isinstance(v, dict)
                    else _fresh(place(v.detach(), mesh, sh[k])))
                for k, v in params.items()}

    def init_fn(params):
        if mesh is None:
            params = _map(lambda t: t.detach().clone(), params)
        else:
            params = placed(params, state_shardings(
                mesh, params_logical, rules, params).params)
        params = _map(lambda t: t.requires_grad_(True), params)
        leaves = _leaves(params)
        step = torch.zeros((), dtype=torch.int64, device=leaves[0].device)
        if mesh is not None:
            # the update is elementwise: the optimizer steps each rank's
            # shards, which are the DTensors' storage
            with torch.no_grad():
                leaves = [p.to_local() for p in leaves]
        return TrainState(step=step, params=params, opt_state=tx(leaves))

    def step_fn(state: TrainState, batch):
        leaves = _leaves(state.params)
        loss = loss_fn(state.params, batch)
        # a leaf the loss does not use (BERT's wtype without token types)
        # gets a zero gradient, as under jax.grad
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        if mesh is None:
            grad_norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g, dtype=torch.float32)
                 for g in grads]))
        else:
            grads = _sum_grads(grads, leaves)
            grad_norm = _global_norm(grads)
            loss = loss.to_local()
            with torch.no_grad():
                leaves = [p.to_local() for p in leaves]
            grads = [g.to_local() for g in grads]
        for p, g in zip(leaves, grads):
            p.grad = g
        state.opt_state.step()
        state.opt_state.zero_grad(set_to_none=True)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return init_fn, step_fn


def gpt_value_and_grads_1f1b(params, tokens, cfg, mesh, *,
                             rules: Rules = DEFAULT_LLM_RULES):
    """One GPT pass through the fused 1F1B schedule
    (``parallel.pipeline_1f1b``) on ``mesh`` (with pp): the embedding runs
    outside it on every pp rank, its backward fed the pipeline's input
    cotangents; the layer stack rides the schedule, each stage on the
    mesh without pp; the loss tail (final norm, head, cross-entropy) is
    folded into the last stage's backward.  The tied ``wte`` gets both
    the embedding's and the head's gradients.

    params: the model's tree (plain tensors, the whole value on every
    rank, or DTensors on ``mesh``); tokens: [b, s + 1] (a DTensor from
    ``shard_batch`` or a plain tensor).  Returns ``(loss, grads)``: the
    loss a replicated 0-d DTensor, the gradients DTensors placed as the
    params are (``state_shardings``)."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import spmd
    from ray_tpu_torch.parallel.pipeline import stage_mesh
    from ray_tpu_torch.parallel.pipeline_1f1b import (
        pipeline_value_and_grads_1f1b)

    M = _check_1f1b(cfg, mesh, tokens.shape[0])
    logical = gpt.param_logical_axes(cfg)
    params = spmd.place_tree(params, logical, rules, mesh)
    if not isinstance(tokens, DTensor):
        tokens = local_shard(torch.as_tensor(tokens), mesh,
                             batch_sharding(mesh),
                             device=torch.device(mesh.device_type))
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    tied = cfg.tie_embeddings
    tail_keys = ["ln_f_scale", "ln_f_bias"] + (["wte"] if tied
                                               else ["lm_head"])
    smesh = stage_mesh(mesh)
    body = gpt.stage_fn(cfg, smesh, rules)

    def last_fn(tp, x, y):
        if smesh is None:
            logits = gpt._head(tp, x, cfg)
            return torch.nn.functional.cross_entropy(
                logits.reshape(-1, logits.shape[-1]), y.reshape(-1).long())
        return spmd.mean_nll(gpt._sharded_head(tp, x, cfg, smesh, rules), y,
                             smesh)

    embed = {k: params[k].detach().requires_grad_(True)
             for k in ("wte", "wpe")}
    with torch.enable_grad():
        x_mb = spmd.to_microbatches(
            gpt._sharded_embed(embed, inp, cfg, mesh, rules), M, mesh)
    y_mb = spmd.to_microbatches(
        constrain(tgt, ("batch", "seq"), rules, mesh), M, mesh)
    loss, d_layers, d_tail, d_x = pipeline_value_and_grads_1f1b(
        lambda lp, x: body(lp, x)[0], last_fn, x_mb.detach(), y_mb,
        params["layers"], {k: params[k] for k in tail_keys}, mesh=mesh)
    d_wte, d_wpe = torch.autograd.grad(x_mb, [embed["wte"], embed["wpe"]],
                                       grad_outputs=d_x)
    grads = _pick(params, {**d_tail, "wte": d_wte, "wpe": d_wpe,
                           "layers": d_layers})
    grads = _unflatten(params, _sum_grads(_leaves(grads), _leaves(params)))
    if tied:     # the head's side, placed as the embedding's
        grads["wte"] = grads["wte"] + _sum_grads([d_tail["wte"]],
                                                 [params["wte"]])[0]
    return loss, grads


def _check_1f1b(cfg, mesh, batch_n: int) -> int:
    """The 1F1B pass's refusals, before any collective: the microbatch
    count M (a batch it divides, at least one microbatch a stage)."""
    from ray_tpu_torch.parallel.mesh import mesh_shape
    from ray_tpu_torch.parallel.pipeline_1f1b import build_1f1b_schedule

    S = mesh_shape(mesh)["pp"]
    M = cfg.pp_microbatches or 2 * S
    if batch_n % M != 0:
        raise ValueError(f"batch {batch_n} not divisible by microbatches "
                         f"{M}")
    build_1f1b_schedule(S, M)
    return M


def train_step_1f1b(cfg, mesh, *, batch_n: int, seq: int,
                    check_parity: bool = True) -> float:
    """One GPT train pass through the fused 1F1B schedule, as the JAX
    package's ``train_step_1f1b``: params from ``init_params(cfg, 0)`` on
    the mesh's device, a batch of zeros ``[batch_n, seq + 1]``, the pass
    of ``gpt_value_and_grads_1f1b``.  Checks that the gradients' global
    norm is finite and nonzero (every leaf, the tied embedding's two
    sides included, reached by the schedule) and, with ``check_parity``,
    that the loss is within 1e-3 + 1e-3 |ref| of the plain single-device
    loss on the same params.  Returns the loss."""
    from ray_tpu_torch.models import gpt

    _check_1f1b(cfg, mesh, batch_n)
    dev = torch.device(mesh.device_type)
    params = gpt.init_params(cfg, 0, device=dev)
    tokens = torch.zeros((batch_n, seq + 1), dtype=torch.long)
    loss, grads = gpt_value_and_grads_1f1b(params, tokens, cfg, mesh)
    loss = loss.to_local().item()
    gnorm = _global_norm(_leaves(grads)).item()
    if not (np.isfinite(gnorm) and gnorm > 0.0):
        raise AssertionError(f"1F1B grad norm {gnorm}")
    if check_parity:
        with torch.no_grad():
            ref = gpt.loss_fn(params, {"tokens": tokens.to(dev)}, cfg).item()
        if not abs(loss - ref) < 1e-3 + 1e-3 * abs(ref):
            raise AssertionError(f"1F1B loss {loss} != reference {ref}")
    return loss
