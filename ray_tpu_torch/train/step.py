"""The train-step factory, the port of ``ray_tpu/train/step.py``.

``make_train_step(loss_fn, tx)`` gives ``(init_fn, step_fn)`` as the JAX
package does.  Where JAX jits the step and donates its state, the port
runs it eagerly and updates the params and the optimizer state in place.
``adamw`` is ``optax.adamw``: torch's AdamW over the stacked leaves does
the same update (decoupled weight decay on every leaf, eps outside the
square root); ``adam`` is ``optax.adam`` the same way.

``state_to_host`` and ``load_state`` are the checkpoint's half of the
state: the params, Adam's moments (``{"count", "mu", "nu"}`` over the
params' tree, ``models.convert``'s layout) and the step, as numpy.
``device_batch`` puts a host batch on the device (``shard_batch`` on one
device).

Single device only: the mesh, sharding rules, ``shard_batch`` and the
1F1B step come with the port of parallelism.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.data.feed import to_device
from ray_tpu_torch.models.convert import _leaves, _map, _pick
from ray_tpu_torch.train.checkpoint import host_tensor, to_host


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


def _no_mesh(mesh, what: str):
    if mesh is not None:
        raise NotImplementedError(
            f"{what} on a mesh is not ported yet; the port trains on one "
            "device")


def device_batch(batch: dict, device=None, *, mesh=None) -> dict:
    """A host batch (columns of numpy arrays) -> the same columns as
    tensors on ``device`` (None = the CUDA card): ``shard_batch`` on one
    device."""
    _no_mesh(mesh, "device_batch")
    return to_device(batch, resolve_device(device))


def adam_state(opt: torch.optim.Optimizer, params) -> dict:
    """An Adam/AdamW optimizer's state over ``params`` as
    ``{"count", "mu", "nu"}``, each moment a tree like ``params`` (live
    tensors: ``to_host`` copies them).  Before the first step the moments
    are zeros and the count 0."""
    def moment(key):
        return _map(lambda p: opt.state[p][key] if p in opt.state
                    else torch.zeros_like(p), params)
    first = opt.state.get(_leaves(params)[0], {})
    return {"count": int(first["step"]) if "step" in first else 0,
            "mu": moment("exp_avg"), "nu": moment("exp_avg_sq")}


def load_adam_state(opt: torch.optim.Optimizer, params, payload: dict):
    """Fill ``opt``'s state from ``{"count", "mu", "nu"}`` (numpy or
    tensors, keyed like ``params``) through ``load_state_dict``, which
    binds it to the optimizer's own leaves: they must be ``params``'
    leaves, in their order.  ``step`` stays a CPU tensor unless the
    optimizer is capturable or fused (torch moves it then)."""
    leaves = _leaves(params)
    bound = [p for g in opt.param_groups for p in g["params"]]
    if len(bound) != len(leaves) or any(
            a is not b for a, b in zip(bound, leaves)):
        raise ValueError("the optimizer is not bound to these params")
    mu, nu = (_leaves(_pick(params, payload[k])) for k in ("mu", "nu"))
    step = torch.tensor(float(payload["count"]), dtype=torch.float32)
    sd = opt.state_dict()
    sd["state"] = {i: {"step": step.clone(), "exp_avg": host_tensor(m),
                       "exp_avg_sq": host_tensor(v)}
                   for i, (m, v) in enumerate(zip(mu, nu))}
    opt.load_state_dict(sd)


def state_to_host(state: "TrainState") -> dict:
    """The checkpoint payload of ``state``: ``{"params", "opt_state",
    "step"}`` as numpy, copied off the device before this returns (one
    pinned buffer, see ``checkpoint.to_host``)."""
    return to_host({"params": state.params,
                    "opt_state": adam_state(state.opt_state, state.params),
                    "step": int(state.step)})


@torch.no_grad()
def load_state(state: "TrainState", payload: dict) -> None:
    """Restore ``state`` in place from a payload of ``state_to_host`` (or
    of the JAX trainer once its ``opt_state`` went through
    ``optax_adam_to_torch``): every params leaf is overwritten with
    ``copy_`` and the optimizer's moments and count are loaded into its
    own state.  The leaves stay the tensors the optimizer steps; binding
    ``state.params`` to new tensors would leave it stepping the old
    ones.  A payload without ``opt_state`` keeps the optimizer's."""
    src = _leaves(_pick(state.params, payload["params"]))
    for p, a in zip(_leaves(state.params), src):
        p.copy_(host_tensor(a))
    if "opt_state" in payload:
        load_adam_state(state.opt_state, state.params, payload["opt_state"])
    state.step.fill_(int(payload.get("step", 0)))


def make_train_step(loss_fn: Callable, tx: Callable, *, mesh=None):
    """Build ``(init_fn, step_fn)``.

    loss_fn(params, batch) -> 0-d loss (closed over the model config).
    tx(leaves) -> a ``torch.optim.Optimizer``, e.g. ``adamw(3e-4)``.
    init_fn(params) -> TrainState over a copy of ``params``: the caller's
    tensors are left as they are (the JAX package copies them because its
    step donates the state).
    step_fn(state, batch) -> (state, {"loss", "grad_norm"}): value and
    grad, then the optimizer's in-place update.  Both metrics are 0-d
    device tensors (grad_norm is ``optax.global_norm``, the f32 L2 norm
    over all leaves) and the step makes no host sync.
    """
    _no_mesh(mesh, "make_train_step")

    def init_fn(params):
        params = _map(lambda t: t.detach().clone().requires_grad_(True),
                      params)
        leaves = _leaves(params)
        step = torch.zeros((), dtype=torch.int64, device=leaves[0].device)
        return TrainState(step=step, params=params, opt_state=tx(leaves))

    def step_fn(state: TrainState, batch):
        leaves = _leaves(state.params)
        loss = loss_fn(state.params, batch)
        # a leaf the loss does not use (BERT's wtype without token types)
        # gets a zero gradient, as under jax.grad
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        grad_norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g, dtype=torch.float32)
             for g in grads]))
        for p, g in zip(leaves, grads):
            p.grad = g
        state.opt_state.step()
        state.opt_state.zero_grad(set_to_none=True)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return init_fn, step_fn
