"""The train-step factory, the port of ``ray_tpu/train/step.py``.

``make_train_step(loss_fn, tx)`` gives ``(init_fn, step_fn)`` as the JAX
package does.  Where JAX jits the step and donates its state, the port
runs it eagerly and updates the params and the optimizer state in place.
``adamw`` is ``optax.adamw``: torch's AdamW over the stacked leaves does
the same update (decoupled weight decay on every leaf, eps outside the
square root).

Single device only: the mesh, sharding rules, ``shard_batch`` and the
1F1B step come with the port of parallelism.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable

import torch

from ray_tpu_torch.models.convert import _leaves, _map


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
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step on a mesh is not ported yet; the port trains "
            "on one device")

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
