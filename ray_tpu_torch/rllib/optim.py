"""Params trees and Adam for the RL learners.

The JAX package's learners keep their params as pytrees (dicts, lists
and tuples of arrays) and step them with optax.  Here a tree holds torch
tensors in the same nesting, and ``Adam`` steps its leaves with torch's
Adam (``optax.adam``), AdamW (``optax.adamw``, every leaf decayed) or
Adam after optax's ``clip_by_global_norm``.

Leaves are taken in JAX's order (dict keys sorted, lists and tuples in
order), so a leaf of an optax state saved by the JAX package lines up
with the port's leaf of the same path, whatever order the port's dicts
were built in.  ``Adam.state()`` is the checkpoint's layout,
``{"count", "mu", "nu"}`` with the moments in the params' nesting, which
``models.convert.torch_adam_to_optax`` turns back into optax's state.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ray_tpu_torch.models.convert import optax_adam_to_torch
from ray_tpu_torch.train.checkpoint import _walk as tree_map
from ray_tpu_torch.train.checkpoint import host_tensor, to_host
from ray_tpu_torch.train.step import adam, adamw


def tree_leaves(tree) -> list:
    """The leaves in JAX's order: dict keys sorted, sequences in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """``leaves`` (in ``tree_leaves`` order) in ``like``'s nesting."""
    it = iter(leaves)
    if isinstance(like, dict):
        out = {k: None for k in like}
        for k in sorted(like):
            out[k] = tree_unflatten(like[k], [next(it) for _ in
                                              tree_leaves(like[k])])
        return out
    if isinstance(like, (list, tuple)):
        return type(like)(tree_unflatten(v, [next(it) for _ in
                                             tree_leaves(v)])
                          for v in like)
    return next(it)


def params_on(tree, device, *, grad: bool = True):
    """A host tree (numpy arrays, or tensors) -> fresh f32 tensors on
    ``device`` in the same nesting, leaves of autograd when ``grad``."""
    def leaf(a):
        t = host_tensor(a) if not isinstance(a, torch.Tensor) else \
            a.detach().clone()
        t = t.to(device=device, dtype=torch.float32)
        return t.requires_grad_(True) if grad else t
    return tree_map(leaf, tree)


def to_numpy(tree):
    """A tree's tensors -> numpy copies on the host, same nesting (other
    leaves pass through)."""
    with torch.no_grad():
        return to_host(tree_map(
            lambda t: t.detach() if isinstance(t, torch.Tensor) else t,
            tree))


@torch.no_grad()
def copy_into(tree, host):
    """Overwrite every leaf of ``tree`` in place with ``host``'s leaf of
    the same path (numpy or tensors): the leaves stay the tensors an
    optimizer steps."""
    for p, a in zip(tree_leaves(tree), tree_leaves(host)):
        p.copy_(a if isinstance(a, torch.Tensor) else host_tensor(a))


@torch.no_grad()
def polyak(target, source, tau: float):
    """``target <- (1 - tau) target + tau source`` over every leaf, in
    place, as two fused ``foreach`` calls."""
    ts = tree_leaves(target)
    torch._foreach_mul_(ts, 1 - tau)
    torch._foreach_add_(ts, tree_leaves(source), alpha=tau)


def clip_by_global_norm(grads: list, max_norm: float) -> list:
    """optax's rule: unchanged when the global norm is below
    ``max_norm``, else each gradient ``g / norm * max_norm``."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    return [torch.where(norm < max_norm, g, g / norm * max_norm)
            for g in grads]


class Adam:
    """``optax.adam(lr)`` over the leaves of ``params`` (a tree of leaf
    tensors, stepped in place); ``weight_decay`` makes it
    ``optax.adamw``, ``clip_norm`` chains ``clip_by_global_norm`` before
    it, as ``optax.chain`` does."""

    def __init__(self, params, lr: float, *,
                 weight_decay: Optional[float] = None,
                 clip_norm: Optional[float] = None):
        self.params = params
        self.leaves = tree_leaves(params)
        ctor = (adam(lr) if weight_decay is None
                else adamw(lr, weight_decay=weight_decay))
        self.opt = ctor(self.leaves)
        self.clip_norm = clip_norm

    def step(self, grads) -> None:
        """One update from ``grads``, the gradients of the leaves in
        ``tree_leaves`` order."""
        grads = list(grads)
        if self.clip_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_norm)
        for p, g in zip(self.leaves, grads):
            p.grad = g
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)

    def minimize(self, loss) -> None:
        """Step on the gradients of ``loss`` with respect to the leaves;
        a leaf the loss does not reach gets a zero gradient, as under
        ``jax.grad`` (its moments decay and it does not move)."""
        grads = torch.autograd.grad(loss, self.leaves, allow_unused=True)
        self.step([torch.zeros_like(p) if g is None else g
                   for p, g in zip(self.leaves, grads)])

    @property
    def count(self) -> int:
        st = self.opt.state.get(self.leaves[0], {})
        return int(st["step"]) if "step" in st else 0

    def state(self) -> dict:
        """``{"count", "mu", "nu"}``, the moments as trees like the
        params' (live tensors; zeros before the first step)."""
        def moment(key):
            return tree_unflatten(self.params, [
                self.opt.state[p][key] if p in self.opt.state
                else torch.zeros_like(p) for p in self.leaves])
        return {"count": self.count, "mu": moment("exp_avg"),
                "nu": moment("exp_avg_sq")}

    def load(self, saved) -> None:
        """Restore the moments and count from ``state()``'s layout or
        from an optax state holding a ``ScaleByAdamState`` (the JAX
        package's ``opt_state``, chains included)."""
        if not (isinstance(saved, dict) and "mu" in saved):
            saved = optax_adam_to_torch(saved)
        mu, nu = tree_leaves(saved["mu"]), tree_leaves(saved["nu"])
        if len(mu) != len(self.leaves):
            raise ValueError(f"{len(mu)} moments for {len(self.leaves)} "
                             "leaves")
        step = torch.tensor(float(saved["count"]), dtype=torch.float32)

        def host(a):
            return (a.detach().cpu() if isinstance(a, torch.Tensor)
                    else host_tensor(np.asarray(a, np.float32)))
        sd = self.opt.state_dict()
        sd["state"] = {i: {"step": step.clone(), "exp_avg": host(m),
                           "exp_avg_sq": host(v)}
                       for i, (m, v) in enumerate(zip(mu, nu))}
        self.opt.load_state_dict(sd)
