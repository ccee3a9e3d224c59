"""MAML: model-agnostic meta-learning, the port of
``ray_tpu/rllib/maml.py``: ``SinusoidTasks``, ``MAMLConfig``,
``init_mlp``, ``mlp_forward``, ``make_maml_update`` and ``MAML``.

The inner SGD, a ``lax.scan`` in the JAX package, is a loop of
``torch.autograd.grad(..., create_graph=True)``, so the meta-gradient is
second order as ``jax.grad`` through the scan is; ``first_order`` takes
the inner gradients without a graph (FOMAML) and keeps the identity path
from the initial params to the adapted ones.  The tasks of a meta-batch
run as one batch: the adapted params carry a leading task axis, and
since each task's loss reaches only its own slice, one gradient of the
summed losses holds every task's own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.data.feed import to_device
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.optim import (Adam, copy_into, params_on, to_numpy,
                                       tree_leaves, tree_unflatten)


class SinusoidTasks:
    """y = A sin(x + phi), A ~ U[0.1, 5], phi ~ U[0, pi]; x ~ U[-5, 5]
    (Finn et al. 2017, section 5.1)."""

    def __init__(self, seed: int = 0, shots: int = 10, query: int = 10):
        self.rng = np.random.RandomState(seed)
        self.shots, self.query = shots, query

    def sample(self, n_tasks: int) -> dict:
        A = self.rng.uniform(0.1, 5.0, (n_tasks, 1, 1))
        phi = self.rng.uniform(0.0, np.pi, (n_tasks, 1, 1))
        xs = self.rng.uniform(-5, 5, (n_tasks, self.shots, 1))
        xq = self.rng.uniform(-5, 5, (n_tasks, self.query, 1))
        return {"xs": xs.astype(np.float32),
                "ys": (A * np.sin(xs + phi)).astype(np.float32),
                "xq": xq.astype(np.float32),
                "yq": (A * np.sin(xq + phi)).astype(np.float32)}


@dataclass
class MAMLConfig(AlgorithmConfig):
    inner_lr: float = 0.05
    inner_steps: int = 3
    meta_lr: float = 3e-3
    meta_batch_size: int = 25
    first_order: bool = False            # FOMAML when True
    hiddens: tuple = (40, 40)
    shots: int = 10
    query: int = 10
    meta_iters_per_step: int = 100
    task_sampler: Optional[Callable] = None   # () -> SinusoidTasks-like

    def build(self, algo_cls=None) -> "MAML":
        return MAML({"_config": self})


def init_mlp(sizes, seed: int = 0, *, device=None,
             generator: Optional[torch.Generator] = None) -> list:
    """Glorot-uniform layers, zero biases, drawn from a
    ``torch.Generator`` on the device."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    params = []
    for nin, nout in zip(sizes[:-1], sizes[1:]):
        lim = float(np.sqrt(6.0 / (nin + nout)))
        w = torch.rand((nin, nout), generator=generator, device=dev)
        params.append({"w": w * (2 * lim) - lim,
                       "b": torch.zeros(nout, device=dev)})
    return params


def mlp_forward(params, x):
    """ReLU MLP; a leading task axis on the params (w [T, in, out], b
    [T, out]) maps x [T, n, in] task by task."""
    for i, layer in enumerate(params):
        x = torch.matmul(x, layer["w"]) + layer["b"].unsqueeze(-2)
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def task_loss(p, x, y):
    """Mean squared error per task ([T] with a task axis, else 0-d)."""
    return ((mlp_forward(p, x) - y) ** 2).mean(dim=(-2, -1))


def make_maml_update(cfg: MAMLConfig):
    """-> ``(update, adapt, task_loss)``.  ``update(params, opt, batch)``
    takes one Adam step of ``opt`` on the meta-loss of a batch of tasks
    (xs, ys [T, shots, 1], xq, yq [T, query, 1]) -> ``(params, opt,
    loss)``; ``adapt(params, xs, ys)`` -> the adapted params, with a
    task axis when xs has one."""
    def inner(p, xs, ys, *, meta: bool):
        """``inner_steps`` of SGD on the support set; with ``meta`` the
        graph is kept for the meta-gradient (second order unless
        ``first_order``)."""
        leaves = tree_leaves(p)
        if xs.dim() == 3:              # one copy of the params per task
            leaves = [t.expand(xs.shape[0], *t.shape) for t in leaves]
        second = meta and not cfg.first_order
        for _ in range(cfg.inner_steps):
            q = tree_unflatten(p, leaves)
            g = torch.autograd.grad(task_loss(q, xs, ys).sum(), leaves,
                                    create_graph=second)
            leaves = [a - cfg.inner_lr * b for a, b in zip(leaves, g)]
        return tree_unflatten(p, leaves)

    def update(params, opt, batch):
        q = inner(params, batch["xs"], batch["ys"], meta=True)
        loss = task_loss(q, batch["xq"], batch["yq"]).mean()
        opt.minimize(loss)
        return params, opt, loss.detach()

    def adapt(params, xs, ys):
        with torch.enable_grad():
            q = inner(params, xs, ys, meta=False)
        return [{k: v.detach() for k, v in layer.items()} for layer in q]

    return update, adapt, task_loss


class MAML(Algorithm):
    _default_config = MAMLConfig

    def _build(self):
        cfg = self.config
        self.device = dev = resolve_device(cfg.device)
        sampler = cfg.task_sampler or (
            lambda: SinusoidTasks(seed=cfg.seed, shots=cfg.shots,
                                  query=cfg.query))
        self.tasks = sampler()
        self.params = params_on(init_mlp(
            (1,) + tuple(cfg.hiddens) + (1,), cfg.seed, device=dev), dev)
        self.opt = Adam(self.params, cfg.meta_lr)
        self._update, self.adapt, self.task_loss = make_maml_update(cfg)

    def training_step(self) -> dict:
        cfg = self.config
        loss = None
        for _ in range(cfg.meta_iters_per_step):
            b = to_device(self.tasks.sample(cfg.meta_batch_size),
                          self.device)
            _, _, loss = self._update(self.params, self.opt, b)
        self._timesteps += cfg.meta_iters_per_step
        return {"meta_loss": float(loss),
                "steps_this_iter": cfg.meta_iters_per_step}

    @torch.no_grad()
    def evaluate_adaptation(self, n_tasks: int = 20) -> dict:
        """Post-adaptation query loss against the unadapted params'."""
        b = to_device(self.tasks.sample(n_tasks), self.device)
        pre = self.task_loss(self.params, b["xq"], b["yq"])
        q = self.adapt(self.params, b["xs"], b["ys"])
        post = self.task_loss(q, b["xq"], b["yq"])
        return {"pre_adapt_loss": float(pre.mean()),
                "post_adapt_loss": float(post.mean())}

    def save_checkpoint(self) -> dict:
        return to_numpy({"params": self.params,
                         "opt_state": self.opt.state(),
                         "timesteps": self._timesteps})

    def load_checkpoint(self, ck):
        """A port save, or the JAX package's (optax state bridged)."""
        copy_into(self.params, ck["params"])
        if "opt_state" in ck:
            self.opt.load(ck["opt_state"])
        self._timesteps = ck.get("timesteps", 0)
