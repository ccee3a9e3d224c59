"""The RLModule / Learner / LearnerGroup stack, the port of
``ray_tpu/rllib/rl_module.py``: ``RLModule``, ``DiscretePGModule``,
``MultiRLModule``, ``Learner`` and ``LearnerGroup``.

A module is a params tree and functions over it (``init_params`` takes
a ``torch.Generator``; ``forward_exploration`` samples with the
generator its batch carries under ``"generator"``, where the JAX
package's carries a key under ``"rng"``).  A ``Learner`` owns one
module's params on its device and an Adam over them.  ``LearnerGroup``
runs one learner inline, or, with ``num_learners > 0`` while the
in-process stand-in ``core.actors`` is initialised, that many learner
actors from the same seed: each update splits the batch's rows over
them, then their params are averaged and set on every one (synchronous
data parallelism), as the JAX package does on its core runtime.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.core import actors
from ray_tpu_torch.rllib.optim import (Adam, copy_into, params_on,
                                       to_numpy, tree_leaves, tree_map,
                                       tree_unflatten)
from ray_tpu_torch.rllib.pg import entropy, log_probs, standardize
from ray_tpu_torch.rllib.policy import (PolicyConfig, init_policy_params,
                                        policy_forward)


class RLModule:
    """The network: forward_inference/_exploration/_train over batch
    dicts and the scalar loss a ``Learner`` differentiates."""

    def init_params(self, generator: torch.Generator) -> Any:
        raise NotImplementedError

    def forward_inference(self, params, batch: Dict) -> Dict:
        """Greedy outputs for serving."""
        raise NotImplementedError

    def forward_exploration(self, params, batch: Dict) -> Dict:
        """Sampling outputs for rollouts (default: inference's)."""
        return self.forward_inference(params, batch)

    def forward_train(self, params, batch: Dict) -> Dict:
        """What the loss needs (logits, values, ...)."""
        raise NotImplementedError

    def loss(self, params, batch: Dict) -> torch.Tensor:
        raise NotImplementedError


class DiscretePGModule(RLModule):
    """Actor-critic over the policy nets of ``policy.py``, with the
    policy-gradient loss (advantages standardised, population std)."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hiddens=(64, 64), vf_coeff: float = 0.5,
                 ent_coeff: float = 0.01):
        self.cfg = PolicyConfig(obs_dim=obs_dim, num_actions=num_actions,
                                hiddens=tuple(hiddens))
        self.vf_coeff = vf_coeff
        self.ent_coeff = ent_coeff

    def init_params(self, generator: torch.Generator):
        return init_policy_params(self.cfg, device=generator.device,
                                  generator=generator)

    def forward_inference(self, params, batch):
        logits, value = policy_forward(params, batch["obs"])
        return {"actions": logits.argmax(dim=-1), "logits": logits,
                "vf": value}

    def forward_exploration(self, params, batch):
        logits, value = policy_forward(params, batch["obs"])
        actions = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                    generator=batch["generator"])[:, 0]
        _, logp = log_probs(logits, actions)
        return {"actions": actions, "logp": logp, "vf": value}

    def forward_train(self, params, batch):
        logits, value = policy_forward(params, batch["obs"])
        return {"logits": logits, "vf": value}

    def loss(self, params, batch):
        out = self.forward_train(params, batch)
        logp_all, logp = log_probs(out["logits"], batch["actions"])
        pi_loss = -(logp * standardize(batch["advantages"])).mean()
        vf_loss = ((out["vf"] - batch["value_targets"]) ** 2).mean()
        return (pi_loss + self.vf_coeff * vf_loss
                - self.ent_coeff * entropy(logp_all))


class MultiRLModule(RLModule):
    """Policy id -> RLModule."""

    def __init__(self, modules: Dict[str, RLModule]):
        self.modules = dict(modules)

    def init_params(self, generator: torch.Generator):
        return {pid: m.init_params(generator)
                for pid, m in sorted(self.modules.items())}

    def forward_inference(self, params, batch):
        return {pid: self.modules[pid].forward_inference(
                    params[pid], batch[pid]) for pid in batch}

    def forward_exploration(self, params, batch):
        return {pid: self.modules[pid].forward_exploration(
                    params[pid], batch[pid]) for pid in batch}

    def forward_train(self, params, batch):
        return {pid: self.modules[pid].forward_train(
                    params[pid], batch[pid]) for pid in batch}

    def loss(self, params, batch):
        return torch.stack([self.modules[pid].loss(params[pid], batch[pid])
                            for pid in batch]).mean()


def _batch_on(batch, device):
    """A (nested) batch of numpy columns -> tensors on ``device``."""
    return tree_map(lambda v: torch.as_tensor(np.asarray(v)).to(device),
                    batch)


class Learner:
    """One module's params on ``device`` (None = the CUDA card) and the
    optimizer over them: ``optimizer(params)`` if given, else
    ``optim.Adam(params, lr)``."""

    def __init__(self, module: RLModule, *, lr: float = 3e-4,
                 optimizer: Optional[Callable[[Any], Adam]] = None,
                 seed: int = 0, device=None):
        self.module = module
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = params_on(module.init_params(gen), self.device)
        self.opt = (optimizer(self.params) if optimizer is not None
                    else Adam(self.params, lr))

    def update(self, batch: Dict) -> Dict:
        loss = self.module.loss(self.params, _batch_on(batch, self.device))
        self.opt.minimize(loss)
        return {"loss": float(loss.detach())}

    def get_weights(self):
        return to_numpy(self.params)

    def set_weights(self, weights):
        copy_into(self.params, weights)

    def get_state(self) -> dict:
        """``{"params", "opt_state"}`` as numpy, the moments in
        ``optim.Adam.state()``'s layout."""
        return to_numpy({"params": self.params,
                         "opt_state": self.opt.state()})

    def set_state(self, state: dict) -> None:
        """Restore ``get_state()``'s payload, or the JAX learner's params
        and optax state under the same keys."""
        self.set_weights(state["params"])
        self.opt.load(state["opt_state"])


class LearnerGroup:
    """Updates through one inline ``Learner``, or through ``num_learners``
    learner actors of ``core.actors`` when it is initialised."""

    def __init__(self, module_factory: Callable[[], RLModule],
                 num_learners: int = 0, *, lr: float = 3e-4,
                 seed: int = 0, device=None):
        self._distributed = num_learners > 0 and actors.is_initialized()
        if not self._distributed:
            self._local = Learner(module_factory(), lr=lr, seed=seed,
                                  device=device)
            self.num_learners = 1
            return
        # the same seed: every learner starts from the same params, and
        # the averaging keeps them in lockstep
        make = actors.remote(Learner).remote
        self._learners = [make(module_factory(), lr=lr, seed=seed,
                               device=device) for _ in range(num_learners)]
        self.num_learners = num_learners

    @staticmethod
    def _rows(batch: Dict) -> int:
        leaves = tree_leaves(batch)
        return min(len(v) for v in leaves) if leaves else 0

    def _call(self, method: str, *args) -> list:
        return actors.get([getattr(lrn, method).remote(*args)
                           for lrn in self._learners])

    def update(self, batch: Dict) -> Dict:
        if not self._distributed:
            return self._local.update(batch)
        n, rows = self.num_learners, self._rows(batch)
        if rows < n:
            # too few rows to split: every learner updates on all of them
            # (an empty shard's NaN loss would spread through the average)
            results = self._call("update", batch)
        else:
            bounds = np.linspace(0, rows, n + 1, dtype=int)
            results = actors.get([lrn.update.remote(tree_map(
                lambda v, lo=int(lo), hi=int(hi): v[lo:hi], batch))
                for lrn, lo, hi in zip(self._learners, bounds, bounds[1:])])
        # parameter averaging over host copies (sync DP)
        ws = self._call("get_weights")
        avg = tree_unflatten(ws[0], [np.mean(np.stack(leaf), axis=0)
                                     for leaf in zip(*map(tree_leaves, ws))])
        self._call("set_weights", actors.put(avg))
        return {"loss": float(np.mean([r["loss"] for r in results]))}

    def get_weights(self):
        if not self._distributed:
            return self._local.get_weights()
        return actors.get(self._learners[0].get_weights.remote())

    def get_state(self) -> dict:
        if not self._distributed:
            return self._local.get_state()
        return actors.get(self._learners[0].get_state.remote())

    def set_state(self, state: dict) -> None:
        if not self._distributed:
            self._local.set_state(state)
        else:
            self._call("set_state", actors.put(state))

    def stop(self):
        """Kill the learner actors (nothing to release inline)."""
        if self._distributed:
            for lrn in self._learners:
                actors.kill(lrn)
