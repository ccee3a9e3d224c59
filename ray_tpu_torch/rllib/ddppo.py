"""DD-PPO: decentralized distributed PPO, the port of
``ray_tpu/rllib/ddppo.py``.  Workers learn locally and average their
gradients among themselves; there is no central learner.

The workers are the members of a ``MultiHostGang`` on ``ProcessHost``
(``parallel.gang``): a learner-less gang of processes, as the JAX
package's workers are actors; they share the card (or the CPU), over
gloo.  Each member process holds a ``_DDPPOWorker`` in its state across
worlds: its own ``RolloutWorker``
(seed ``seed + 1000 * rank``), its own numpy permutation stream (seed
``seed + 31 * rank``) and the same initial params on every rank (from
``seed``).  Each minibatch's gradients are flattened in JAX's leaf order
and averaged over the world in ONE all-reduce, then Adam steps on every
rank, so the ranks stay in lockstep with no weight sync.  Where the JAX
package needs its core runtime for the worker gang, the port's gang is
its runtime.  ``train_batch_size`` is per worker.  The owner reaches
the workers only through the gang's ``run`` (``on_workers``, given a
module-level function of the worker such as ``worker_weights``): the
config goes out, numpy comes back.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.data.feed import to_device
from ray_tpu_torch.parallel.gang import (MultiHostGang, ProcessHost,
                                         current_member)
from ray_tpu_torch.rllib import sample_batch as SB
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.optim import Adam, params_on, to_numpy, tree_leaves
from ray_tpu_torch.rllib.policy import PolicyConfig, init_policy_params
from ray_tpu_torch.rllib.ppo import METRIC_KEYS, TRAIN_KEYS, PPOConfig, ppo_loss
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker
from ray_tpu_torch.rllib.sample_batch import SampleBatch


@dataclass
class DDPPOConfig(PPOConfig):
    # train_batch_size is PER WORKER
    num_rollout_workers: int = 2

    def build(self, algo_cls=None) -> "DDPPO":
        return DDPPO({"_config": self})


class _DDPPOWorker:
    """One decentralized worker: rollouts, local SGD and the gradient
    all-reduce, on ``device``.  Lives in its gang member's state."""

    def __init__(self, cfg: DDPPOConfig, rank: int, world: int, device):
        self.cfg = cfg
        self.rank, self.world = rank, world
        self.device = device
        self.worker = RolloutWorker(
            cfg.env, seed=cfg.seed + 1000 * rank,
            num_envs=cfg.num_envs_per_worker,
            rollout_length=cfg.rollout_length, gamma=cfg.gamma,
            lam=cfg.lam, hiddens=cfg.hiddens, device=device)
        pcfg = PolicyConfig(obs_dim=self.worker.cfg.obs_dim,
                            num_actions=self.worker.cfg.num_actions,
                            hiddens=tuple(cfg.hiddens))
        # the same seed on every rank: identical initial params, which
        # the averaged gradients keep in lockstep
        self.params = params_on(init_policy_params(pcfg, cfg.seed,
                                                   device=device), device)
        self.opt = Adam(self.params, cfg.lr)
        self._rng = np.random.RandomState(cfg.seed + 31 * rank)
        self._loss = partial(ppo_loss, clip=cfg.clip_param,
                             vf_clip=cfg.vf_clip_param,
                             vf_coeff=cfg.vf_loss_coeff,
                             ent_coeff=cfg.entropy_coeff)
        self.worker.set_weights(self.get_weights())

    def _allreduce_grads(self, grads: list) -> list:
        """ONE all-reduce per minibatch: the gradients flattened into a
        single vector, summed over the world and divided by its size."""
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat /= self.world
        out, off = [], 0
        for g in grads:
            out.append(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        return out

    def sample(self) -> SampleBatch:
        """Rollouts until ``train_batch_size`` steps, concatenated."""
        batches, steps = [], 0
        while steps < self.cfg.train_batch_size:
            b = SampleBatch(self.worker.sample())
            batches.append(b)
            steps += b.count
        return SampleBatch.concat_samples(batches)

    def learn(self, batch) -> dict:
        """The local SGD on a host batch (the train columns, numpy):
        advantages standardised on the host, then ``num_epochs`` epochs
        of minibatch steps on averaged gradients.  Returns the metrics,
        each averaged over the minibatch steps."""
        cfg = self.cfg
        jb = {k: np.asarray(batch[k]) for k in TRAIN_KEYS}
        adv = jb[SB.ADVANTAGES]
        jb[SB.ADVANTAGES] = (adv - adv.mean()) / (adv.std() + 1e-8)
        tb = to_device(jb, self.device)
        n = jb[SB.OBS].shape[0]
        mb = min(cfg.minibatch_size, n)
        num_mb = max(1, n // mb)
        leaves = tree_leaves(self.params)
        rows = []
        for _ in range(cfg.num_epochs):
            perm = torch.as_tensor(self._rng.permutation(n),
                                   device=self.device)
            shuf = {k: v[perm] for k, v in tb.items()}
            for i in range(num_mb):
                sl = {k: v[i * mb:(i + 1) * mb] for k, v in shuf.items()}
                total, aux = self._loss(self.params, sl)
                grads = torch.autograd.grad(total, leaves)
                self.opt.step(self._allreduce_grads(list(grads)))
                rows.append(torch.stack(
                    [aux[k].detach() for k in METRIC_KEYS[:-1]]
                    + [total.detach()]))
        self.worker.set_weights(self.get_weights())
        per_step = torch.stack(rows).tolist()
        return {k: float(np.mean([r[j] for r in per_step]))
                for j, k in enumerate(METRIC_KEYS)}

    def train_once(self) -> dict:
        batch = self.sample()
        out = self.learn(batch)
        out["count"] = batch.count
        out["episode_returns"] = self.worker.episode_returns()
        return out

    def get_weights(self):
        return to_numpy(self.params)

    def set_weights(self, weights) -> None:
        self.params = params_on(weights, self.device)
        self.opt = Adam(self.params, self.cfg.lr)
        self.worker.set_weights(self.get_weights())


def _worker() -> _DDPPOWorker:
    return current_member().state["ddppo"]


def _build_worker(rank: int, cfg: DDPPOConfig, world: int) -> None:
    me = current_member()
    me.state["ddppo"] = _DDPPOWorker(cfg, rank, world, me.device)


def _on_worker(rank: int, fn, *args):
    return fn(_worker(), rank, *args)


# what ``DDPPO.on_workers`` runs on a worker: fn(worker, rank, *args)

def worker_train_once(w: _DDPPOWorker, rank: int) -> dict:
    return w.train_once()


def worker_weights(w: _DDPPOWorker, rank: int):
    """The worker's params as numpy."""
    return w.get_weights()


def worker_set_weights(w: _DDPPOWorker, rank: int, weights) -> None:
    w.set_weights(weights)


def worker_sample(w: _DDPPOWorker, rank: int) -> SampleBatch:
    return w.sample()


def worker_learn(w: _DDPPOWorker, rank: int, batches: list) -> dict:
    """The local SGD on ``batches[rank]`` (every rank's host batch is
    sent to every rank; each learns on its own)."""
    return w.learn(batches[rank])


class DDPPO(Algorithm):
    _default_config = DDPPOConfig

    def _build(self):
        cfg = self.config
        if cfg.num_rollout_workers < 2:
            raise ValueError(
                "DD-PPO needs num_rollout_workers >= 2 (train_batch_size "
                "is PER WORKER; silently adding workers would change the "
                f"experiment), got {cfg.num_rollout_workers}")
        self.device = resolve_device(cfg.device)
        world = cfg.num_rollout_workers
        self.gang: Optional[MultiHostGang] = MultiHostGang(
            world, device=self.device, host=ProcessHost())
        try:
            self.gang.run(_build_worker, cfg, world)
        except BaseException:
            self.gang.shutdown()
            raise

    def on_workers(self, fn, *args) -> list:
        """``fn(worker, rank, *args)`` on every worker, in its member's
        process, all in one world -> the results in rank order.  ``fn``
        is module-level (or a ``functools.partial`` of such) and the
        arguments and results travel with the standard pickle (numpy,
        not tensors): ``worker_weights``, ``worker_sample``,
        ``worker_learn`` and the like."""
        return self.gang.run(_on_worker, fn, *args)

    def training_step(self) -> dict:
        results = self.on_workers(worker_train_once)
        for r in results:
            self._ep_returns.extend(r.pop("episode_returns", []))
        steps = sum(r.pop("count") for r in results)
        self._timesteps += steps
        out = {k: float(np.mean([r[k] for r in results]))
               for k in results[0]}
        out["steps_this_iter"] = steps
        return out

    def save_checkpoint(self) -> dict:
        return {"params": self.on_workers(worker_weights)[0],
                "timesteps": self._timesteps}

    def load_checkpoint(self, ck):
        self.on_workers(worker_set_weights, ck["params"])
        self._timesteps = ck.get("timesteps", 0)

    def cleanup(self):
        if getattr(self, "gang", None) is not None:
            self.gang.shutdown()
        super().cleanup()
