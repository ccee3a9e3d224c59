"""Vanilla policy gradient (REINFORCE with a value baseline), the port of
``ray_tpu/rllib/pg.py``: ``PGConfig``, ``pg_loss`` and ``PG``.

``OnPolicyLearner`` is the learner half that PG, A2C and IMPALA share:
the inline ``WorkerSet``, the actor-critic params on the learner's
device, one Adam over them, and a checkpoint that also restores the
JAX package's (``params``, optax ``opt_state``, ``timesteps``).  The
advantages are standardised with the population std (``correction=0``,
as ``jnp.std``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.data.feed import to_device
from ray_tpu_torch.rllib import sample_batch as SB
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig, WorkerSet
from ray_tpu_torch.rllib.optim import Adam, copy_into, params_on, to_numpy
from ray_tpu_torch.rllib.policy import (PolicyConfig, init_policy_params,
                                        policy_forward)
from ray_tpu_torch.rllib.sample_batch import SampleBatch


@dataclass
class PGConfig(AlgorithmConfig):
    vf_coeff: float = 0.5
    ent_coeff: float = 0.0
    lr: float = 4e-3

    def build(self, algo_cls=None) -> "PG":
        return PG({"_config": self})


def standardize(adv):
    """(adv - mean) / (population std + 1e-8)."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def log_probs(logits, actions):
    """-> (log-softmax [..., A], log-probability of ``actions`` [...])."""
    logp_all = torch.log_softmax(logits, dim=-1)
    return logp_all, logp_all.gather(-1, actions.long()[..., None])[..., 0]


def entropy(logp_all):
    return -(torch.exp(logp_all) * logp_all).sum(dim=-1).mean()


def pg_loss(params, batch, *, vf_coeff, ent_coeff):
    """-> (total loss, {"pi_loss", "vf_loss", "entropy"})."""
    logits, value = policy_forward(params, batch[SB.OBS])
    logp_all, logp = log_probs(logits, batch[SB.ACTIONS])
    adv = standardize(batch[SB.ADVANTAGES])
    pi_loss = -(logp * adv).mean()
    vf_loss = ((value - batch[SB.VALUE_TARGETS]) ** 2).mean()
    ent = entropy(logp_all)
    total = pi_loss + vf_coeff * vf_loss - ent_coeff * ent
    return total, {"pi_loss": pi_loss, "vf_loss": vf_loss, "entropy": ent}


class OnPolicyLearner(Algorithm):
    """Workers, actor-critic params and their Adam on ``config.device``
    (None = the CUDA card)."""

    def _build_learner(self, clip_norm=None):
        cfg = self.config
        self.device = resolve_device(cfg.device)
        self.workers = WorkerSet(cfg)
        pcfg = PolicyConfig(obs_dim=self.workers.obs_dim,
                            num_actions=self.workers.num_actions,
                            hiddens=tuple(cfg.hiddens))
        self.params = params_on(
            init_policy_params(pcfg, cfg.seed, device=self.device),
            self.device)
        self.opt = Adam(self.params, cfg.lr, clip_norm=clip_norm)
        self.workers.sync_weights(to_numpy(self.params))

    def save_checkpoint(self) -> dict:
        return to_numpy({"params": self.params,
                         "opt_state": self.opt.state(),
                         "timesteps": self._timesteps})

    def load_checkpoint(self, ck):
        """A port save, or the JAX package's (its optax state goes
        through the Adam bridge)."""
        copy_into(self.params, ck["params"])
        if "opt_state" in ck:
            self.opt.load(ck["opt_state"])
        else:
            self.opt = Adam(self.params, self.config.lr,
                            clip_norm=self.opt.clip_norm)
        self._timesteps = ck.get("timesteps", 0)
        self.workers.sync_weights(to_numpy(self.params))

    def cleanup(self):
        self.workers.stop()


class PG(OnPolicyLearner):
    _default_config = PGConfig

    def _build(self):
        self._build_learner()

    def update(self, batch) -> dict:
        """One Adam step of ``pg_loss`` on ``batch`` (tensors on the
        learner's device) -> the loss's parts, 0-d tensors."""
        cfg = self.config
        total, aux = pg_loss(self.params, batch, vf_coeff=cfg.vf_coeff,
                             ent_coeff=cfg.ent_coeff)
        self.opt.minimize(total)
        return {k: v.detach() for k, v in aux.items()}

    def _gather(self, keys):
        """Sample until a train batch is full -> its ``keys`` columns on
        the learner's device, and the batch's row count."""
        batches, steps = [], 0
        while steps < self.config.train_batch_size:
            b, rets = self.workers.sample_sync()
            self._ep_returns.extend(rets)
            batches.append(b)
            steps += b.count
        train_batch = SampleBatch.concat_samples(batches)
        self._timesteps += train_batch.count
        return (to_device({k: train_batch[k] for k in keys}, self.device),
                train_batch.count)

    def training_step(self) -> dict:
        batch, n = self._gather((SB.OBS, SB.ACTIONS, SB.ADVANTAGES,
                                 SB.VALUE_TARGETS))
        aux = self.update(batch)
        self.workers.sync_weights(to_numpy(self.params))
        out = {k: float(v) for k, v in aux.items()}
        out["steps_this_iter"] = n
        return out
