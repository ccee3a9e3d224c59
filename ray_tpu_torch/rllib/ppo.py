"""PPO: the clipped surrogate objective, the port of
``ray_tpu/rllib/ppo.py``: ``PPOConfig``, ``ppo_loss``, ``make_ppo_update``
and ``PPO``.

Where the JAX package compiles the whole update (epochs x minibatches)
into one program with ``lax.scan``, the port runs it as a Python loop
of Adam steps on the learner's device.  Three points hold it to the
reference: the advantages are standardised with the population std
(``correction=0``, as ``jnp.std``); each epoch takes ``n // minibatch``
minibatches and drops the rows left over; and the permutations, which
the JAX package draws from its key, can be passed in (``perms``), so a
parity test feeds JAX's.  Without them the port draws its own from a
seeded ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.data.feed import to_device
from ray_tpu_torch.models.convert import (_leaves, _map, _pick,
                                          optax_adam_to_torch,
                                          params_to_numpy)
from ray_tpu_torch.rllib import sample_batch as SB
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig, WorkerSet
from ray_tpu_torch.rllib.policy import (PolicyConfig, init_policy_params,
                                        policy_forward)
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.train.checkpoint import host_tensor, to_host
from ray_tpu_torch.train.step import adam, adam_state, load_adam_state

# the columns the learner trains on
TRAIN_KEYS = (SB.OBS, SB.ACTIONS, SB.LOGP, SB.ADVANTAGES, SB.VALUE_TARGETS,
              SB.VF_PREDS)
METRIC_KEYS = ("policy_loss", "vf_loss", "entropy", "kl", "total_loss")


@dataclass
class PPOConfig(AlgorithmConfig):
    clip_param: float = 0.2
    vf_clip_param: float = 10.0
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.0
    kl_target: float = 0.2

    def build(self, algo_cls=None) -> "PPO":
        return PPO({"_config": self})


def ppo_loss(params, batch, *, clip, vf_clip, vf_coeff, ent_coeff):
    """-> (total loss, {"policy_loss", "vf_loss", "entropy", "kl"})."""
    logits, value = policy_forward(params, batch[SB.OBS])
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(1, batch[SB.ACTIONS].long()[:, None])[:, 0]
    ratio = torch.exp(logp - batch[SB.LOGP])
    adv = batch[SB.ADVANTAGES]
    surr = torch.minimum(ratio * adv,
                         torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
    pi_loss = -surr.mean()

    vf_err = value - batch[SB.VALUE_TARGETS]
    vf_clipped = batch[SB.VF_PREDS] + torch.clamp(
        value - batch[SB.VF_PREDS], -vf_clip, vf_clip)
    vf_err2 = torch.maximum(vf_err ** 2,
                            (vf_clipped - batch[SB.VALUE_TARGETS]) ** 2)
    vf_loss = 0.5 * vf_err2.mean()

    entropy = -(torch.exp(logp_all) * logp_all).sum(dim=-1).mean()
    kl = (batch[SB.LOGP] - logp).mean()
    total = pi_loss + vf_coeff * vf_loss - ent_coeff * entropy
    return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                   "entropy": entropy, "kl": kl}


def make_ppo_update(cfg: PPOConfig):
    """-> ``update(params, opt, batch, *, perms=None, generator=None)``:
    ``cfg.num_epochs`` epochs of ``n // cfg.minibatch_size`` Adam steps
    of ``opt`` (an optimizer over ``params``' leaves, updated in place)
    on ``batch`` (tensors on the params' device).  ``perms[e]`` (an array
    of row indices) is epoch e's row order; without it each epoch draws ``randperm`` from
    ``generator``.  Returns ``(params, opt, metrics)``, the metrics
    0-d tensors averaged over every minibatch step."""
    loss_fn = partial(ppo_loss, clip=cfg.clip_param,
                      vf_clip=cfg.vf_clip_param,
                      vf_coeff=cfg.vf_loss_coeff,
                      ent_coeff=cfg.entropy_coeff)

    def update(params, opt, batch, *, perms=None,
               generator: Optional[torch.Generator] = None):
        leaves = _leaves(params)
        n = batch[SB.OBS].shape[0]
        mb = cfg.minibatch_size
        num_mb = n // mb

        # standardise the advantages over the train batch (population std)
        adv = batch[SB.ADVANTAGES]
        batch = dict(batch)
        batch[SB.ADVANTAGES] = (adv - adv.mean()) / (
            adv.std(correction=0) + 1e-8)

        rows = []
        for e in range(cfg.num_epochs):
            perm = (torch.as_tensor(np.array(perms[e], np.int64),
                                    device=adv.device)
                    if perms is not None else
                    torch.randperm(n, generator=generator,
                                   device=adv.device))
            shuf = {k: v[perm] for k, v in batch.items()}
            for i in range(num_mb):
                sl = {k: v[i * mb:(i + 1) * mb] for k, v in shuf.items()}
                total, aux = loss_fn(params, sl)
                grads = torch.autograd.grad(total, leaves)
                for p, g in zip(leaves, grads):
                    p.grad = g
                opt.step()
                opt.zero_grad(set_to_none=True)
                rows.append(torch.stack(
                    [aux[k].detach() for k in METRIC_KEYS[:-1]]
                    + [total.detach()]))
        means = torch.stack(rows).mean(dim=0)
        return params, opt, dict(zip(METRIC_KEYS, means))

    return update


class PPO(Algorithm):
    _default_config = PPOConfig

    def _build(self):
        cfg = self.config
        self.device = resolve_device(cfg.device)
        self.workers = WorkerSet(cfg)
        pcfg = PolicyConfig(obs_dim=self.workers.obs_dim,
                            num_actions=self.workers.num_actions,
                            hiddens=tuple(cfg.hiddens))
        self.params = _map(lambda t: t.requires_grad_(True),
                           init_policy_params(pcfg, cfg.seed,
                                              device=self.device))
        self.tx = adam(cfg.lr)
        self.opt_state = self.tx(_leaves(self.params))
        self._update = make_ppo_update(cfg)
        self._gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 7)
        self.workers.sync_weights(params_to_numpy(self.params))

    def training_step(self) -> dict:
        cfg = self.config
        batches, steps = [], 0
        while steps < cfg.train_batch_size:
            b, rets = self.workers.sample_sync()
            self._ep_returns.extend(rets)
            batches.append(b)
            steps += b.count
        train_batch = SampleBatch.concat_samples(batches)
        self._timesteps += train_batch.count

        batch = to_device({k: train_batch[k] for k in TRAIN_KEYS},
                          self.device)
        _, _, metrics = self._update(self.params, self.opt_state, batch,
                                     generator=self._gen)
        self.workers.sync_weights(params_to_numpy(self.params))
        out = {k: float(v) for k, v in metrics.items()}
        out["steps_this_iter"] = train_batch.count
        return out

    def save_checkpoint(self) -> dict:
        return to_host({"params": self.params,
                        "opt_state": adam_state(self.opt_state, self.params),
                        "timesteps": self._timesteps})

    @torch.no_grad()
    def load_checkpoint(self, ck):
        """Restores a port save, or the JAX package's (its optax state
        goes through ``optax_adam_to_torch``); the leaves stay the ones
        the optimizer steps."""
        src = ck["params"]
        for p, a in zip(_leaves(self.params),
                        _leaves(_pick(self.params, src))):
            p.copy_(host_tensor(a))
        opt = ck.get("opt_state")
        if opt is None:
            self.opt_state = self.tx(_leaves(self.params))
        else:
            if not (isinstance(opt, dict) and "mu" in opt):
                opt = optax_adam_to_torch(opt)
            load_adam_state(self.opt_state, self.params, opt)
        self._timesteps = ck.get("timesteps", 0)
        self.workers.sync_weights(params_to_numpy(self.params))
