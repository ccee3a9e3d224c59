"""APPO: IMPALA's actor-learner with PPO's clipped surrogate over
V-trace advantages, the port of ``ray_tpu/rllib/appo.py``:
``APPOConfig``, ``make_appo_update`` and ``APPO``.

V-trace runs on the target network's values and log-probabilities; the
surrogate clips the learner/behaviour ratio.  The target network is a
copy of the params taken every ``target_update_freq`` updates.  In the
JAX package ``target_params = params`` binds immutable arrays; here the
optimizer steps the params in place, so the target is a clone, or it
would follow the learner at every step.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ray_tpu_torch.rllib import sample_batch as SB
from ray_tpu_torch.rllib.impala import (Impala, ImpalaConfig,
                                        forward_time_major, vtrace)
from ray_tpu_torch.rllib.optim import copy_into, params_on, to_numpy
from ray_tpu_torch.rllib.pg import entropy, log_probs
from ray_tpu_torch.rllib.policy import policy_forward


@dataclass
class APPOConfig(ImpalaConfig):
    clip_param: float = 0.2
    target_update_freq: int = 16     # learner updates between refreshes

    def build(self, algo_cls=None) -> "APPO":
        return APPO({"_config": self})


def appo_loss(params, target_params, batch, cfg):
    """-> (total, {"policy_loss", "vf_loss", "entropy"})."""
    logits, values = forward_time_major(params, batch[SB.OBS])
    logp_all, tgt_logp = log_probs(logits, batch[SB.ACTIONS])
    with torch.no_grad():
        t_logits, t_values = forward_time_major(target_params,
                                                batch[SB.OBS])
        _, boot_v = policy_forward(target_params, batch["last_obs"])
        _, t_logp = log_probs(t_logits, batch[SB.ACTIONS])
        vs, pg_adv = vtrace(batch[SB.LOGP], t_logp, batch[SB.REWARDS],
                            t_values, batch[SB.DONES], boot_v,
                            gamma=cfg.gamma, rho_clip=cfg.rho_clip,
                            c_clip=cfg.c_clip)
    ratio = torch.exp(tgt_logp - batch[SB.LOGP])
    surr = torch.minimum(
        ratio * pg_adv,
        torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param) * pg_adv)
    pg_loss = -surr.mean()
    vf_loss = 0.5 * ((values - vs) ** 2).mean()
    ent = entropy(logp_all)
    total = pg_loss + cfg.vf_loss_coeff * vf_loss - cfg.entropy_coeff * ent
    return total, {"policy_loss": pg_loss, "vf_loss": vf_loss,
                   "entropy": ent}


def make_appo_update(cfg: APPOConfig):
    """-> ``update(params, target_params, opt, batch)``: one step of
    ``opt`` on a time-major batch -> ``(params, opt, metrics)``."""
    def update(params, target_params, opt, batch):
        total, aux = appo_loss(params, target_params, batch, cfg)
        opt.minimize(total)
        return params, opt, {**{k: v.detach() for k, v in aux.items()},
                             "total_loss": total.detach()}
    return update


class APPO(Impala):
    _default_config = APPOConfig

    def _build(self):
        super()._build()
        self.target_params = params_on(self.params, self.device, grad=False)
        self._updates_since_refresh = 0
        self._appo_update = make_appo_update(self.config)

    def _learn_on(self, b) -> dict:
        _, _, m = self._appo_update(self.params, self.target_params,
                                    self.opt, self._time_major(b))
        self._updates_since_refresh += 1
        if self._updates_since_refresh >= self.config.target_update_freq:
            copy_into(self.target_params, self.params)
            self._updates_since_refresh = 0
        return m

    def save_checkpoint(self) -> dict:
        ck = super().save_checkpoint()
        ck["target_params"] = to_numpy(self.target_params)
        return ck

    def load_checkpoint(self, ck):
        super().load_checkpoint(ck)
        copy_into(self.target_params, ck.get("target_params", self.params))
