"""A2C: synchronous advantage actor-critic, the port of
``ray_tpu/rllib/a2c.py``: ``A2CConfig``, ``a2c_loss`` and ``A2C``.

One Adam step on each rollout, after optax's ``clip_by_global_norm``
(scaled by ``max_norm / norm`` only when ``norm`` reaches ``max_norm``,
not torch's ``clip_grad_norm_``, which divides by ``norm + 1e-6``).  The
advantages are standardised inside the update with the population std.
"""

from __future__ import annotations

from dataclasses import dataclass

from ray_tpu_torch.data.feed import to_device
from ray_tpu_torch.rllib import sample_batch as SB
from ray_tpu_torch.rllib.algorithm import AlgorithmConfig
from ray_tpu_torch.rllib.optim import to_numpy
from ray_tpu_torch.rllib.pg import (OnPolicyLearner, entropy, log_probs,
                                    standardize)
from ray_tpu_torch.rllib.policy import policy_forward


@dataclass
class A2CConfig(AlgorithmConfig):
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.01
    grad_clip: float = 40.0

    def build(self, algo_cls=None) -> "A2C":
        return A2C({"_config": self})


def a2c_loss(params, batch, *, vf_coeff, ent_coeff):
    """-> (total loss, {"policy_loss", "vf_loss", "entropy"}); the
    advantages are used as given."""
    logits, value = policy_forward(params, batch[SB.OBS])
    logp_all, logp = log_probs(logits, batch[SB.ACTIONS])
    pi_loss = -(logp * batch[SB.ADVANTAGES]).mean()
    vf_loss = 0.5 * ((value - batch[SB.VALUE_TARGETS]) ** 2).mean()
    ent = entropy(logp_all)
    total = pi_loss + vf_coeff * vf_loss - ent_coeff * ent
    return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                   "entropy": ent}


class A2C(OnPolicyLearner):
    _default_config = A2CConfig

    def _build(self):
        self._build_learner(clip_norm=self.config.grad_clip)

    def update(self, batch) -> dict:
        """Standardise the advantages, one clipped Adam step of
        ``a2c_loss`` -> its parts and ``total_loss``, 0-d tensors."""
        cfg = self.config
        batch = dict(batch)
        batch[SB.ADVANTAGES] = standardize(batch[SB.ADVANTAGES])
        total, aux = a2c_loss(self.params, batch,
                              vf_coeff=cfg.vf_loss_coeff,
                              ent_coeff=cfg.entropy_coeff)
        self.opt.minimize(total)
        return {**{k: v.detach() for k, v in aux.items()},
                "total_loss": total.detach()}

    def training_step(self) -> dict:
        batch, rets = self.workers.sample_sync()
        self._ep_returns.extend(rets)
        self._timesteps += batch.count
        metrics = self.update(to_device(
            {k: batch[k] for k in (SB.OBS, SB.ACTIONS, SB.ADVANTAGES,
                                   SB.VALUE_TARGETS)}, self.device))
        self.workers.sync_weights(to_numpy(self.params))
        out = {k: float(v) for k, v in metrics.items()}
        out["steps_this_iter"] = batch.count
        return out
