"""IMPALA: actor-learner with the V-trace off-policy correction, the port
of ``ray_tpu/rllib/impala.py``: ``ImpalaConfig``, ``vtrace``,
``make_impala_update`` and ``Impala``.

``vtrace`` is the JAX package's reverse ``lax.scan`` over time as a loop
over T on the tensors' device.  The learner consumes each inline
worker's rollout as it comes, time-major [T, B], bootstrapping from the
rollout's ``bootstrap_obs`` (the state after its last step), and pushes
the new weights back to that worker, as the JAX package's inline mode
does; rollout workers as actors are not ported (``WorkerSet`` raises).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ray_tpu_torch.data.feed import to_device
from ray_tpu_torch.rllib import sample_batch as SB
from ray_tpu_torch.rllib.algorithm import AlgorithmConfig
from ray_tpu_torch.rllib.optim import to_numpy
from ray_tpu_torch.rllib.pg import OnPolicyLearner, entropy, log_probs
from ray_tpu_torch.rllib.policy import policy_forward
from ray_tpu_torch.rllib.sample_batch import SampleBatch

TIME_MAJOR_KEYS = (SB.OBS, SB.ACTIONS, SB.LOGP, SB.REWARDS, SB.DONES)


@dataclass
class ImpalaConfig(AlgorithmConfig):
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.01
    rho_clip: float = 1.0
    c_clip: float = 1.0
    batches_per_step: int = 4

    def build(self, algo_cls=None) -> "Impala":
        return Impala({"_config": self})


def vtrace(behavior_logp, target_logp, rewards, values, dones,
           bootstrap_value, *, gamma, rho_clip=1.0, c_clip=1.0):
    """V-trace targets over time-major [T, B] tensors (Espeholt et al.
    2018) -> (vs, pg_adv), both [T, B]."""
    rho = torch.exp(target_logp - behavior_logp)
    rho_c = torch.clamp(rho, max=rho_clip)
    cs = torch.clamp(rho, max=c_clip)
    nonterminal = 1.0 - dones.to(torch.float32)

    values_next = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = rho_c * (rewards + gamma * nonterminal * values_next - values)
    acc = torch.zeros_like(bootstrap_value)
    out = [None] * deltas.shape[0]
    for t in reversed(range(deltas.shape[0])):
        acc = deltas[t] + gamma * nonterminal[t] * cs[t] * acc
        out[t] = acc
    vs = torch.stack(out) + values
    vs_next = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    pg_adv = rho_c * (rewards + gamma * nonterminal * vs_next - values)
    return vs, pg_adv


def forward_time_major(params, obs):
    """obs [T, B, O] -> (logits [T, B, A], values [T, B])."""
    T, B = obs.shape[:2]
    logits, values = policy_forward(params, obs.reshape(T * B, -1))
    return logits.reshape(T, B, -1), values.reshape(T, B)


def impala_loss(params, batch, cfg):
    """-> (total, {"policy_loss", "vf_loss", "entropy"}) on a time-major
    batch with ``last_obs`` [B, O]."""
    logits, values = forward_time_major(params, batch[SB.OBS])
    logp_all, tgt_logp = log_probs(logits, batch[SB.ACTIONS])
    _, boot_v = policy_forward(params, batch["last_obs"])
    vs, pg_adv = vtrace(batch[SB.LOGP], tgt_logp, batch[SB.REWARDS],
                        values, batch[SB.DONES], boot_v, gamma=cfg.gamma,
                        rho_clip=cfg.rho_clip, c_clip=cfg.c_clip)
    pg_loss = -(tgt_logp * pg_adv.detach()).mean()
    vf_loss = 0.5 * ((values - vs.detach()) ** 2).mean()
    ent = entropy(logp_all)
    total = pg_loss + cfg.vf_loss_coeff * vf_loss - cfg.entropy_coeff * ent
    return total, {"policy_loss": pg_loss, "vf_loss": vf_loss,
                   "entropy": ent}


def make_impala_update(cfg: ImpalaConfig):
    """-> ``update(params, opt, batch)``: one step of ``opt`` (an
    ``optim.Adam`` over ``params``) on a time-major batch; returns
    ``(params, opt, metrics)``, the metrics 0-d tensors."""
    def update(params, opt, batch):
        total, aux = impala_loss(params, batch, cfg)
        opt.minimize(total)
        return params, opt, {**{k: v.detach() for k, v in aux.items()},
                             "total_loss": total.detach()}
    return update


class Impala(OnPolicyLearner):
    _default_config = ImpalaConfig

    def _build(self):
        self._build_learner()
        self._update = make_impala_update(self.config)

    def _time_major(self, b: SampleBatch) -> dict:
        tm = SampleBatch({k: b[k] for k in TIME_MAJOR_KEYS}
                         ).split_time_major(self.config.rollout_length)
        # bootstrap_obs is s_T, the state after the last step, [B, obs]
        return to_device(dict(tm, last_obs=b["bootstrap_obs"]), self.device)

    def _learn_on(self, b: SampleBatch) -> dict:
        """One update on one worker's rollout -> its metrics."""
        _, _, metrics = self._update(self.params, self.opt,
                                     self._time_major(b))
        return metrics

    def training_step(self) -> dict:
        cfg = self.config
        metrics, steps = {}, 0
        for _ in range(cfg.batches_per_step):
            # one worker's batch at a time keeps the [T, B] layout intact
            for w in self.workers.workers:
                b = SampleBatch(w.sample())
                self._ep_returns.extend(w.episode_returns())
                metrics = self._learn_on(b)
                steps += b.count
                w.set_weights(to_numpy(self.params))
        self._timesteps += steps
        out = {k: float(v) for k, v in metrics.items()}
        out["steps_this_iter"] = steps
        return out
