"""BC and MARWIL: policy learning from logged sample batches, the port of
``ray_tpu/rllib/bc.py``: ``MARWILConfig``, ``BCConfig``, ``MARWIL`` and
``BC``.

MARWIL weights the log-likelihood of each logged action by
``exp(beta * adv / sqrt(ma))``, capped at 20, where ``ma`` is a moving
average of the squared advantage kept on the host (refreshed from each
update's own value loss); BC is ``beta = 0``, plain imitation.  The
minibatch rows are the JAX package's numpy draws.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.data.feed import to_device
from ray_tpu_torch.rllib import sample_batch as SB
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.offline import JsonReader
from ray_tpu_torch.rllib.optim import Adam, copy_into, params_on, to_numpy
from ray_tpu_torch.rllib.pg import log_probs
from ray_tpu_torch.rllib.policy import (PolicyConfig, init_policy_params,
                                        policy_forward)


@dataclass
class MARWILConfig(AlgorithmConfig):
    input_path: str = ""                 # offline data dir (JsonReader)
    beta: float = 1.0                    # 0 → BC
    vf_coeff: float = 1.0
    batch_size: int = 256
    moving_average_sqd_adv_norm: float = 100.0

    def offline_data(self, input_path: str) -> "MARWILConfig":
        return replace(self, input_path=input_path)

    def build(self, algo_cls=None) -> "MARWIL":
        return MARWIL({"_config": self})


@dataclass
class BCConfig(MARWILConfig):
    beta: float = 0.0

    def build(self, algo_cls=None) -> "BC":
        return BC({"_config": self})


def marwil_loss(params, batch, ma_adv_norm, *, beta, vf_coeff):
    """-> (total, policy loss, value loss, squared advantage), the last
    three detached; ``ma_adv_norm`` is a 0-d f32 tensor."""
    logits, value = policy_forward(params, batch[SB.OBS])
    _, logp = log_probs(logits, batch[SB.ACTIONS])
    if beta == 0.0:
        pi_loss = -logp.mean()
        zero = torch.zeros((), device=logp.device)
        return pi_loss, pi_loss.detach(), zero, zero
    adv = batch[SB.VALUE_TARGETS] - value
    vf_loss = (adv ** 2).mean()
    w = torch.exp(beta * (adv / torch.sqrt(ma_adv_norm + 1e-8)).detach())
    pi_loss = -(torch.clamp(w, max=20.0) * logp).mean()
    return (pi_loss + vf_coeff * vf_loss, pi_loss.detach(),
            vf_loss.detach(), vf_loss.detach())


class MARWIL(Algorithm):
    _default_config = MARWILConfig

    def _build(self):
        cfg = self.config
        if not cfg.input_path:
            raise ValueError("MARWIL/BC require config.input_path "
                             "(offline data)")
        self.device = resolve_device(cfg.device)
        self.data = JsonReader(cfg.input_path).read_all()
        obs = np.asarray(self.data[SB.OBS])
        acts = np.asarray(self.data[SB.ACTIONS])
        self.pcfg = PolicyConfig(obs_dim=obs.shape[-1],
                                 num_actions=int(acts.max()) + 1
                                 if acts.size else 2,
                                 hiddens=tuple(cfg.hiddens))
        self.params = params_on(
            init_policy_params(self.pcfg, cfg.seed, device=self.device),
            self.device)
        self.opt = Adam(self.params, cfg.lr)
        self._rng = np.random.default_rng(cfg.seed)
        self._ma_adv_norm = cfg.moving_average_sqd_adv_norm

    def update(self, batch, ma_adv_norm: float):
        """One Adam step on ``batch`` (tensors on the learner's device)
        -> (total, policy, value losses, squared advantage), 0-d."""
        cfg = self.config
        ma = torch.tensor(ma_adv_norm, dtype=torch.float32,
                          device=self.device)
        total, pl, vl, sqd = marwil_loss(self.params, batch, ma,
                                         beta=cfg.beta,
                                         vf_coeff=cfg.vf_coeff)
        self.opt.minimize(total)
        return total.detach(), pl, vl, sqd

    def training_step(self) -> dict:
        cfg = self.config
        idx = self._rng.integers(0, len(self.data), cfg.batch_size)
        cols = [SB.OBS, SB.ACTIONS]
        if cfg.beta != 0.0:
            cols.append(SB.VALUE_TARGETS)
        batch = to_device({k: np.asarray(self.data[k])[idx] for k in cols},
                          self.device)
        total, pl, vl, sqd = self.update(batch, self._ma_adv_norm)
        if cfg.beta != 0.0:
            self._ma_adv_norm += 1e-6 * (float(sqd) - self._ma_adv_norm)
        self._timesteps += cfg.batch_size
        return {"total_loss": float(total), "policy_loss": float(pl),
                "vf_loss": float(vl), "steps_this_iter": cfg.batch_size}

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(obs, np.float32)).to(self.device)
        logits, _ = policy_forward(self.params, x)
        return logits.argmax(dim=-1).cpu().numpy()

    def save_checkpoint(self) -> dict:
        return to_numpy({"params": self.params,
                         "opt_state": self.opt.state(),
                         "ma_adv_norm": float(self._ma_adv_norm),
                         "timesteps": self._timesteps})

    def load_checkpoint(self, ck):
        """A port save, or the JAX package's (optax state bridged)."""
        copy_into(self.params, ck["params"])
        if "opt_state" in ck:
            self.opt.load(ck["opt_state"])
        else:
            self.opt = Adam(self.params, self.config.lr)
        self._ma_adv_norm = ck.get("ma_adv_norm", self._ma_adv_norm)
        self._timesteps = ck.get("timesteps", 0)


class BC(MARWIL):
    """Plain behaviour cloning: MARWIL with ``beta`` 0."""
    _default_config = BCConfig
