"""CQL: conservative Q-learning from offline data, discrete actions, the
port of ``ray_tpu/rllib/cql.py``: ``CQLConfig``, ``make_cql_update`` and
``CQL``.

The loss is the double-Q TD error plus ``cql_alpha`` times the gap
``logsumexp_a Q(s, a) - Q(s, a_data)``, over DQN's Q network, on
(obs, actions, rewards, dones, next_obs) columns read by
``offline.JsonReader``.  Every ``target_update_freq`` gradient steps the
target network moves towards the params by ``tau`` (1.0: a hard copy),
in place on a clone.  The minibatch rows are the JAX package's numpy
draws.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.data.feed import to_device
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.dqn import init_q_params, q_values, take
from ray_tpu_torch.rllib.offline import JsonReader
from ray_tpu_torch.rllib.optim import (Adam, copy_into, params_on, polyak,
                                       to_numpy)

BATCH_KEYS = ("obs", "actions", "rewards", "dones", "next_obs")


@dataclass
class CQLConfig(AlgorithmConfig):
    input_path: str = ""             # offline data dir (JsonReader)
    cql_alpha: float = 1.0           # conservative penalty weight
    batch_size: int = 256
    grad_steps_per_iter: int = 100
    target_update_freq: int = 500    # in grad steps
    tau: float = 1.0                 # 1.0 = hard target sync
    gamma: float = 0.99
    lr: float = 3e-4
    double_q: bool = True

    def build(self, algo_cls=None) -> "CQL":
        return CQL({"_config": self})


def make_cql_update(cfg: CQLConfig):
    """-> ``update(params, target_params, opt, batch)``: one step of
    ``opt`` (an ``optim.Adam`` over ``params``) -> ``(params, opt, loss,
    td, gap)``, the last three 0-d tensors."""
    def update(params, target_params, opt, batch):
        with torch.no_grad():
            q_next_t = q_values(target_params, batch["next_obs"])
            sel = (q_values(params, batch["next_obs"]) if cfg.double_q
                   else q_next_t).argmax(dim=-1)
            target = batch["rewards"] + cfg.gamma * (
                1.0 - batch["dones"]) * take(q_next_t, sel)
        q_all = q_values(params, batch["obs"])
        q_data = take(q_all, batch["actions"])
        td = ((q_data - target) ** 2).mean()
        gap = (torch.logsumexp(q_all, dim=-1) - q_data).mean()
        loss = td + cfg.cql_alpha * gap
        opt.minimize(loss)
        return params, opt, loss.detach(), td.detach(), gap.detach()

    return update


class CQL(Algorithm):
    _default_config = CQLConfig

    def _build(self):
        cfg = self.config
        if not cfg.input_path:
            raise ValueError("CQL requires config.input_path offline data")
        self.device = resolve_device(cfg.device)
        self.data = JsonReader(cfg.input_path).read_all()
        self.obs_dim = int(np.asarray(self.data["obs"]).shape[1])
        self.num_actions = int(np.asarray(self.data["actions"]).max()) + 1
        self.params = params_on(
            init_q_params(self.obs_dim, self.num_actions, cfg.hiddens,
                          False, cfg.seed, device=self.device),
            self.device)
        self.target_params = params_on(self.params, self.device, grad=False)
        self.opt = Adam(self.params, cfg.lr)
        self._update = make_cql_update(cfg)
        self._rng = np.random.default_rng(cfg.seed)
        self._grad_steps = 0

    def training_step(self) -> dict:
        cfg = self.config
        n = len(np.asarray(self.data["obs"]))
        losses = []
        for _ in range(cfg.grad_steps_per_iter):
            idx = self._rng.integers(0, n, cfg.batch_size)
            batch = to_device({k: np.asarray(self.data[k])[idx]
                               for k in BATCH_KEYS}, self.device)
            _, _, loss, td, gap = self._update(
                self.params, self.target_params, self.opt, batch)
            losses.append(torch.stack([loss, td, gap]))
            self._grad_steps += 1
            if self._grad_steps % cfg.target_update_freq == 0:
                polyak(self.target_params, self.params, cfg.tau)
        self._timesteps += cfg.grad_steps_per_iter
        # the means read once an iteration (no sync per update)
        loss, td, gap = torch.stack(losses).mean(dim=0).tolist()
        return {"steps_this_iter": cfg.grad_steps_per_iter, "loss": loss,
                "td_loss": td, "cql_gap": gap}

    @torch.no_grad()
    def compute_action(self, obs: np.ndarray) -> int:
        x = torch.as_tensor(np.asarray(obs, np.float32)[None]).to(
            self.device)
        return int(q_values(self.params, x)[0].argmax())

    def save_checkpoint(self) -> dict:
        return to_numpy({"params": self.params,
                         "target_params": self.target_params,
                         "opt_state": self.opt.state(),
                         "timesteps": self._timesteps,
                         "grad_steps": self._grad_steps})

    def load_checkpoint(self, ck):
        """A port save, or the JAX package's (optax state bridged)."""
        copy_into(self.params, ck["params"])
        copy_into(self.target_params, ck["target_params"])
        self.opt.load(ck["opt_state"])
        self._timesteps = ck.get("timesteps", 0)
        self._grad_steps = ck.get("grad_steps", 0)
