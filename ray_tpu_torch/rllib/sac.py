"""SAC for discrete actions: twin soft-Q critics, a stochastic policy and
a tuned entropy temperature, the port of ``ray_tpu/rllib/sac.py``:
``SACConfig``, ``make_sac_update`` and ``SAC``.

One update runs the JAX package's three Adam steps in its order: both
critics on the soft target, then the policy against the *already
updated* critics (with the temperature from before this update), then
``log_alpha`` (a 0-d leaf with an Adam of its own) on the updated
policy's entropy; the target critics follow by Polyak averaging, in
place.  Actions are sampled from the policy with a ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.data.feed import to_device
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.dqn import init_q_params, q_values, take
from ray_tpu_torch.rllib.env import VectorEnv
from ray_tpu_torch.rllib.optim import (Adam, copy_into, params_on, polyak,
                                       to_numpy)
from ray_tpu_torch.rllib.policy import (PolicyConfig, init_policy_params,
                                        policy_forward)
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.sample_batch import SampleBatch

NETS = ("q1", "q2", "q1_t", "q2_t", "pi", "log_alpha")
OPTS = ("q1", "q2", "pi", "alpha")
BATCH_KEYS = ("obs", "actions", "rewards", "dones", "next_obs")


@dataclass
class SACConfig(AlgorithmConfig):
    buffer_size: int = 50_000
    learning_starts: int = 1_000
    batch_size: int = 64
    train_intensity: float = 0.25        # grad steps per env step
    tau: float = 0.005                   # polyak target update
    target_entropy: Optional[float] = None  # None = scale·log|A|
    target_entropy_scale: float = 0.5
    initial_alpha: float = 1.0
    gamma: float = 0.99
    lr: float = 3e-4

    def build(self, algo_cls=None) -> "SAC":
        return SAC({"_config": self})


def make_sac_update(cfg: SACConfig, num_actions: int):
    """-> ``update(nets, opts, batch)``: ``nets`` holds the trees
    ``q1, q2, q1_t, q2_t, pi`` and the 0-d ``log_alpha``, ``opts`` the
    ``optim.Adam``s ``q1, q2, pi, alpha``; all are stepped in place.
    Returns ``{"q_loss", "pi_loss", "alpha"}`` as 0-d tensors."""
    target_entropy = (cfg.target_entropy if cfg.target_entropy is not None
                      else cfg.target_entropy_scale
                      * float(np.log(num_actions)))

    def update(nets, opts, batch):
        obs, actions = batch["obs"], batch["actions"]
        with torch.no_grad():
            alpha = torch.exp(nets["log_alpha"])
            next_logits, _ = policy_forward(nets["pi"], batch["next_obs"])
            next_logp = torch.log_softmax(next_logits, dim=-1)
            qmin_next = torch.minimum(q_values(nets["q1_t"],
                                               batch["next_obs"]),
                                      q_values(nets["q2_t"],
                                               batch["next_obs"]))
            v_next = (torch.softmax(next_logits, dim=-1)
                      * (qmin_next - alpha * next_logp)).sum(dim=-1)
            target = batch["rewards"] + cfg.gamma * (
                1.0 - batch["dones"]) * v_next

        q_losses = []
        for k in ("q1", "q2"):
            loss = ((take(q_values(nets[k], obs), actions) - target) ** 2
                    ).mean()
            opts[k].minimize(loss)
            q_losses.append(loss.detach())

        with torch.no_grad():
            qmin = torch.minimum(q_values(nets["q1"], obs),
                                 q_values(nets["q2"], obs))
        logits, _ = policy_forward(nets["pi"], obs)
        logp = torch.log_softmax(logits, dim=-1)
        pi_loss = (torch.softmax(logits, dim=-1) * (alpha * logp - qmin)
                   ).sum(dim=-1).mean()
        opts["pi"].minimize(pi_loss)

        with torch.no_grad():
            logits, _ = policy_forward(nets["pi"], obs)
            logp = torch.log_softmax(logits, dim=-1)
            ent_gap = (-(torch.softmax(logits, dim=-1) * logp).sum(dim=-1)
                       - target_entropy)
        opts["alpha"].minimize((torch.exp(nets["log_alpha"]) * ent_gap
                                ).mean())

        polyak(nets["q1_t"], nets["q1"], cfg.tau)
        polyak(nets["q2_t"], nets["q2"], cfg.tau)
        return {"q_loss": 0.5 * (q_losses[0] + q_losses[1]),
                "pi_loss": pi_loss.detach(),
                "alpha": torch.exp(nets["log_alpha"].detach())}

    return update


class SAC(Algorithm):
    _default_config = SACConfig

    def _build(self):
        cfg = self.config
        self.device = dev = resolve_device(cfg.device)
        self.vec = VectorEnv(cfg.env, cfg.num_envs_per_worker,
                             seed=cfg.seed)
        obs_dim, num_actions = (self.vec.observation_dim,
                                self.vec.num_actions)
        self.num_actions = num_actions
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        q1 = init_q_params(obs_dim, num_actions, cfg.hiddens, False,
                           device=dev, generator=gen)
        q2 = init_q_params(obs_dim, num_actions, cfg.hiddens, False,
                           device=dev, generator=gen)
        pi = init_policy_params(PolicyConfig(obs_dim, num_actions,
                                             tuple(cfg.hiddens)),
                                device=dev, generator=gen)
        self.nets = {
            "q1": params_on(q1, dev), "q2": params_on(q2, dev),
            "q1_t": params_on(q1, dev, grad=False),
            "q2_t": params_on(q2, dev, grad=False),
            "pi": params_on(pi, dev),
            "log_alpha": torch.tensor(float(np.log(cfg.initial_alpha)),
                                      device=dev, requires_grad=True)}
        self.opts = {"q1": Adam(self.nets["q1"], cfg.lr),
                     "q2": Adam(self.nets["q2"], cfg.lr),
                     "pi": Adam(self.nets["pi"], cfg.lr),
                     "alpha": Adam(self.nets["log_alpha"], cfg.lr)}
        self._update = make_sac_update(cfg, num_actions)
        self._gen = torch.Generator(device=dev).manual_seed(cfg.seed + 9)
        self.buffer = ReplayBuffer(cfg.buffer_size, seed=cfg.seed)
        self._obs = self.vec.reset()
        self._ep_rew = np.zeros(self.vec.num_envs, np.float32)
        self._grad_debt = 0.0

    @torch.no_grad()
    def _sample_action(self, obs) -> np.ndarray:
        x = torch.as_tensor(np.asarray(obs, np.float32)).to(self.device)
        logits, _ = policy_forward(self.nets["pi"], x)
        return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                 generator=self._gen)[:, 0].cpu().numpy()

    def training_step(self) -> dict:
        cfg = self.config
        B = self.vec.num_envs
        steps, metrics = 0, {}
        for _ in range(cfg.rollout_length):
            actions = self._sample_action(self._obs)
            next_obs, rew, done = self.vec.step(actions)
            self.buffer.add(SampleBatch({
                "obs": np.asarray(self._obs, np.float32),
                "actions": actions.astype(np.int64),
                "rewards": rew.astype(np.float32),
                "dones": done.astype(np.float32),
                "next_obs": np.asarray(next_obs, np.float32)}))
            self._ep_rew += rew
            for i in np.nonzero(done)[0]:
                self._ep_returns.append(float(self._ep_rew[i]))
                self._ep_rew[i] = 0.0
            self._obs = next_obs
            steps += B
            self._timesteps += B

            if len(self.buffer) < cfg.learning_starts:
                continue
            self._grad_debt += cfg.train_intensity * B
            while self._grad_debt >= 1.0:
                self._grad_debt -= 1.0
                batch = self.buffer.sample(cfg.batch_size)
                metrics = self._update(self.nets, self.opts, to_device(
                    {k: batch[k] for k in BATCH_KEYS}, self.device))

        # the last update's metrics, read once (no sync per update)
        return {"steps_this_iter": steps, "buffer_size": len(self.buffer),
                **{k: float(v) for k, v in metrics.items()}}

    def save_checkpoint(self) -> dict:
        """The JAX package's layout: ``state`` is ``(q1, q2, q1_t, q2_t,
        pi, log_alpha, opt_q1, opt_q2, opt_pi, opt_a)``."""
        return to_numpy({
            "state": tuple(self.nets[k] for k in NETS)
            + tuple(self.opts[k].state() for k in OPTS),
            "timesteps": self._timesteps})

    def load_checkpoint(self, ck):
        """A port save, or the JAX package's (optax states bridged)."""
        state = ck["state"]
        for k, v in zip(NETS, state[:len(NETS)]):
            copy_into(self.nets[k], v)
        for k, v in zip(OPTS, state[len(NETS):]):
            self.opts[k].load(v)
        self._timesteps = ck.get("timesteps", 0)

