"""DDPG and TD3: deterministic-policy continuous control, the port of
``ray_tpu/rllib/ddpg.py``: ``DDPGConfig``, ``TD3Config``,
``actor_forward``, ``critic_forward``, ``make_ddpg_update``, ``DDPG``
and ``TD3``.

One Adam spans both critics, over the pair ``(q1, q2)`` in the JAX
package's leaf order, so its optax state bridges leaf by leaf (without
twin critics ``q2`` gets zero gradients, as under ``jax.grad``).  The
delayed actor step, a ``lax.cond`` in the JAX package, is a host ``if``
on the step index.  TD3's target-policy noise is a standard normal draw
from a ``torch.Generator``, or the caller's (``noise=``), so a test can
feed JAX's.  Exploration noise and the warm-up actions are the JAX
package's numpy draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.data.feed import to_device
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env import VectorEnv
from ray_tpu_torch.rllib.optim import (Adam, copy_into, params_on, polyak,
                                       to_numpy)
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.sample_batch import SampleBatch

# the JAX package's state tuple, without its PRNG key
NETS = ("pi", "pi_t", "q1", "q2", "q1_t", "q2_t")
BATCH_KEYS = ("obs", "actions", "rewards", "dones", "next_obs")


@dataclass
class DDPGConfig(AlgorithmConfig):
    env: object = "Pendulum-v1"      # continuous-control default
    buffer_size: int = 50_000
    learning_starts: int = 1_000
    batch_size: int = 128
    train_intensity: float = 0.5     # grad steps per env step
    tau: float = 0.005               # polyak
    gamma: float = 0.99
    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    exploration_noise: float = 0.1   # action-space Gaussian sigma (scaled)
    # TD3 extensions (twin_q=False, policy_delay=1, noise=0 => plain DDPG)
    twin_q: bool = False
    policy_delay: int = 1
    target_noise: float = 0.0
    target_noise_clip: float = 0.5

    def build(self, algo_cls=None) -> "DDPG":
        return DDPG({"_config": self})


@dataclass
class TD3Config(DDPGConfig):
    twin_q: bool = True
    policy_delay: int = 2
    target_noise: float = 0.2

    def build(self, algo_cls=None) -> "TD3":
        return TD3({"_config": self})


def mlp_init(generator: torch.Generator, dims, out_dim: int,
             out_scale: float = 0.01) -> dict:
    """He-normal ReLU layers ``fc{i}`` and an N(0, out_scale) ``out``,
    zero biases, on the generator's device."""
    dev = generator.device

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=dev) * scale
    params = {f"fc{i}": {"w": normal((dims[i], dims[i + 1]),
                                     np.sqrt(2.0 / dims[i])),
                         "b": torch.zeros(dims[i + 1], device=dev)}
              for i in range(len(dims) - 1)}
    params["out"] = {"w": normal((dims[-1], out_dim), out_scale),
                     "b": torch.zeros(out_dim, device=dev)}
    return params


def _mlp(params, x):
    i = 0
    while f"fc{i}" in params:
        lp = params[f"fc{i}"]
        x = F.relu(x @ lp["w"] + lp["b"])
        i += 1
    return x @ params["out"]["w"] + params["out"]["b"]


def actor_forward(params, obs, low, high):
    """Deterministic action in [low, high] through a tanh squash."""
    raw = torch.tanh(_mlp(params, obs))
    return low + (raw + 1.0) * 0.5 * (high - low)


def critic_forward(params, obs, act):
    return _mlp(params, torch.cat([obs, act], dim=-1))[:, 0]


def make_ddpg_update(cfg: DDPGConfig, low, high):
    """-> ``update(nets, opts, batch, step_idx, *, noise=None,
    generator=None)``: ``nets`` holds ``pi, pi_t, q1, q2, q1_t, q2_t``,
    ``opts`` the ``optim.Adam``s ``pi`` and ``q`` (over ``(q1, q2)``),
    all stepped in place.  ``noise`` is TD3's standard normal draw for
    the target action ([batch, action dim]); without it, one is drawn
    from ``generator``.  Returns ``(critic loss, actor loss)``, 0-d
    tensors (the actor's 0 on a step it skips)."""
    def update(nets, opts, batch, step_idx: int, *,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        obs, actions = batch["obs"], batch["actions"]
        with torch.no_grad():
            a_next = actor_forward(nets["pi_t"], batch["next_obs"], low,
                                   high)
            if cfg.target_noise > 0:
                if noise is None:
                    noise = torch.randn(a_next.shape, generator=generator,
                                        device=a_next.device)
                eps = torch.clamp(noise * cfg.target_noise,
                                  -cfg.target_noise_clip,
                                  cfg.target_noise_clip)
                a_next = torch.clamp(a_next + eps * (high - low) * 0.5,
                                     low, high)
            q_next = critic_forward(nets["q1_t"], batch["next_obs"], a_next)
            if cfg.twin_q:
                q_next = torch.minimum(q_next, critic_forward(
                    nets["q2_t"], batch["next_obs"], a_next))
            target = batch["rewards"] + cfg.gamma * (
                1.0 - batch["dones"]) * q_next

        closs = ((critic_forward(nets["q1"], obs, actions) - target) ** 2
                 ).mean()
        if cfg.twin_q:
            closs = closs + ((critic_forward(nets["q2"], obs, actions)
                              - target) ** 2).mean()
        opts["q"].minimize(closs)

        if step_idx % cfg.policy_delay == 0:
            aloss = -critic_forward(nets["q1"], obs, actor_forward(
                nets["pi"], obs, low, high)).mean()
            opts["pi"].minimize(aloss)
            aloss = aloss.detach()
        else:
            aloss = torch.zeros((), device=obs.device)

        for t, s in (("pi_t", "pi"), ("q1_t", "q1"), ("q2_t", "q2")):
            polyak(nets[t], nets[s], cfg.tau)
        return closs.detach(), aloss

    return update


def _mean(xs) -> float:
    return float(torch.stack(xs).mean()) if xs else 0.0


class DDPG(Algorithm):
    _default_config = DDPGConfig

    def _build(self):
        cfg = self.config
        self.device = dev = resolve_device(cfg.device)
        self.vec = VectorEnv(cfg.env, cfg.num_envs_per_worker,
                             seed=cfg.seed)
        if self.vec.action_dim is None:
            raise ValueError("DDPG/TD3 require a continuous-action env")
        obs_dim, act_dim = self.vec.observation_dim, self.vec.action_dim
        self.low = torch.as_tensor(self.vec.action_low).to(dev)
        self.high = torch.as_tensor(self.vec.action_high).to(dev)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        pi = mlp_init(gen, (obs_dim, *cfg.hiddens), act_dim)
        q1 = mlp_init(gen, (obs_dim + act_dim, *cfg.hiddens), 1, 0.1)
        q2 = mlp_init(gen, (obs_dim + act_dim, *cfg.hiddens), 1, 0.1)
        self.nets = {"pi": params_on(pi, dev),
                     "pi_t": params_on(pi, dev, grad=False),
                     "q1": params_on(q1, dev),
                     "q2": params_on(q2, dev),
                     "q1_t": params_on(q1, dev, grad=False),
                     "q2_t": params_on(q2, dev, grad=False)}
        self.opts = {"pi": Adam(self.nets["pi"], cfg.actor_lr),
                     "q": Adam((self.nets["q1"], self.nets["q2"]),
                               cfg.critic_lr)}
        self._update = make_ddpg_update(cfg, self.low, self.high)
        self._gen = torch.Generator(device=dev).manual_seed(cfg.seed + 3)
        self.buffer = ReplayBuffer(cfg.buffer_size, seed=cfg.seed)
        self._obs = self.vec.reset()
        self._np_rng = np.random.default_rng(cfg.seed + 1)
        self._ep_rew = np.zeros(self.vec.num_envs, np.float32)
        self._grad_debt = 0.0
        self._grad_steps = 0

    @torch.no_grad()
    def _policy(self, obs) -> np.ndarray:
        x = torch.as_tensor(np.asarray(obs, np.float32)).to(self.device)
        return actor_forward(self.nets["pi"], x, self.low,
                             self.high).cpu().numpy()

    def _explore(self, obs) -> np.ndarray:
        a = self._policy(obs)
        low, high = self.vec.action_low, self.vec.action_high
        noise = self._np_rng.normal(
            0.0, self.config.exploration_noise, a.shape) * (
            (high - low) * 0.5)
        return np.clip(a + noise, low, high)

    def training_step(self) -> dict:
        cfg = self.config
        B = self.vec.num_envs
        low, high = self.vec.action_low, self.vec.action_high
        steps, closses, alosses = 0, [], []
        for _ in range(cfg.rollout_length):
            if self._timesteps < cfg.learning_starts:
                actions = self._np_rng.uniform(
                    low, high, (B, len(low))).astype(np.float32)
            else:
                actions = self._explore(self._obs).astype(np.float32)
            next_obs, rew, done = self.vec.step(actions)
            self.buffer.add(SampleBatch({
                "obs": np.asarray(self._obs, np.float32),
                "actions": actions,
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
                closs, aloss = self._update(
                    self.nets, self.opts,
                    to_device({k: batch[k] for k in BATCH_KEYS},
                              self.device),
                    self._grad_steps, generator=self._gen)
                self._grad_steps += 1
                closses.append(closs)
                alosses.append(aloss)
        # the losses read once an iteration (no sync per update)
        return {"steps_this_iter": steps,
                "buffer_size": len(self.buffer),
                "critic_loss": _mean(closses), "actor_loss": _mean(alosses)}

    def compute_action(self, obs: np.ndarray) -> np.ndarray:
        return self._policy(np.asarray(obs, np.float32)[None])[0]

    def save_checkpoint(self) -> dict:
        """The JAX package's layout: ``state`` is ``(pi, pi_t, q1, q2,
        q1_t, q2_t, opt_pi, opt_q)`` (the JAX package's also ends with
        its PRNG key, which the port ignores)."""
        return to_numpy({
            "state": tuple(self.nets[k] for k in NETS)
            + (self.opts["pi"].state(), self.opts["q"].state()),
            "timesteps": self._timesteps,
            "grad_steps": self._grad_steps})

    def load_checkpoint(self, ck):
        state = ck["state"]
        for k, v in zip(NETS, state):
            copy_into(self.nets[k], v)
        self.opts["pi"].load(state[len(NETS)])
        self.opts["q"].load(state[len(NETS) + 1])
        self._timesteps = ck.get("timesteps", 0)
        self._grad_steps = ck.get("grad_steps", 0)


class TD3(DDPG):
    _default_config = TD3Config
