"""DQN: double and dueling Q-learning with prioritized replay, and
SimpleQ, the port of ``ray_tpu/rllib/dqn.py``: ``DQNConfig``,
``init_q_params``, ``q_values``, ``make_dqn_update``, ``_NStepWindow``,
``DQN``, ``SimpleQConfig`` and ``SimpleQ``.

The Q trunk is ``models/zoo.py``'s FCNet (ReLU), with an advantage head
and, when dueling, a value head.  The update (Huber loss weighted by
the replay's importance weights, bootstrapped from the target network,
the per-sample |TD| returned to refresh the priorities) runs on the
learner's device; replay and exploration stay on the host, with the JAX
package's numpy draws, so one greedy action costs one device round trip
per env step.  The target network is a clone refreshed in place: in the
JAX package ``target_params = params`` binds immutable arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.data.feed import to_device
from ray_tpu_torch.models.zoo import (FCNetConfig, _dense, _dense_init,
                                      fcnet_init)
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env import VectorEnv
from ray_tpu_torch.rllib.optim import Adam, copy_into, params_on, to_numpy
from ray_tpu_torch.rllib.replay_buffer import (PrioritizedReplayBuffer,
                                               ReplayBuffer)
from ray_tpu_torch.rllib.sample_batch import SampleBatch

BATCH_KEYS = ("obs", "actions", "rewards", "dones", "next_obs", "weights")


@dataclass
class DQNConfig(AlgorithmConfig):
    buffer_size: int = 50_000
    learning_starts: int = 1_000
    target_update_freq: int = 500        # in env steps
    train_intensity: float = 0.25        # grad steps per env step
    batch_size: int = 64
    double_q: bool = True
    dueling: bool = True
    prioritized_replay: bool = True
    prioritized_alpha: float = 0.6
    prioritized_beta: float = 0.4
    n_step: int = 1
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_steps: int = 10_000
    gamma: float = 0.99
    lr: float = 5e-4

    def build(self, algo_cls=None) -> "DQN":
        return DQN({"_config": self})


def init_q_params(obs_dim: int, num_actions: int, hiddens, dueling: bool,
                  seed: int = 0, *, device=None,
                  generator: Optional[torch.Generator] = None) -> dict:
    """He-normal ReLU trunk, N(0, 0.01) heads, zero biases, drawn from a
    ``torch.Generator`` on the target device (seeded with ``seed``
    unless one is passed)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    tcfg = FCNetConfig(obs_dim, tuple(hiddens), activation="relu")
    params = fcnet_init(tcfg, generator)
    params["adv"] = _dense_init(generator, tcfg.out_dim, num_actions,
                                scale=0.01)
    if dueling:
        params["val"] = _dense_init(generator, tcfg.out_dim, 1, scale=0.01)
    return params


def q_values(params, obs):
    """obs [B, O] -> Q [B, A] (dueling: val + adv - mean(adv))."""
    x = obs
    i = 0
    while f"fc{i}" in params:
        x = F.relu(_dense(params[f"fc{i}"], x))
        i += 1
    adv = _dense(params["adv"], x)
    if "val" in params:
        return _dense(params["val"], x) + adv - adv.mean(dim=-1,
                                                         keepdim=True)
    return adv


def take(q, actions):
    return q.gather(1, actions.long()[:, None])[:, 0]


def make_dqn_update(cfg: DQNConfig):
    """-> ``update(params, target_params, opt, batch)``: one step of
    ``opt`` (an ``optim.Adam`` over ``params``) on the weighted Huber
    loss -> ``(params, opt, loss, |td|)``."""
    gamma_n = cfg.gamma ** cfg.n_step

    def update(params, target_params, opt, batch):
        with torch.no_grad():
            q_next_target = q_values(target_params, batch["next_obs"])
            sel = (q_values(params, batch["next_obs"]) if cfg.double_q
                   else q_next_target).argmax(dim=-1)
            target = batch["rewards"] + gamma_n * (
                1.0 - batch["dones"]) * take(q_next_target, sel)
        td = take(q_values(params, batch["obs"]), batch["actions"]) - target
        hub = torch.where(td.abs() < 1.0, 0.5 * td ** 2, td.abs() - 0.5)
        loss = (batch["weights"] * hub).mean()
        opt.minimize(loss)
        return params, opt, loss.detach(), td.detach().abs()

    return update


class _NStepWindow:
    """Per-env n-step return accumulator: emits (obs, action,
    sum_{k<n} gamma^k r_{t+k}, done, obs_{t+n}) transitions; on episode
    end all pending entries flush with done=1 and their actual
    discounted return-to-termination (the bootstrap is masked by done,
    so the shorter horizon is exact)."""

    def __init__(self, n: int, gamma: float):
        self.n, self.gamma = n, gamma
        self.pending: list[list] = []  # [obs, action, reward_sum]

    def push(self, obs, action, rew, done, next_obs) -> list[tuple]:
        out = []
        self.pending.append([obs, action, 0.0])
        L = len(self.pending)
        for i, e in enumerate(self.pending):
            e[2] += rew * self.gamma ** (L - 1 - i)
        if L == self.n:
            o, a, r = self.pending.pop(0)
            out.append((o, a, r, float(done), next_obs))
        if done:
            while self.pending:
                o, a, r = self.pending.pop(0)
                out.append((o, a, r, 1.0, next_obs))
        return out


@dataclass
class SimpleQConfig(DQNConfig):
    """Vanilla Q-learning: DQN minus double/dueling/prioritized/n-step."""
    double_q: bool = False
    dueling: bool = False
    prioritized_replay: bool = False
    n_step: int = 1

    def build(self, algo_cls=None) -> "SimpleQ":
        return SimpleQ({"_config": self})


class DQN(Algorithm):
    _default_config = DQNConfig

    def _build(self):
        cfg = self.config
        self.device = resolve_device(cfg.device)
        self.vec = VectorEnv(cfg.env, cfg.num_envs_per_worker,
                             seed=cfg.seed)
        self.obs_dim = self.vec.observation_dim
        self.num_actions = self.vec.num_actions
        self.params = params_on(
            init_q_params(self.obs_dim, self.num_actions, cfg.hiddens,
                          cfg.dueling, cfg.seed, device=self.device),
            self.device)
        self.target_params = params_on(self.params, self.device, grad=False)
        self.opt = Adam(self.params, cfg.lr)
        self._update = make_dqn_update(cfg)
        if cfg.prioritized_replay:
            self.buffer = PrioritizedReplayBuffer(
                cfg.buffer_size, cfg.prioritized_alpha, seed=cfg.seed)
        else:
            self.buffer = ReplayBuffer(cfg.buffer_size, seed=cfg.seed)
        self._obs = self.vec.reset()
        self._rng = np.random.default_rng(cfg.seed + 1)
        self._ep_rew = np.zeros(self.vec.num_envs, np.float32)
        self._since_target_sync = 0
        self._grad_debt = 0.0
        self._nstep = [
            _NStepWindow(cfg.n_step, cfg.gamma)
            for _ in range(self.vec.num_envs)] if cfg.n_step > 1 else None

    @property
    def epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._timesteps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_start + frac * (cfg.epsilon_end
                                           - cfg.epsilon_start)

    @torch.no_grad()
    def _greedy(self, obs) -> np.ndarray:
        x = torch.as_tensor(np.asarray(obs, np.float32)).to(self.device)
        return q_values(self.params, x).cpu().numpy().argmax(axis=-1)

    def _act(self, obs) -> np.ndarray:
        greedy = self._greedy(obs)
        explore = self._rng.random(len(greedy)) < self.epsilon
        rand = self._rng.integers(0, self.num_actions, len(greedy))
        return np.where(explore, rand, greedy)

    def _store(self, actions, rew, done, next_obs) -> None:
        B = self.vec.num_envs
        if self._nstep is None:
            self.buffer.add(SampleBatch({
                "obs": np.asarray(self._obs, np.float32),
                "actions": actions.astype(np.int64),
                "rewards": rew.astype(np.float32),
                "dones": done.astype(np.float32),
                "next_obs": np.asarray(next_obs, np.float32)}))
            return
        rows = []
        for e in range(B):
            rows += self._nstep[e].push(
                np.asarray(self._obs[e], np.float32), int(actions[e]),
                float(rew[e]), bool(done[e]),
                np.asarray(next_obs[e], np.float32))
        if rows:
            o, a, r, d, no = zip(*rows)
            self.buffer.add(SampleBatch({
                "obs": np.stack(o), "actions": np.asarray(a, np.int64),
                "rewards": np.asarray(r, np.float32),
                "dones": np.asarray(d, np.float32),
                "next_obs": np.stack(no)}))

    def training_step(self) -> dict:
        cfg = self.config
        B = self.vec.num_envs
        steps, losses = 0, []
        for _ in range(cfg.rollout_length):
            actions = self._act(self._obs)
            next_obs, rew, done = self.vec.step(actions)
            self._store(actions, rew, done, next_obs)
            self._ep_rew += rew
            for i in np.nonzero(done)[0]:
                self._ep_returns.append(float(self._ep_rew[i]))
                self._ep_rew[i] = 0.0
            self._obs = next_obs
            steps += B
            self._timesteps += B
            self._since_target_sync += B

            if len(self.buffer) < cfg.learning_starts:
                continue
            self._grad_debt += cfg.train_intensity * B
            while self._grad_debt >= 1.0:
                self._grad_debt -= 1.0
                losses.append(self._train_once())

            if self._since_target_sync >= cfg.target_update_freq:
                copy_into(self.target_params, self.params)
                self._since_target_sync = 0

        return {"steps_this_iter": steps,
                "epsilon": self.epsilon,
                "buffer_size": len(self.buffer),
                "mean_td_loss": float(np.mean(losses)) if losses else 0.0}

    def _train_once(self) -> float:
        cfg = self.config
        prioritized = isinstance(self.buffer, PrioritizedReplayBuffer)
        if prioritized:
            batch = self.buffer.sample(cfg.batch_size,
                                       beta=cfg.prioritized_beta)
        else:
            batch = self.buffer.sample(cfg.batch_size)
            batch["weights"] = np.ones(cfg.batch_size, np.float32)
        _, _, loss, td = self._update(
            self.params, self.target_params, self.opt,
            to_device({k: batch[k] for k in BATCH_KEYS}, self.device))
        if prioritized:
            self.buffer.update_priorities(batch["batch_indexes"],
                                          td.cpu().numpy())
        return float(loss)

    def save_checkpoint(self) -> dict:
        return to_numpy({"params": self.params,
                         "target_params": self.target_params,
                         "opt_state": self.opt.state(),
                         "timesteps": self._timesteps})

    def load_checkpoint(self, ck):
        """A port save, or the JAX package's (optax state bridged)."""
        copy_into(self.params, ck["params"])
        copy_into(self.target_params, ck.get("target_params", ck["params"]))
        if "opt_state" in ck:
            self.opt.load(ck["opt_state"])
        else:
            self.opt = Adam(self.params, self.config.lr)
        self._timesteps = ck.get("timesteps", 0)


class SimpleQ(DQN):
    _default_config = SimpleQConfig
