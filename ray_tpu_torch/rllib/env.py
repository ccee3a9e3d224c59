"""Environments: vectorized rollout envs.

The port's own copy of ``ray_tpu/rllib/env.py``: numpy CartPole and
Pendulum (so no environment is downloaded), the gymnasium adapter for
other ids, and ``VectorEnv``, which steps N sub-envs in lockstep and
resets each one when its episode ends.  The same seeds give the same
trajectories as the JAX package's envs.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import numpy as np


class CartPole:
    """Classic control CartPole-v1 dynamics (numpy, single env)."""

    MAX_STEPS = 500

    def __init__(self, seed: Optional[int] = None):
        self.rng = np.random.default_rng(seed)
        self.observation_dim = 4
        self.num_actions = 2
        self.state = None
        self.t = 0

    def reset(self):
        self.state = self.rng.uniform(-0.05, 0.05, size=4)
        self.t = 0
        return self.state.astype(np.float32)

    def step(self, action: int):
        x, x_dot, th, th_dot = self.state
        force = 10.0 if action == 1 else -10.0
        costh, sinth = np.cos(th), np.sin(th)
        temp = (force + 0.05 * th_dot ** 2 * sinth) / 1.1
        th_acc = (9.8 * sinth - costh * temp) / (
            0.5 * (4.0 / 3.0 - 0.1 * costh ** 2 / 1.1))
        x_acc = temp - 0.05 * th_acc * costh / 1.1
        tau = 0.02
        self.state = np.array([x + tau * x_dot, x_dot + tau * x_acc,
                               th + tau * th_dot, th_dot + tau * th_acc])
        self.t += 1
        done = bool(abs(self.state[0]) > 2.4 or abs(self.state[2]) > 0.2095
                    or self.t >= self.MAX_STEPS)
        return self.state.astype(np.float32), 1.0, done, {}


class Pendulum:
    """Classic control Pendulum-v1 dynamics (numpy, single env) —
    continuous action in [-2, 2], the built-in test env for the
    continuous-control algorithms (DDPG/TD3)."""

    MAX_STEPS = 200

    def __init__(self, seed: Optional[int] = None):
        self.rng = np.random.default_rng(seed)
        self.observation_dim = 3
        self.action_dim = 1
        self.action_low = np.array([-2.0], np.float32)
        self.action_high = np.array([2.0], np.float32)
        self.th = self.thdot = 0.0
        self.t = 0

    def _obs(self):
        return np.array([np.cos(self.th), np.sin(self.th), self.thdot],
                        np.float32)

    def reset(self):
        self.th = self.rng.uniform(-np.pi, np.pi)
        self.thdot = self.rng.uniform(-1.0, 1.0)
        self.t = 0
        return self._obs()

    def step(self, action):
        u = float(np.clip(np.asarray(action).reshape(-1)[0], -2.0, 2.0))
        g, m, l, dt = 10.0, 1.0, 1.0, 0.05
        th_norm = ((self.th + np.pi) % (2 * np.pi)) - np.pi
        cost = th_norm ** 2 + 0.1 * self.thdot ** 2 + 0.001 * u ** 2
        self.thdot += (3 * g / (2 * l) * np.sin(self.th)
                       + 3.0 / (m * l ** 2) * u) * dt
        self.thdot = float(np.clip(self.thdot, -8.0, 8.0))
        self.th += self.thdot * dt
        self.t += 1
        return self._obs(), -float(cost), self.t >= self.MAX_STEPS, {}


class GymEnvAdapter:
    """gymnasium env → the 4-tuple interface used here."""

    def __init__(self, env_id: str, seed: Optional[int] = None):
        import gymnasium
        self.env = gymnasium.make(env_id)
        self._seed = seed
        self.observation_dim = int(np.prod(self.env.observation_space.shape))
        self.num_actions = int(self.env.action_space.n)

    def reset(self):
        obs, _ = self.env.reset(seed=self._seed)
        self._seed = None
        return np.asarray(obs, np.float32).reshape(-1)

    def step(self, action):
        obs, rew, term, trunc, info = self.env.step(int(action))
        return (np.asarray(obs, np.float32).reshape(-1), float(rew),
                bool(term or trunc), info)


def make_env(env: Union[str, Callable], seed: Optional[int] = None):
    if callable(env):
        return env()
    if env in ("CartPole-v1", "CartPole"):
        return CartPole(seed)
    if env in ("Pendulum-v1", "Pendulum"):
        return Pendulum(seed)
    return GymEnvAdapter(env, seed)


class VectorEnv:
    """N sub-envs stepped in lockstep with auto-reset
    (reference: rllib/env/vector_env.py VectorEnvWrapper)."""

    def __init__(self, env: Union[str, Callable], num_envs: int,
                 seed: int = 0):
        self.envs = [make_env(env, seed + i) for i in range(num_envs)]
        self.num_envs = num_envs
        self.observation_dim = self.envs[0].observation_dim
        # discrete envs expose num_actions; continuous expose action_dim
        self.num_actions = getattr(self.envs[0], "num_actions", None)
        self.action_dim = getattr(self.envs[0], "action_dim", None)
        self.action_low = getattr(self.envs[0], "action_low", None)
        self.action_high = getattr(self.envs[0], "action_high", None)
        self._obs = None

    def reset(self) -> np.ndarray:
        self._obs = np.stack([e.reset() for e in self.envs])
        return self._obs

    def step(self, actions: np.ndarray):
        obs, rews, dones = [], [], []
        for e, a in zip(self.envs, actions):
            o, r, d, _ = e.step(a)
            if d:
                o = e.reset()
            obs.append(o)
            rews.append(r)
            dones.append(d)
        self._obs = np.stack(obs)
        return (self._obs, np.asarray(rews, np.float32),
                np.asarray(dones, bool))
