"""Contextual bandits: LinUCB and linear Thompson sampling, the port of
``ray_tpu/rllib/bandit.py``: ``LinearBanditEnv``, ``BanditConfig``,
``LinUCB`` and ``LinTS``.

Every arm's ridge-regression statistics sit in one stacked pair on the
device (A [K, d, d], b [K, d]), so scoring is one batched
``torch.linalg.solve`` (and for Thompson sampling one batched ``inv``
and ``cholesky``) over the arms.  LinTS's standard normal draw ``z``
comes from a ``torch.Generator``, or the caller's, so a test can feed
JAX's.  Choosing an arm is one device round trip per step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.optim import to_numpy


class LinearBanditEnv:
    """K arms, reward ``w_k . x`` plus Gaussian noise, unit contexts."""

    def __init__(self, num_arms: int = 5, context_dim: int = 8,
                 noise: float = 0.1, seed: Optional[int] = None):
        rng = np.random.default_rng(seed)
        self.w = rng.normal(size=(num_arms, context_dim))
        self.w /= np.linalg.norm(self.w, axis=1, keepdims=True)
        self.noise = noise
        self.context_dim = context_dim
        self.num_actions = num_arms
        self.rng = rng
        self._ctx = None

    def reset(self) -> np.ndarray:
        self._ctx = self.rng.normal(size=self.context_dim).astype(np.float32)
        self._ctx /= np.linalg.norm(self._ctx)
        return self._ctx

    def step(self, arm: int):
        rew = float(self.w[arm] @ self._ctx
                    + self.rng.normal() * self.noise)
        regret = float(np.max(self.w @ self._ctx) - self.w[arm] @ self._ctx)
        ctx = self.reset()
        return ctx, rew, False, {"regret": regret}


@dataclass
class BanditConfig(AlgorithmConfig):
    env: Union[str, Callable] = LinearBanditEnv
    exploration: str = "ucb"      # "ucb" | "ts"
    alpha: float = 1.0            # UCB exploration coefficient
    lambda_reg: float = 1.0       # ridge prior precision
    steps_per_iter: int = 128

    def build(self, algo_cls=None) -> "LinUCB":
        return (LinTS if self.exploration == "ts" else LinUCB)(
            {"_config": self})


def ucb_scores(A, b, x, alpha: float):
    """theta_k . x + alpha sqrt(x . A_k^-1 x) for every arm -> [K]."""
    K, d = b.shape
    theta = torch.linalg.solve(A, b[..., None])[..., 0]
    ainv_x = torch.linalg.solve(A, x.expand(K, d)[..., None])[..., 0]
    conf = torch.sqrt(torch.clamp(ainv_x @ x, min=0.0))
    return theta @ x + alpha * conf


def ts_scores(A, b, x, z):
    """(theta_k + chol(A_k^-1 + 1e-6 I) z_k) . x for every arm -> [K];
    ``z`` [K, d] is a standard normal draw."""
    d = b.shape[1]
    theta = torch.linalg.solve(A, b[..., None])[..., 0]
    chol = torch.linalg.cholesky(
        torch.linalg.inv(A) + 1e-6 * torch.eye(d, device=A.device)[None])
    return (theta + (chol @ z[..., None])[..., 0]) @ x


class LinUCB(Algorithm):
    _default_config = BanditConfig
    _mode = "ucb"

    def _build(self):
        cfg = self.config
        self.device = resolve_device(cfg.device)
        self.env = cfg.env() if callable(cfg.env) else cfg.env
        K, d = self.env.num_actions, self.env.context_dim
        # stacked ridge stats: A = lambda I + sum x x^T per arm, b = sum r x
        self.A = (cfg.lambda_reg * torch.eye(d, device=self.device)
                  ).expand(K, d, d).clone()
        self.b = torch.zeros((K, d), device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed)

    def scores(self, x, z=None):
        """The arms' scores for context ``x`` (a tensor on the device);
        LinTS draws ``z`` from its generator unless one is given."""
        if self._mode == "ts":
            if z is None:
                z = torch.randn(self.b.shape, generator=self._gen,
                                device=self.device)
            return ts_scores(self.A, self.b, x, z)
        return ucb_scores(self.A, self.b, x, self.config.alpha)

    def observe(self, arm: int, x, rew: float) -> None:
        """The ridge statistics' update for reward ``rew`` of ``arm`` in
        context ``x``."""
        self.A[arm] += torch.outer(x, x)
        self.b[arm] += rew * x

    def training_step(self) -> dict:
        cfg = self.config
        ctx = self.env.reset()
        rewards, regrets = [], []
        for _ in range(cfg.steps_per_iter):
            x = torch.as_tensor(np.asarray(ctx, np.float32)).to(self.device)
            arm = int(self.scores(x).argmax())
            ctx, rew, _, info = self.env.step(arm)
            self.observe(arm, x, rew)
            rewards.append(rew)
            regrets.append(info.get("regret", 0.0))
        self._timesteps += cfg.steps_per_iter
        self._ep_returns.append(float(np.sum(rewards)))
        return {"steps_this_iter": cfg.steps_per_iter,
                "mean_reward": float(np.mean(rewards)),
                "mean_regret": float(np.mean(regrets))}

    def save_checkpoint(self) -> dict:
        return to_numpy({"A": self.A, "b": self.b,
                         "timesteps": self._timesteps})

    def load_checkpoint(self, ck):
        self.A = torch.as_tensor(np.array(ck["A"], np.float32)).to(
            self.device)
        self.b = torch.as_tensor(np.array(ck["b"], np.float32)).to(
            self.device)
        self._timesteps = ck.get("timesteps", 0)


class LinTS(LinUCB):
    """Linear Thompson sampling: a posterior draw of each arm's weights."""
    _mode = "ts"
