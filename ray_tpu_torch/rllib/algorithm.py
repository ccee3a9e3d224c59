"""Algorithm base, config and worker set, the port of
``ray_tpu/rllib/algorithm.py``.

``Algorithm`` carries its own copy of the Trainable API that the JAX
package's ``Algorithm`` inherits from ``ray_tpu/tune/trainable.py``
(``train``, ``save``, ``restore``, ``iteration``), because the port does
not import ``ray_tpu.tune``.  ``training_step`` is the override point.

``WorkerSet`` samples inline only: rollout workers as actors need a host
runtime, which the port does not have, so ``use_actors=True`` raises.
``AlgorithmConfig.device`` places the learner and the workers' policies
(None = the CUDA card).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Callable, Optional, Union

import numpy as np


@dataclass
class AlgorithmConfig:
    env: Union[str, Callable] = "CartPole-v1"
    num_rollout_workers: int = 0     # inline workers: max(1, this)
    num_envs_per_worker: int = 4
    rollout_length: int = 64
    gamma: float = 0.99
    lam: float = 0.95
    lr: float = 3e-4
    train_batch_size: int = 1024
    minibatch_size: int = 256
    num_epochs: int = 4
    hiddens: tuple = (64, 64)
    seed: int = 0
    use_actors: Optional[bool] = None  # True raises: inline only
    device: Optional[str] = None

    def environment(self, env) -> "AlgorithmConfig":
        return replace(self, env=env)

    def rollouts(self, *, num_rollout_workers=None,
                 num_envs_per_worker=None,
                 rollout_length=None) -> "AlgorithmConfig":
        out = self
        if num_rollout_workers is not None:
            out = replace(out, num_rollout_workers=num_rollout_workers)
        if num_envs_per_worker is not None:
            out = replace(out, num_envs_per_worker=num_envs_per_worker)
        if rollout_length is not None:
            out = replace(out, rollout_length=rollout_length)
        return out

    def training(self, **kw) -> "AlgorithmConfig":
        return replace(self, **kw)

    def build(self, algo_cls=None) -> "Algorithm":
        cls = algo_cls or getattr(self, "_algo_cls", None)
        if cls is None:
            raise ValueError("pass algo_cls or use PPOConfig")
        return cls({"_config": self})


class WorkerSet:
    """The learner's handle to its rollout workers, all inline."""

    def __init__(self, config: AlgorithmConfig):
        from ray_tpu_torch.rllib.rollout_worker import RolloutWorker
        if config.use_actors:
            raise NotImplementedError(
                "rollout workers as actors are not ported; the port "
                "samples inline")
        kw = dict(num_envs=config.num_envs_per_worker,
                  rollout_length=config.rollout_length,
                  gamma=config.gamma, lam=config.lam,
                  hiddens=config.hiddens, device=config.device)
        self.workers = [
            RolloutWorker(config.env, seed=config.seed + 1000 * i, **kw)
            for i in range(max(1, config.num_rollout_workers))]

    @property
    def obs_dim(self):
        return self.workers[0].cfg.obs_dim

    @property
    def num_actions(self):
        return self.workers[0].cfg.num_actions

    def sample_sync(self):
        """One rollout from every worker, concatenated, and the returns
        of the episodes that ended meanwhile."""
        from ray_tpu_torch.rllib.sample_batch import SampleBatch
        batches = [w.sample() for w in self.workers]
        rets = [r for w in self.workers for r in w.episode_returns()]
        return SampleBatch.concat_samples(
            [SampleBatch(b) for b in batches]), rets

    def sync_weights(self, weights) -> None:
        for w in self.workers:
            w.set_weights(weights)

    def stop(self) -> None:
        """Nothing to release: the workers are inline, not actors."""


class Algorithm:
    """setup(config), step() -> result, save_checkpoint() -> dict,
    load_checkpoint(dict); ``train``/``save``/``restore`` as a Tune
    Trainable has them."""

    _default_config: Callable[[], AlgorithmConfig] = AlgorithmConfig

    def __init__(self, config: Optional[dict] = None):
        self.config = config or {}
        self._iteration = 0
        self.setup(self.config)

    def setup(self, config: dict):
        cfg = config.get("_config")
        if cfg is None:
            base = self._default_config()
            known = {k: v for k, v in config.items() if hasattr(base, k)}
            cfg = replace(base, **known)
        self.config: AlgorithmConfig = cfg
        self._timesteps = 0
        self._ep_returns: list[float] = []
        self._build()

    # subclass hooks
    def _build(self):
        raise NotImplementedError

    def training_step(self) -> dict:
        raise NotImplementedError

    def save_checkpoint(self) -> dict:
        return {}

    def load_checkpoint(self, checkpoint: dict):
        pass

    def cleanup(self):
        pass

    def step(self) -> dict:
        t0 = time.perf_counter()
        result = self.training_step()
        dt = time.perf_counter() - t0
        result.setdefault("timesteps_total", self._timesteps)
        if self._ep_returns:
            recent = self._ep_returns[-100:]
            result["episode_reward_mean"] = float(np.mean(recent))
        result["env_steps_per_sec"] = result.get("steps_this_iter", 0) / dt
        return result

    def train(self) -> dict:
        result = self.step()
        self._iteration += 1
        result.setdefault("training_iteration", self._iteration)
        return result

    def save(self) -> dict:
        return {"_iteration": self._iteration,
                "payload": self.save_checkpoint()}

    def restore(self, saved: dict):
        self._iteration = saved.get("_iteration", 0)
        self.load_checkpoint(saved.get("payload", {}))

    @property
    def iteration(self) -> int:
        return self._iteration
