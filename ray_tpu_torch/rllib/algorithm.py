"""Algorithm base, config and worker set, the port of
``ray_tpu/rllib/algorithm.py``.

``Algorithm`` carries its own copy of the Trainable API that the JAX
package's ``Algorithm`` inherits from ``ray_tpu/tune/trainable.py``
(``train``, ``save``, ``restore``, ``iteration``), because the port does
not import ``ray_tpu.tune``.  ``training_step`` is the override point.

``WorkerSet`` samples inline, or with its rollout workers as actors of
the in-process stand-in ``core.actors`` (where the JAX package spawns
actors on its core runtime).  ``AlgorithmConfig.device`` places the
learner and the workers' policies (None = the CUDA card).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional, Union

import numpy as np

from ray_tpu_torch.core import actors


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
    use_actors: Optional[bool] = None  # None = actors iff workers > 0
                                       # and core.actors is initialised
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


def call_env_maker(env_maker: Callable, cfg) -> Any:
    """Build a multi-agent env, passing ``num_agents``/``seed`` only where
    the factory's signature takes them (directly or through
    ``**kwargs``); a ``TypeError`` about those two retries bare."""
    import inspect
    try:
        params = inspect.signature(env_maker).parameters
        var_kw = any(p.kind == inspect.Parameter.VAR_KEYWORD
                     for p in params.values())
        kwargs = {}
        if var_kw or "num_agents" in params:
            kwargs["num_agents"] = cfg.num_agents
        if var_kw or "seed" in params:
            kwargs["seed"] = cfg.seed
    except ValueError:        # a callable without a signature
        kwargs = {"num_agents": cfg.num_agents, "seed": cfg.seed}
    try:
        return env_maker(**kwargs)
    except TypeError as e:
        if kwargs and ("num_agents" in str(e) or "seed" in str(e)):
            return env_maker()
        raise


class WorkerSet:
    """The learner's handle to its rollout workers: inline, or actors of
    ``core.actors`` that sample in parallel (``use_actors``; None = actors
    when ``num_rollout_workers > 0`` and the stand-in is initialised)."""

    def __init__(self, config: AlgorithmConfig):
        from ray_tpu_torch.rllib.rollout_worker import RolloutWorker
        use_actors = config.use_actors
        if use_actors is None:
            use_actors = (config.num_rollout_workers > 0
                          and actors.is_initialized())
        self.use_actors = use_actors
        kw = dict(num_envs=config.num_envs_per_worker,
                  rollout_length=config.rollout_length,
                  gamma=config.gamma, lam=config.lam,
                  hiddens=config.hiddens, device=config.device)
        make = (actors.remote(RolloutWorker).remote if use_actors
                else RolloutWorker)
        self.workers = [make(config.env, seed=config.seed + 1000 * i, **kw)
                        for i in range(max(1, config.num_rollout_workers))]
        # a local probe worker for the obs/action dims
        self._probe = (RolloutWorker(config.env, seed=config.seed, **kw)
                       if use_actors else self.workers[0])

    @property
    def obs_dim(self):
        return self._probe.cfg.obs_dim

    @property
    def num_actions(self):
        return self._probe.cfg.num_actions

    def sample_sync(self):
        """One rollout from every worker, concatenated in worker order,
        and the returns of the episodes that ended meanwhile."""
        from ray_tpu_torch.rllib.sample_batch import SampleBatch
        if self.use_actors:
            batches = actors.get([w.sample.remote() for w in self.workers])
            rets = actors.get([w.episode_returns.remote()
                               for w in self.workers])
        else:
            batches = [w.sample() for w in self.workers]
            rets = [w.episode_returns() for w in self.workers]
        return SampleBatch.concat_samples(
            [SampleBatch(b) for b in batches]), [r for rs in rets for r in rs]

    def sync_weights(self, weights) -> None:
        """Every worker's policy from ``weights`` (actors: one ``put``,
        every worker reads the same ref and copies it)."""
        if self.use_actors:
            ref = actors.put(weights)
            actors.get([w.set_weights.remote(ref) for w in self.workers])
        else:
            for w in self.workers:
                w.set_weights(weights)

    def stop(self) -> None:
        """Kill the actors (nothing to release inline)."""
        if self.use_actors:
            for w in self.workers:
                actors.kill(w)


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
        """Stop the rollout workers of an algorithm that has a
        ``WorkerSet`` (its actors; nothing to release inline)."""
        workers = getattr(self, "workers", None)
        if isinstance(workers, WorkerSet):
            workers.stop()

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
