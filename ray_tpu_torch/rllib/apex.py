"""Ape-X DQN: distributed prioritized experience replay, the port of
``ray_tpu/rllib/apex.py``: ``ApexDQNConfig``, ``_ReplayShard``,
``_Collector`` and ``ApexDQN``.

Collectors with a ladder of exploration epsilons (Horgan et al. 2018,
eq. 1) push experience into replay shards round-robin; the learner
samples from the shards in turn, takes DQN's update
(``dqn.make_dqn_update``) on its device, pushes the new priorities back
to the shard the batch came from, refreshes the target network every
``target_update_freq`` env steps and the collectors' weights every
``weight_sync_freq`` rounds.

With ``num_rollout_workers > 0`` while the in-process stand-in
``core.actors`` is initialised, the shards and collectors are its actors
(the JAX package's are actors of its core runtime): ``num_replay_shards``
shards of ``buffer_size // num_replay_shards`` rows each.  Otherwise one
shard of ``buffer_size`` rows and ``max(1, num_rollout_workers)``
collectors run inline.  Replay and exploration draws are numpy with the
JAX package's seeds; a collector's Q net acts on the algorithm's device,
one device round trip per env step, as the port's DQN acts.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.core import actors
from ray_tpu_torch.data.feed import to_device
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.dqn import (BATCH_KEYS, DQNConfig, init_q_params,
                                     make_dqn_update, q_values)
from ray_tpu_torch.rllib.env import VectorEnv
from ray_tpu_torch.rllib.optim import Adam, copy_into, params_on, to_numpy
from ray_tpu_torch.rllib.replay_buffer import PrioritizedReplayBuffer
from ray_tpu_torch.rllib.sample_batch import SampleBatch


@dataclass
class ApexDQNConfig(DQNConfig):
    num_rollout_workers: int = 2
    num_replay_shards: int = 1
    collect_steps_per_round: int = 256   # env steps per collector round
    train_rounds_per_iter: int = 8
    grad_steps_per_round: int = 8
    weight_sync_freq: int = 2            # rounds between weight pushes
    epsilon_base: float = 0.4            # collector i: base^(1+i/(N-1)·7)
    learning_starts: int = 500

    def build(self, algo_cls=None) -> "ApexDQN":
        return ApexDQN({"_config": self})


class _ReplayShard:
    """A prioritized replay buffer behind the calls the learner makes."""

    def __init__(self, capacity: int, alpha: float, seed: int):
        self.buf = PrioritizedReplayBuffer(capacity, alpha, seed=seed)

    def add(self, batch_dict: dict):
        self.buf.add(SampleBatch(batch_dict))
        return len(self.buf)

    def sample(self, n: int, beta: float):
        if len(self.buf) < n:
            return None
        return dict(self.buf.sample(n, beta=beta))

    def update_priorities(self, idx, prio):
        self.buf.update_priorities(np.asarray(idx), np.asarray(prio))

    def size(self):
        return len(self.buf)


class _Collector:
    """An epsilon-greedy collector: its own ``VectorEnv`` and a copy of
    the Q net on ``device``."""

    def __init__(self, env, num_envs, hiddens, dueling, epsilon, seed,
                 device=None):
        self.vec = VectorEnv(env, num_envs, seed=seed)
        self.epsilon = epsilon
        self.device = resolve_device(device)
        self.params = init_q_params(
            self.vec.observation_dim, self.vec.num_actions, hiddens,
            dueling, seed, device=self.device)
        self._rng = np.random.default_rng(seed)
        self._obs = self.vec.reset()
        self._ep_rew = np.zeros(num_envs, np.float32)
        self._completed: list = []

    def set_weights(self, weights):
        copy_into(self.params, weights)

    @torch.no_grad()
    def collect(self, n_steps: int) -> dict:
        B = self.vec.num_envs
        rows = {"obs": [], "actions": [], "rewards": [], "dones": [],
                "next_obs": []}
        for _ in range(max(1, n_steps // B)):
            x = torch.as_tensor(np.asarray(self._obs, np.float32))
            greedy = q_values(self.params, x.to(self.device)).cpu().numpy(
                ).argmax(axis=-1)
            explore = self._rng.random(B) < self.epsilon
            rand = self._rng.integers(0, self.vec.num_actions, B)
            actions = np.where(explore, rand, greedy)
            next_obs, rew, done = self.vec.step(actions)
            rows["obs"].append(np.asarray(self._obs, np.float32))
            rows["actions"].append(actions.astype(np.int64))
            rows["rewards"].append(rew.astype(np.float32))
            rows["dones"].append(done.astype(np.float32))
            rows["next_obs"].append(np.asarray(next_obs, np.float32))
            self._ep_rew += rew
            for i in np.nonzero(done)[0]:
                self._completed.append(float(self._ep_rew[i]))
                self._ep_rew[i] = 0.0
            self._obs = next_obs
        return {k: np.concatenate(v) for k, v in rows.items()}

    def episode_returns(self):
        out, self._completed = self._completed, []
        return out


class ApexDQN(Algorithm):
    _default_config = ApexDQNConfig

    def _build(self):
        cfg = self.config
        self.device = resolve_device(cfg.device)
        self._distributed = (cfg.num_rollout_workers > 0
                             and actors.is_initialized())
        probe = VectorEnv(cfg.env, 1, seed=cfg.seed)
        self.obs_dim = probe.observation_dim
        self.num_actions = probe.num_actions
        self.params = params_on(
            init_q_params(self.obs_dim, self.num_actions, cfg.hiddens,
                          cfg.dueling, cfg.seed, device=self.device),
            self.device)
        self.target_params = params_on(self.params, self.device, grad=False)
        self.opt = Adam(self.params, cfg.lr)
        self._update = make_dqn_update(cfg)
        self._round = 0
        self._since_target_sync = 0

        N = max(1, cfg.num_rollout_workers)
        # the collectors' epsilon ladder (Horgan et al. eq. 1)
        eps = [cfg.epsilon_base ** (1 + (i / max(1, N - 1)) * 7)
               for i in range(N)]
        if self._distributed:
            shard = actors.remote(_ReplayShard).remote
            collector = actors.remote(_Collector).remote
            self.shards = [
                shard(cfg.buffer_size // cfg.num_replay_shards,
                      cfg.prioritized_alpha, cfg.seed + 100 + i)
                for i in range(cfg.num_replay_shards)]
        else:
            collector = _Collector
            self.shards = [_ReplayShard(cfg.buffer_size,
                                        cfg.prioritized_alpha, cfg.seed)]
        self.collectors = [
            collector(cfg.env, cfg.num_envs_per_worker, cfg.hiddens,
                      cfg.dueling, eps[i], cfg.seed + 1000 * (i + 1),
                      device=self.device)
            for i in range(N)]
        self._sync_collector_weights()

    def _call(self, objs, method, *args) -> list:
        """``method(*args)`` on every object, inline or as actor calls
        (all submitted, then gathered in order)."""
        if self._distributed:
            return actors.get([getattr(o, method).remote(*args)
                               for o in objs], timeout=600)
        return [getattr(o, method)(*args) for o in objs]

    def _sync_collector_weights(self):
        w = to_numpy(self.params)
        self._call(self.collectors, "set_weights",
                   actors.put(w) if self._distributed else w)

    def training_step(self) -> dict:
        cfg = self.config
        steps, losses = 0, []
        for _ in range(cfg.train_rounds_per_iter):
            self._round += 1
            # 1. collect in parallel, scatter round-robin into the shards
            batches = self._call(self.collectors, "collect",
                                 cfg.collect_steps_per_round)
            for i, b in enumerate(batches):
                n = len(b["rewards"])
                steps += n
                self._timesteps += n
                self._since_target_sync += n
                self._call([self.shards[i % len(self.shards)]], "add", b)
            for rets in self._call(self.collectors, "episode_returns"):
                self._ep_returns.extend(rets)

            # 2. learn from the shards in turn
            if sum(self._call(self.shards, "size")) < cfg.learning_starts:
                continue
            for g in range(cfg.grad_steps_per_round):
                shard = self.shards[g % len(self.shards)]
                got = self._call([shard], "sample", cfg.batch_size,
                                 cfg.prioritized_beta)[0]
                if got is None:
                    continue
                _, _, loss, td = self._update(
                    self.params, self.target_params, self.opt,
                    to_device({k: got[k] for k in BATCH_KEYS}, self.device))
                losses.append(float(loss))
                # 3. the new priorities back to the shard they came from
                self._call([shard], "update_priorities",
                           got["batch_indexes"], td.cpu().numpy())

            if self._since_target_sync >= cfg.target_update_freq:
                copy_into(self.target_params, self.params)
                self._since_target_sync = 0
            if self._round % cfg.weight_sync_freq == 0:
                self._sync_collector_weights()

        return {"steps_this_iter": steps,
                "replay_size": int(sum(self._call(self.shards, "size"))),
                "mean_td_loss": float(np.mean(losses)) if losses else 0.0}

    def save_checkpoint(self) -> dict:
        return to_numpy({"params": self.params,
                         "target_params": self.target_params,
                         "opt_state": self.opt.state(),
                         "timesteps": self._timesteps})

    def load_checkpoint(self, ck):
        """A port save, or the JAX package's (optax state bridged); the
        collectors get the restored weights."""
        copy_into(self.params, ck["params"])
        copy_into(self.target_params, ck["target_params"])
        self.opt.load(ck["opt_state"])
        self._timesteps = ck.get("timesteps", 0)
        self._sync_collector_weights()

    def cleanup(self):
        """Kill every collector and shard; one kill that raises (a thread
        still running past the join bound) does not spare the rest."""
        if self._distributed:
            for o in self.collectors + self.shards:
                try:
                    actors.kill(o)
                except RuntimeError:
                    pass
