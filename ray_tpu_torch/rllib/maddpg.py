"""MADDPG: multi-agent DDPG with centralised critics, the port of
``ray_tpu/rllib/maddpg.py``: ``SpreadLine``, ``MADDPGConfig``,
``make_maddpg_update`` and ``MADDPG``.

Each agent's deterministic actor sees its own observation; its critic
sees every agent's observation and action.  The actors and critics are
stacked trees (leading axis: the agent) built from ``ddpg.py``'s
``mlp_init`` and run slice by slice through ``actor_forward`` and
``critic_forward``.  As in the JAX package each agent's actor and critic
take a plain SGD step (``-lr * g`` on its slice, the critic's loss and
the actor's read the critic from before the step), then the targets
follow by Polyak averaging.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.data.feed import to_device
from ray_tpu_torch.rllib.algorithm import (Algorithm, AlgorithmConfig,
                                           call_env_maker)
from ray_tpu_torch.rllib.ddpg import actor_forward, critic_forward, mlp_init
from ray_tpu_torch.rllib.optim import (copy_into, params_on, polyak,
                                       to_numpy, tree_leaves, tree_map)
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class SpreadLine:
    """N agents on [-1, 1] must spread over N landmarks; the TEAM reward
    is -sum_l min_a |pos_a - landmark_l| (the 1-D analogue of MPE
    simple_spread)."""

    def __init__(self, num_agents: int = 2, episode_len: int = 25,
                 seed: Optional[int] = None):
        self.n = num_agents
        self.episode_len = episode_len
        self.rng = np.random.default_rng(seed)
        self.agent_ids = [f"agent_{i}" for i in range(num_agents)]
        # obs: own pos + all landmark positions
        self.observation_dim = 1 + num_agents
        self.action_dim = 1
        self.action_low = np.asarray([-1.0], np.float32)
        self.action_high = np.asarray([1.0], np.float32)
        self._pos = None
        self._marks = None
        self._t = 0

    def reset(self):
        self._pos = self.rng.uniform(-1, 1, self.n)
        self._marks = np.sort(self.rng.uniform(-1, 1, self.n))
        self._t = 0
        return self._obs()

    def _obs(self):
        return {aid: np.concatenate(
                    [[self._pos[i]], self._marks]).astype(np.float32)
                for i, aid in enumerate(self.agent_ids)}

    def step(self, action_dict):
        for i, aid in enumerate(self.agent_ids):
            v = float(np.clip(np.asarray(action_dict[aid]).reshape(-1)[0],
                              -1.0, 1.0))
            self._pos[i] = float(np.clip(self._pos[i] + 0.1 * v, -1, 1))
        cover = sum(np.abs(self._pos - m).min() for m in self._marks)
        team_r = -float(cover)
        self._t += 1
        done = self._t >= self.episode_len
        rew = {aid: team_r for aid in self.agent_ids}
        dones = {aid: done for aid in self.agent_ids}
        dones["__all__"] = done
        return self._obs(), rew, dones, {}


@dataclass
class MADDPGConfig(AlgorithmConfig):
    env: object = SpreadLine
    num_agents: int = 2
    buffer_size: int = 50_000
    learning_starts: int = 500
    batch_size: int = 128
    train_intensity: float = 0.25
    tau: float = 0.01
    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    exploration_noise: float = 0.15
    gamma: float = 0.95

    def build(self, algo_cls=None) -> "MADDPG":
        return MADDPG({"_config": self})


def agent_slice(tree, i: int):
    """Agent i's net out of a stacked tree (views of its leaves)."""
    return tree_map(lambda p: p[i], tree)


def _stack(nets: list):
    """Per-agent trees of one layout -> one tree of stacked leaves."""
    if isinstance(nets[0], dict):
        return {k: _stack([n[k] for n in nets]) for k in nets[0]}
    return torch.stack(nets)


def make_maddpg_update(cfg: MADDPGConfig, N, obs_dim, act_dim, low, high):
    """-> ``update(state, batch)``: ``state`` is ``(actors, actors_t,
    critics, critics_t)``, stacked trees stepped in place; batch obs and
    next_obs [B, N, O], actions [B, N, A], rewards and dones [B].
    Returns ``(state, critic loss, actor loss)``, each the mean over the
    agents."""
    def update(state, batch):
        actors, actors_t, critics, critics_t = state
        obs, actions = batch["obs"], batch["actions"]
        rewards, dones, next_obs = (batch["rewards"], batch["dones"],
                                    batch["next_obs"])
        B = obs.shape[0]
        flat_obs = obs.reshape(B, N * obs_dim)
        flat_a = actions.reshape(B, N * act_dim)
        with torch.no_grad():
            flat_next = next_obs.reshape(B, N * obs_dim)
            a_next = torch.stack(
                [actor_forward(agent_slice(actors_t, i), next_obs[:, i],
                               low, high) for i in range(N)], dim=1)
            flat_a_next = a_next.reshape(B, N * act_dim)
            ys = [rewards + cfg.gamma * (1.0 - dones) * critic_forward(
                agent_slice(critics_t, i), flat_next, flat_a_next)
                for i in range(N)]
        closses, alosses = [], []
        for i in range(N):
            crit_i = agent_slice(critics, i)
            closses.append(((critic_forward(crit_i, flat_obs, flat_a)
                             - ys[i]) ** 2).mean())
            # own action from the actor, the others' from the buffer
            my_a = actor_forward(agent_slice(actors, i), obs[:, i], low,
                                 high)
            joint = torch.cat([actions[:, :i].reshape(B, -1), my_a,
                               actions[:, i + 1:].reshape(B, -1)], dim=1)
            alosses.append(-critic_forward(crit_i, flat_obs, joint).mean())
        # agent i's loss reaches only slice i of the stacked leaves, so
        # one gradient of each sum holds every agent's own gradient
        c_leaves, a_leaves = tree_leaves(critics), tree_leaves(actors)
        cgrads = torch.autograd.grad(torch.stack(closses).sum(), c_leaves)
        agrads = torch.autograd.grad(torch.stack(alosses).sum(), a_leaves)
        with torch.no_grad():
            torch._foreach_add_(c_leaves, list(cgrads), alpha=-cfg.critic_lr)
            torch._foreach_add_(a_leaves, list(agrads), alpha=-cfg.actor_lr)
        polyak(actors_t, actors, cfg.tau)
        polyak(critics_t, critics, cfg.tau)
        return (state, torch.stack(closses).mean().detach(),
                torch.stack(alosses).mean().detach())

    return update


class MADDPG(Algorithm):
    _default_config = MADDPGConfig

    def _build(self):
        cfg = self.config
        self.device = dev = resolve_device(cfg.device)
        if not callable(cfg.env):
            raise ValueError("MADDPG needs a MultiAgentEnv factory")
        self.env = call_env_maker(cfg.env, cfg)
        self._obs = self.env.reset()
        self.agent_ids = list(self.env.agent_ids)
        N = self.N = len(self.agent_ids)
        O, A = self.env.observation_dim, self.env.action_dim
        self.low = torch.as_tensor(self.env.action_low).to(dev)
        self.high = torch.as_tensor(self.env.action_high).to(dev)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        adims = (O, *cfg.hiddens)
        cdims = (N * O + N * A, *cfg.hiddens)
        actors = _stack([mlp_init(gen, adims, A) for _ in range(N)])
        critics = _stack([mlp_init(gen, cdims, 1, out_scale=0.1)
                          for _ in range(N)])
        self.state = (params_on(actors, dev),
                      params_on(actors, dev, grad=False),
                      params_on(critics, dev),
                      params_on(critics, dev, grad=False))
        self._update = make_maddpg_update(cfg, N, O, A, self.low, self.high)
        self.buffer = ReplayBuffer(cfg.buffer_size, seed=cfg.seed)
        self._np_rng = np.random.default_rng(cfg.seed + 1)
        self._ep_rew = 0.0
        self._grad_debt = 0.0

    def _obs_array(self, obs_dict) -> np.ndarray:
        return np.stack([np.asarray(obs_dict[a], np.float32)
                         for a in self.agent_ids])

    @torch.no_grad()
    def _act(self, oa) -> np.ndarray:
        """Every agent's deterministic action for obs [N, O] -> [N, A]."""
        x = torch.as_tensor(oa).to(self.device)
        return torch.stack([
            actor_forward(agent_slice(self.state[0], i), x[i][None],
                          self.low, self.high)[0]
            for i in range(self.N)]).cpu().numpy()

    def training_step(self) -> dict:
        cfg = self.config
        low, high = self.low.cpu().numpy(), self.high.cpu().numpy()
        steps, closses, alosses = 0, [], []
        for _ in range(cfg.rollout_length):
            oa = self._obs_array(self._obs)                   # [N, O]
            acts = self._act(oa)
            noise = self._np_rng.normal(0, cfg.exploration_noise,
                                        acts.shape)
            acts = np.clip(acts + noise, low, high).astype(np.float32)
            next_obs, rew, dones, _ = self.env.step(
                {a: acts[i] for i, a in enumerate(self.agent_ids)})
            team_r = float(np.mean([rew[a] for a in self.agent_ids]))
            done = bool(dones["__all__"])
            self.buffer.add(SampleBatch({
                "obs": oa[None], "actions": acts[None],
                "rewards": np.asarray([team_r], np.float32),
                "dones": np.asarray([float(done)], np.float32),
                "next_obs": self._obs_array(next_obs)[None]}))
            self._ep_rew += team_r
            if done:
                self._ep_returns.append(self._ep_rew)
                self._ep_rew = 0.0
                self._obs = self.env.reset()
            else:
                self._obs = next_obs
            steps += 1
            self._timesteps += 1
            if len(self.buffer) < cfg.learning_starts:
                continue
            self._grad_debt += cfg.train_intensity
            while self._grad_debt >= 1.0:
                self._grad_debt -= 1.0
                batch = self.buffer.sample(cfg.batch_size)
                batch.pop("batch_indexes", None)
                _, closs, aloss = self._update(
                    self.state, to_device(dict(batch), self.device))
                closses.append(closs)
                alosses.append(aloss)
        return {"steps_this_iter": steps,
                "buffer_size": len(self.buffer),
                "critic_loss": (float(torch.stack(closses).mean())
                                if closses else 0.0),
                "actor_loss": (float(torch.stack(alosses).mean())
                               if alosses else 0.0)}

    def save_checkpoint(self) -> dict:
        """The JAX package's layout: ``state`` is ``(actors, actors_t,
        critics, critics_t)``, each leaf stacked over the agents."""
        return to_numpy({"state": self.state, "timesteps": self._timesteps})

    def load_checkpoint(self, ck):
        for mine, saved in zip(self.state, ck["state"]):
            copy_into(mine, saved)
        self._timesteps = ck.get("timesteps", 0)
