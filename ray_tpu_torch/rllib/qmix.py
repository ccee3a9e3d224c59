"""QMIX: cooperative multi-agent Q-learning with monotonic value mixing,
the port of ``ray_tpu/rllib/qmix.py``: ``TeamSwitch``, ``QMIXConfig``,
``init_qmix_params``, ``agent_q``, ``mix``, ``make_qmix_update`` and
``QMIX``.

Every agent's Q-net is one slice of a stacked tree (leading axis: the
agent), as the JAX package keeps it for ``vmap``; here the agents run as
one batched product per layer over the stacked weights.  The mixer's
hypernetworks map the global state to non-negative (|W|) mixing weights,
so the joint argmax factorises into per-agent argmaxes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.data.feed import to_device
from ray_tpu_torch.models.zoo import _dense, _dense_init
from ray_tpu_torch.rllib.algorithm import (Algorithm, AlgorithmConfig,
                                           call_env_maker)
from ray_tpu_torch.rllib.optim import Adam, copy_into, params_on, to_numpy
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class TeamSwitch:
    """Each agent sees a private bit; the team earns +1 only when EVERY
    agent plays its own bit, else 0: individually derivable, jointly
    rewarded, so credit assignment is the hard part."""

    def __init__(self, num_agents: int = 2, episode_len: int = 8,
                 seed: Optional[int] = None):
        self.n = num_agents
        self.episode_len = episode_len
        self.rng = np.random.default_rng(seed)
        self.observation_dim = 2       # [own bit, t/episode_len]
        self.num_actions = 2
        self.agent_ids = [f"agent_{i}" for i in range(num_agents)]
        self._bits = None
        self._t = 0

    def reset(self):
        self._bits = self.rng.integers(0, 2, self.n)
        self._t = 0
        return self._obs()

    def _obs(self):
        frac = self._t / self.episode_len
        return {aid: np.asarray([self._bits[i], frac], np.float32)
                for i, aid in enumerate(self.agent_ids)}

    def state(self) -> np.ndarray:
        """Global state for the mixer (bits + time)."""
        return np.asarray([*self._bits, self._t / self.episode_len],
                          np.float32)

    def step(self, action_dict):
        acts = np.asarray([int(action_dict[a]) for a in self.agent_ids])
        team_r = 1.0 if np.array_equal(acts, self._bits) else 0.0
        self._t += 1
        self._bits = self.rng.integers(0, 2, self.n)
        done = self._t >= self.episode_len
        obs = self._obs()
        rew = {aid: team_r for aid in self.agent_ids}
        dones = {aid: done for aid in self.agent_ids}
        dones["__all__"] = done
        return obs, rew, dones, {}


@dataclass
class QMIXConfig(AlgorithmConfig):
    env: object = TeamSwitch
    num_agents: int = 2
    buffer_size: int = 20_000
    learning_starts: int = 200
    batch_size: int = 64
    mixing_embed: int = 32
    target_update_freq: int = 200     # env (team) steps
    train_intensity: float = 0.5
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_steps: int = 4_000
    gamma: float = 0.99
    lr: float = 1e-3

    def build(self, algo_cls=None) -> "QMIX":
        return QMIX({"_config": self})


def init_qmix_params(n_agents, obs_dim, num_actions, hiddens, state_dim,
                     embed, seed: int = 0, *, device=None,
                     generator: Optional[torch.Generator] = None) -> dict:
    """The agents' nets stacked on a leading agent axis, and the mixer's
    hypernetworks, drawn from a ``torch.Generator`` on the device."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    h = hiddens[0]
    nets = [{"fc0": _dense_init(generator, obs_dim, h),
             "fc1": _dense_init(generator, h, h),
             "q": _dense_init(generator, h, num_actions, scale=0.01)}
            for _ in range(n_agents)]
    agents = {k: {leaf: torch.stack([n[k][leaf] for n in nets])
                  for leaf in ("w", "b")} for k in nets[0]}
    return {
        "agents": agents,
        "hyper_w1": _dense_init(generator, state_dim, n_agents * embed),
        "hyper_b1": _dense_init(generator, state_dim, embed),
        "hyper_w2": _dense_init(generator, state_dim, embed),
        "hyper_b2_1": _dense_init(generator, state_dim, embed),
        "hyper_b2_2": _dense_init(generator, embed, 1, scale=0.01),
    }


def _batched(p, x):
    """x [N, B, din] through the stacked layer w [N, din, dout]."""
    return torch.matmul(x, p["w"]) + p["b"][:, None, :]


def agent_q(agent_params, obs):
    """Per-agent Q: obs [B, N, D] -> [B, N, A], every agent at once."""
    x = obs.transpose(0, 1)                               # [N, B, D]
    x = F.relu(_batched(agent_params["fc0"], x))
    x = F.relu(_batched(agent_params["fc1"], x))
    return _batched(agent_params["q"], x).transpose(0, 1)


def mix(params, chosen_q, state):
    """Monotonic mixer: chosen_q [B, N], state [B, S] -> Q_tot [B]."""
    B, N = chosen_q.shape
    w1 = _dense(params["hyper_w1"], state).abs()          # [B, N*E]
    w1 = w1.reshape(B, N, w1.shape[-1] // N)
    b1 = _dense(params["hyper_b1"], state)                # [B, E]
    hidden = F.elu(torch.einsum("bn,bne->be", chosen_q, w1) + b1)
    w2 = _dense(params["hyper_w2"], state).abs()          # [B, E]
    v = _dense(params["hyper_b2_2"],
               F.relu(_dense(params["hyper_b2_1"], state)))[:, 0]
    return (hidden * w2).sum(dim=-1) + v


def make_qmix_update(cfg: QMIXConfig):
    """-> ``update(params, target_params, opt, batch)``: one step of
    ``opt`` (an ``optim.Adam`` over ``params``) on the mixed TD loss with
    per-agent double-Q selection -> ``(params, opt, loss)``."""
    def update(params, target_params, opt, batch):
        obs, actions = batch["obs"], batch["actions"].long()  # [B,N,D],[B,N]
        with torch.no_grad():
            sel = agent_q(params["agents"], batch["next_obs"]).argmax(-1)
            q_next = agent_q(target_params["agents"], batch["next_obs"]
                             ).gather(2, sel[..., None])[..., 0]
            target = batch["rewards"] + cfg.gamma * (
                1.0 - batch["dones"]) * mix(target_params, q_next,
                                            batch["next_state"])
        chosen = agent_q(params["agents"], obs).gather(
            2, actions[..., None])[..., 0]
        loss = ((mix(params, chosen, batch["state"]) - target) ** 2).mean()
        opt.minimize(loss)
        return params, opt, loss.detach()

    return update


class QMIX(Algorithm):
    _default_config = QMIXConfig

    def _build(self):
        cfg = self.config
        self.device = dev = resolve_device(cfg.device)
        if not callable(cfg.env):
            raise ValueError("QMIX needs a cooperative MultiAgentEnv "
                             "factory as config.env")
        self.env = call_env_maker(cfg.env, cfg)
        self._obs = self.env.reset()   # state() is defined after reset
        self.agent_ids = list(self.env.agent_ids)
        self.num_actions = self.env.num_actions
        params = init_qmix_params(
            len(self.agent_ids), self.env.observation_dim, self.num_actions,
            cfg.hiddens, len(np.asarray(self.env.state())),
            cfg.mixing_embed, cfg.seed, device=dev)
        self.params = params_on(params, dev)
        self.target_params = params_on(params, dev, grad=False)
        self.opt = Adam(self.params, cfg.lr)
        self._update = make_qmix_update(cfg)
        self.buffer = ReplayBuffer(cfg.buffer_size, seed=cfg.seed)
        self._rng = np.random.default_rng(cfg.seed + 1)
        self._ep_rew = 0.0
        self._since_target_sync = 0
        self._grad_debt = 0.0

    @property
    def epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._timesteps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_start + frac * (cfg.epsilon_end
                                           - cfg.epsilon_start)

    def _obs_array(self, obs_dict) -> np.ndarray:
        return np.stack([np.asarray(obs_dict[a], np.float32)
                         for a in self.agent_ids])[None]   # [1, N, D]

    @torch.no_grad()
    def _greedy(self, oa) -> np.ndarray:
        q = agent_q(self.params["agents"], torch.as_tensor(oa).to(
            self.device))
        return q[0].argmax(dim=-1).cpu().numpy()

    def training_step(self) -> dict:
        cfg = self.config
        steps, losses = 0, []
        for _ in range(cfg.rollout_length):
            oa = self._obs_array(self._obs)
            state = self.env.state()
            greedy = self._greedy(oa)
            explore = self._rng.random(len(greedy)) < self.epsilon
            rand = self._rng.integers(0, self.num_actions, len(greedy))
            acts = np.where(explore, rand, greedy)
            next_obs, rew, dones, _ = self.env.step(
                {a: int(acts[i]) for i, a in enumerate(self.agent_ids)})
            team_r = float(np.mean([rew[a] for a in self.agent_ids]))
            done = bool(dones["__all__"])
            self.buffer.add(SampleBatch({
                "obs": oa.astype(np.float32),
                "actions": acts[None].astype(np.int32),
                "rewards": np.asarray([team_r], np.float32),
                "dones": np.asarray([float(done)], np.float32),
                "next_obs": self._obs_array(next_obs).astype(np.float32),
                "state": state[None].astype(np.float32),
                "next_state": self.env.state()[None].astype(np.float32)}))
            self._ep_rew += team_r
            if done:
                self._ep_returns.append(self._ep_rew)
                self._ep_rew = 0.0
                self._obs = self.env.reset()
            else:
                self._obs = next_obs
            steps += 1
            self._timesteps += 1
            self._since_target_sync += 1

            if len(self.buffer) < cfg.learning_starts:
                continue
            self._grad_debt += cfg.train_intensity
            while self._grad_debt >= 1.0:
                self._grad_debt -= 1.0
                batch = self.buffer.sample(cfg.batch_size)
                batch.pop("batch_indexes", None)
                _, _, loss = self._update(self.params, self.target_params,
                                          self.opt,
                                          to_device(dict(batch),
                                                    self.device))
                losses.append(loss)
            if self._since_target_sync >= cfg.target_update_freq:
                copy_into(self.target_params, self.params)
                self._since_target_sync = 0

        return {"steps_this_iter": steps,
                "epsilon": self.epsilon,
                "buffer_size": len(self.buffer),
                "mean_td_loss": (float(torch.stack(losses).mean())
                                 if losses else 0.0)}

    def save_checkpoint(self) -> dict:
        return to_numpy({"params": self.params,
                         "target_params": self.target_params,
                         "opt_state": self.opt.state(),
                         "timesteps": self._timesteps})

    def load_checkpoint(self, ck):
        """A port save, or the JAX package's (optax state bridged)."""
        copy_into(self.params, ck["params"])
        copy_into(self.target_params, ck["target_params"])
        self.opt.load(ck["opt_state"])
        self._timesteps = ck.get("timesteps", 0)
