"""AlphaZero: MCTS planning guided by a learned policy/value network, the
port of ``ray_tpu/rllib/alpha_zero.py``: ``GridGoal``,
``RankedRewardsBuffer``, ``_Node``, ``MCTS`` (numpy copies),
``AlphaZeroConfig``, ``init_az_params``, ``az_forward`` and
``AlphaZero``.

The tree search stays on the host; each leaf it expands asks the net on
the learner's device for its priors and value (one round trip a leaf).
The train step is the policy's cross-entropy to the tree's visit
distribution, the value's squared error to the ranked reward, and an L2
over every leaf.  Self-play draws only from numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.zoo import _dense, _dense_init
from ray_tpu_torch.rllib.algorithm import (Algorithm, AlgorithmConfig,
                                           call_env_maker)
from ray_tpu_torch.rllib.optim import (Adam, copy_into, params_on, to_numpy,
                                       tree_leaves)


class GridGoal:
    """Deterministic sparse-reward planning task: walk a WxW grid from
    corner to corner in a tight step budget; the only reward is 1.0 at
    the episode's end on the goal."""

    W = 4
    MAX_T = 8

    def __init__(self, seed: Optional[int] = None):
        self.num_actions = 4          # N E S W
        self.observation_dim = self.W * self.W + 1
        self.reset()

    def _obs(self):
        grid = np.zeros(self.W * self.W, np.float32)
        grid[self.y * self.W + self.x] = 1.0
        vec = np.concatenate([grid, [self.t / self.MAX_T]]).astype(
            np.float32)
        return {"obs": vec,
                "action_mask": np.ones(self.num_actions, np.float32)}

    def reset(self):
        self.x = self.y = 0
        self.t = 0
        return self._obs()

    def get_state(self):
        return (self.x, self.y, self.t)

    def set_state(self, s):
        self.x, self.y, self.t = s
        return self._obs()

    def step(self, action: int):
        dx, dy = [(0, -1), (1, 0), (0, 1), (-1, 0)][int(action)]
        self.x = min(max(self.x + dx, 0), self.W - 1)
        self.y = min(max(self.y + dy, 0), self.W - 1)
        self.t += 1
        done = self.t >= self.MAX_T
        goal = (self.x == self.W - 1 and self.y == self.W - 1)
        reward = 1.0 if (done and goal) else 0.0
        return self._obs(), reward, done, {}


class RankedRewardsBuffer:
    """Ranked rewards (R2): a score against a percentile of the recent
    ones -> +1 or -1."""

    def __init__(self, max_len: int, percentile: float):
        self.max_len = max_len
        self.percentile = percentile
        self.buffer: list[float] = []

    def add(self, reward: float) -> None:
        if len(self.buffer) >= self.max_len:
            self.buffer.pop(0)
        self.buffer.append(reward)

    def normalize(self, reward: float) -> float:
        if not self.buffer:
            return 1.0 if reward > 0 else -1.0
        threshold = np.percentile(self.buffer, self.percentile)
        if reward > threshold:
            return 1.0
        if reward < threshold:
            return -1.0
        # at the threshold a positive score is a win, a zero one is not
        return 1.0 if reward > 0 else -1.0


class _Node:
    __slots__ = ("parent", "action", "children", "priors", "q_total",
                 "visits", "mask", "state", "obs", "reward", "done",
                 "expanded", "n_actions")

    def __init__(self, state, obs, done, reward, n_actions, parent=None,
                 action=0):
        self.parent = parent
        self.action = action
        self.children: dict[int, _Node] = {}
        self.priors = np.zeros(n_actions, np.float32)
        self.q_total = np.zeros(n_actions, np.float32)
        self.visits = np.zeros(n_actions, np.float32)
        self.mask = obs["action_mask"].astype(bool)
        self.state = state
        self.obs = obs
        self.reward = reward
        self.done = done
        self.expanded = False
        self.n_actions = n_actions

    def best_child_action(self, c_puct: float) -> int:
        n_total = max(self.visits.sum(), 1.0)
        q = self.q_total / (1.0 + self.visits)
        u = np.sqrt(n_total) * self.priors / (1.0 + self.visits)
        score = q + c_puct * u
        score[~self.mask] = -np.inf
        return int(np.argmax(score))


class MCTS:
    """PUCT search over a deterministic env via get_state/set_state;
    ``predict_fn(obs) -> (priors, value)``."""

    def __init__(self, predict_fn, cfg: "AlphaZeroConfig",
                 rng: np.random.Generator):
        self.predict = predict_fn
        self.cfg = cfg
        self.rng = rng

    def search(self, env, obs) -> np.ndarray:
        cfg = self.cfg
        n = env.num_actions
        root = _Node(env.get_state(), obs, False, 0.0, n)
        for _ in range(cfg.num_sims):
            node = root
            # select
            while node.expanded and not node.done:
                a = node.best_child_action(cfg.c_puct)
                child = node.children.get(a)
                if child is None:
                    env.set_state(node.state)
                    cobs, rew, done, _ = env.step(a)
                    child = _Node(env.get_state(), cobs, done, rew, n,
                                  parent=node, action=a)
                    node.children[a] = child
                node = child
            # expand + evaluate
            if node.done:
                value = 0.0
            else:
                priors, value = self.predict(node.obs["obs"])
                priors = np.array(priors, np.float32)   # writable copy
                priors *= node.obs["action_mask"]
                s = priors.sum()
                priors = priors / s if s > 0 else node.obs[
                    "action_mask"] / node.obs["action_mask"].sum()
                if node is root and cfg.dirichlet_epsilon > 0:
                    noise = self.rng.dirichlet(
                        [cfg.dirichlet_alpha] * n).astype(np.float32)
                    priors = ((1 - cfg.dirichlet_epsilon) * priors
                              + cfg.dirichlet_epsilon * noise)
                node.priors = priors
                node.expanded = True
                value = float(value)
            # backup (undiscounted within the tree)
            while node.parent is not None:
                value = node.reward + cfg.gamma * value
                node.parent.q_total[node.action] += value
                node.parent.visits[node.action] += 1.0
                node = node.parent
        # the rollouts moved the live env: put it back at the root
        env.set_state(root.state)
        visits = root.visits * root.mask
        total = visits.sum()
        if total <= 0:
            return root.mask.astype(np.float32) / root.mask.sum()
        return visits / total


@dataclass
class AlphaZeroConfig(AlgorithmConfig):
    env: object = GridGoal
    num_sims: int = 32               # tree simulations per move
    c_puct: float = 1.5
    dirichlet_alpha: float = 0.3
    dirichlet_epsilon: float = 0.25
    temperature: float = 1.0         # visit-count action sampling
    episodes_per_iter: int = 8
    buffer_size: int = 4096          # stored (obs, pi, z) rows
    batch_size: int = 128
    sgd_epochs: int = 2
    value_coeff: float = 1.0
    l2_coeff: float = 1e-4
    ranked_rewards: bool = True      # R2 normalization
    r2_buffer_len: int = 100
    r2_percentile: float = 60.0
    gamma: float = 1.0
    lr: float = 5e-3

    def build(self, algo_cls=None) -> "AlphaZero":
        return AlphaZero({"_config": self})


def init_az_params(obs_dim: int, n_actions: int, hiddens, seed: int = 0, *,
                   device=None,
                   generator: Optional[torch.Generator] = None) -> dict:
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    h1, h2 = hiddens[0], hiddens[-1]
    return {"fc0": _dense_init(generator, obs_dim, h1),
            "fc1": _dense_init(generator, h1, h2),
            "pi": _dense_init(generator, h2, n_actions, scale=0.01),
            "v": _dense_init(generator, h2, 1, scale=0.01)}


def az_forward(params, obs):
    """obs [B, D] -> (logits [B, A], value in (-1, 1) [B])."""
    x = torch.tanh(_dense(params["fc0"], obs))
    x = torch.tanh(_dense(params["fc1"], x))
    return _dense(params["pi"], x), torch.tanh(_dense(params["v"], x))[..., 0]


def az_loss(params, obs, pi_target, z, *, value_coeff, l2_coeff):
    """-> (total, policy cross-entropy, value MSE); the L2 sums every
    leaf in JAX's leaf order."""
    logits, value = az_forward(params, obs)
    pi_loss = -(pi_target * torch.log_softmax(logits, dim=-1)).sum(-1).mean()
    v_loss = ((value - z) ** 2).mean()
    l2 = sum((w ** 2).sum() for w in tree_leaves(params))
    return pi_loss + value_coeff * v_loss + l2_coeff * l2, pi_loss, v_loss


class AlphaZero(Algorithm):
    _default_config = AlphaZeroConfig

    def _build(self):
        cfg = self.config
        self.device = dev = resolve_device(cfg.device)
        self.env = (call_env_maker(cfg.env, cfg)
                    if callable(cfg.env) else cfg.env)
        self.n_actions = self.env.num_actions
        self.params = params_on(init_az_params(
            self.env.observation_dim, self.n_actions, cfg.hiddens, cfg.seed,
            device=dev), dev)
        self.opt = Adam(self.params, cfg.lr)
        self._rng = np.random.default_rng(cfg.seed)
        self.r2 = (RankedRewardsBuffer(cfg.r2_buffer_len,
                                       cfg.r2_percentile)
                   if cfg.ranked_rewards else None)
        self._replay: list[tuple] = []
        self.mcts = MCTS(self._predict, cfg, self._rng)

    @torch.no_grad()
    def _predict(self, obs):
        """One leaf on the device -> (priors, value) on the host."""
        x = torch.as_tensor(np.asarray(obs, np.float32)).to(self.device)
        logits, value = az_forward(self.params, x[None])
        out = torch.cat([torch.softmax(logits[0], dim=-1),
                         value]).cpu().numpy()
        return out[:-1], float(out[-1])

    def update(self, obs, pi_target, z):
        """One Adam step on a batch (tensors on the device) -> (loss,
        policy loss, value loss), 0-d tensors."""
        cfg = self.config
        loss, pl, vl = az_loss(self.params, obs, pi_target, z,
                               value_coeff=cfg.value_coeff,
                               l2_coeff=cfg.l2_coeff)
        self.opt.minimize(loss)
        return loss.detach(), pl.detach(), vl.detach()

    def _self_play_episode(self) -> tuple[list, float]:
        cfg = self.config
        env = self.env
        obs = env.reset()
        rows, total = [], 0.0
        done = False
        while not done:
            pi = self.mcts.search(env, obs)
            if cfg.temperature > 0:
                t = pi ** (1.0 / cfg.temperature)
                t /= t.sum()
                action = int(self._rng.choice(len(pi), p=t))
            else:
                action = int(np.argmax(pi))
            rows.append((obs["obs"], pi))
            obs, rew, done, _ = env.step(action)
            total += rew
        return rows, total

    def training_step(self) -> dict:
        cfg = self.config
        returns = []
        for _ in range(cfg.episodes_per_iter):
            rows, score = self._self_play_episode()
            returns.append(score)
            if self.r2 is not None:
                self.r2.add(score)
                z = self.r2.normalize(score)
            else:
                z = score
            for o, pi in rows:
                self._replay.append((o, pi, z))
            self._ep_returns.append(score)
        if len(self._replay) > cfg.buffer_size:
            self._replay = self._replay[-cfg.buffer_size:]

        losses = []
        n = len(self._replay)
        steps = cfg.episodes_per_iter * self.env.MAX_T \
            if hasattr(self.env, "MAX_T") else cfg.episodes_per_iter
        self._timesteps += steps
        if n >= cfg.batch_size:
            for _ in range(cfg.sgd_epochs):
                idx = self._rng.integers(0, n, cfg.batch_size)
                cols = [np.stack([self._replay[i][0] for i in idx]),
                        np.stack([self._replay[i][1] for i in idx]),
                        np.asarray([self._replay[i][2] for i in idx],
                                   np.float32)]
                loss, _, _ = self.update(*(torch.as_tensor(
                    c, dtype=torch.float32).to(self.device) for c in cols))
                losses.append(loss)
        return {"steps_this_iter": steps,
                "episode_reward_mean": float(np.mean(returns)),
                "replay_rows": n,
                "mean_loss": (float(torch.stack(losses).mean())
                              if losses else 0.0)}

    def compute_single_action(self, obs, explore: bool = False) -> int:
        """Greedy tree-search move (evaluation-time action)."""
        return int(np.argmax(self.mcts.search(self.env, obs)))

    def save_checkpoint(self) -> dict:
        return to_numpy({"params": self.params,
                         "opt_state": self.opt.state(),
                         "r2": list(self.r2.buffer) if self.r2 else None,
                         "timesteps": self._timesteps})

    def load_checkpoint(self, ck):
        """A port save, or the JAX package's (optax state bridged)."""
        copy_into(self.params, ck["params"])
        self.opt.load(ck["opt_state"])
        if self.r2 is not None and ck.get("r2") is not None:
            self.r2.buffer = list(ck["r2"])
        self._timesteps = ck.get("timesteps", 0)
