"""Evolution strategies (ES) and augmented random search (ARS), the port
of ``ray_tpu/rllib/es.py``: ``ESConfig``, ``ARSConfig``, ``ES`` and
``ARS``.

The policy's params live as one flat vector on the device, its pieces
in JAX's leaf order (dict keys sorted), so a JAX ``theta`` restores
as is.  Each iteration perturbs it antithetically (``eps`` [P, dim], a
standard normal draw from a ``torch.Generator``, or the caller's), runs
each candidate's greedy episodes on the host's numpy envs with the
policy on the device (one device round trip per env step), shapes the
returns by centred rank (ES) or keeps the top-k directions scaled by
their returns' std (ARS), and steps the vector.  ARS's ``MeanStdFilter``
moments stay on the host.  With ``eval_parallelism > 0`` the candidates'
episodes run as tasks of the in-process stand-in ``core.actors`` (its
thread pool), over the same arguments and seeds, and their outputs are
folded into the filter in candidate order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.core import actors
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.optim import (to_numpy, tree_leaves,
                                       tree_unflatten)
from ray_tpu_torch.rllib.policy import (PolicyConfig, init_policy_params,
                                        policy_forward)


@dataclass
class ESConfig(AlgorithmConfig):
    pop_size: int = 16          # perturbation pairs per iteration
    sigma: float = 0.05         # noise stddev
    step_size: float = 0.02
    episodes_per_eval: int = 1
    max_episode_steps: int = 500
    top_directions: int = 0     # 0 = use all (ES); >0 = ARS top-k
    eval_parallelism: int = 0   # >0: evaluations as core.actors tasks
    observation_filter: str = "NoFilter"   # "MeanStdFilter" = ARS V2

    def build(self, algo_cls=None) -> "ES":
        return ES({"_config": self})


@dataclass
class ARSConfig(ESConfig):
    top_directions: int = 8
    sigma: float = 0.03
    step_size: float = 0.02
    observation_filter: str = "MeanStdFilter"   # ARS V2 default

    def build(self, algo_cls=None) -> "ARS":
        return ARS({"_config": self})


def flatten(params):
    """-> (flat vector, the params as a template for ``unflatten``)."""
    return torch.cat([t.reshape(-1) for t in tree_leaves(params)]), params


def unflatten(flat, like):
    """A flat vector -> views of it in ``like``'s tree."""
    pieces, off = [], 0
    for t in tree_leaves(like):
        pieces.append(flat[off:off + t.numel()].reshape(t.shape))
        off += t.numel()
    return tree_unflatten(like, pieces)


@torch.no_grad()
def rollout_return(env_name, params, obs_dim: int, seed: int,
                   episodes: int, max_steps: int, obs_stats=None,
                   track_obs: bool = False):
    """Mean greedy (argmax) episode return of ``params`` -> (return, sum
    and sum of squares of the visited observations, their count, env
    steps).  ``obs_stats = (mean, std)`` normalises the observations;
    ``track_obs`` accumulates their moments (float64, on the host)."""
    dev = tree_leaves(params)[0].device
    total = 0.0
    s, s2 = np.zeros(obs_dim), np.zeros(obs_dim)
    n = env_steps = 0
    for ep in range(episodes):
        env = make_env(env_name, seed=seed + ep)
        obs = env.reset()
        for _ in range(max_steps):
            o = np.asarray(obs, np.float64)
            if track_obs:
                s += o
                s2 += o * o
                n += 1
            if obs_stats is not None:
                mean, std = obs_stats
                o = (o - mean) / std
            x = torch.as_tensor(o.astype(np.float32)[None]).to(dev)
            logits, _ = policy_forward(params, x)
            obs, rew, done, _ = env.step(int(logits[0].argmax()))
            total += rew
            env_steps += 1
            if done:
                break
    return total / episodes, s, s2, n, env_steps


def _centered_ranks(x: np.ndarray) -> np.ndarray:
    """Fitness shaping: map returns to [-0.5, 0.5] by rank."""
    ranks = np.empty(len(x), dtype=np.float32)
    ranks[x.argsort()] = np.arange(len(x), dtype=np.float32)
    return ranks / (len(x) - 1) - 0.5


class ES(Algorithm):
    _default_config = ESConfig

    def _build(self):
        cfg = self.config
        self.device = resolve_device(cfg.device)
        probe = make_env(cfg.env, seed=cfg.seed)
        probe.reset()
        self.pcfg = PolicyConfig(obs_dim=probe.observation_dim,
                                 num_actions=probe.num_actions,
                                 hiddens=tuple(cfg.hiddens))
        self.theta, self.spec = flatten(
            init_policy_params(self.pcfg, cfg.seed, device=self.device))
        self._gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 11)
        # the shared observation filter's moments (ARS V2 MeanStdFilter)
        self._obs_sum = np.zeros(self.pcfg.obs_dim)
        self._obs_sq = np.zeros(self.pcfg.obs_dim)
        self._obs_n = 0

    def _obs_stats(self):
        if self.config.observation_filter != "MeanStdFilter" \
                or self._obs_n < 2:
            return None
        mean = self._obs_sum / self._obs_n
        var = np.maximum(self._obs_sq / self._obs_n - mean * mean, 0.0)
        return mean, np.sqrt(var) + 1e-8

    def _evaluate(self, candidates) -> np.ndarray:
        cfg = self.config
        track = cfg.observation_filter == "MeanStdFilter"
        stats = self._obs_stats()
        args = [(cfg.env, unflatten(c, self.spec), self.pcfg.obs_dim,
                 cfg.seed + 7919 * self.iteration + i,
                 cfg.episodes_per_eval, cfg.max_episode_steps, stats, track)
                for i, c in enumerate(candidates)]
        if cfg.eval_parallelism > 0:
            task = actors.remote(rollout_return)
            outs = actors.get([task.remote(*a) for a in args], timeout=1200)
        else:
            outs = [rollout_return(*a) for a in args]
        if track:
            for _, s, s2, n, _ in outs:
                self._obs_sum += s
                self._obs_sq += s2
                self._obs_n += n
        self._env_steps_last_eval = sum(es for *_, es in outs)
        return np.asarray([r for r, *_ in outs], np.float32)

    def iterate(self, eps: Optional[np.ndarray] = None) -> dict:
        """One iteration with the perturbations ``eps`` [pop, dim] (a
        standard normal draw; drawn from the generator when None)."""
        cfg = self.config
        P, dim = cfg.pop_size, self.theta.shape[0]
        eps = (torch.randn((P, dim), generator=self._gen,
                           device=self.device) if eps is None
               else torch.as_tensor(np.array(eps, np.float32)).to(
                   self.device))
        cands = torch.cat([self.theta + cfg.sigma * eps,
                           self.theta - cfg.sigma * eps])
        returns = self._evaluate(cands)
        pos, neg = returns[:P], returns[P:]
        shaped = _centered_ranks(returns)
        pairs = np.stack([shaped[:P], shaped[P:]], axis=1)
        eps_used, pairs = self._select_directions(eps, pairs, pos, neg)
        f = torch.as_tensor(pairs[:, 0] - pairs[:, 1]).to(self.device)
        grad = (f @ eps_used) / (eps_used.shape[0] * cfg.sigma)
        self.theta = self.theta + cfg.step_size * grad
        # env steps actually taken (episodes that end early count theirs)
        steps = int(self._env_steps_last_eval)
        self._timesteps += steps
        self._ep_returns.extend(returns.tolist())
        return {"steps_this_iter": steps,
                "pop_return_mean": float(returns.mean()),
                "pop_return_max": float(returns.max())}

    def training_step(self) -> dict:
        return self.iterate()

    def _select_directions(self, eps, pairs, pos, neg):
        return eps, pairs  # plain ES: all directions

    def save_checkpoint(self) -> dict:
        return {"theta": to_numpy(self.theta),
                "timesteps": self._timesteps,
                "obs_sum": np.copy(self._obs_sum),
                "obs_sq": np.copy(self._obs_sq),
                "obs_n": self._obs_n}

    def load_checkpoint(self, ck):
        self.theta = torch.as_tensor(np.array(ck["theta"], np.float32)
                                     ).to(self.device)
        self._timesteps = ck.get("timesteps", 0)
        self._obs_sum = np.copy(ck.get("obs_sum",
                                       np.zeros(self.pcfg.obs_dim)))
        self._obs_sq = np.copy(ck.get("obs_sq",
                                      np.zeros(self.pcfg.obs_dim)))
        self._obs_n = ck.get("obs_n", 0)

    def get_policy_params(self):
        return unflatten(self.theta, self.spec)


class ARS(ES):
    """ES with the top-k directions, their raw returns scaled by the
    std of the selected returns."""

    _default_config = ARSConfig

    def _select_directions(self, eps, pairs, pos, neg):
        k = min(self.config.top_directions, len(pos))
        idx = np.argsort(-np.maximum(pos, neg))[:k]
        std = np.concatenate([pos[idx], neg[idx]]).std() + 1e-8
        raw = np.stack([pos[idx], neg[idx]], axis=1) / std
        return eps[torch.as_tensor(idx).to(eps.device)], raw
