"""Multi-agent environments and independent-learner PPO, the port of
``ray_tpu/rllib/multi_agent.py``: ``MultiAgentEnv``,
``MultiAgentCartPole``, ``MultiAgentRolloutWorker``,
``MultiAgentPPOConfig`` and ``MultiAgentPPO``.

Each policy owns its params and its Adam and trains on the concatenation
of its agents' trajectories with the port's ``make_ppo_update``.  The
worker's categorical draw is ``argmax(logits + g)`` with ``g`` Gumbel
noise, as ``jax.random.categorical`` draws it; the noise comes from a
``torch.Generator`` on the worker's device, or from ``gumbel_fn`` (one
call per draw, in the JAX worker's order of key splits), so a test can
feed JAX's.  ``MultiAgentPPO.perms_fn`` likewise hands the update each
epoch's permutation.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.data.feed import to_device
from ray_tpu_torch.rllib import sample_batch as SB
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.env import CartPole
from ray_tpu_torch.rllib.optim import Adam, copy_into, params_on, to_numpy
from ray_tpu_torch.rllib.policy import (PolicyConfig, compute_gae,
                                        init_policy_params, policy_forward)
from ray_tpu_torch.rllib.ppo import PPOConfig, make_ppo_update
from ray_tpu_torch.rllib.sample_batch import SampleBatch

TRAJ_KEYS = (SB.OBS, SB.ACTIONS, SB.LOGP, SB.ADVANTAGES, SB.VALUE_TARGETS,
             SB.VF_PREDS)


class MultiAgentEnv:
    """reset() -> {agent_id: obs}; step({agent_id: action}) -> (obs,
    rewards, dones, info) keyed by agent, dones also holding "__all__".
    Only agents present in the obs dict act on the next step."""

    agent_ids: list[str] = []

    def reset(self) -> dict:
        raise NotImplementedError

    def step(self, action_dict: dict):
        raise NotImplementedError


class MultiAgentCartPole(MultiAgentEnv):
    """N independent CartPoles, one per agent; the episode ends when every
    agent's pole has fallen."""

    def __init__(self, num_agents: int = 2, seed: Optional[int] = None):
        self.agent_ids = [f"agent_{i}" for i in range(num_agents)]
        self._envs = {aid: CartPole(seed=None if seed is None else seed + i)
                      for i, aid in enumerate(self.agent_ids)}
        self._done: dict[str, bool] = {}
        self.observation_dim = 4
        self.num_actions = 2

    def reset(self) -> dict:
        self._done = {aid: False for aid in self.agent_ids}
        return {aid: env.reset() for aid, env in self._envs.items()}

    def step(self, action_dict: dict):
        obs, rew, done = {}, {}, {}
        for aid, action in action_dict.items():
            if self._done.get(aid):
                continue
            o, r, d, _ = self._envs[aid].step(int(action))
            rew[aid] = r
            done[aid] = d
            self._done[aid] = d
            if not d:
                obs[aid] = o
        done["__all__"] = all(self._done.values())
        return obs, rew, done, {}


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(E)`` with E ~ Exp(1)."""
    e = torch.empty(shape, device=device).exponential_(generator=generator)
    return -torch.log(e)


class MultiAgentRolloutWorker:
    """Samples a MultiAgentEnv into per-POLICY batches with GAE; the
    policies act on ``device`` (None = the CUDA card)."""

    def __init__(self, env_maker: Callable[[], MultiAgentEnv],
                 policies: dict[str, PolicyConfig],
                 policy_mapping_fn: Callable[[str], str],
                 *, rollout_length: int = 256, gamma: float = 0.99,
                 lam: float = 0.95, seed: int = 0, device=None):
        self.env = env_maker()
        self.policies = policies
        self.map_fn = policy_mapping_fn
        self.rollout_length = rollout_length
        self.gamma, self.lam = gamma, lam
        self.device = resolve_device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # () -> Gumbel noise [num_actions] for the next draw; None draws
        # from the generator
        self.gumbel_fn: Optional[Callable[[], np.ndarray]] = None
        self._weights: dict[str, dict] = {}
        self._obs = self.env.reset()
        self._traj: dict[str, dict[str, list]] = {}
        self._ep_return: dict[str, float] = {}
        self.episode_returns_buf: list[float] = []

    @torch.no_grad()
    def _act(self, params, obs) -> tuple[int, float, float]:
        """One categorical draw -> (action, its log-probability, value)."""
        x = torch.as_tensor(np.asarray(obs, np.float32)).to(self.device)
        logits, value = policy_forward(params, x[None])
        logits = logits[0]
        g = (torch.as_tensor(np.array(self.gumbel_fn(), np.float32))
             .to(self.device) if self.gumbel_fn is not None
             else gumbel(logits.shape, self._gen, self.device))
        a = torch.argmax(logits + g)
        logp = torch.log_softmax(logits, dim=-1)[a]
        out = torch.stack([a.float(), logp, value[0]]).cpu().numpy()
        return int(out[0]), float(out[1]), float(out[2])

    def set_weights(self, weights: dict) -> None:
        self._weights = {pid: params_on(w, self.device, grad=False)
                         for pid, w in weights.items()}

    def _finish_trajectory(self, aid: str, last_value: float,
                           out: dict) -> None:
        traj = self._traj.pop(aid, None)
        if not traj or not traj["obs"]:
            return
        pid = self.map_fn(aid)
        rewards = np.asarray(traj["rew"], np.float32)
        values = np.asarray(traj["val"], np.float32)
        dones = np.asarray(traj["done"], bool)
        adv, vt = compute_gae(rewards, values, dones,
                              np.float32(last_value),
                              gamma=self.gamma, lam=self.lam)
        dst = out.setdefault(pid, {k: [] for k in TRAJ_KEYS})
        dst[SB.OBS].extend(traj["obs"])
        dst[SB.ACTIONS].extend(traj["act"])
        dst[SB.LOGP].extend(traj["logp"])
        dst[SB.ADVANTAGES].extend(adv.tolist())
        dst[SB.VALUE_TARGETS].extend(vt.tolist())
        dst[SB.VF_PREDS].extend(values.tolist())

    def sample(self) -> dict[str, SampleBatch]:
        """Collect ~rollout_length env steps -> per-policy SampleBatches."""
        out: dict[str, dict] = {}
        for _ in range(self.rollout_length):
            actions, step_meta = {}, {}
            for aid, obs in self._obs.items():
                a, logp, v = self._act(self._weights[self.map_fn(aid)], obs)
                actions[aid] = a
                step_meta[aid] = (obs, a, logp, v)
            nobs, rew, done, _ = self.env.step(actions)
            # rewards for agents that did not act this step go to their
            # latest recorded transition
            for aid, r in rew.items():
                if aid in step_meta:
                    continue
                traj = self._traj.get(aid)
                if traj and traj["rew"]:
                    traj["rew"][-1] += r
                self._ep_return[aid] = self._ep_return.get(aid, 0.0) + r
            for aid, (obs, a, logp, v) in step_meta.items():
                traj = self._traj.setdefault(
                    aid, {"obs": [], "act": [], "logp": [], "rew": [],
                          "val": [], "done": []})
                traj["obs"].append(obs)
                traj["act"].append(a)
                traj["logp"].append(logp)
                traj["rew"].append(rew.get(aid, 0.0))
                traj["val"].append(v)
                traj["done"].append(bool(done.get(aid, False)))
                self._ep_return[aid] = (self._ep_return.get(aid, 0.0)
                                        + rew.get(aid, 0.0))
                if done.get(aid, False):
                    self._finish_trajectory(aid, 0.0, out)
                    self.episode_returns_buf.append(
                        self._ep_return.pop(aid, 0.0))
            self._obs = nobs
            if done.get("__all__"):
                # an episode ended by "__all__" alone closes every
                # trajectory in flight, or GAE would run across the reset
                for aid in list(self._traj):
                    traj = self._traj[aid]
                    if traj["done"]:
                        traj["done"][-1] = True
                    self._finish_trajectory(aid, 0.0, out)
                    if aid in self._ep_return:
                        self.episode_returns_buf.append(
                            self._ep_return.pop(aid))
                self._obs = self.env.reset()
        # truncated trajectories bootstrap from V(s_t)
        for aid in list(self._traj):
            obs = self._obs.get(aid)
            if obs is not None:
                _, _, v = self._act(self._weights[self.map_fn(aid)], obs)
                self._finish_trajectory(aid, v, out)
            else:
                self._finish_trajectory(aid, 0.0, out)
        return {pid: SampleBatch({k: np.asarray(v)
                                  for k, v in cols.items()})
                for pid, cols in out.items()}

    def episode_returns(self, clear: bool = True) -> list[float]:
        out = list(self.episode_returns_buf)
        if clear:
            self.episode_returns_buf.clear()
        return out


@dataclass
class MultiAgentPPOConfig(PPOConfig):
    env_maker: Optional[Callable] = None        # () -> MultiAgentEnv
    policies: tuple = ("shared",)               # policy ids
    policy_mapping_fn: Optional[Callable] = None  # agent_id -> policy id

    def multi_agent(self, *, policies=None,
                    policy_mapping_fn=None) -> "MultiAgentPPOConfig":
        out = self
        if policies is not None:
            out = replace(out, policies=tuple(policies))
        if policy_mapping_fn is not None:
            out = replace(out, policy_mapping_fn=policy_mapping_fn)
        return out

    def build(self, algo_cls=None) -> "MultiAgentPPO":
        return MultiAgentPPO({"_config": self})


class MultiAgentPPO(Algorithm):
    """Independent PPO learners over a MultiAgentEnv.  Policy i's params
    come from a generator seeded ``seed * 1000 + i`` (the JAX package
    folds i into its key)."""

    _default_config = MultiAgentPPOConfig

    def _build(self):
        cfg = self.config
        self.device = dev = resolve_device(cfg.device)
        env_maker = cfg.env_maker or (
            cfg.env if callable(cfg.env) else None)
        if env_maker is None:
            raise ValueError("MultiAgentPPO needs env_maker=callable "
                             "returning a MultiAgentEnv")
        probe = env_maker()
        pcfg = PolicyConfig(obs_dim=probe.observation_dim,
                            num_actions=probe.num_actions,
                            hiddens=tuple(cfg.hiddens))
        self.map_fn = cfg.policy_mapping_fn or (lambda aid: cfg.policies[0])
        self.params: dict = {}
        self.opts: dict = {}
        for i, pid in enumerate(cfg.policies):
            self.params[pid] = params_on(init_policy_params(
                pcfg, cfg.seed * 1000 + i, device=dev), dev)
            self.opts[pid] = Adam(self.params[pid], cfg.lr)
        self._update = make_ppo_update(cfg)
        self._gen = torch.Generator(device=dev).manual_seed(cfg.seed + 7)
        # (policy id, rows) -> one permutation per epoch; None draws them
        # from the generator
        self.perms_fn: Optional[Callable[[str, int], list]] = None
        self.worker = MultiAgentRolloutWorker(
            env_maker, {pid: pcfg for pid in cfg.policies}, self.map_fn,
            rollout_length=cfg.rollout_length, gamma=cfg.gamma,
            lam=cfg.lam, seed=cfg.seed, device=dev)
        self._sync()

    def _sync(self):
        self.worker.set_weights(self.params)

    def training_step(self) -> dict:
        cfg = self.config
        # accumulate per policy until every policy has a train batch
        acc: dict[str, list[SampleBatch]] = {p: [] for p in cfg.policies}
        counts = {p: 0 for p in cfg.policies}
        steps = sweeps = 0
        while any(c < cfg.train_batch_size for c in counts.values()):
            batches = self.worker.sample()
            sweeps += 1
            self._ep_returns.extend(self.worker.episode_returns())
            for pid, b in batches.items():
                acc[pid].append(b)
                counts[pid] += b.count
                steps += b.count
            if sweeps >= 2:
                starved = [p for p, c in counts.items() if c == 0]
                if starved:
                    raise ValueError(
                        f"policies {starved} received no samples: "
                        "policy_mapping_fn maps no agent to them")
        metrics = {}
        for pid in cfg.policies:
            if not acc[pid]:
                continue
            batch = SampleBatch.concat_samples(acc[pid])
            n = (batch.count // cfg.minibatch_size) * cfg.minibatch_size
            if n == 0:
                continue
            tb = to_device({k: np.asarray(batch[k][:n]) for k in TRAJ_KEYS},
                           self.device)
            perms = self.perms_fn(pid, n) if self.perms_fn else None
            _, _, m = self._update(self.params[pid], self.opts[pid].opt, tb,
                                   perms=perms, generator=self._gen)
            metrics.update({f"{pid}/{k}": float(v) for k, v in m.items()})
        self._sync()
        self._timesteps += steps
        metrics["steps_this_iter"] = steps
        return metrics

    def save_checkpoint(self) -> dict:
        return to_numpy({"params": self.params,
                         "opt_state": {pid: o.state()
                                       for pid, o in self.opts.items()},
                         "timesteps": self._timesteps})

    def load_checkpoint(self, ck):
        """A port save, or the JAX package's (optax states bridged)."""
        for pid, p in ck["params"].items():
            copy_into(self.params[pid], p)
        for pid in self.params:
            if "opt_state" in ck:
                self.opts[pid].load(ck["opt_state"][pid])
            else:
                self.opts[pid] = Adam(self.params[pid], self.config.lr)
        self._timesteps = ck.get("timesteps", 0)
        self._sync()
