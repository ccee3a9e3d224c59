"""RolloutWorker: env sampling with a local policy copy, the port of
``ray_tpu/rllib/rollout_worker.py``.  It samples inline; its policy runs
on the worker's ``device`` (None = the CUDA card), the envs on the host.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np

from ray_tpu_torch.rllib import sample_batch as SB
from ray_tpu_torch.rllib.env import VectorEnv
from ray_tpu_torch.rllib.policy import PolicyConfig, TorchPolicy, compute_gae
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class RolloutWorker:
    def __init__(self, env: Union[str, Callable], *, num_envs: int = 4,
                 rollout_length: int = 64, gamma: float = 0.99,
                 lam: float = 0.95, seed: int = 0,
                 hiddens: tuple = (64, 64), device=None):
        self.vec = VectorEnv(env, num_envs, seed=seed)
        self.cfg = PolicyConfig(obs_dim=self.vec.observation_dim,
                                num_actions=self.vec.num_actions,
                                hiddens=tuple(hiddens))
        self.policy = TorchPolicy(self.cfg, seed=seed, device=device)
        self.rollout_length = rollout_length
        self.gamma, self.lam = gamma, lam
        self._obs = self.vec.reset()
        # episode-return bookkeeping
        self._ep_rew = np.zeros(num_envs, np.float32)
        self._completed: list[float] = []

    def set_weights(self, weights) -> None:
        self.policy.set_weights(weights)

    def get_weights(self):
        return self.policy.get_weights()

    def sample(self) -> SampleBatch:
        """One rollout of T×B steps with GAE advantages, flattened
        [T*B, ...] (time-major order preserved for vtrace learners via
        split_time_major)."""
        T, B = self.rollout_length, self.vec.num_envs
        obs_buf = np.empty((T, B, self.cfg.obs_dim), np.float32)
        act_buf = np.empty((T, B), np.int64)
        logp_buf = np.empty((T, B), np.float32)
        vf_buf = np.empty((T, B), np.float32)
        rew_buf = np.empty((T, B), np.float32)
        done_buf = np.empty((T, B), bool)
        logits_buf = np.empty((T, B, self.cfg.num_actions), np.float32)

        for t in range(T):
            actions, logp, value, logits = self.policy.compute_actions(
                self._obs)
            obs_buf[t] = self._obs
            act_buf[t], logp_buf[t], vf_buf[t] = actions, logp, value
            logits_buf[t] = logits
            self._obs, rew, done = self.vec.step(actions)
            rew_buf[t], done_buf[t] = rew, done
            self._ep_rew += rew
            for i in np.nonzero(done)[0]:
                self._completed.append(float(self._ep_rew[i]))
                self._ep_rew[i] = 0.0

        _, _, last_value, _ = self.policy.compute_actions(self._obs)
        adv, vtarg = compute_gae(rew_buf, vf_buf, done_buf, last_value,
                                 gamma=self.gamma, lam=self.lam)

        def flat(x):
            return x.reshape(T * B, *x.shape[2:])

        return SampleBatch({
            SB.OBS: flat(obs_buf), SB.ACTIONS: flat(act_buf),
            SB.LOGP: flat(logp_buf), SB.VF_PREDS: flat(vf_buf),
            SB.REWARDS: flat(rew_buf), SB.DONES: flat(done_buf),
            SB.ADVANTAGES: flat(adv), SB.VALUE_TARGETS: flat(vtarg),
            SB.LOGITS: flat(logits_buf),
            # successor state after the last step — the V-trace/GAE
            # bootstrap state s_T (NOT the obs the last action was taken
            # from); [B, obs_dim]
            "bootstrap_obs": np.array(self._obs, np.float32),
        })

    def episode_returns(self, clear: bool = True) -> list[float]:
        out = list(self._completed)
        if clear:
            self._completed.clear()
        return out
