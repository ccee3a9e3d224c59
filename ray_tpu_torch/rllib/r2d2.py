"""R2D2: recurrent replay DQN, the port of ``ray_tpu/rllib/r2d2.py``:
``R2D2Config``, the value rescaling ``_h``/``_h_inv``,
``init_r2d2_params``, ``q_seq``, ``_SeqBuffer``, ``make_r2d2_update`` and
``R2D2``.

An LSTM Q-network (``models/zoo.py``'s ``lstm_forward``, a Python loop
over time) trains on stored sequences: the burn-in prefix only advances
the recurrent state, under ``no_grad``; the online net selects the next
action and the target net evaluates it (double Q); the alive mask is
computed over the whole sequence and then sliced, since a padded row may
end inside the burn-in.  The sequence replay and exploration stay on the
host with the JAX package's numpy draws; the recurrent carry of the
acting envs stays on the learner's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.data.feed import to_device
from ray_tpu_torch.models.zoo import (LSTMNetConfig, _dense, _dense_init,
                                      lstm_forward, lstm_init,
                                      lstm_initial_state)
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.dqn import _NStepWindow  # noqa: F401 (as in JAX)
from ray_tpu_torch.rllib.env import VectorEnv
from ray_tpu_torch.rllib.optim import Adam, copy_into, params_on, to_numpy


@dataclass
class R2D2Config(AlgorithmConfig):
    buffer_size: int = 2_000          # stored sequences
    learning_starts: int = 32         # sequences before training
    batch_size: int = 16              # sequences per update
    seq_len: int = 16                 # replayed sequence length
    burn_in: int = 4                  # no-gradient prefix
    cell_size: int = 64
    target_update_freq: int = 400     # env steps
    train_intensity: float = 0.125    # grad steps per env step
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_steps: int = 10_000
    use_h_function: bool = True       # value rescaling h(x)
    gamma: float = 0.997
    lr: float = 1e-3

    def build(self, algo_cls=None) -> "R2D2":
        return R2D2({"_config": self})


# value rescaling (Pohlen et al.): h(x) = sign(x)(sqrt(|x|+1)-1) + eps·x
_H_EPS = 1e-3


def _h(x):
    return torch.sign(x) * (torch.sqrt(x.abs() + 1.0) - 1.0) + _H_EPS * x


def _h_inv(x):
    a = torch.sqrt(1.0 + 4.0 * _H_EPS * (x.abs() + 1.0 + _H_EPS))
    return torch.sign(x) * ((((a - 1.0) / (2.0 * _H_EPS)) ** 2) - 1.0)


def init_r2d2_params(obs_dim, num_actions, cell_size, seed: int = 0, *,
                     device=None,
                     generator: Optional[torch.Generator] = None):
    """-> (params, LSTMNetConfig): the LSTM and an N(0, 0.01) Q head,
    drawn from a ``torch.Generator`` on the target device."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    cfg = LSTMNetConfig(obs_dim, cell_size)
    return {"lstm": lstm_init(cfg, generator),
            "q": _dense_init(generator, cell_size, num_actions,
                             scale=0.01)}, cfg


def q_seq(params, lcfg, obs_seq, carry):
    """obs [B, T, D], carry -> (q [B, T, A], carry)."""
    ys, carry = lstm_forward(params["lstm"], obs_seq, carry, lcfg)
    return _dense(params["q"], ys), carry


class _SeqBuffer:
    """Uniform replay of fixed-length sequences with their stored initial
    recurrent state."""

    def __init__(self, capacity: int, seed: int):
        self.capacity = capacity
        self.rows: list = []
        self.pos = 0
        self.rng = np.random.default_rng(seed)

    def add(self, row: dict):
        if len(self.rows) < self.capacity:
            self.rows.append(row)
        else:
            self.rows[self.pos] = row
            self.pos = (self.pos + 1) % self.capacity

    def __len__(self):
        return len(self.rows)

    def sample(self, n: int) -> dict:
        idx = self.rng.integers(0, len(self.rows), n)
        return {k: np.stack([self.rows[i][k] for i in idx])
                for k in self.rows[0]}


def make_r2d2_update(cfg: R2D2Config, lcfg):
    """-> ``update(params, target_params, opt, batch)``: one step of
    ``opt`` (an ``optim.Adam`` over ``params``) on the masked sequence
    TD loss -> ``(params, opt, loss)``.  ``batch``: obs [B, T+1, D],
    actions, rewards, dones [B, T], the stored h0 and c0 [B, cell]."""
    burn = cfg.burn_in

    def full_q(p, obs, carry):
        if burn > 0:
            with torch.no_grad():
                _, carry = q_seq(p, lcfg, obs[:, :burn], carry)
        q, _ = q_seq(p, lcfg, obs[:, burn:], carry)
        return q                                # [B, T+1-burn, A]

    def update(params, target_params, opt, batch):
        obs, actions = batch["obs"], batch["actions"].long()
        rewards, dones = batch["rewards"], batch["dones"]
        h0 = (batch["h0"], batch["c0"])
        B, T = actions.shape
        tb = slice(burn, T)
        with torch.no_grad():
            q_t = full_q(target_params, obs, h0)
        q = full_q(params, obs, h0)
        q_taken = q[:, :-1].gather(2, actions[:, tb, None])[..., 0]
        with torch.no_grad():
            # double Q: the online net selects, the target evaluates
            sel = q[:, 1:].argmax(dim=-1)
            q_next = q_t[:, 1:].gather(2, sel[..., None])[..., 0]
            if cfg.use_h_function:
                target = _h(rewards[:, tb] + cfg.gamma
                            * (1.0 - dones[:, tb]) * _h_inv(q_next))
            else:
                target = rewards[:, tb] + cfg.gamma * (
                    1.0 - dones[:, tb]) * q_next
            alive_full = torch.cat(
                [torch.ones((B, 1), device=obs.device),
                 torch.cumprod(1.0 - dones, dim=1)[:, :-1]], dim=1)
            alive = alive_full[:, tb]
        td = q_taken - target
        loss = (alive * td ** 2).sum() / torch.clamp(alive.sum(), min=1.0)
        opt.minimize(loss)
        return params, opt, loss.detach()

    return update


class R2D2(Algorithm):
    _default_config = R2D2Config

    def _build(self):
        cfg = self.config
        self.device = dev = resolve_device(cfg.device)
        self.vec = VectorEnv(cfg.env, cfg.num_envs_per_worker,
                             seed=cfg.seed)
        self.obs_dim = self.vec.observation_dim
        self.num_actions = self.vec.num_actions
        params, self.lcfg = init_r2d2_params(
            self.obs_dim, self.num_actions, cfg.cell_size, cfg.seed,
            device=dev)
        self.params = params_on(params, dev)
        self.target_params = params_on(params, dev, grad=False)
        self.opt = Adam(self.params, cfg.lr)
        self._update = make_r2d2_update(cfg, self.lcfg)
        self.buffer = _SeqBuffer(cfg.buffer_size, cfg.seed)
        self._obs = self.vec.reset()
        self._carry = lstm_initial_state(self.lcfg, self.vec.num_envs,
                                         device=dev)
        self._rng = np.random.default_rng(cfg.seed + 1)
        self._ep_rew = np.zeros(self.vec.num_envs, np.float32)
        self._since_target_sync = 0
        self._grad_debt = 0.0
        # rolling per-env sequence accumulators (obs includes s_{t+T})
        self._acc = [self._fresh_acc() for _ in range(self.vec.num_envs)]

    def _fresh_acc(self, h0=None, c0=None) -> dict:
        z = np.zeros(self.config.cell_size, np.float32)
        return {"obs": [], "actions": [], "rewards": [], "dones": [],
                "h0": z if h0 is None else h0,
                "c0": z.copy() if c0 is None else c0}

    @property
    def epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._timesteps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_start + frac * (cfg.epsilon_end
                                           - cfg.epsilon_start)

    @torch.no_grad()
    def _qstep(self, obs) -> np.ndarray:
        """Greedy Q of one env step, advancing the carry on the device."""
        x = torch.as_tensor(np.asarray(obs, np.float32)).to(self.device)
        q, self._carry = q_seq(self.params, self.lcfg, x[:, None, :],
                               self._carry)
        return q[:, 0].cpu().numpy()

    def _flush_seq(self, e: int, next_obs_e, carry) -> None:
        cfg = self.config
        acc = self._acc[e]
        if len(acc["actions"]) < cfg.seq_len:
            return
        self.buffer.add({
            "obs": np.stack(acc["obs"] + [next_obs_e]),
            "actions": np.asarray(acc["actions"], np.int32),
            "rewards": np.asarray(acc["rewards"], np.float32),
            "dones": np.asarray(acc["dones"], np.float32),
            "h0": acc["h0"], "c0": acc["c0"]})
        # the next sequence starts from the CURRENT recurrent state
        self._acc[e] = self._fresh_acc(carry[0][e].copy(),
                                       carry[1][e].copy())

    def _flush_partial(self, e: int, next_obs_e) -> None:
        """Zero-pad a partial sequence to seq_len and store it at an
        episode's end; padded steps carry done=1, so the alive mask
        zeroes them.  A row no longer than the burn-in would train
        nothing and is not stored."""
        cfg = self.config
        acc = self._acc[e]
        n = len(acc["actions"])
        if n <= cfg.burn_in or n >= cfg.seq_len:
            return
        pad = cfg.seq_len - n
        self.buffer.add({
            "obs": np.stack(acc["obs"] + [next_obs_e] * (pad + 1)),
            "actions": np.asarray(acc["actions"] + [0] * pad, np.int32),
            "rewards": np.asarray(acc["rewards"] + [0.0] * pad, np.float32),
            "dones": np.asarray(acc["dones"] + [1.0] * pad, np.float32),
            "h0": acc["h0"], "c0": acc["c0"]})

    def training_step(self) -> dict:
        cfg = self.config
        B = self.vec.num_envs
        steps, losses = 0, []
        for _ in range(cfg.rollout_length):
            greedy = self._qstep(self._obs).argmax(axis=-1)
            explore = self._rng.random(B) < self.epsilon
            rand = self._rng.integers(0, self.num_actions, B)
            actions = np.where(explore, rand, greedy)
            next_obs, rew, done = self.vec.step(actions)
            carry = None
            for e in range(B):
                acc = self._acc[e]
                acc["obs"].append(np.asarray(self._obs[e], np.float32))
                acc["actions"].append(int(actions[e]))
                acc["rewards"].append(float(rew[e]))
                acc["dones"].append(float(done[e]))
                if len(acc["actions"]) >= cfg.seq_len and carry is None:
                    carry = [t.cpu().numpy() for t in self._carry]
                self._flush_seq(e, np.asarray(next_obs[e], np.float32),
                                carry)
                if done[e]:
                    self._flush_partial(e, np.asarray(next_obs[e],
                                                      np.float32))
                    self._acc[e] = self._fresh_acc()
            if done.any():
                keep = torch.as_tensor(~done, dtype=torch.float32).to(
                    self.device)[:, None]
                self._carry = tuple(t * keep for t in self._carry)
            self._ep_rew += rew
            for i in np.nonzero(done)[0]:
                self._ep_returns.append(float(self._ep_rew[i]))
                self._ep_rew[i] = 0.0
            self._obs = next_obs
            steps += B
            self._timesteps += B
            self._since_target_sync += B

            if len(self.buffer) < cfg.learning_starts:
                continue
            self._grad_debt += cfg.train_intensity * B
            while self._grad_debt >= 1.0:
                self._grad_debt -= 1.0
                batch = self.buffer.sample(cfg.batch_size)
                _, _, loss = self._update(self.params, self.target_params,
                                          self.opt,
                                          to_device(batch, self.device))
                losses.append(loss)
            if self._since_target_sync >= cfg.target_update_freq:
                copy_into(self.target_params, self.params)
                self._since_target_sync = 0

        return {"steps_this_iter": steps,
                "epsilon": self.epsilon,
                "buffer_sequences": len(self.buffer),
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
