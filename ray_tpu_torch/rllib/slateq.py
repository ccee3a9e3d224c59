"""SlateQ: Q-learning for slate recommendation, the port of
``ray_tpu/rllib/slateq.py``: ``InterestEvolution``, ``SlateQConfig``,
``enumerate_slates``, ``init_slateq_params``, ``q_values``,
``choice_scores``, ``make_slateq_fns`` and ``SlateQ``.

Per-item Q-values are combined through a learned conditional choice
model: a slate's value is the choice-weighted mean of its items' Q, the
target maximises it over every enumerated slate (a precomputed [A, S]
index array on the device), the TD loss counts clicked items only, and
the choice model trains by cross-entropy on the observed clicks.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.data.feed import to_device
from ray_tpu_torch.models.zoo import _dense, _dense_init
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.optim import Adam, copy_into, params_on, to_numpy
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class InterestEvolution:
    """RecSim-lite: a user with a hidden interest vector receives a slate
    of S documents from C candidates, clicks one (or none) by a softmax
    choice model over interest . doc scores, earns watch-time reward for
    the click, and the interest drifts toward clicked docs."""

    def __init__(self, num_candidates: int = 8, slate_size: int = 2,
                 embedding_dim: int = 4, episode_len: int = 20,
                 seed: Optional[int] = None):
        self.C, self.S, self.E = num_candidates, slate_size, embedding_dim
        self.episode_len = episode_len
        self.rng = np.random.default_rng(seed)
        self.no_click_score = 1.0

    def reset(self):
        self.user = self.rng.normal(size=self.E).astype(np.float32)
        self.user /= np.linalg.norm(self.user) + 1e-8
        self.docs = self.rng.normal(
            size=(self.C, self.E)).astype(np.float32)
        self.docs /= (np.linalg.norm(self.docs, axis=1, keepdims=True)
                      + 1e-8)
        # hidden per-doc quality drives watch time (not observed)
        self.quality = self.rng.uniform(0.2, 1.0, self.C).astype(
            np.float32)
        self.t = 0
        return self._obs()

    def _obs(self):
        return {"user": self.user.copy(), "doc": self.docs.copy()}

    def step(self, slate):
        """slate: S candidate indices -> (obs, reward, done, info); info
        carries the click position (S for no click)."""
        slate = np.asarray(slate, np.int64)
        scores = np.exp(self.docs[slate] @ self.user)
        probs = np.concatenate(
            [scores, [self.no_click_score]]).astype(np.float64)
        probs /= probs.sum()
        choice = int(self.rng.choice(self.S + 1, p=probs))
        reward, clicked_doc = 0.0, -1
        if choice < self.S:
            clicked_doc = int(slate[choice])
            reward = float(self.quality[clicked_doc]
                           * (1.0 + 0.2 * self.rng.standard_normal()))
            self.user = 0.9 * self.user + 0.1 * self.docs[clicked_doc]
            self.user /= np.linalg.norm(self.user) + 1e-8
        self.t += 1
        done = self.t >= self.episode_len
        return self._obs(), reward, done, {"click": choice,
                                           "clicked_doc": clicked_doc}


@dataclass
class SlateQConfig(AlgorithmConfig):
    env: object = InterestEvolution
    num_candidates: int = 8
    slate_size: int = 2
    embedding_dim: int = 4
    episode_len: int = 20
    buffer_size: int = 20_000
    learning_starts: int = 500
    batch_size: int = 64
    target_update_freq: int = 500
    train_intensity: float = 0.25
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_steps: int = 3_000
    gamma: float = 0.95
    lr: float = 1e-3

    def build(self, algo_cls=None) -> "SlateQ":
        return SlateQ({"_config": self})


def enumerate_slates(num_candidates: int, slate_size: int) -> np.ndarray:
    """[A, S] array of all ordered candidate slates."""
    return np.asarray(list(itertools.permutations(range(num_candidates),
                                                  slate_size)),
                      np.int32)


def init_slateq_params(embed: int, hiddens, seed: int = 0, *, device=None,
                       generator: Optional[torch.Generator] = None) -> dict:
    """The per-item Q-net over [user ++ doc] and the choice model's
    scale and shift (1 and 0), drawn from a ``torch.Generator``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    h = hiddens[0]
    return {"q0": _dense_init(generator, 2 * embed, h),
            "q1": _dense_init(generator, h, h),
            "q2": _dense_init(generator, h, 1, scale=0.01),
            "choice_a": torch.ones((), device=dev),
            "choice_b": torch.zeros((), device=dev)}


def q_values(params, user, docs):
    """user [B, E], docs [B, C, E] -> Q [B, C]."""
    B, C, E = docs.shape
    x = torch.cat([user[:, None, :].expand(B, C, E), docs], dim=-1)
    x = F.relu(_dense(params["q0"], x))
    x = F.relu(_dense(params["q1"], x))
    return _dense(params["q2"], x)[..., 0]


def choice_scores(params, user, docs):
    """Unnormalised click scores per doc [B, C] (no-click scores 1)."""
    dot = torch.einsum("be,bce->bc", user, docs)
    return torch.exp(params["choice_a"] * dot + params["choice_b"])


def make_slateq_fns(cfg: SlateQConfig, slates: np.ndarray, device):
    """-> ``(best_slate, update)``.  ``best_slate(params, user, docs)``
    -> [B, S] slates; ``update(params, target_params, opt, batch)``: one
    step of ``opt`` on the click-masked TD loss plus the choice model's
    cross-entropy -> ``(params, opt, q loss, choice loss)``."""
    S = slates.shape[1]
    slates_t = torch.as_tensor(slates, dtype=torch.long, device=device)

    def slate_decomposition(params, user, docs):
        """Choice-weighted slate values [B, A] from per-item Q."""
        q = q_values(params, user, docs)[:, slates_t]        # [B, A, S]
        sc = choice_scores(params, user, docs)[:, slates_t]  # [B, A, S]
        return (q * sc).sum(-1) / (sc.sum(-1) + 1.0)

    @torch.no_grad()
    def best_slate(params, user, docs):
        return slates_t[slate_decomposition(params, user, docs)
                        .argmax(dim=-1)]

    def update(params, target_params, opt, batch):
        user, docs = batch["user"], batch["doc"]
        actions, click = batch["actions"].long(), batch["click"].long()
        B = user.shape[0]
        with torch.no_grad():
            next_q_max = slate_decomposition(
                target_params, batch["next_user"], batch["next_doc"]
            ).max(dim=-1).values
            target = batch["rewards"] + cfg.gamma * (
                1.0 - batch["dones"]) * next_q_max
        slate_q = q_values(params, user, docs).gather(1, actions)  # [B, S]
        clicked = click < S
        replay_click_q = slate_q.gather(
            1, click.clamp(0, S - 1)[:, None])[:, 0]
        td = torch.where(clicked, replay_click_q - target,
                         torch.zeros_like(target))
        q_loss = (td ** 2).sum() / torch.clamp(clicked.float().sum(),
                                               min=1.0)
        # the choice model's cross-entropy on the observed click
        # positions, no click being class S with logit 0
        slate_sc = choice_scores(params, user, docs).gather(1, actions)
        logits = torch.cat([torch.log(slate_sc + 1e-8),
                            torch.zeros((B, 1), device=user.device)], dim=1)
        choice_loss = -torch.log_softmax(logits, dim=-1).gather(
            1, click[:, None]).mean()
        opt.minimize(q_loss + choice_loss)
        return params, opt, q_loss.detach(), choice_loss.detach()

    return best_slate, update


class SlateQ(Algorithm):
    _default_config = SlateQConfig

    def _build(self):
        cfg = self.config
        self.device = dev = resolve_device(cfg.device)
        if isinstance(cfg.env, type):
            self.env = cfg.env(num_candidates=cfg.num_candidates,
                               slate_size=cfg.slate_size,
                               embedding_dim=cfg.embedding_dim,
                               episode_len=cfg.episode_len,
                               seed=cfg.seed)
        else:
            self.env = cfg.env
        self.slates = enumerate_slates(self.env.C, self.env.S)
        params = init_slateq_params(self.env.E, cfg.hiddens, cfg.seed,
                                    device=dev)
        self.params = params_on(params, dev)
        self.target_params = params_on(params, dev, grad=False)
        self.opt = Adam(self.params, cfg.lr)
        self._best_slate, self._update = make_slateq_fns(cfg, self.slates,
                                                         dev)
        self.buffer = ReplayBuffer(cfg.buffer_size, seed=cfg.seed)
        self._rng = np.random.default_rng(cfg.seed + 1)
        self._obs = self.env.reset()
        self._since_target_sync = 0
        self._grad_debt = 0.0
        self._ep_rew = 0.0

    @property
    def epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._timesteps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_start + frac * (cfg.epsilon_end
                                           - cfg.epsilon_start)

    def _act(self, obs) -> np.ndarray:
        if self._rng.random() < self.epsilon:
            return self._rng.choice(self.env.C, self.env.S,
                                    replace=False).astype(np.int64)
        x = to_device({"user": obs["user"][None], "doc": obs["doc"][None]},
                      self.device)
        out = self._best_slate(self.params, x["user"], x["doc"])
        return out[0].cpu().numpy().astype(np.int64)

    def training_step(self) -> dict:
        cfg = self.config
        steps, q_losses, c_losses = 0, [], []
        for _ in range(cfg.rollout_length):
            obs = self._obs
            slate = self._act(obs)
            nobs, rew, done, info = self.env.step(slate)
            self.buffer.add(SampleBatch({
                "user": obs["user"][None], "doc": obs["doc"][None],
                "next_user": nobs["user"][None],
                "next_doc": nobs["doc"][None],
                "actions": slate.astype(np.int64)[None],
                "click": np.asarray([info["click"]], np.int64),
                "rewards": np.asarray([rew], np.float32),
                "dones": np.asarray([float(done)], np.float32)}))
            self._ep_rew += rew
            self._obs = self.env.reset() if done else nobs
            if done:
                self._ep_returns.append(self._ep_rew)
                self._ep_rew = 0.0
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
                _, _, ql, cl = self._update(
                    self.params, self.target_params, self.opt,
                    to_device(dict(batch), self.device))
                q_losses.append(ql)
                c_losses.append(cl)
            if self._since_target_sync >= cfg.target_update_freq:
                copy_into(self.target_params, self.params)
                self._since_target_sync = 0

        return {"steps_this_iter": steps,
                "epsilon": self.epsilon,
                "replay_size": len(self.buffer),
                "mean_q_loss": (float(torch.stack(q_losses).mean())
                                if q_losses else 0.0),
                "mean_choice_loss": (float(torch.stack(c_losses).mean())
                                     if c_losses else 0.0)}

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
