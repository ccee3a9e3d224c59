"""DT: the Decision Transformer, offline RL as sequence modelling, the
port of ``ray_tpu/rllib/dt.py``: ``DTConfig``, ``segment_episodes``,
``init_dt_params``, ``dt_forward`` and ``DT``.

Trajectories become interleaved (return-to-go, state, action) tokens, 3K
of them for a context of K states; a causal pre-LN transformer predicts
the action at each state token.  The numerics follow the JAX code:
attention is plain ``matmul`` and softmax with scores masked to -1e9
(not SDPA, which the JAX package does not use either), ``gelu`` is the
tanh form, LayerNorm takes the population variance with eps 1e-5, and
AdamW decays every leaf, embeddings and LayerNorms included.  The params
keep the JAX layout (``layers`` a list), so a JAX save restores leaf by
leaf.  Segments are the JAX package's numpy draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.data.feed import to_device
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.offline import JsonReader
from ray_tpu_torch.rllib.optim import Adam, copy_into, params_on, to_numpy


@dataclass
class DTConfig(AlgorithmConfig):
    input_path: str = ""
    context_len: int = 20           # K state tokens (3K transformer slots)
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    target_return: float = 400.0    # eval conditioning
    batch_size: int = 64
    grad_steps_per_iter: int = 100
    lr: float = 1e-3
    weight_decay: float = 1e-4
    max_episode_steps: int = 500

    def build(self, algo_cls=None) -> "DT":
        return DT({"_config": self})


def segment_episodes(data: dict) -> List[dict]:
    """Flat (obs, actions, rewards, dones) columns -> per-episode dicts
    with returns-to-go."""
    obs = np.asarray(data["obs"], np.float32)
    acts = np.asarray(data["actions"], np.int64)
    rews = np.asarray(data["rewards"], np.float32)
    dones = np.asarray(data["dones"], np.float32)
    episodes, start = [], 0
    for i in range(len(rews)):
        if dones[i] > 0.5 or i == len(rews) - 1:
            r = rews[start:i + 1]
            rtg = np.cumsum(r[::-1])[::-1].astype(np.float32)
            episodes.append({"obs": obs[start:i + 1],
                             "actions": acts[start:i + 1],
                             "rtg": rtg,
                             "timesteps": np.arange(i + 1 - start)})
            start = i + 1
    return episodes


def init_dt_params(cfg: DTConfig, obs_dim: int, num_actions: int,
                   seed: int = 0, *, max_timestep: int = 4096, device=None,
                   generator: Optional[torch.Generator] = None) -> dict:
    """The JAX package's tree: He-normal dense layers (N(0, 0.01) for
    the head and each block's output projections), N(0, 0.02) action
    (with a padding row) and timestep embeddings, unit LayerNorms."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    d = cfg.d_model

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=dev) * scale

    def dense(i, o, scale=None):
        return {"w": normal((i, o), math.sqrt(2.0 / i) if scale is None
                            else scale),
                "b": torch.zeros(o, device=dev)}

    def ln():
        return {"scale": torch.ones(d, device=dev),
                "bias": torch.zeros(d, device=dev)}

    params = {"emb_rtg": dense(1, d), "emb_obs": dense(obs_dim, d),
              "emb_act": normal((num_actions + 1, d), 0.02),
              "emb_t": normal((max_timestep, d), 0.02),
              "head": dense(d, num_actions, scale=0.01),
              "ln_f": ln(), "layers": []}
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "ln1": ln(), "qkv": dense(d, 3 * d),
            "proj": dense(d, d, scale=0.01), "ln2": ln(),
            "up": dense(d, 4 * d), "down": dense(4 * d, d, scale=0.01)})
    return params


def _ln(x, p):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    return (x - mu) / torch.sqrt(var + 1e-5) * p["scale"] + p["bias"]


def _dense(p, x):
    return x @ p["w"] + p["b"]


def dt_forward(params, cfg: DTConfig, rtg, obs, actions, timesteps):
    """rtg [B, K], obs [B, K, O], actions [B, K] (shifted: a_{t-1} feeds
    slot t; index num_actions = pad), timesteps [B, K] -> action logits
    at each state token [B, K, A]."""
    B, K = rtg.shape
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    t_emb = params["emb_t"][timesteps]
    e_rtg = _dense(params["emb_rtg"], rtg[..., None]) + t_emb
    e_obs = _dense(params["emb_obs"], obs) + t_emb
    e_act = params["emb_act"][actions] + t_emb
    T = 3 * K
    x = torch.stack([e_rtg, e_obs, e_act], dim=2).reshape(B, T, d)
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                 device=x.device))
    for lp in params["layers"]:
        y = _ln(x, lp["ln1"])
        qkv = _dense(lp["qkv"], y).reshape(B, T, 3, h, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        att = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        att = torch.softmax(torch.where(mask, att, -1e9), dim=-1)
        o = torch.matmul(att, v).transpose(1, 2).reshape(B, T, d)
        x = x + _dense(lp["proj"], o)
        y = _ln(x, lp["ln2"])
        x = x + _dense(lp["down"], F.gelu(_dense(lp["up"], y),
                                          approximate="tanh"))
    x = _ln(x, params["ln_f"])
    return _dense(params["head"], x.reshape(B, K, 3, d)[:, :, 1])


def dt_loss(params, cfg: DTConfig, batch):
    """Masked mean negative log-likelihood of the logged actions."""
    logits = dt_forward(params, cfg, batch["rtg"], batch["obs"],
                        batch["prev_actions"], batch["timesteps"])
    gold = torch.log_softmax(logits, dim=-1).gather(
        2, batch["actions"][..., None])[..., 0]
    mask = batch["mask"]
    return -(gold * mask).sum() / torch.clamp(mask.sum(), min=1.0)


class DT(Algorithm):
    _default_config = DTConfig

    def _build(self):
        cfg = self.config
        if not cfg.input_path:
            raise ValueError("DT requires config.input_path offline data")
        self.device = resolve_device(cfg.device)
        data = JsonReader(cfg.input_path).read_all()
        self.episodes = segment_episodes(data)
        if not self.episodes:
            raise ValueError("no episodes in offline data")
        self.obs_dim = self.episodes[0]["obs"].shape[1]
        self.num_actions = int(max(e["actions"].max()
                                   for e in self.episodes)) + 1
        # the timestep table covers the data and the eval horizon
        max_t = max(max(len(e["actions"]) for e in self.episodes),
                    cfg.max_episode_steps) + 1
        self.params = params_on(
            init_dt_params(cfg, self.obs_dim, self.num_actions, cfg.seed,
                           max_timestep=max(4096, max_t),
                           device=self.device), self.device)
        self.opt = Adam(self.params, cfg.lr, weight_decay=cfg.weight_decay)
        self._rng = np.random.default_rng(cfg.seed)
        # episodes sampled in proportion to their length
        lens = np.asarray([len(e["actions"]) for e in self.episodes],
                          np.float64)
        self._ep_p = lens / lens.sum()

    def _sample_batch(self) -> dict:
        cfg = self.config
        K, B = cfg.context_len, cfg.batch_size
        rtg = np.zeros((B, K), np.float32)
        obs = np.zeros((B, K, self.obs_dim), np.float32)
        acts = np.zeros((B, K), np.int64)
        prev = np.full((B, K), self.num_actions, np.int64)  # pad token
        ts = np.zeros((B, K), np.int64)
        mask = np.zeros((B, K), np.float32)
        idx = self._rng.choice(len(self.episodes), B, p=self._ep_p)
        for b, ei in enumerate(idx):
            ep = self.episodes[ei]
            L = len(ep["actions"])
            s = int(self._rng.integers(0, max(1, L - 1)))
            e = min(L, s + K)
            n = e - s
            rtg[b, :n] = ep["rtg"][s:e]
            obs[b, :n] = ep["obs"][s:e]
            acts[b, :n] = ep["actions"][s:e]
            if s > 0:
                prev[b, 0] = ep["actions"][s - 1]
            prev[b, 1:n] = ep["actions"][s:e - 1]
            ts[b, :n] = ep["timesteps"][s:e]
            mask[b, :n] = 1.0
        return {"rtg": rtg, "obs": obs, "actions": acts,
                "prev_actions": prev, "timesteps": ts, "mask": mask}

    def update(self, batch) -> torch.Tensor:
        """One AdamW step on ``batch`` (tensors on the device) -> the
        loss, 0-d."""
        loss = dt_loss(self.params, self.config, batch)
        self.opt.minimize(loss)
        return loss.detach()

    def training_step(self) -> dict:
        cfg = self.config
        losses = [self.update(to_device(self._sample_batch(), self.device))
                  for _ in range(cfg.grad_steps_per_iter)]
        self._timesteps += cfg.grad_steps_per_iter
        # the mean read once an iteration (no sync per update)
        return {"steps_this_iter": cfg.grad_steps_per_iter,
                "loss": float(torch.stack(losses).mean())}

    @torch.no_grad()
    def evaluate(self, env_name: Optional[str] = None,
                 num_episodes: int = 5,
                 target_return: Optional[float] = None) -> float:
        """Mean return of greedy episodes conditioned on a target return,
        the model unrolled one step at a time."""
        cfg = self.config
        K = cfg.context_len
        tgt = (target_return if target_return is not None
               else cfg.target_return)
        total = 0.0
        for ep_i in range(num_episodes):
            env = make_env(env_name or cfg.env, seed=cfg.seed + ep_i)
            o = env.reset()
            rtg_hist = [tgt]
            obs_hist = [np.asarray(o, np.float32)]
            act_hist: List[int] = []
            ret = 0.0
            for t in range(cfg.max_episode_steps):
                n = min(len(obs_hist), K)
                rtg = np.zeros((1, K), np.float32)
                obs = np.zeros((1, K, self.obs_dim), np.float32)
                prev = np.full((1, K), self.num_actions, np.int64)
                ts = np.zeros((1, K), np.int64)
                rtg[0, :n] = rtg_hist[-n:]
                obs[0, :n] = np.stack(obs_hist[-n:])
                prev[0, :n] = ([self.num_actions] + act_hist)[-n:]
                ts[0, :n] = np.arange(max(0, t - n + 1), t + 1)[:n]
                x = to_device({"rtg": rtg, "obs": obs, "prev": prev,
                               "ts": ts}, self.device)
                logits = dt_forward(self.params, cfg, x["rtg"], x["obs"],
                                    x["prev"], x["ts"])
                a = int(logits[0, n - 1].argmax())
                o, r, done, _ = env.step(a)
                ret += r
                act_hist.append(a)
                obs_hist.append(np.asarray(o, np.float32))
                rtg_hist.append(rtg_hist[-1] - r)
                if done:
                    break
            total += ret
        return total / num_episodes

    def save_checkpoint(self) -> dict:
        return to_numpy({"params": self.params,
                         "opt_state": self.opt.state(),
                         "timesteps": self._timesteps})

    def load_checkpoint(self, ck):
        """A port save, or the JAX package's (optax state bridged)."""
        copy_into(self.params, ck["params"])
        self.opt.load(ck["opt_state"])
        self._timesteps = ck.get("timesteps", 0)
