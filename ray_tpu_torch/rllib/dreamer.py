"""DreamerV1: world-model RL, the port of ``ray_tpu/rllib/dreamer.py``:
``LinearLatentEnv``, ``DreamerConfig``, the RSSM pieces (``_dense``,
``_mlp``, ``_gru``, ``_stats``, ``_img_step``, ``_obs_step``, ``_kl``),
``make_dreamer_update``, ``EpisodeBuffer`` and ``Dreamer``.

An RSSM world model (a GRU's deterministic path and a Gaussian latent),
observation and reward decoders, and an actor-critic trained on imagined
latent rollouts with lambda-returns.  The JAX package's three nested
``lax.scan``s (observe, imagine, lambda_returns) are loops over T and H.
The actor's gradient flows through the learned dynamics but is taken
over the actor's leaves only, so the model takes no update from it.  The
three optimizers are optax's ``chain(clip_by_global_norm, adam)``, here
``optim.Adam(..., clip_norm=)``.

Every Gaussian draw the JAX package makes inside its jitted update can
be passed in as ``eps``: ``{"observe": [T, B, S], "imagine_a": [H, N, A],
"imagine_s": [H, N, S]}`` (N = B * T); so can the two of
``policy_step``.  Without them the draws come from a ``torch.Generator``;
the exploration noise on an executed action is a numpy draw.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.data.feed import to_device
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.optim import (Adam, copy_into, params_on, to_numpy,
                                       tree_leaves)

MODEL_KEYS = ("encoder", "gru", "prior", "post", "obs_dec", "rew_dec")


class LinearLatentEnv:
    """Hidden linear dynamics observed through a random projection:
    x' = Ax + Ba + noise, obs = Cx, reward = -|x|^2 - 0.01|a|^2."""

    OBS_DIM, LATENT, ACT_DIM = 6, 2, 2
    HORIZON = 64

    def __init__(self, seed: Optional[int] = None):
        r = np.random.RandomState(0)   # fixed dynamics across instances
        self.A = np.eye(self.LATENT) * 0.9
        self.B = r.randn(self.LATENT, self.ACT_DIM) * 0.15
        self.C = r.randn(self.OBS_DIM, self.LATENT) * 0.5
        self.rng = np.random.RandomState(seed)
        self.observation_dim = self.OBS_DIM
        self.action_dim = self.ACT_DIM
        self.x = None
        self.t = 0

    def reset(self):
        self.x = (self.rng.randn(self.LATENT) * 0.7).astype(np.float32)
        self.t = 0
        return (self.C @ self.x).astype(np.float32)

    def step(self, action):
        a = np.clip(np.asarray(action, np.float32), -1.0, 1.0)
        noise = self.rng.randn(self.LATENT).astype(np.float32) * 0.01
        self.x = (self.A @ self.x + self.B @ a + noise).astype(np.float32)
        self.t += 1
        reward = float(-(self.x ** 2).sum() - 0.01 * (a ** 2).sum())
        done = self.t >= self.HORIZON
        return (self.C @ self.x).astype(np.float32), reward, done


@dataclass
class DreamerConfig(AlgorithmConfig):
    deter_size: int = 64                 # GRU state
    stoch_size: int = 8                  # stochastic latent
    hidden: int = 64                     # MLP width
    kl_coeff: float = 1.0
    free_nats: float = 1.0
    lambda_: float = 0.95
    imagine_horizon: int = 10
    gamma: float = 0.99
    model_lr: float = 3e-3
    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    grad_clip: float = 100.0
    batch_size: int = 16                 # sequences per update
    seq_len: int = 16
    buffer_episodes: int = 200
    prefill_episodes: int = 5
    model_warmup_updates: int = 40       # model-only updates before the
    #                                      actor trains on imagination
    train_iters_per_step: int = 10       # model updates per training_step
    episodes_per_step: int = 2
    explore_noise: float = 0.3

    def build(self, algo_cls=None) -> "Dreamer":
        return Dreamer({"_config": self})


def _dense(generator, nin, nout, scale=1.0) -> dict:
    """Glorot-uniform weights (times ``scale``), zero biases."""
    lim = scale * float(np.sqrt(6.0 / (nin + nout)))
    dev = generator.device
    w = torch.rand((nin, nout), generator=generator, device=dev)
    return {"w": w * (2 * lim) - lim, "b": torch.zeros(nout, device=dev)}


def _mlp(params, x):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = F.elu(x)
    return x


def init_dreamer_params(cfg: DreamerConfig, obs_dim: int, act_dim: int,
                        seed: int = 0, *, device=None,
                        generator: Optional[torch.Generator] = None) -> dict:
    dev = resolve_device(device)
    g = generator or torch.Generator(device=dev).manual_seed(int(seed))
    H, D, S = cfg.hidden, cfg.deter_size, cfg.stoch_size
    feat = D + S
    return {
        "encoder": [_dense(g, obs_dim, H), _dense(g, H, H)],
        # GRU cell: input [stoch + action] -> deter
        "gru": {"wi": _dense(g, S + act_dim, 3 * D),
                "wh": _dense(g, D, 3 * D)},
        # prior p(s|h) and posterior q(s|h, embed): mean and std heads
        "prior": [_dense(g, D, H), _dense(g, H, 2 * S)],
        "post": [_dense(g, D + H, H), _dense(g, H, 2 * S)],
        "obs_dec": [_dense(g, feat, H), _dense(g, H, obs_dim)],
        "rew_dec": [_dense(g, feat, H), _dense(g, H, 1)],
        # a small output head: actions start near tanh(0)
        "actor": [_dense(g, feat, H), _dense(g, H, H),
                  _dense(g, H, 2 * act_dim, scale=0.1)],
        "critic": [_dense(g, feat, H), _dense(g, H, 1)],
    }


def _gru(p, x, h):
    """GRU cell; the candidate's hidden part passes the reset gate."""
    xi = x @ p["wi"]["w"] + p["wi"]["b"]
    hh = h @ p["wh"]["w"] + p["wh"]["b"]
    D = h.shape[-1]
    r = torch.sigmoid(xi[..., :D] + hh[..., :D])
    z = torch.sigmoid(xi[..., D:2 * D] + hh[..., D:2 * D])
    n = torch.tanh(xi[..., 2 * D:] + r * hh[..., 2 * D:])
    return (1 - z) * n + z * h


def _stats(raw):
    S = raw.shape[-1] // 2
    return raw[..., :S], F.softplus(raw[..., S:]) + 0.1


def _img_step(p, stoch, deter, action):
    """Prior step: (s, h, a) -> (h', prior mean, prior std)."""
    h = _gru(p["gru"], torch.cat([stoch, action], -1), deter)
    mean, std = _stats(_mlp(p["prior"], h))
    return h, mean, std


def _obs_step(p, stoch, deter, action, embed):
    """Posterior step: the prior step, then condition on the embedding."""
    h, pmean, pstd = _img_step(p, stoch, deter, action)
    qmean, qstd = _stats(_mlp(p["post"], torch.cat([h, embed], -1)))
    return h, (pmean, pstd), (qmean, qstd)


def _kl(qm, qs, pm, ps):
    return (torch.log(ps / qs)
            + (qs ** 2 + (qm - pm) ** 2) / (2 * ps ** 2) - 0.5).sum(-1)


def make_dreamer_update(cfg: DreamerConfig, obs_dim: int, act_dim: int):
    """-> ``(update, observe, actor_sample)``.

    ``update(params, opts, batch, *, train_ac=True, eps=None,
    generator=None)`` steps ``opts`` (the ``optim.Adam``s ``model``,
    ``actor``, ``critic``) in place: the world model on its loss, then
    (unless in the warm-up, ``train_ac=False``) the actor on the
    imagined lambda-returns through the updated model, and the critic on
    them.  Returns the metrics as 0-d tensors."""
    H, D = cfg.imagine_horizon, cfg.deter_size

    def normal(shape, generator, device):
        return torch.randn(shape, generator=generator, device=device)

    def observe(p, obs_seq, act_seq, eps):
        """Posterior pass over [B, T, ...] -> features [T, B, feat] and
        KL [T, B].  The step into obs t is conditioned on a_{t-1}."""
        B, T = obs_seq.shape[:2]
        embed = _mlp(p["encoder"], obs_seq)              # [B, T, H]
        prev_act = torch.cat([torch.zeros_like(act_seq[:, :1]),
                              act_seq[:, :-1]], dim=1)
        stoch = obs_seq.new_zeros((B, cfg.stoch_size))
        deter = obs_seq.new_zeros((B, D))
        feats, kls = [], []
        for t in range(T):
            h, (pm, ps), (qm, qs) = _obs_step(p, stoch, deter,
                                              prev_act[:, t], embed[:, t])
            stoch, deter = qm + qs * eps[t], h
            feats.append(torch.cat([h, stoch], -1))
            kls.append(_kl(qm, qs, pm, ps))
        return torch.stack(feats), torch.stack(kls)

    def model_loss(p, batch, eps):
        obs, rew = batch["obs"], batch["rewards"]
        feats, kls = observe(p, obs, batch["actions"], eps)
        obs_t, rew_t = obs.transpose(0, 1), rew.transpose(0, 1)
        obs_pred = _mlp(p["obs_dec"], feats)
        # rew[t-1], the reward a_{t-1} produced, is read from feat_t
        rew_pred = _mlp(p["rew_dec"], feats[1:])[..., 0]
        recon = 0.5 * ((obs_pred - obs_t) ** 2).sum(-1).mean()
        rloss = 0.5 * ((rew_pred - rew_t[:-1]) ** 2).mean()
        div = torch.clamp(kls.mean(), min=cfg.free_nats)
        loss = cfg.kl_coeff * div + recon + rloss
        return loss, feats, {"model_loss": loss, "obs_loss": recon,
                             "reward_loss": rloss, "kl": kls.mean()}

    def actor_sample(p, feat, eps):
        mean, std = _stats(_mlp(p["actor"], feat))
        return torch.tanh(mean + std * eps)

    def imagine(p, feats0, eps_a, eps_s):
        """Imagined rollout from every posterior state [N, feat] -> [H, N,
        feat]; gradients flow through the dynamics."""
        stoch, deter = feats0[..., D:], feats0[..., :D]
        out = []
        for t in range(H):
            a = actor_sample(p, torch.cat([deter, stoch], -1), eps_a[t])
            deter, pm, ps = _img_step(p, stoch, deter, a)
            stoch = pm + ps * eps_s[t]
            out.append(torch.cat([deter, stoch], -1))
        return torch.stack(out)

    def lambda_returns(rew, val, gamma, lam):
        """[H, N] -> lambda-returns [H-1, N]."""
        inputs = rew[:-1] + gamma * val[1:] * (1 - lam)
        nxt, rets = val[-1], []
        for t in reversed(range(inputs.shape[0])):
            nxt = inputs[t] + gamma * lam * nxt
            rets.append(nxt)
        return torch.stack(rets[::-1])

    def update(params, opts, batch, *, train_ac: bool = True, eps=None,
               generator: Optional[torch.Generator] = None):
        obs = batch["obs"]
        B, T = obs.shape[:2]
        dev = obs.device
        eps = dict(eps or {})
        if "observe" not in eps:
            eps["observe"] = normal((T, B, cfg.stoch_size), generator, dev)
        loss, feats, metrics = model_loss(params, batch, eps["observe"])
        opts["model"].minimize(loss)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if not train_ac:
            # warm-up: the world model settles before the actor trusts
            # (and exploits) its imagination
            zero = torch.zeros((), device=dev)
            return {**metrics, "actor_loss": zero, "critic_loss": zero}

        feats_flat = feats.detach().reshape(-1, feats.shape[-1])
        N = feats_flat.shape[0]
        if "imagine_a" not in eps:
            eps["imagine_a"] = normal((H, N, act_dim), generator, dev)
        if "imagine_s" not in eps:
            eps["imagine_s"] = normal((H, N, cfg.stoch_size), generator,
                                      dev)
        ifeats = imagine(params, feats_flat, eps["imagine_a"],
                         eps["imagine_s"])
        rew = _mlp(params["rew_dec"], ifeats)[..., 0]      # [H, N]
        val = _mlp(params["critic"], ifeats)[..., 0]
        rets = lambda_returns(rew, val, cfg.gamma, cfg.lambda_)
        disc = torch.cumprod(torch.cat([
            torch.ones(1, device=dev),
            torch.full((H - 2,), cfg.gamma, device=dev)]), 0)
        aloss = -(disc[:, None] * rets).mean()
        # over the actor's leaves only: the model and the critic take no
        # update from the actor's loss
        opts["actor"].step(torch.autograd.grad(aloss,
                                               tree_leaves(params["actor"])))
        val = _mlp(params["critic"], ifeats[:-1].detach())[..., 0]
        closs = 0.5 * ((val - rets.detach()) ** 2).mean()
        opts["critic"].minimize(closs)
        return {**metrics, "actor_loss": aloss.detach(),
                "critic_loss": closs.detach()}

    return update, observe, actor_sample


class EpisodeBuffer:
    """Whole episodes on the host; samples [B, seq_len] windows."""

    def __init__(self, capacity: int, seed: int = 0):
        self.episodes: list[dict] = []
        self.capacity = capacity
        self.rng = np.random.RandomState(seed)

    def add(self, ep: dict) -> None:
        self.episodes.append(ep)
        if len(self.episodes) > self.capacity:
            self.episodes.pop(0)

    def __len__(self):
        return len(self.episodes)

    def sample(self, batch_size: int, seq_len: int) -> dict:
        outs = {"obs": [], "actions": [], "rewards": []}
        for _ in range(batch_size):
            ep = self.episodes[self.rng.randint(len(self.episodes))]
            T = len(ep["rewards"])
            start = self.rng.randint(max(1, T - seq_len + 1))
            sl = slice(start, start + seq_len)
            for k in outs:
                seq = ep[k][sl]
                if len(seq) < seq_len:   # pad short tails by repetition
                    pad = np.repeat(seq[-1:], seq_len - len(seq), axis=0)
                    seq = np.concatenate([seq, pad], 0)
                outs[k].append(seq)
        return {k: np.stack(v) for k, v in outs.items()}


def policy_step(params, stoch, deter, prev_action, obs, eps_s, eps_a):
    """Online filtering: one posterior step, then act -> (stoch, deter,
    action)."""
    embed = _mlp(params["encoder"], obs)
    h, _, (qm, qs) = _obs_step(params, stoch, deter, prev_action, embed)
    s = qm + qs * eps_s
    mean, std = _stats(_mlp(params["actor"], torch.cat([h, s], -1)))
    return s, h, torch.tanh(mean + std * eps_a)


class Dreamer(Algorithm):
    _default_config = DreamerConfig

    def _build(self):
        cfg = self.config
        self.device = dev = resolve_device(cfg.device)
        # the base config's default env (the discrete CartPole string)
        # maps to the latent toy env; other strings resolve normally
        env = cfg.env
        if isinstance(env, str):
            if env == AlgorithmConfig.env:
                env = LinearLatentEnv
            else:
                from ray_tpu_torch.rllib.env import make_env
                env = make_env(env, seed=cfg.seed)
        self.env = env(seed=cfg.seed) if callable(env) else env
        if not hasattr(self.env, "action_dim"):
            raise ValueError(
                f"Dreamer needs a continuous env exposing action_dim; "
                f"{type(self.env).__name__} does not")
        obs_dim = self.env.observation_dim
        self.act_dim = act_dim = self.env.action_dim
        self.params = params_on(init_dreamer_params(
            cfg, obs_dim, act_dim, cfg.seed, device=dev), dev)
        clip = cfg.grad_clip
        self.opts = {
            "model": Adam({k: self.params[k] for k in MODEL_KEYS},
                          cfg.model_lr, clip_norm=clip),
            "actor": Adam(self.params["actor"], cfg.actor_lr,
                          clip_norm=clip),
            "critic": Adam(self.params["critic"], cfg.critic_lr,
                           clip_norm=clip)}
        self._update, self._observe, self._actor_sample = \
            make_dreamer_update(cfg, obs_dim, act_dim)
        self._gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
        self._noise_rng = np.random.default_rng(cfg.seed + 2)
        self._model_updates = 0
        self.buffer = EpisodeBuffer(cfg.buffer_episodes, seed=cfg.seed)
        for _ in range(cfg.prefill_episodes):
            self._collect_episode(random_policy=True)

    @torch.no_grad()
    def _act(self, stoch, deter, prev_a, obs):
        cfg = self.config
        x = torch.as_tensor(np.asarray(obs, np.float32)).to(self.device)
        eps_s = torch.randn((1, cfg.stoch_size), generator=self._gen,
                            device=self.device)
        eps_a = torch.randn((1, self.act_dim), generator=self._gen,
                            device=self.device)
        return policy_step(self.params, stoch, deter, prev_a, x[None],
                           eps_s, eps_a)

    def _collect_episode(self, random_policy: bool = False,
                         explore: bool = True,
                         record: bool = True) -> float:
        cfg = self.config
        dev = self.device
        obs = self.env.reset()
        stoch = torch.zeros((1, cfg.stoch_size), device=dev)
        deter = torch.zeros((1, cfg.deter_size), device=dev)
        prev_a = torch.zeros((1, self.act_dim), device=dev)
        traj = {"obs": [], "actions": [], "rewards": []}
        ep_rew, done = 0.0, False
        while not done:
            if random_policy:
                a = np.random.RandomState(int(self._timesteps)).uniform(
                    -1, 1, (self.act_dim,)).astype(np.float32)
            else:
                stoch, deter, a_t = self._act(stoch, deter, prev_a, obs)
                a = a_t[0].cpu().numpy()
                if explore and cfg.explore_noise > 0:
                    # exploration noise on the executed action keeps the
                    # replayed actions wide enough that the model cannot
                    # be exploited where it has seen nothing
                    noise = self._noise_rng.standard_normal(a.shape)
                    a = np.clip(a + noise * cfg.explore_noise, -1.0,
                                1.0).astype(np.float32)
                prev_a = torch.as_tensor(a, dtype=torch.float32).to(
                    dev)[None]
            nobs, rew, done = self.env.step(a)
            traj["obs"].append(np.asarray(obs, np.float32))
            traj["actions"].append(np.asarray(a, np.float32))
            traj["rewards"].append(np.float32(rew))
            obs = nobs
            ep_rew += rew
            if record:
                self._timesteps += 1
        if record:
            self.buffer.add({k: np.stack(v) for k, v in traj.items()})
            self._ep_returns.append(ep_rew)
        return ep_rew

    def training_step(self) -> dict:
        cfg = self.config
        for _ in range(cfg.episodes_per_step):
            self._collect_episode()
        metrics = {}
        for _ in range(cfg.train_iters_per_step):
            b = to_device(self.buffer.sample(cfg.batch_size, cfg.seq_len),
                          self.device)
            train_ac = self._model_updates >= cfg.model_warmup_updates
            metrics = self._update(self.params, self.opts, b,
                                   train_ac=train_ac, generator=self._gen)
            self._model_updates += 1
        return {"steps_this_iter":
                cfg.episodes_per_step * getattr(self.env, "HORIZON", 64),
                **{k: float(v) for k, v in metrics.items()}}

    def evaluate_episodes(self, n: int = 4) -> float:
        """Mean return of noise-free policy episodes, entering neither
        the buffer nor the counters."""
        return float(np.mean(
            [self._collect_episode(explore=False, record=False)
             for _ in range(n)]))

    def save_checkpoint(self) -> dict:
        """The JAX package's layout: ``state`` is ``(params, opt_model,
        opt_actor, opt_critic)``."""
        return to_numpy({
            "state": (self.params, self.opts["model"].state(),
                      self.opts["actor"].state(),
                      self.opts["critic"].state()),
            "timesteps": self._timesteps,
            "model_updates": self._model_updates})

    def load_checkpoint(self, ck):
        """A port save, or the JAX package's (optax chains bridged)."""
        state = ck["state"]
        copy_into(self.params, state[0])
        for k, saved in zip(("model", "actor", "critic"), state[1:]):
            self.opts[k].load(saved)
        self._timesteps = ck.get("timesteps", 0)
        # without this a restored agent re-enters the model-only warm-up
        self._model_updates = ck.get("model_updates", 0)
