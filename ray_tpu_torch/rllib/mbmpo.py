"""MB-MPO: model-based meta-policy optimisation, the port of
``ray_tpu/rllib/mbmpo.py``: ``MBMPOConfig``, ``_model_init``,
``_model_forward``, ``make_model_fit``, ``make_meta_update`` and
``MBMPO``.

An ensemble of dynamics models learns from real transitions; each model
is one task of a MAML-style meta-update of the policy (``policy.py``'s
``policy_forward``): imagine a rollout under the model, take one
policy-gradient step on it (differentiated through, with
``create_graph=True``), imagine again with the adapted policy, and step
the policy's Adam on the mean over the models.

The ensemble's leaves are stacked on a leading member axis and fitted
as one batch (one Adam over the stacked leaves steps every member as
its own Adam would).  The draws the JAX package makes inside its jitted
programs can be passed in: the bootstrap indices of the fit (``idx``,
[members, epochs, rows]) and the Gumbel noise of the imagined
categorical actions (``gumbel``, [meta steps, members, 2, horizon,
rollouts, actions]); without them both come from a ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib import sample_batch as SB
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig, WorkerSet
from ray_tpu_torch.rllib.multi_agent import gumbel as gumbel_noise
from ray_tpu_torch.rllib.optim import (Adam, copy_into, params_on, to_numpy,
                                       tree_leaves, tree_unflatten)
from ray_tpu_torch.rllib.policy import (PolicyConfig, init_policy_params,
                                        policy_forward)


@dataclass
class MBMPOConfig(AlgorithmConfig):
    ensemble_size: int = 4
    model_hidden: int = 128
    model_epochs: int = 40
    model_lr: float = 1e-3
    inner_lr: float = 0.1
    imagine_horizon: int = 32
    imagine_rollouts: int = 64
    real_batch_size: int = 2048
    meta_steps: int = 8

    def build(self, algo_cls=None) -> "MBMPO":
        return MBMPO({"_config": self})


def _model_init(generator: torch.Generator, obs_dim: int, n_actions: int,
                hidden: int) -> dict:
    """Dynamics net: (obs, one-hot action) -> (next obs, reward, done
    logit); He-normal weights, zero biases."""
    dev = generator.device
    d_in, d_out = obs_dim + n_actions, obs_dim + 2

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=dev) * scale
    s1, s2 = np.sqrt(2.0 / d_in), np.sqrt(2.0 / hidden)
    return {"w1": normal((d_in, hidden), s1),
            "b1": torch.zeros(hidden, device=dev),
            "w2": normal((hidden, hidden), s2),
            "b2": torch.zeros(hidden, device=dev),
            "w3": normal((hidden, d_out), s2),
            "b3": torch.zeros(d_out, device=dev)}


def _model_forward(m, obs, act_onehot):
    """One member (w [in, out]) or the stacked ensemble (w [E, in, out]
    on obs [n, D] or [E, n, D]) -> (next obs, reward, done logit)."""
    x = torch.cat([obs, act_onehot], dim=-1)
    h = torch.tanh(torch.matmul(x, m["w1"]) + m["b1"].unsqueeze(-2))
    h = torch.tanh(torch.matmul(h, m["w2"]) + m["b2"].unsqueeze(-2))
    out = torch.matmul(h, m["w3"]) + m["b3"].unsqueeze(-2)
    return obs + out[..., :-2], out[..., -2], out[..., -1]


def member_losses(models, obs, act1h, next_obs, rew, done):
    """Each member's dynamics loss [E]; terminal transitions are masked
    out of the observation loss (their successor is a reset state)."""
    pred_next, pred_r, pred_d = _model_forward(models, obs, act1h)
    w = (1.0 - done)[..., None]
    l_obs = (w * (pred_next - next_obs) ** 2).sum(dim=(-2, -1)) / \
        torch.clamp(w.sum(dim=(-2, -1)) * obs.shape[-1], min=1.0)
    l_rew = ((pred_r - rew) ** 2).mean(dim=-1)
    l_done = F.binary_cross_entropy_with_logits(
        pred_d, done.expand_as(pred_d), reduction="none").mean(dim=-1)
    return l_obs + l_rew + l_done


def make_model_fit(cfg: MBMPOConfig):
    """-> ``fit(models, opt, data, *, idx=None, generator=None)``:
    ``cfg.model_epochs`` Adam steps of ``opt`` (over the stacked
    members), each member on its own bootstrap rows ``idx[:, epoch]``
    (min(512, n) rows drawn with replacement) -> each member's loss on
    all the data [E]."""
    def fit(models, opt, data, *, idx=None,
            generator: Optional[torch.Generator] = None):
        n = data["obs"].shape[0]
        dev = data["obs"].device
        if idx is None:
            idx = torch.randint(0, n, (cfg.ensemble_size, cfg.model_epochs,
                                       min(512, n)), generator=generator,
                                device=dev)
        idx = torch.as_tensor(np.array(idx) if not isinstance(
            idx, torch.Tensor) else idx, dtype=torch.long, device=dev)
        cols = ("obs", "act1h", "next_obs", "rew", "done")
        for e in range(cfg.model_epochs):
            rows = idx[:, e]                                # [E, rows]
            opt.minimize(member_losses(
                models, *(data[k][rows] for k in cols)).sum())
        with torch.no_grad():
            return member_losses(models, *(data[k] for k in cols))

    return fit


def make_meta_update(cfg: MBMPOConfig, n_actions: int):
    """-> ``(meta_update, imagine_returns)``.  ``meta_update(params, opt,
    models, start_obs, *, gumbel=None, generator=None)`` takes
    ``cfg.meta_steps`` Adam steps of ``opt`` on the meta-loss through the
    inner adaptation -> ``(params, opt, mean loss, mean imagined
    return)``."""
    H, gamma = cfg.imagine_horizon, cfg.gamma

    def imagine_returns(p, model, g, start_obs):
        """The imagined REINFORCE objective under one model; g [H, B, A]
        the Gumbel noise of the categorical draws."""
        obs = start_obs
        B = obs.shape[0]
        alive = torch.ones(B, device=obs.device)
        ret = torch.zeros(B, device=obs.device)
        logps, rews, alives = [], [], []
        for t in range(H):
            logits, _ = policy_forward(p, obs)
            act = torch.argmax(logits.detach() + g[t], dim=-1)
            logps.append(torch.log_softmax(logits, dim=-1).gather(
                1, act[:, None])[:, 0])
            nxt, rew, dlogit = _model_forward(
                model, obs, F.one_hot(act, n_actions).float())
            rews.append(rew)
            alives.append(alive)
            ret = ret + alive * rew
            alive = alive * (1.0 - torch.sigmoid(dlogit))
            obs = nxt
        logps, rews, alives = (torch.stack(logps), torch.stack(rews),
                               torch.stack(alives))
        # discounted reward-to-go weights for the surrogate
        disc = gamma ** torch.arange(H, device=obs.device,
                                     dtype=torch.float32)
        weighted = rews * alives * disc[:, None]
        rtg = torch.flip(torch.cumsum(torch.flip(weighted, [0]), 0), [0]) \
            / torch.clamp(disc[:, None], min=1e-8)
        base = rtg.mean(dim=1, keepdim=True)
        # alive-masked: steps after an imagined termination add nothing
        surr = (logps * alives * (rtg - base).detach()).mean()
        return surr, ret.mean()

    def meta_loss(params, models, g, start_obs):
        leaves = tree_leaves(params)
        surrs, rets = [], []
        for e in range(cfg.ensemble_size):
            model = {k: v[e] for k, v in models.items()}
            surr, _ = imagine_returns(params, model, g[e, 0], start_obs)
            # the value head takes no part: its gradient is None (zero)
            grads = torch.autograd.grad(-surr, leaves, create_graph=True,
                                        allow_unused=True)
            adapted = tree_unflatten(params, [
                p if gi is None else p - cfg.inner_lr * gi
                for p, gi in zip(leaves, grads)])
            surr2, ret2 = imagine_returns(adapted, model, g[e, 1],
                                          start_obs)
            surrs.append(surr2)
            rets.append(ret2)
        return -torch.stack(surrs).mean(), torch.stack(rets).mean()

    def meta_update(params, opt, models, start_obs, *, gumbel=None,
                    generator: Optional[torch.Generator] = None):
        dev = start_obs.device
        models = {k: v.detach() for k, v in models.items()}
        shape = (cfg.meta_steps, cfg.ensemble_size, 2, H,
                 start_obs.shape[0], n_actions)
        g_all = (gumbel_noise(shape, generator, dev) if gumbel is None
                 else torch.as_tensor(np.array(gumbel, np.float32)
                                      if not isinstance(gumbel, torch.Tensor)
                                      else gumbel).to(dev))
        losses, rets = [], []
        for s in range(cfg.meta_steps):
            loss, ret = meta_loss(params, models, g_all[s], start_obs)
            opt.minimize(loss)
            losses.append(loss.detach())
            rets.append(ret.detach())
        return (params, opt, torch.stack(losses).mean(),
                torch.stack(rets).mean())

    return meta_update, imagine_returns


class MBMPO(Algorithm):
    _default_config = MBMPOConfig

    def _build(self):
        cfg = self.config
        self.device = dev = resolve_device(cfg.device)
        self.workers = WorkerSet(cfg)
        self.obs_dim = self.workers.obs_dim
        self.n_actions = self.workers.num_actions
        pcfg = PolicyConfig(obs_dim=self.obs_dim,
                            num_actions=self.n_actions,
                            hiddens=tuple(cfg.hiddens))
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        self.params = params_on(init_policy_params(pcfg, generator=gen,
                                                   device=dev), dev)
        self.opt = Adam(self.params, cfg.lr)
        members = [_model_init(gen, self.obs_dim, self.n_actions,
                               cfg.model_hidden)
                   for _ in range(cfg.ensemble_size)]
        self.models = params_on({k: torch.stack([m[k] for m in members])
                                 for k in members[0]}, dev)
        self.model_opt = Adam(self.models, cfg.model_lr)
        self._fit_models = make_model_fit(cfg)
        self._meta_update, _ = make_meta_update(cfg, self.n_actions)
        self._gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
        self._np_rng = np.random.RandomState(cfg.seed)
        self.workers.sync_weights(to_numpy(self.params))

    def transitions(self, batches) -> dict:
        """Rollouts (time-major [T*B] flats) -> (obs, one-hot action,
        next obs, reward, done) columns on the device; an episode's last
        transition keeps done=1 and its successor is the reset state,
        which the dynamics loss masks."""
        cfg = self.config
        T, Bn = cfg.rollout_length, cfg.num_envs_per_worker
        obs_l, nxt_l, act_l, rew_l, done_l = [], [], [], [], []
        for b in batches:
            o = np.asarray(b[SB.OBS], np.float32)
            reps = o.shape[0] // (T * Bn)   # a concat of worker rollouts
            boot_all = np.asarray(b["bootstrap_obs"], np.float32).reshape(
                reps, Bn, self.obs_dim)
            for r in range(reps):
                blk = o[r * T * Bn:(r + 1) * T * Bn].reshape(
                    T, Bn, self.obs_dim)
                nxt = np.concatenate([blk[1:], boot_all[r][None]], axis=0)
                obs_l.append(blk.reshape(-1, self.obs_dim))
                nxt_l.append(nxt.reshape(-1, self.obs_dim))
                sl = slice(r * T * Bn, (r + 1) * T * Bn)
                act_l.append(np.asarray(b[SB.ACTIONS])[sl])
                rew_l.append(np.asarray(b[SB.REWARDS], np.float32)[sl])
                done_l.append(np.asarray(b[SB.DONES], np.float32)[sl])
        dev = self.device
        act = torch.as_tensor(np.concatenate(act_l)).to(dev)
        return {"obs": torch.as_tensor(np.concatenate(obs_l)).to(dev),
                "act1h": F.one_hot(act.long(), self.n_actions).float(),
                "next_obs": torch.as_tensor(np.concatenate(nxt_l)).to(dev),
                "rew": torch.as_tensor(np.concatenate(rew_l)).to(dev),
                "done": torch.as_tensor(np.concatenate(done_l)).to(dev)}

    def training_step(self) -> dict:
        cfg = self.config
        batches, steps = [], 0
        while steps < cfg.real_batch_size:
            b, rets = self.workers.sample_sync()
            self._ep_returns.extend(rets)
            batches.append(b)
            steps += b.count
        self._timesteps += steps
        data = self.transitions(batches)
        model_losses = self._fit_models(self.models, self.model_opt, data,
                                        generator=self._gen)
        starts = data["obs"][torch.as_tensor(self._np_rng.randint(
            0, data["obs"].shape[0], cfg.imagine_rollouts)).to(self.device)]
        _, _, mloss, imag_ret = self._meta_update(
            self.params, self.opt, self.models, starts, generator=self._gen)
        self.workers.sync_weights(to_numpy(self.params))
        return {"model_loss_mean": float(model_losses.mean()),
                "meta_loss": float(mloss),
                "imagined_return": float(imag_ret),
                "steps_this_iter": steps}

    def save_checkpoint(self) -> dict:
        """The JAX package's layout: params, models and timesteps (no
        optimizer state)."""
        return to_numpy({"params": self.params, "models": self.models,
                         "timesteps": self._timesteps})

    def load_checkpoint(self, ck):
        copy_into(self.params, ck["params"])
        copy_into(self.models, ck["models"])
        self._timesteps = ck.get("timesteps", 0)
        self.workers.sync_weights(to_numpy(self.params))
