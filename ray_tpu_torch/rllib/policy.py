"""The actor-critic policy of the RL algorithms, the port of
``ray_tpu/rllib/policy.py``: ``PolicyConfig``, ``init_policy_params``,
``policy_forward`` (a tanh MLP trunk with ``pi`` logits and ``vf`` value
heads, in the JAX package's params layout, so ``models.convert`` bridges
them byte for byte), ``TorchPolicy`` (the rollout side: sampled actions,
their log-probabilities and values, as numpy) and ``compute_gae``, a
numpy copy.

The draws of ``init_policy_params`` and of ``compute_actions`` come from
``torch.Generator``s and differ from ``jax.random``'s; parity tests
bridge one set of weights and compare functions, not samples.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy


@dataclass(frozen=True)
class PolicyConfig:
    obs_dim: int
    num_actions: int
    hiddens: tuple = (64, 64)


def init_policy_params(cfg: PolicyConfig, seed: int = 0, *, device=None,
                       generator: Optional[torch.Generator] = None) -> dict:
    """He-normal trunk, N(0, 0.01) policy head, N(0, 1) value head, zero
    biases, f32, drawn from a ``torch.Generator`` on the target device
    (seeded with ``seed`` unless one is passed)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=dev) * scale

    dims = (cfg.obs_dim, *cfg.hiddens)
    params = {}
    for i in range(len(dims) - 1):
        params[f"fc{i}"] = {"w": normal((dims[i], dims[i + 1]),
                                        np.sqrt(2.0 / dims[i])),
                            "b": torch.zeros(dims[i + 1], device=dev)}
    params["pi"] = {"w": normal((dims[-1], cfg.num_actions), 0.01),
                    "b": torch.zeros(cfg.num_actions, device=dev)}
    params["vf"] = {"w": normal((dims[-1], 1), 1.0),
                    "b": torch.zeros(1, device=dev)}
    return params


def policy_forward(params, obs):
    """obs [B, obs_dim] -> (logits [B, A], value [B])."""
    x = obs
    i = 0
    while f"fc{i}" in params:
        lp = params[f"fc{i}"]
        x = torch.tanh(x @ lp["w"] + lp["b"])
        i += 1
    logits = x @ params["pi"]["w"] + params["pi"]["b"]
    value = (x @ params["vf"]["w"] + params["vf"]["b"])[:, 0]
    return logits, value


class TorchPolicy:
    """Params on ``device`` (None = the CUDA card) and the sampling
    generator, seeded with ``seed + 1`` as the JAX policy seeds its key."""

    def __init__(self, cfg: PolicyConfig, seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = init_policy_params(cfg, seed, device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(
            seed + 1)

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray):
        """-> actions, their log-probabilities, values and logits (numpy),
        actions sampled from the categorical over the logits."""
        x = torch.as_tensor(np.asarray(obs, np.float32)).to(self.device)
        logits, value = policy_forward(self.params, x)
        logp_all = torch.log_softmax(logits, dim=-1)
        actions = torch.multinomial(logp_all.exp(), 1,
                                    generator=self._gen)[:, 0]
        logp = logp_all.gather(1, actions[:, None])[:, 0]
        return (actions.cpu().numpy(), logp.cpu().numpy(),
                value.cpu().numpy(), logits.cpu().numpy())

    def get_weights(self):
        return params_to_numpy(self.params)

    def set_weights(self, weights):
        self.params = params_from_numpy(weights, device=self.device)


def compute_gae(rewards, values, dones, last_value, *, gamma=0.99,
                lam=0.95):
    """Generalized advantage estimation over a [T, B] rollout."""
    T = rewards.shape[0]
    adv = np.zeros_like(rewards)
    last_gae = np.zeros_like(last_value)
    next_value = last_value
    for t in reversed(range(T)):
        nonterminal = 1.0 - dones[t].astype(np.float32)
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last_gae = delta + gamma * lam * nonterminal * last_gae
        adv[t] = last_gae
        next_value = values[t]
    value_targets = adv + values
    return adv, value_targets
