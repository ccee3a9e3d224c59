"""Shared helpers of the RL tests of the port (``test_torch_port_*`` files
for the RLlib tail): numpy trees, comparisons in JAX's leaf order, the
batches both packages update on, and offline CartPole data."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ray_tpu_torch.rllib import optim


def np_tree(tree):
    """A JAX (or port) tree -> numpy leaves, same nesting."""
    return jax.tree_util.tree_map(
        lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
        else np.asarray(x), tree)


def jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def t_tree(tree, device="cpu"):
    """numpy columns -> torch tensors (no grad)."""
    return optim.tree_map(lambda a: torch.as_tensor(np.array(a)).to(device),
                          tree)


def assert_trees_close(got, want, *, atol=1e-5, rtol=0.0, err=""):
    """Every leaf of ``got`` (a port tree) within tolerance of ``want``
    (a JAX tree), leaves paired in JAX's order."""
    g = jax.tree_util.tree_leaves(np_tree(got))
    w = jax.tree_util.tree_leaves(np_tree(want))
    assert len(g) == len(w), (len(g), len(w))
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.shape == b.shape, (err, i, a.shape, b.shape)
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol,
                                   err_msg=f"{err} leaf {i}")


def assert_trees_equal(got, want, err=""):
    g = jax.tree_util.tree_leaves(np_tree(got))
    w = jax.tree_util.tree_leaves(np_tree(want))
    assert len(g) == len(w), (len(g), len(w))
    for i, (a, b) in enumerate(zip(g, w)):
        assert np.array_equal(a, b), f"{err} leaf {i}"


def assert_metrics_close(got: dict, want: dict, rtol=1e-4, atol=1e-7):
    for k, v in want.items():
        g = got[k].detach() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_allclose(float(g), float(v), rtol=rtol,
                                   atol=atol, err_msg=k)


def grads_of(loss, leaves):
    """d loss / d leaves, unused leaves zero (as ``jax.grad`` gives)."""
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, gs)]


def with_grad(tree):
    """A port tree of fresh leaves of autograd (f32 copies)."""
    return optim.params_on(tree, "cpu")


def rollout_batch(n, obs_dim=4, num_actions=2, seed=0, vt_scale=3.0):
    """A flat on-policy batch: CartPole-like observations, actions,
    behaviour log-probabilities near uniform, advantages and targets."""
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, num_actions, n).astype(np.int64),
            "logp": (np.log(1.0 / num_actions)
                     + 0.05 * rng.standard_normal(n)).astype(np.float32),
            "vf_preds": rng.standard_normal(n).astype(np.float32),
            "advantages": (2.0 * rng.standard_normal(n) + 0.5)
            .astype(np.float32),
            "value_targets": (vt_scale * rng.standard_normal(n))
            .astype(np.float32)}


def transition_batch(n, obs_dim=4, num_actions=2, seed=0, act_dim=None):
    """A replay batch: (obs, actions, rewards, dones, next_obs); with
    ``act_dim`` the actions are continuous in [-2, 2]."""
    rng = np.random.default_rng(seed)
    acts = (rng.uniform(-2, 2, (n, act_dim)).astype(np.float32)
            if act_dim else rng.integers(0, num_actions, n).astype(np.int64))
    return {"obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
            "actions": acts,
            "rewards": rng.standard_normal(n).astype(np.float32),
            "dones": (rng.random(n) < 0.1).astype(np.float32),
            "next_obs": rng.standard_normal((n, obs_dim)).astype(np.float32)}


def write_offline_cartpole(path, n_steps=600, seed=0, value_targets=False):
    """Random-policy CartPole transitions, written with the JAX package's
    JsonWriter (the port reads them with its own reader)."""
    from ray_tpu.rllib.env import CartPole
    from ray_tpu.rllib.offline import JsonWriter
    from ray_tpu.rllib.sample_batch import SampleBatch
    rng = np.random.default_rng(seed)
    env = CartPole(seed=seed)
    obs = env.reset()
    rows = {k: [] for k in ("obs", "actions", "rewards", "dones",
                            "next_obs")}
    for _ in range(n_steps):
        a = int(rng.integers(0, 2))
        nxt, r, done, _ = env.step(a)
        rows["obs"].append(obs)
        rows["actions"].append(a)
        rows["rewards"].append(r)
        rows["dones"].append(float(done))
        rows["next_obs"].append(nxt)
        obs = env.reset() if done else nxt
    cols = {"obs": np.stack(rows["obs"]).astype(np.float32),
            "actions": np.asarray(rows["actions"], np.int64),
            "rewards": np.asarray(rows["rewards"], np.float32),
            "dones": np.asarray(rows["dones"], np.float32),
            "next_obs": np.stack(rows["next_obs"]).astype(np.float32)}
    if value_targets:
        cols["value_targets"] = (5.0 * rng.standard_normal(n_steps)
                                 ).astype(np.float32)
    w = JsonWriter(str(path))
    w.write(SampleBatch(cols))
    w.close()
    return cols
