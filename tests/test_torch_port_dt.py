"""The port's Decision Transformer against the JAX package's on the CPU,
in f32, at the JAX defaults' full width (d_model 64, 4 heads, 2 layers,
context 20: 60 tokens).

- ``segment_episodes`` equal; ``init_dt_params`` the same tree;
- ``dt_forward``'s logits within 1e-5 on params bridged from JAX's init,
  over padded segments (the -1e9 causal fill, tanh GELU, population
  LayerNorm);
- the loss and its grads within rtol 1e-5 (JAX's own, read back from its
  update through a transform that keeps the gradients as its state);
- two whole ``train()`` iterations from a JAX ``save()`` restored into
  the port (the segments are the same numpy draws; AdamW decays every
  leaf): params within atol 1e-5, losses within rel 1e-4; then
  ``evaluate`` takes the same greedy actions;
- a JAX ``save()`` restored into the port and back through the Adam
  bridge (optax's adamw chain); ``device=None`` without a card raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_rl import (assert_trees_close, assert_trees_equal,
                            jnp_tree, np_tree, t_tree, with_grad)
from ray_tpu.rllib import dt as jdt
from ray_tpu.rllib.env import CartPole
from ray_tpu.rllib.offline import JsonWriter
from ray_tpu.rllib.sample_batch import SampleBatch
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import dt as tdt
from ray_tpu_torch.rllib import optim

GRAD_TAP = optax.GradientTransformation(
    lambda params: (),
    lambda grads, state, params=None: (
        jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Six CartPole episodes, half from a balancing heuristic."""
    path = tmp_path_factory.mktemp("dt")
    rng = np.random.default_rng(0)
    rows = {k: [] for k in ("obs", "actions", "rewards", "dones")}
    for ep in range(6):
        env = CartPole(seed=ep)
        o = env.reset()
        for _ in range(60):
            a = ((1 if (o[2] + 0.5 * o[3]) > 0 else 0) if ep % 2 == 0
                 else int(rng.integers(0, 2)))
            no, r, done, _ = env.step(a)
            rows["obs"].append(o)
            rows["actions"].append(a)
            rows["rewards"].append(r)
            rows["dones"].append(float(done or len(rows["obs"]) % 60 == 0))
            o = no
            if done:
                break
    w = JsonWriter(str(path))
    w.write(SampleBatch({
        "obs": np.stack(rows["obs"]).astype(np.float32),
        "actions": np.asarray(rows["actions"], np.int64),
        "rewards": np.asarray(rows["rewards"], np.float32),
        "dones": np.asarray(rows["dones"], np.float32)}))
    w.close()
    return str(path)


def _cfg(mod, data_dir, **kw):
    return mod.DTConfig(input_path=data_dir, env="CartPole-v1",
                        batch_size=8, grad_steps_per_iter=3,
                        max_episode_steps=40, seed=0, **kw)


@pytest.fixture(scope="module")
def jalgo(data_dir):
    return _cfg(jdt, data_dir).build()


def test_segment_episodes_and_tree_match(jalgo, data_dir):
    port = _cfg(tdt, data_dir, device="cpu").build()
    assert len(port.episodes) == len(jalgo.episodes)
    for a, b in zip(port.episodes, jalgo.episodes):
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    got = np_tree(port.params)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(np_tree(jalgo.params))
    assert_trees_close(jax.tree_util.tree_map(np.zeros_like, got),
                       jax.tree_util.tree_map(np.zeros_like,
                                              np_tree(jalgo.params)))
    assert got["emb_t"].shape == (4096, 64)


def test_dt_forward_matches_jax(jalgo):
    batch = jalgo._sample_batch()
    cfg = jalgo.config
    want = jax.jit(lambda p, b: jdt.dt_forward(
        p, cfg, b["rtg"], b["obs"], b["prev_actions"], b["timesteps"]))(
        jalgo.params, jnp_tree(batch))
    tb = t_tree(batch)
    got = tdt.dt_forward(optim.params_on(np_tree(jalgo.params), "cpu",
                                         grad=False), cfg, tb["rtg"],
                         tb["obs"], tb["prev_actions"], tb["timesteps"])
    assert got.shape == (8, 20, 2) and (batch["mask"] == 0).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_dt_loss_and_grads_match_jax(jalgo, data_dir):
    tap = _cfg(jdt, data_dir).build()      # its update traces GRAD_TAP
    tap.tx = GRAD_TAP
    batch = jalgo._sample_batch()
    _, jg, jl = tap._update(jalgo.params, (), jnp_tree(batch))
    tp = with_grad(np_tree(jalgo.params))
    tl = tdt.dt_loss(tp, jalgo.config, t_tree(batch))
    grads = torch.autograd.grad(tl, optim.tree_leaves(tp))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert_trees_close(optim.tree_unflatten(tp, list(grads)), jg,
                       atol=1e-5, rtol=1e-5)


def _key_bias_apart(params):
    """(params without each layer's key bias, the key biases): the
    slice ``qkv.b[d:2d]``, whose exact gradient is zero (every score of
    a query row shifts by the same q . b_k, and softmax ignores it)."""
    p = np_tree(params)
    d = p["emb_t"].shape[1]
    keys = [np.array(lp["qkv"]["b"][d:2 * d]) for lp in p["layers"]]
    for lp in p["layers"]:
        lp["qkv"]["b"] = np.concatenate([lp["qkv"]["b"][:d],
                                         lp["qkv"]["b"][2 * d:]])
    return p, keys


def test_two_train_iterations_match_jax(data_dir):
    jalgo = _cfg(jdt, data_dir).build()     # fresh: the same draws each run
    port = _cfg(tdt, data_dir, device="cpu").build()
    port.restore(jalgo.save())
    _, k0 = _key_bias_apart(jalgo.params)
    for it in range(2):
        jr, tr = jalgo.train(), port.train()
        np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=1e-4)
        # the key biases move by Adam-normalised rounding noise of a zero
        # gradient, g / (|g| + eps), in both packages: held apart, by
        # the most lr-sized steps can move them
        (tp, tk), (jp, jk) = (_key_bias_apart(port.params),
                              _key_bias_apart(jalgo.params))
        assert_trees_close(tp, jp, atol=1e-5, err=f"iteration {it}")
        steps = 3 * (it + 1)
        for a, b, c in zip(tk, jk, k0):
            assert np.abs(a - c).max() <= steps * 1e-3 * 1.01
            assert np.abs(b - c).max() <= steps * 1e-3 * 1.01
    assert port.opt.count == 6
    assert port.evaluate(num_episodes=1) == jalgo.evaluate(num_episodes=1)


def test_jax_save_restores_into_the_port_and_back(jalgo, data_dir):
    jalgo.train()
    saved = jalgo.save()
    port = _cfg(tdt, data_dir, device="cpu").build()
    port.restore(saved)
    assert port._timesteps == jalgo._timesteps
    back = port.save()["payload"]
    assert_trees_equal(back["params"], jalgo.params)
    opt = convert.torch_adam_to_optax(back["opt_state"],
                                      like=np_tree(jalgo.opt_state))
    assert jax.tree_util.tree_structure(opt) == \
        jax.tree_util.tree_structure(jalgo.opt_state)
    assert_trees_equal(opt, jalgo.opt_state)
    assert np.isfinite(port.train()["loss"])


def test_device_none_without_a_card_raises(monkeypatch, data_dir):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _cfg(tdt, data_dir).build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdt.init_dt_params(tdt.DTConfig(), 4, 2)
