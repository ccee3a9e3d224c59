"""The port's MLP and ResNet against the JAX package on the CPU (BERT
is in test_torch_port_bert.py).

Parameters are numpy draws in the tree of the JAX package's
``init_params`` (``weights``), bridged through ``params_from_numpy(...,
device="cpu")``; inputs come from numpy seeds.  The JAX references are
jitted per case.

- MLP: forward, loss, accuracy and grads (its ``make_train_step``
  trajectory is in test_torch_port_bert.py, beside BERT's).
- ResNet: ``tiny`` at 16x16 (even SAME padding: a 3x3 stride-2 conv pads
  (0, 1)) and 15x15 (odd: (1, 1)), and ``resnet50(num_filters=8,
  cifar_stem=False)`` at 64x64 (the 7x7/2 stem pads (2, 3), then the
  -inf max-pool), each with ``train=True`` (batch statistics, the biased
  variance, running stats at momentum 0.9) and ``train=False`` (on the
  running stats the train call returned): logits and BN state.  Grads of
  ``loss_fn`` on ``tiny``, and a 3-step SGD trajectory with the state
  carried.

Tolerances, f32: forwards atol = rtol = 1e-5 (ResNet-50 at 1e-4 plus
1e-5 of its scale, see ``_r50_tol``); grads and trajectories atol = rtol = 1e-4 (params after a
trajectory atol 1e-5)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_trees import (  # no_onednn: an autouse fixture
    FWD, GRAD, assert_same_layout, assert_trees_close, bridge, grad_tree,
    jax_shapes, no_onednn, requiring_grad, to_numpy, weights)
from ray_tpu.models import mlp as jmlp
from ray_tpu.models import resnet as jresnet
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import mlp as tmlp
from ray_tpu_torch.models import resnet as tresnet

# ------------------------------------------------------------------ MLP

MLP_CFG = dict(in_dim=64, hidden=(32, 32), out_dim=10)


@pytest.fixture(scope="module")
def mlp_case():
    jcfg = jmlp.MLPConfig(**MLP_CFG)
    tree = weights(jmlp.init_params, jcfg)
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((16, 64)).astype(np.float32),
             "y": rng.integers(0, 10, 16).astype(np.int32)}

    def ref(p, b):
        loss, grads = jax.value_and_grad(jmlp.loss_fn)(p, b, jcfg)
        return (jmlp.forward(p, b["x"], jcfg), loss,
                jmlp.accuracy(p, b, jcfg), grads)

    return tree, batch, to_numpy(jax.jit(ref)(tree, batch))


def test_mlp_matches_jax(mlp_case):
    tree, batch, (logits, loss, acc, grads) = mlp_case
    cfg = tmlp.MLPConfig(**MLP_CFG)
    params = requiring_grad(tree)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    np.testing.assert_allclose(
        tmlp.forward(params, tb["x"], cfg).detach().numpy(), logits, **FWD)
    got_loss = tmlp.loss_fn(params, tb, cfg)
    np.testing.assert_allclose(got_loss.item(), loss, **FWD)
    assert tmlp.accuracy(params, tb, cfg).item() == pytest.approx(acc)
    assert_trees_close(grad_tree(got_loss, params), grads, **GRAD)
    assert tmlp.MLP(cfg).apply(params, tb["x"]).shape == (16, 10)


# --------------------------------------------------------------- ResNet

# name -> (config kwargs, image size); the JAX and the port configs
# differ only in the dtype's type
RESNET_CASES = {
    "tiny16": (dict(stage_sizes=(1, 1), num_filters=8, num_classes=4), 16),
    "tiny15": (dict(stage_sizes=(1, 1), num_filters=8, num_classes=4), 15),
    "r50_64": (dict(stage_sizes=(3, 4, 6, 3), bottleneck=True,
                    num_filters=8, cifar_stem=False), 64),
}
# ResNet-50 amplifies f32 rounding through 16 blocks whose last stage
# normalises over 8 values, and its eval logits reach ~40: against an f64
# evaluation the JAX package is up to 4.0e-5 off in train logits, 2.5e-4
# in eval logits and 6.7e-5 in BN state (the port up to 2.4e-5, 8.0e-5,
# 4.4e-5).  So its forward is held at 1e-4 plus 1e-5 of the largest
# reference value
def _r50_tol(want):
    return dict(atol=1e-4 + 1e-5 * np.abs(want).max(), rtol=0)

GRAD_CASES = ["tiny16", "tiny15"]
SGD_STEPS, SGD_LR = 3, 0.1


def _resnet_cfgs(kw):
    return (jresnet.ResNetConfig(dtype=jnp.float32, **kw),
            tresnet.ResNetConfig(dtype=torch.float32, **kw))


def _resnet_ref(name, p, st, b):
    """JAX's train forward, the eval forward on the running stats it
    returned, and (for GRAD_CASES) loss, accuracy and grads."""
    jcfg, _ = _resnet_cfgs(RESNET_CASES[name][0])
    logits, st1 = jresnet.forward(p, st, b["x"], jcfg, train=True)
    eval_logits, st2 = jresnet.forward(p, st1, b["x"], jcfg, train=False)
    out = dict(logits=logits, state=st1, eval_logits=eval_logits,
               eval_state=st2)
    if name in GRAD_CASES:
        (loss, (_, m)), g = jax.value_and_grad(
            lambda p: jresnet.loss_fn(p, st, b, jcfg), has_aux=True)(p)
        out.update(loss=loss, acc=m["accuracy"], grads=g)
    return out


@pytest.fixture(scope="module")
def resnet_cases():
    """Per case: params, state, batch and ``_resnet_ref``; for tiny16
    also the SGD trajectory.  One jit per case and one for the SGD step:
    XLA compiles these apart in a third of the time it takes for them
    together."""
    inputs, want = {}, {}
    for i, (name, (kw, size)) in enumerate(RESNET_CASES.items()):
        jcfg, _ = _resnet_cfgs(kw)
        params, state = weights(jresnet.init_params, jcfg, i)
        rng = np.random.default_rng(i)
        batch = {"x": rng.standard_normal((2, size, size, 3))
                 .astype(np.float32),
                 "y": rng.integers(0, jcfg.num_classes, 2).astype(np.int32)}
        inputs[name] = (params, state, batch)
        want[name] = to_numpy(jax.jit(functools.partial(_resnet_ref, name))(
            *inputs[name]))

    jcfg, _ = _resnet_cfgs(RESNET_CASES["tiny16"][0])

    @jax.jit
    def sgd_step(p, st, b):
        (loss, (st, _)), g = jax.value_and_grad(
            lambda p: jresnet.loss_fn(p, st, b, jcfg), has_aux=True)(p)
        return jax.tree_util.tree_map(lambda a, d: a - SGD_LR * d, p, g), \
            st, loss

    p, st, b = inputs["tiny16"]
    losses = []
    for _ in range(SGD_STEPS):
        p, st, loss = sgd_step(p, st, b)
        losses.append(loss)
    want["sgd"] = to_numpy(dict(losses=jnp.stack(losses), params=p, state=st))
    return inputs, want


@pytest.mark.parametrize("name", list(RESNET_CASES))
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_resnet_forward_matches_jax(resnet_cases, name, train):
    inputs, want = resnet_cases
    tree, st_tree, batch = inputs[name]
    _, cfg = _resnet_cfgs(RESNET_CASES[name][0])
    params, state = bridge(tree), bridge(st_tree)
    x = torch.from_numpy(batch["x"])
    with torch.no_grad():
        logits, st1 = tresnet.forward(params, state, x, cfg, train=True)
        if train:
            got_logits, got_state = logits, st1
            want_logits, want_state = (want[name]["logits"],
                                       want[name]["state"])
        else:
            got_logits, got_state = tresnet.forward(params, st1, x, cfg,
                                                    train=False)
            want_logits, want_state = (want[name]["eval_logits"],
                                       want[name]["eval_state"])
            # eval hands the running stats back as they are
            assert all(a is b for a, b in zip(convert._leaves(got_state),
                                              convert._leaves(st1)))
    assert got_logits.dtype == torch.float32
    tol = _r50_tol(want_logits) if name == "r50_64" else FWD
    np.testing.assert_allclose(got_logits.numpy(), want_logits, **tol)
    for (path, g), w in zip(
            jax.tree_util.tree_leaves_with_path(
                convert.params_to_numpy(got_state)),
            jax.tree_util.tree_leaves(want_state)):
        tol = _r50_tol(w) if name == "r50_64" else FWD
        np.testing.assert_allclose(g, w, **tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", GRAD_CASES)
def test_resnet_loss_grads_match_jax(resnet_cases, name):
    inputs, want = resnet_cases
    tree, st_tree, batch = inputs[name]
    _, cfg = _resnet_cfgs(RESNET_CASES[name][0])
    params = requiring_grad(tree)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, (new_state, m) = tresnet.loss_fn(params, bridge(st_tree), tb, cfg)
    np.testing.assert_allclose(loss.item(), want[name]["loss"], **FWD)
    assert m["accuracy"].item() == pytest.approx(float(want[name]["acc"]))
    assert not any(t.requires_grad for t in convert._leaves(new_state))
    assert_trees_close(grad_tree(loss, params), want[name]["grads"],
                        **GRAD)


def test_resnet_sgd_trajectory_matches_jax(resnet_cases):
    inputs, want = resnet_cases
    tree, st_tree, batch = inputs["tiny16"]
    _, cfg = _resnet_cfgs(RESNET_CASES["tiny16"][0])
    params, state = bridge(tree), bridge(st_tree)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = []
    for _ in range(SGD_STEPS):
        leaves = convert._leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss, (state, _) = tresnet.loss_fn(params, state, tb, cfg)
        grads = iter(torch.autograd.grad(loss, leaves))
        params = convert._map(
            lambda t: (t - SGD_LR * next(grads)).detach(), params)
        losses.append(loss.item())
    np.testing.assert_allclose(losses, want["sgd"]["losses"], **GRAD)
    assert losses[-1] < losses[0]
    assert_trees_close(convert.params_to_numpy(params),
                        want["sgd"]["params"], atol=1e-5, rtol=1e-4)
    assert_trees_close(convert.params_to_numpy(state),
                        want["sgd"]["state"], **GRAD)


def test_same_padding_is_xla_s():
    assert tresnet._same_pad(16, 3, 2) == (0, 1)
    assert tresnet._same_pad(15, 3, 2) == (1, 1)
    assert tresnet._same_pad(64, 7, 2) == (2, 3)
    assert tresnet._same_pad(84, 8, 4) == (2, 2)
    assert tresnet._same_pad(21, 4, 2) == (1, 2)
    assert tresnet._same_pad(8, 1, 2) == (0, 0)


# ----------------------------------------------------------- init trees

def test_init_trees_have_jax_layout():
    """Shapes and dtypes only, so JAX's side is traced, not run."""
    cfg = dict(MLP_CFG)
    assert_same_layout(tmlp.init_params(tmlp.MLPConfig(**cfg), device="cpu"),
                        jax_shapes(jmlp.init_params, jmlp.MLPConfig(**cfg)))
    for kw, _ in RESNET_CASES.values():
        jcfg, tcfg = _resnet_cfgs(kw)
        got = tresnet.init_params(tcfg, device="cpu")
        want = jax_shapes(jresnet.init_params, jcfg)
        assert_same_layout(got[0], want[0])
        assert_same_layout(got[1], want[1])
        assert tresnet.num_params(got[0]) == jresnet.num_params(want[0])


def test_entry_points_take_none_as_the_card(monkeypatch):
    """device=None means CUDA, and raises without a card, for every model
    of this file, BERT's and the RL catalog's."""
    from ray_tpu_torch.models import bert as tbert
    from ray_tpu_torch.models import zoo as tzoo

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: tmlp.init_params(tmlp.MLPConfig()),
        lambda: tresnet.init_params(tresnet.ResNetConfig.tiny()),
        lambda: tbert.init_params(tbert.BERTConfig.tiny()),
        lambda: tzoo.ActorCritic(tzoo.ModelConfig()).init(),
        lambda: tzoo.ActorCritic(tzoo.ModelConfig(kind="lstm"))
        .initial_state(2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
