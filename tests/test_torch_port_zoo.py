"""The port's RL catalog (``models/zoo.py``) against the JAX package on
the CPU.

Parameters are numpy draws in the tree of the JAX package's
``ActorCritic.init`` (biases not zero), bridged through
``params_from_numpy(..., device="cpu")``; observations come from numpy
seeds, and the JAX references of every case are one jit.

- FCNet under each of the four activations (gelu is the tanh form,
  swish is silu).
- VisionNet on uint8 84x84x4 frames (SAME convs 8x8/4 and 4x4/2, fc input
  11 x 11 x 32 in NHWC order), ``apply`` and ``apply_seq``.
- LSTM over two windows with the carry threaded, and the +1.0 on its
  forget gate.
- GTrXL: ``apply_seq``, and causality within the window.
- ``apply`` raises on the recurrent kinds; the init trees are JAX's.

Tolerance, f32: atol = rtol = 1e-5 on outputs and carries."""

import jax
import numpy as np
import pytest
import torch

from _torch_port_trees import (  # no_onednn: an autouse fixture
    FWD, assert_same_layout, assert_trees_close, bridge, jax_shapes,
    no_onednn, to_numpy, weights)
from ray_tpu.models import zoo as jzoo
from ray_tpu_torch.models import zoo as tzoo

# name -> (ModelConfig kwargs, batch, window T (None: feedforward only))
CASES = {
    "fcnet_tanh": (dict(kind="fcnet", obs_shape=(4,)), 8, 3),
    "fcnet_relu": (dict(kind="fcnet", obs_shape=(4,),
                        fcnet_activation="relu"), 8, None),
    "fcnet_gelu": (dict(kind="fcnet", obs_shape=(4,),
                        fcnet_activation="gelu"), 8, None),
    "fcnet_swish": (dict(kind="fcnet", obs_shape=(4,),
                         fcnet_activation="swish"), 8, None),
    "visionnet": (dict(kind="visionnet", obs_shape=(84, 84, 4),
                       num_actions=6), 2, 2),
    "lstm": (dict(kind="lstm", obs_shape=(6,), num_actions=3,
                  cell_size=16), 3, 5),
    "gtrxl": (dict(kind="gtrxl", obs_shape=(6,), num_actions=3,
                   attn_dim=32), 2, 8),
}


def _jax_init(cfg, key):
    return jzoo.ActorCritic(cfg).init(key)


def _obs(kind, rng, shape):
    if kind == "visionnet":
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def cases():
    """Per case: params, observations ([B, ...] and, for a window, two
    [B, T, ...] windows) and JAX's outputs, one jit for all."""
    inputs = {}
    for i, (name, (kw, b, t)) in enumerate(CASES.items()):
        cfg = jzoo.ModelConfig(**kw)
        rng = np.random.default_rng(i)
        obs = {"ff": _obs(cfg.kind, rng, (b, *cfg.obs_shape))}
        if t is not None:
            obs["seq"] = [_obs(cfg.kind, rng, (b, t, *cfg.obs_shape))
                          for _ in range(2)]
        inputs[name] = (weights(_jax_init, cfg, i), obs)

    def ref(inputs):
        out = {}
        for name, (p, obs) in inputs.items():
            ac = jzoo.ActorCritic(jzoo.ModelConfig(**CASES[name][0]))
            o = {}
            if not ac.is_recurrent:
                o["ff"] = ac.apply(p, obs["ff"])
            if "seq" in obs:
                state = None
                o["seq"] = []
                for window in obs["seq"]:
                    logits, value, state = ac.apply_seq(p, window, state)
                    o["seq"].append((logits, value, state))
            out[name] = o
        return out

    return inputs, to_numpy(jax.jit(ref)(inputs))


def _port(name):
    return tzoo.ActorCritic(tzoo.ModelConfig(**CASES[name][0]))


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[0]["kind"] in ("fcnet", "visionnet")])
def test_apply_matches_jax(cases, name):
    inputs, want = cases
    tree, obs = inputs[name]
    with torch.no_grad():
        logits, value = _port(name).apply(bridge(tree),
                                          torch.from_numpy(obs["ff"]))
    np.testing.assert_allclose(logits.numpy(), want[name]["ff"][0], **FWD)
    np.testing.assert_allclose(value.numpy(), want[name]["ff"][1], **FWD)
    assert value.shape == (CASES[name][1],)


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[2] is not None])
def test_apply_seq_matches_jax_over_two_windows(cases, name):
    """The second window starts from the state the first returned: the
    LSTM's (h, c) carry threads across windows."""
    inputs, want = cases
    tree, obs = inputs[name]
    ac, params = _port(name), bridge(tree)
    state = None
    for i, window in enumerate(obs["seq"]):
        with torch.no_grad():
            logits, value, state = ac.apply_seq(
                params, torch.from_numpy(window), state)
        w_logits, w_value, w_state = want[name]["seq"][i]
        np.testing.assert_allclose(logits.numpy(), w_logits, **FWD)
        np.testing.assert_allclose(value.numpy(), w_value, **FWD)
        if ac.cfg.kind == "lstm":
            for got, w in zip(state, w_state):
                np.testing.assert_allclose(got.numpy(), w, **FWD)
        else:
            assert state is None and w_state is None
    b, t = window.shape[:2]
    assert logits.shape == (b, t, ac.cfg.num_actions)


def test_lstm_forget_gate_is_biased_by_one():
    """With every weight 0 the gates are sigmoid(0) = 0.5 and tanh(0) = 0,
    except the forget gate's sigmoid(1.0): one step from c = 1 gives
    c' = sigmoid(1.0) and h' = 0.5 tanh(c')."""
    cfg = tzoo.LSTMNetConfig(in_dim=3, cell_size=4)
    params = tzoo.lstm_init(cfg, torch.Generator().manual_seed(0))
    params = {k: {n: torch.zeros_like(t) for n, t in v.items()}
              for k, v in params.items()}
    carry = (torch.zeros(2, 4), torch.ones(2, 4))
    ys, (h, c) = tzoo.lstm_forward(params, torch.randn(2, 1, 3), carry, cfg)
    want_c = torch.sigmoid(torch.tensor(1.0))
    torch.testing.assert_close(c, torch.full((2, 4), want_c.item()))
    torch.testing.assert_close(h, 0.5 * torch.tanh(c))
    torch.testing.assert_close(ys[:, 0], h)


def test_gtrxl_is_causal_within_its_window(cases):
    """Changing the last step's observation changes no earlier step."""
    inputs, _ = cases
    tree, obs = inputs["gtrxl"]
    ac, params = _port("gtrxl"), bridge(tree)
    window = torch.from_numpy(obs["seq"][0])
    moved = window.clone()
    moved[:, -1] += 1.0
    with torch.no_grad():
        a, va, _ = ac.apply_seq(params, window)
        b, vb, _ = ac.apply_seq(params, moved)
    torch.testing.assert_close(a[:, :-1], b[:, :-1], atol=0, rtol=0)
    torch.testing.assert_close(va[:, :-1], vb[:, :-1], atol=0, rtol=0)
    assert not torch.allclose(a[:, -1], b[:, -1])


@pytest.mark.parametrize("kind", ["lstm", "gtrxl"])
def test_apply_refuses_recurrent_kinds(kind):
    ac = tzoo.ActorCritic(tzoo.ModelConfig(kind=kind))
    params = ac.init(device="cpu")
    with pytest.raises(ValueError, match="apply_seq"):
        ac.apply(params, torch.zeros(2, 4))


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown model kind"):
        tzoo.ActorCritic(tzoo.ModelConfig(kind="resnet"))


@pytest.mark.parametrize("name", list(CASES))
def test_init_tree_is_jax_s(name):
    kw = CASES[name][0]
    ac = _port(name)
    got = ac.init(device="cpu")
    assert_same_layout(got, jax_shapes(_jax_init, jzoo.ModelConfig(**kw)))
    assert ac.is_recurrent == (kw["kind"] in ("lstm", "gtrxl"))
    if kw["kind"] == "visionnet":
        assert got["trunk"]["fc"]["w"].shape == (11 * 11 * 32, 256)


def test_initial_state_and_generator_device():
    ac = tzoo.ActorCritic(tzoo.ModelConfig(kind="lstm", cell_size=8))
    h, c = ac.initial_state(3, device="cpu")
    assert h.shape == c.shape == (3, 8) and not h.any() and not c.any()
    assert tzoo.ActorCritic(tzoo.ModelConfig()).initial_state(3) is None
    a = ac.init(7, device="cpu")
    b = ac.init(7, device="cpu")
    assert_trees_close(a, b, atol=0, rtol=0)
