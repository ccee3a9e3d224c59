"""The port's RLModule / Learner / LearnerGroup against the JAX package's
on the CPU, in f32.

- ``DiscretePGModule``'s forward passes and its loss value and grads
  (rtol 1e-5) on params bridged from JAX's init; its exploration samples
  from the batch's generator, with the log-probabilities of what it drew;
- ``Learner`` and ``LearnerGroup`` (inline): the JAX learner's params
  and optax state restored into the port, three updates on the same
  batches: params within atol 1e-5, losses within rel 1e-4, and the
  port's state back in optax's layout equal to JAX's Adam state within
  the same bounds; a ``MultiRLModule`` over two policies the same way;
- ``LearnerGroup(num_learners > 0)`` and ``device=None`` without a card
  raise.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_port_rl import (assert_trees_close, grads_of, jnp_tree,
                            np_tree, rollout_batch, t_tree, with_grad)
from ray_tpu.rllib import rl_module as jrl
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import optim
from ray_tpu_torch.rllib import rl_module as trl

KEYS = ("obs", "actions", "advantages", "value_targets")


def _batch(seed, n=64):
    b = rollout_batch(n, seed=seed)
    return {k: b[k] for k in KEYS}


@pytest.fixture(scope="module")
def params():
    return np_tree(jrl.DiscretePGModule(4, 2).init_params(
        jax.random.PRNGKey(0)))


def test_forward_passes_match_jax(params):
    jm, tm = jrl.DiscretePGModule(4, 2), trl.DiscretePGModule(4, 2)
    obs = np.random.default_rng(1).standard_normal((16, 4)).astype(
        np.float32)
    tp = optim.params_on(params, "cpu", grad=False)
    ji = jm.forward_inference(jnp_tree(params), {"obs": obs})
    ti = tm.forward_inference(tp, {"obs": torch.from_numpy(obs)})
    for k in ("logits", "vf"):
        np.testing.assert_allclose(ti[k].numpy(), np.asarray(ji[k]),
                                   atol=1e-6, rtol=1e-6)
    assert np.array_equal(ti["actions"].numpy(), np.asarray(ji["actions"]))
    draws = [tm.forward_exploration(tp, {
        "obs": torch.from_numpy(obs),
        "generator": torch.Generator().manual_seed(3)}) for _ in range(2)]
    assert torch.equal(draws[0]["actions"], draws[1]["actions"])
    logp = torch.log_softmax(ti["logits"], -1).gather(
        1, draws[0]["actions"][:, None])[:, 0]
    assert torch.equal(draws[0]["logp"], logp)


def test_loss_value_and_grads_match_jax(params):
    jm, tm = jrl.DiscretePGModule(4, 2), trl.DiscretePGModule(4, 2)
    batch = _batch(2, n=96)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(jnp_tree(params),
                                                  jnp_tree(batch))
    tp = with_grad(params)
    tl = tm.loss(tp, t_tree(batch))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert_trees_close(optim.tree_unflatten(
        tp, grads_of(tl, optim.tree_leaves(tp))), jg, atol=1e-5, rtol=1e-5)


def _learners(kind):
    """(JAX learner, the port's with the JAX state restored, batches)."""
    if kind == "multi":
        jmod = jrl.MultiRLModule({"p0": jrl.DiscretePGModule(4, 2),
                                  "p1": jrl.DiscretePGModule(4, 2)})
        tmod = trl.MultiRLModule({"p0": trl.DiscretePGModule(4, 2),
                                  "p1": trl.DiscretePGModule(4, 2)})
        batches = [{"p0": _batch(10 + i), "p1": _batch(20 + i)}
                   for i in range(3)]
    else:
        jmod, tmod = jrl.DiscretePGModule(4, 2), trl.DiscretePGModule(4, 2)
        batches = [_batch(10 + i) for i in range(3)]
    jl = jrl.Learner(jmod, lr=0.01, seed=1)
    if kind == "group":
        tl = trl.LearnerGroup(lambda: tmod, 0, lr=0.01, device="cpu")
    else:
        tl = trl.Learner(tmod, lr=0.01, device="cpu")
    tl.set_state({"params": jl.get_weights(),
                  "opt_state": np_tree(jl.opt_state)})
    assert_trees_close(tl.get_weights(), jl.get_weights(), atol=0)
    return jl, tl, batches


@pytest.mark.parametrize("kind", ["learner", "group", "multi"])
def test_updates_match_jax(kind):
    jl, tl, batches = _learners(kind)
    for i, b in enumerate(batches):
        jr, tr = jl.update(b), tl.update(b)
        np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=1e-4)
        assert_trees_close(tl.get_weights(), jl.get_weights(), atol=1e-5,
                           err=f"update {i}")
    state = tl.get_state()
    opt = convert.torch_adam_to_optax(state["opt_state"],
                                      like=np_tree(jl.opt_state))
    assert jax.tree_util.tree_structure(opt) == \
        jax.tree_util.tree_structure(jl.opt_state)
    assert int(opt[0].count) == 3
    assert_trees_close(opt, jl.opt_state, atol=1e-5, rtol=1e-4)


def test_refusals(monkeypatch):
    with pytest.raises(NotImplementedError, match="multi-learner"):
        trl.LearnerGroup(lambda: trl.DiscretePGModule(4, 2), 2,
                         device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: trl.Learner(trl.DiscretePGModule(4, 2)),
                 lambda: trl.LearnerGroup(
                     lambda: trl.DiscretePGModule(4, 2))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
