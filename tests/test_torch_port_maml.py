"""The port's MAML against the JAX package's on the CPU, in f32.

- ``SinusoidTasks``: the same seed gives the same tasks, exactly;
  ``mlp_forward`` on params bridged from JAX's init;
- the meta-loss and its SECOND-ORDER meta-gradient (``autograd.grad``
  with ``create_graph=True`` through three inner SGD steps, every task of
  the meta-batch at once) against ``jax.grad`` through the JAX package's
  ``lax.scan`` (read through an optax transform whose state is the
  gradients) within rel 1e-5, and the first-order variant's against
  JAX's ``first_order=True``; the two differ;
- two Adam meta-updates' params within atol 1e-5, then a whole
  ``training_step`` from a JAX ``save()`` (tasks drawn from numpy);
- ``adapt`` and ``evaluate_adaptation`` on the same tasks;
- that save restored into the port and back through the Adam bridge;
  ``device=None`` without a card raises.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_port_rl import (GradTap, assert_trees_close, assert_trees_equal,
                            jax_grad_tap, jnp_tree, opt_back, t_tree)
from ray_tpu.rllib import maml as jmaml
from ray_tpu_torch.rllib import maml as tmaml

SMALL = dict(meta_batch_size=5, meta_iters_per_step=2, hiddens=(16, 16),
             seed=0)


@pytest.fixture(scope="module")
def jalgo():
    algo = jmaml.MAMLConfig(**SMALL).build()
    return algo, algo.save(), algo.params


def _port(saved, **kw):
    port = tmaml.MAMLConfig(**dict(SMALL, **kw), device="cpu").build()
    port.restore(saved)
    return port


def test_tasks_and_forward_match(jalgo):
    algo, saved, params = jalgo
    a, b = jmaml.SinusoidTasks(seed=3), tmaml.SinusoidTasks(seed=3)
    for _ in range(3):
        ja, tb = a.sample(4), b.sample(4)
        for k in ja:
            assert np.array_equal(ja[k], tb[k]), k
    port = _port(saved)
    x = np.linspace(-5, 5, 40, dtype=np.float32)[:, None]
    np.testing.assert_allclose(
        tmaml.mlp_forward(port.params, torch.from_numpy(x)).detach()
        .numpy(), np.asarray(jax.jit(jmaml.mlp_forward)(params, x)),
        atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("first_order", [False, True])
def test_meta_gradient_matches_jax_grad_through_the_scan(jalgo,
                                                         first_order):
    algo, saved, params0 = jalgo
    cfg = dataclasses.replace(algo.config, first_order=first_order)
    batch = jmaml.SinusoidTasks(seed=5).sample(5)
    _, jg, jl = jmaml.make_maml_update(cfg, jax_grad_tap())[0](
        params0, (), jnp_tree(batch))
    port = _port(saved, first_order=first_order)
    tap = GradTap(port.params)
    _, _, tl = port._update(port.params, tap, t_tree(batch))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert_trees_close(tap.grads, jg, atol=1e-6, rtol=1e-5)
    if first_order:       # the second-order terms are not negligible
        second = GradTap(port.params)
        _port(saved)._update(port.params, second, t_tree(batch))
        gap = max(float((a - b).abs().max()) for a, b in zip(
            jax.tree_util.tree_leaves(second.grads),
            jax.tree_util.tree_leaves(tap.grads)))
        assert gap > 1e-3, gap


def test_meta_updates_training_step_and_adaptation_match(jalgo):
    algo, saved, params0 = jalgo
    port = _port(saved)
    params, opt_state = params0, algo.opt_state
    tasks = jmaml.SinusoidTasks(seed=7)
    for i in range(2):
        b = tasks.sample(5)
        params, opt_state, jl = algo._update(params, opt_state,
                                             jnp_tree(b))
        _, _, tl = port._update(port.params, port.opt, t_tree(b))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
        assert_trees_close(port.params, params, atol=1e-5,
                           err=f"update {i}")

    port = _port(saved)
    jr, tr = algo.train(), port.train()
    np.testing.assert_allclose(tr["meta_loss"], jr["meta_loss"], rtol=1e-5)
    assert_trees_close(port.params, algo.params, atol=1e-5)
    b = jmaml.SinusoidTasks(seed=8).sample(3)
    jq = algo.adapt(algo.params, b["xs"][0], b["ys"][0])
    tq = port.adapt(port.params, torch.from_numpy(b["xs"][0]),
                    torch.from_numpy(b["ys"][0]))
    assert_trees_close(tq, jq, atol=1e-5)
    algo.tasks, port.tasks = (jmaml.SinusoidTasks(seed=9),
                              tmaml.SinusoidTasks(seed=9))
    je, te = algo.evaluate_adaptation(6), port.evaluate_adaptation(6)
    for k in je:
        np.testing.assert_allclose(te[k], je[k], rtol=1e-5, err_msg=k)


def test_jax_save_restores_into_the_port_and_back(jalgo):
    algo = jalgo[0]        # trained by the test above
    back = _port(algo.save(), seed=4)
    ck = back.save()["payload"]
    assert_trees_equal(ck["params"], algo.params)
    assert_trees_equal(opt_back(ck["opt_state"], algo.opt_state),
                       algo.opt_state)
    assert back._timesteps == algo._timesteps > 0
    assert np.isfinite(back.train()["meta_loss"])


def test_device_none_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmaml.MAMLConfig(**SMALL).build()
