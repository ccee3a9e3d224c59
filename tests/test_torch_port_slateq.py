"""The port's SlateQ against the JAX package's on the CPU, in f32.

- ``InterestEvolution``: the same seed and slates give the same
  observations, clicks and rewards, exactly; ``enumerate_slates`` equal;
- ``best_slate`` (per-item Q, choice scores, the choice-weighted value of
  every enumerated slate) on params bridged from JAX's init: the same
  items;
- the update's two losses (click-masked TD against the target net's best
  next slate, the choice model's cross-entropy with no click as class S)
  and every gradient against JAX's own ``value_and_grad`` (read through
  an optax transform whose state is the gradients) within rel 1e-5, then
  two Adam updates' params within atol 1e-5;
- two whole ``train()`` iterations from a JAX ``save()``: both draw only
  from numpy after their init; the port acts on JAX's slates, each its
  own greedy slate up to the order of its items (a tie: a slate's value
  ignores the order); the buffer and the params agree;
- that save restored into the port and back through the Adam bridge;
  ``device=None`` without a card raises.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_port_rl import (GradTap, assert_trees_close, assert_trees_equal,
                            jax_grad_tap, jnp_tree, np_tree, opt_back,
                            t_tree)
from ray_tpu.rllib import slateq as jslateq
from ray_tpu_torch.rllib import optim
from ray_tpu_torch.rllib import slateq as tslateq

SMALL = dict(num_candidates=5, slate_size=2, rollout_length=40,
             learning_starts=16, batch_size=8, hiddens=(16,),
             target_update_freq=24, epsilon_decay_steps=60, seed=0)


@pytest.fixture(scope="module")
def jalgo():
    """One JAX SlateQ for the file, its initial save and params (the
    iteration test trains it last); its init runs as one jit (eagerly,
    each op compiles on its own, ~55 ms each on the CPU)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jslateq, "init_slateq_params", jax.jit(
            jslateq.init_slateq_params, static_argnums=(0, 1)))
        algo = jslateq.SlateQConfig(**SMALL).build()
    return algo, algo.save(), algo.params


def _port(saved, **kw):
    port = tslateq.SlateQConfig(**dict(SMALL, **kw), device="cpu").build()
    port.restore(saved)
    return port


def _batch(B=8, C=5, E=4, S=2, seed=0):
    rng = np.random.default_rng(seed)

    def unit(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)
    return {"user": unit(B, E), "doc": unit(B, C, E),
            "next_user": unit(B, E), "next_doc": unit(B, C, E),
            "actions": np.stack([rng.choice(C, S, replace=False)
                                 for _ in range(B)]).astype(np.int64),
            "click": rng.integers(0, S + 1, B).astype(np.int64),
            "rewards": rng.uniform(0, 1, B).astype(np.float32),
            "dones": (rng.random(B) < 0.2).astype(np.float32)}


def test_env_and_slates_match():
    assert np.array_equal(jslateq.enumerate_slates(6, 3),
                          tslateq.enumerate_slates(6, 3))
    je = jslateq.InterestEvolution(num_candidates=6, seed=3)
    te = tslateq.InterestEvolution(num_candidates=6, seed=3)
    jo, to = je.reset(), te.reset()
    rng = np.random.default_rng(0)
    for _ in range(50):
        for k in jo:
            assert np.array_equal(jo[k], to[k])
        slate = rng.choice(6, 2, replace=False)
        jo, jr, jd, ji = je.step(slate)
        to, tr, td, ti = te.step(slate)
        assert (jr, jd, ji) == (tr, td, ti)
        if jd:
            jo, to = je.reset(), te.reset()


def test_best_slate_matches(jalgo):
    algo, saved, params = jalgo
    port = _port(saved)
    for i in range(6):
        b = _batch(B=1, seed=10 + i)
        want = np.asarray(algo._best_slate(params, b["user"], b["doc"]))
        got = port._best_slate(port.params, torch.from_numpy(b["user"]),
                               torch.from_numpy(b["doc"]))
        # the same items; their order is a tie (see the iteration test)
        assert np.array_equal(np.sort(got.numpy()), np.sort(want))


def test_update_losses_grads_and_steps_match(jalgo):
    algo, saved, params0 = jalgo
    port = _port(saved)
    rng = np.random.default_rng(9)
    other = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(
            np.float32), np_tree(params0))
    optim.copy_into(port.target_params, other)
    b = _batch(seed=2)
    _, jupdate = jslateq.make_slateq_fns(algo.config, algo.slates,
                                         jax_grad_tap())
    _, jg, jql, jcl = jupdate(params0, other, (), jnp_tree(b))
    tap = GradTap(port.params)
    _, _, tql, tcl = port._update(port.params, port.target_params, tap,
                                  t_tree(b))
    np.testing.assert_allclose(tql.item(), float(jql), rtol=1e-5)
    np.testing.assert_allclose(tcl.item(), float(jcl), rtol=1e-5)
    assert_trees_close(tap.grads, jg, atol=1e-6, rtol=1e-5)

    params, opt_state = params0, algo.opt_state
    for i in range(2):
        b = _batch(seed=3 + i)
        params, opt_state, jql, jcl = algo._update(params, other, opt_state,
                                                   jnp_tree(b))
        _, _, tql, tcl = port._update(port.params, port.target_params,
                                      port.opt, t_tree(b))
        np.testing.assert_allclose([tql.item(), tcl.item()],
                                   [float(jql), float(jcl)], rtol=1e-5)
        assert_trees_close(port.params, params, atol=1e-5,
                           err=f"update {i}")


def test_train_iterations_and_save_match(jalgo):
    """A slate's value does not depend on the order of its items, so the
    greedy argmax ties (a, b) with (b, a) and each package's f32 rounding
    breaks the tie its own way: the port acts on JAX's slates, each the
    port's own greedy choice up to order (the numpy draws advance the
    same either way)."""
    algo, saved, _ = jalgo
    port = _port(saved)
    played, j_act, t_act = [], algo._act, port._act
    algo._act = lambda obs: played.append(j_act(obs)) or played[-1]
    replay = iter(played)

    def act(obs):
        mine, theirs = t_act(obs), next(replay)
        assert sorted(mine) == sorted(theirs), (mine, theirs)
        return theirs
    port._act = act
    for _ in range(2):
        jr = algo.train()
        tr = port.train()
        for k in ("mean_q_loss", "mean_choice_loss"):
            np.testing.assert_allclose(tr[k], jr[k], rtol=1e-4, atol=1e-7)
        assert jr["replay_size"] == tr["replay_size"]
    np.testing.assert_allclose(port._ep_returns, algo._ep_returns,
                               rtol=1e-6)
    for k, v in algo.buffer._cols.items():
        assert np.array_equal(v[:algo.buffer._size],
                              port.buffer._cols[k][:port.buffer._size]), k
    assert_trees_close(port.params, algo.params, atol=1e-5)

    back = _port(algo.save(), seed=4)
    ck = back.save()["payload"]
    assert_trees_equal(ck["params"], algo.params)
    assert_trees_equal(ck["target_params"], algo.target_params)
    assert_trees_equal(opt_back(ck["opt_state"], algo.opt_state),
                       algo.opt_state)
    assert back.train()["training_iteration"] == 3


def test_device_none_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tslateq.SlateQConfig(**SMALL).build()
