"""The port's MADDPG against the JAX package's on the CPU, in f32.

- ``SpreadLine`` equal under the same seed and actions;
- two updates from the same stacked state: every agent's actor and
  critic gradient (read back from one SGD step at lr 1e3, both
  packages) within rel 1e-4, then at the default rates the actors,
  critics and their Polyak targets within atol 1e-5 and the losses
  within rel 1e-5;
- two whole ``train()`` iterations from a JAX ``save()``: both draw only
  from numpy after their init, so the returns and the nets agree;
- that save restored into the port and back; ``device=None`` without a
  card raises.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_port_rl import (assert_trees_close, assert_trees_equal,
                            jnp_tree, np_tree, t_tree)
from ray_tpu.rllib import maddpg as jmaddpg
from ray_tpu_torch.rllib import maddpg as tmaddpg
from ray_tpu_torch.rllib import optim

MADDPG_SMALL = dict(num_agents=2, rollout_length=40, learning_starts=16,
                    batch_size=8, hiddens=(16, 16), seed=0)


@pytest.fixture(scope="module")
def jmalgo():
    """One JAX MADDPG for the file, its initial save and state (the
    iteration test trains it last).  Its nets' init runs as one jit:
    eagerly, each op compiles on its own (~55 ms each on the CPU)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmaddpg, "_mlp_init", jax.jit(
            jmaddpg._mlp_init, static_argnums=(1, 2),
            static_argnames=("out_scale",)))
        algo = jmaddpg.MADDPGConfig(**MADDPG_SMALL).build()
    return algo, algo.save(), algo.state


def _port(cls, kw, saved, **over):
    port = cls(**dict(kw, **over), device="cpu").build()
    port.restore(saved)
    return port


def _maddpg_batch(B=8, N=2, seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.uniform(-1, 1, (B, N, N + 1)).astype(np.float32),
            "actions": rng.uniform(-1, 1, (B, N, 1)).astype(np.float32),
            "rewards": -rng.uniform(0, 2, B).astype(np.float32),
            "dones": (rng.random(B) < 0.2).astype(np.float32),
            "next_obs": rng.uniform(-1, 1, (B, N, N + 1)).astype(
                np.float32)}


def test_spread_line_matches():
    je, te = jmaddpg.SpreadLine(3, seed=1), tmaddpg.SpreadLine(3, seed=1)
    jo, to = je.reset(), te.reset()
    rng = np.random.default_rng(0)
    for _ in range(30):
        for a in jo:
            assert np.array_equal(jo[a], to[a])
        acts = {a: rng.uniform(-1, 1, 1).astype(np.float32)
                for a in je.agent_ids}
        jo, jr, jd, _ = je.step(acts)
        to, tr, td, _ = te.step(acts)
        assert jr == tr and jd == td


def _sgd_grads(update, state, batch):
    """(before - after) / lr of one step at lr 1e3: the gradients, as a
    tree like the state's (actors, critics)."""
    after = update(state, batch)[0]
    return [jax.tree_util.tree_map(lambda a, b: (a - b) / 1e3,
                                   np_tree(state[k]), np_tree(after[k]))
            for k in (0, 2)]


def test_maddpg_grads_and_updates_match(jmalgo):
    algo, saved, state0 = jmalgo
    port = _port(tmaddpg.MADDPGConfig, MADDPG_SMALL, saved)
    N, O, A = 2, 3, 1
    big = dataclasses.replace(algo.config, actor_lr=1e3, critic_lr=1e3)
    b = _maddpg_batch(seed=1)
    jgrads = _sgd_grads(jax.jit(jmaddpg.make_maddpg_update(
        big, N, O, A, algo.low, algo.high)), state0, jnp_tree(b))
    tstate = tuple(optim.params_on(np_tree(s), "cpu", grad=(k % 2 == 0))
                   for k, s in enumerate(state0))
    before = jax.tree_util.tree_map(np.copy, np_tree(tstate))
    tupdate = tmaddpg.make_maddpg_update(big, N, O, A, port.low, port.high)
    tupdate(tstate, t_tree(b))
    tgrads = [jax.tree_util.tree_map(lambda a, c: (a - c) / 1e3,
                                     before[k], np_tree(tstate[k]))
              for k in (0, 2)]
    for name, got, want in zip(("actors", "critics"), tgrads, jgrads):
        assert_trees_close(got, want, atol=1e-5, rtol=1e-4, err=name)

    state = state0
    for i in range(2):
        b = _maddpg_batch(seed=2 + i)
        state, jc, ja = algo._update(state, jnp_tree(b))
        _, tc, ta = port._update(port.state, t_tree(b))
        np.testing.assert_allclose(tc.item(), float(jc), rtol=1e-5)
        np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-5)
        for k in range(4):
            assert_trees_close(port.state[k], state[k], atol=1e-5,
                               err=f"update {i} net {k}")


def test_maddpg_train_iterations_and_save_match(jmalgo):
    algo, saved, _ = jmalgo
    port = _port(tmaddpg.MADDPGConfig, MADDPG_SMALL, saved)
    for _ in range(2):
        jr, tr = algo.train(), port.train()
        for k in ("critic_loss", "actor_loss"):
            np.testing.assert_allclose(tr[k], jr[k], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(port._ep_returns, algo._ep_returns,
                               rtol=1e-5)
    for k in range(4):
        assert_trees_close(port.state[k], algo.state[k], atol=1e-5)
    back = _port(tmaddpg.MADDPGConfig, MADDPG_SMALL, algo.save(), seed=4)
    assert_trees_equal(back.save()["payload"]["state"], algo.state)
    assert back.train()["training_iteration"] == 3


def test_device_none_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmaddpg.MADDPGConfig(**MADDPG_SMALL).build()
