"""The port's multi-agent env, rollout worker and MultiAgentPPO against the
JAX package's on the CPU, in f32.

- ``MultiAgentCartPole``: the same seeds and actions give the same
  observations, rewards and dones, exactly, agents dropping out as
  their poles fall;
- the rollout worker on policy params bridged from JAX's, with JAX's
  Gumbel noise fed in (one draw per ``jax.random.split`` of the JAX
  worker's key, in its order): the same actions, exactly, and the
  log-probabilities, values, advantages and targets within 1e-5;
- one whole ``MultiAgentPPO.train()`` from a JAX ``save()`` restored into
  the port, JAX's Gumbel noise and permutations fed in: the same
  per-policy batches, metrics within rel 1e-4, params and Adam moments
  within atol 1e-5;
- the save restored into the port and back through the Adam bridge;
  ``device=None`` without a card raises.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from _torch_port_rl import assert_trees_close, assert_trees_equal, np_tree
from ray_tpu.rllib import multi_agent as jma
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import multi_agent as tma

MAP = {"agent_0": "p0", "agent_1": "p1"}
SMALL = dict(train_batch_size=96, minibatch_size=32, num_epochs=2,
             rollout_length=48, lr=1e-3, hiddens=(16, 16), seed=0)


def _cfg(pkg, **kw):
    return (pkg.MultiAgentPPOConfig(
        env_maker=lambda: pkg.MultiAgentCartPole(2, seed=0), **kw)
        .multi_agent(policies=["p0", "p1"], policy_mapping_fn=MAP.get)
        .training(**SMALL))


class JaxKeys:
    """The JAX worker's key stream: each call splits the key as the worker
    does and returns the Gumbel noise ``jax.random.categorical`` adds."""

    def __init__(self, seed: int, num_actions: int = 2):
        self.rng, self.n = jax.random.PRNGKey(seed), num_actions

    @staticmethod
    @functools.partial(jax.jit, static_argnums=1)
    def _next(rng, n):
        rng, sub = jax.random.split(rng)
        return rng, jax.random.gumbel(sub, (n,))

    def __call__(self):
        self.rng, g = self._next(self.rng, self.n)
        return np.asarray(g)


def test_multi_agent_cartpole_matches():
    je, te = jma.MultiAgentCartPole(3, seed=4), tma.MultiAgentCartPole(
        3, seed=4)
    jo, to = je.reset(), te.reset()
    rng = np.random.default_rng(0)
    for _ in range(300):
        assert set(jo) == set(to)
        for a in jo:
            assert np.array_equal(jo[a], to[a])
        acts = {a: int(rng.integers(0, 2)) for a in jo}
        jo, jr, jd, _ = je.step(acts)
        to, tr, td, _ = te.step(acts)
        assert jr == tr and jd == td
        if jd["__all__"]:
            jo, to = je.reset(), te.reset()


def test_worker_with_jax_gumbel_noise_matches():
    jalgo = _cfg(jma).build()
    weights = {pid: np_tree(p) for pid, p in jalgo.params.items()}
    pcfg = {pid: None for pid in weights}
    jw = jma.MultiAgentRolloutWorker(
        lambda: jma.MultiAgentCartPole(2, seed=3), pcfg, MAP.get,
        rollout_length=30, seed=5)
    tw = tma.MultiAgentRolloutWorker(
        lambda: tma.MultiAgentCartPole(2, seed=3), pcfg, MAP.get,
        rollout_length=30, seed=5, device="cpu")
    tw.gumbel_fn = JaxKeys(5)
    jw.set_weights(weights)
    tw.set_weights(weights)
    jb, tb = jw.sample(), tw.sample()
    assert set(jb) == set(tb) == {"p0", "p1"}
    for pid in jb:
        assert np.array_equal(jb[pid]["actions"], tb[pid]["actions"])
        assert np.array_equal(jb[pid]["obs"], tb[pid]["obs"])
        for k in ("logp", "vf_preds", "advantages", "value_targets"):
            np.testing.assert_allclose(tb[pid][k], jb[pid][k], atol=1e-5,
                                       rtol=1e-5, err_msg=f"{pid} {k}")
    assert jw.episode_returns() == tw.episode_returns()


def test_worker_draws_its_own_noise_from_the_generator():
    weights = {"p0": np_tree(_cfg(jma).build().params["p0"])}
    out = []
    for _ in range(2):
        w = tma.MultiAgentRolloutWorker(
            lambda: tma.MultiAgentCartPole(2, seed=3), {"p0": None},
            lambda aid: "p0", rollout_length=30, seed=5, device="cpu")
        w.set_weights(weights)
        out.append(w.sample()["p0"]["actions"])
    assert np.array_equal(out[0], out[1]) and set(out[0]) == {0, 1}


def _jax_perms(jalgo_rng, policies, num_epochs):
    """The permutations JAX's update draws, policy by policy, from the
    algorithm's key (split per policy, then per epoch)."""
    state = {"rng": jalgo_rng}

    def perms(pid, n):
        state["rng"], sub = jax.random.split(state["rng"])
        return [np.asarray(jax.random.permutation(r, n))
                for r in jax.random.split(sub, num_epochs)]
    return perms


def _opt_back(port_opt, like):
    return convert.torch_adam_to_optax(np_tree(port_opt), like=np_tree(like))


@pytest.fixture(scope="module")
def iterated():
    """A JAX MultiAgentPPO and the port's, restored from its initial
    save, after one ``train()`` each with JAX's draws fed to the port."""
    jalgo = _cfg(jma).build()
    port = _cfg(tma, device="cpu").build()
    port.restore(jalgo.save())
    assert_trees_equal(port.params, jalgo.params)
    port.worker.gumbel_fn = JaxKeys(SMALL["seed"])
    port.perms_fn = _jax_perms(jalgo._rng, ["p0", "p1"],
                               SMALL["num_epochs"])
    return jalgo, jalgo.train(), port, port.train()


def test_train_iteration_from_a_jax_save_matches(iterated):
    jalgo, jr, port, tr = iterated
    assert set(jr) == set(tr)
    assert jr["steps_this_iter"] == tr["steps_this_iter"]
    assert jr["episode_reward_mean"] == tr["episode_reward_mean"]
    for k in jr:
        if "/" in k:
            np.testing.assert_allclose(tr[k], jr[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    for pid in ("p0", "p1"):
        assert_trees_close(port.params[pid], jalgo.params[pid], atol=1e-5,
                           err=pid)
        want = jalgo.opt_state[pid]
        assert_trees_close(_opt_back(port.opts[pid].state(), want), want,
                           atol=1e-5, rtol=1e-4, err=f"{pid} adam")


def test_save_restores_into_the_port_and_back(iterated):
    jalgo = iterated[0]
    saved = jalgo.save()
    port = _cfg(tma, device="cpu", seed=3).build()
    port.restore(saved)
    assert port.iteration == 1 and port._timesteps == jalgo._timesteps
    ck = port.save()["payload"]
    assert set(ck["params"]) == {"p0", "p1"}
    assert_trees_equal(ck["params"], jalgo.params)
    for pid, want in jalgo.opt_state.items():
        opt = _opt_back(ck["opt_state"][pid], want)
        assert jax.tree_util.tree_structure(opt) == \
            jax.tree_util.tree_structure(want)
        assert_trees_equal(opt, want)
    r = port.train()
    assert r["training_iteration"] == 2 and r["steps_this_iter"] > 0
    assert any(k.startswith("p1/") for k in r)


def test_unmapped_policy_raises_and_device_none_raises(monkeypatch):
    cfg = _cfg(tma, device="cpu").multi_agent(
        policies=["p0", "p1", "p2"])
    with pytest.raises(ValueError, match="received no samples"):
        cfg.build().train()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _cfg(tma).build()
