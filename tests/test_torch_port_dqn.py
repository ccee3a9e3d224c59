"""The port's replay buffers, DQN and SimpleQ against the JAX package's
on the CPU, in f32.

- the replay buffers and segment trees: the same seed and the same adds
  give the same indices, columns, importance weights and priorities,
  exactly;
- ``_NStepWindow`` emits the same n-step transitions, exactly;
- ``q_values`` (dueling and plain) on params bridged from JAX's init;
- one ``make_dqn_update`` (double Q, dueling, importance weights) from
  the same state: params within atol 1e-5, the loss within rel 1e-4,
  |TD| within 1e-6; the target network is untouched;
- two whole ``train()`` iterations of DQN (prioritized replay, 3-step
  returns) and SimpleQ from a JAX ``save()`` restored into the port:
  both draw only from numpy after their init, so the actions, the
  buffer, its priorities and the params agree (params within atol 1e-5);
- a JAX ``save()`` restored into the port and back; ``device=None``
  without a card raises.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from _torch_port_rl import (assert_trees_close, assert_trees_equal,
                            jnp_tree, np_tree, t_tree, transition_batch)
from ray_tpu.rllib import dqn as jdqn
from ray_tpu.rllib import replay_buffer as jrb
from ray_tpu.rllib.sample_batch import SampleBatch as JBatch
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import dqn as tdqn
from ray_tpu_torch.rllib import optim
from ray_tpu_torch.rllib import replay_buffer as trb
from ray_tpu_torch.rllib.sample_batch import SampleBatch as TBatch

SMALL = dict(env="CartPole-v1", num_envs_per_worker=4, rollout_length=16,
             learning_starts=32, buffer_size=256, batch_size=16,
             target_update_freq=32, epsilon_decay_steps=200, lr=1e-3,
             hiddens=(32, 32), seed=0)


def _adds(seed=0, n=5, rows=7):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((rows, 3)).astype(np.float32),
             "a": rng.integers(0, 4, rows)} for _ in range(n)]


@pytest.mark.parametrize("kind", ["uniform", "prioritized", "reservoir"])
def test_replay_buffers_draw_the_same(kind):
    make = {"uniform": lambda m: m.ReplayBuffer(16, seed=3),
            "prioritized": lambda m: m.PrioritizedReplayBuffer(
                16, alpha=0.6, seed=3),
            "reservoir": lambda m: m.ReservoirReplayBuffer(16, seed=3)}[kind]
    jbuf, tbuf = make(jrb), make(trb)
    rng = np.random.default_rng(9)
    for cols in _adds():
        jbuf.add(JBatch(cols))
        tbuf.add(TBatch(cols))
        assert len(jbuf) == len(tbuf)
        js, ts = jbuf.sample(8), tbuf.sample(8)
        assert set(js) == set(ts)
        for k in js:
            assert np.array_equal(js[k], ts[k]), k
        if kind == "prioritized":
            td = rng.uniform(0, 3, 8)
            jbuf.update_priorities(js["batch_indexes"], td)
            tbuf.update_priorities(ts["batch_indexes"], td)
            assert np.array_equal(jbuf._sum.value, tbuf._sum.value)
            assert np.array_equal(jbuf._min.value, tbuf._min.value)
            assert jbuf._max_priority == tbuf._max_priority


def test_segment_trees_match():
    rng = np.random.default_rng(1)
    vals = rng.uniform(0, 5, 8)
    for jt, tt in ((jrb.SumSegmentTree(8), trb.SumSegmentTree(8)),
                   (jrb.MinSegmentTree(8), trb.MinSegmentTree(8))):
        for i, v in enumerate(vals):
            jt[i] = v
            tt[i] = v
        for s, e in ((0, 8), (2, 5), (3, 4)):
            assert jt.reduce(s, e) == tt.reduce(s, e)
    js, ts = jrb.SumSegmentTree(8), trb.SumSegmentTree(8)
    for i, v in enumerate(vals):
        js[i] = v
        ts[i] = v
    for m in rng.uniform(0, vals.sum(), 20):
        assert js.find_prefixsum_idx(m) == ts.find_prefixsum_idx(m)


def test_n_step_window_matches():
    rng = np.random.default_rng(2)
    jw, tw = jdqn._NStepWindow(3, 0.9), tdqn._NStepWindow(3, 0.9)
    for t in range(40):
        args = (np.full(2, t, np.float32), int(rng.integers(0, 2)),
                float(rng.standard_normal()), bool(rng.random() < 0.2),
                np.full(2, t + 1, np.float32))
        jo, to = jw.push(*args), tw.push(*args)
        assert len(jo) == len(to)
        for a, b in zip(jo, to):
            for x, y in zip(a, b):
                assert np.array_equal(x, y)


@pytest.fixture(scope="module")
def qparams():
    return {d: np_tree(jdqn.init_q_params(4, 3, (32, 32), d,
                                          jax.random.PRNGKey(1)))
            for d in (True, False)}


@pytest.mark.parametrize("dueling", [True, False])
def test_q_values_match_jax(qparams, dueling):
    p = qparams[dueling]
    got = tdqn.init_q_params(4, 3, (32, 32), dueling, 1, device="cpu")
    assert sorted(got) == sorted(p)
    obs = np.random.default_rng(3).standard_normal((20, 4)).astype(
        np.float32)
    want = jax.jit(jdqn.q_values)(p, obs)
    tq = tdqn.q_values(t_tree(p), torch.from_numpy(obs))
    np.testing.assert_allclose(tq.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_dqn_update_matches_jax(qparams):
    cfg = jdqn.DQNConfig(gamma=0.95, n_step=2, lr=1e-3)
    p = qparams[True]
    target = jax.tree_util.tree_map(lambda a: a * 0.9, p)
    batch = transition_batch(48, num_actions=3, seed=4)
    batch["weights"] = np.random.default_rng(5).uniform(
        0.3, 1.0, 48).astype(np.float32)
    tx = optax.adam(cfg.lr)
    jp, _, jl, jtd = jdqn.make_dqn_update(cfg, tx)(
        jnp_tree(p), jnp_tree(target), tx.init(jnp_tree(p)),
        jnp_tree(batch))

    tcfg = tdqn.DQNConfig(gamma=0.95, n_step=2, lr=1e-3)
    tp, tt = optim.params_on(p, "cpu"), optim.params_on(target, "cpu",
                                                        grad=False)
    _, _, tl, ttd = tdqn.make_dqn_update(tcfg)(
        tp, tt, optim.Adam(tp, tcfg.lr), t_tree(batch))
    assert_trees_close(tp, jp, atol=1e-5)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    np.testing.assert_allclose(ttd.numpy(), np.asarray(jtd), atol=1e-6)
    assert_trees_equal(tt, target)


@pytest.mark.parametrize("which", ["dqn", "simple_q"])
def test_two_train_iterations_match_jax(which):
    jcls, tcls = ((jdqn.DQNConfig, tdqn.DQNConfig) if which == "dqn"
                  else (jdqn.SimpleQConfig, tdqn.SimpleQConfig))
    kw = dict(SMALL, n_step=3) if which == "dqn" else SMALL
    jalgo = jcls(**kw).build()
    port = tcls(**kw, device="cpu").build()
    port.restore(jalgo.save())
    for it in range(2):
        jr, tr = jalgo.train(), port.train()
        for k in ("steps_this_iter", "buffer_size", "epsilon"):
            assert jr[k] == tr[k], k
        np.testing.assert_allclose(tr["mean_td_loss"], jr["mean_td_loss"],
                                   rtol=1e-4)
        assert jalgo._ep_returns == port._ep_returns
        assert_trees_close(port.params, jalgo.params, atol=1e-5,
                           err=f"iteration {it}")
        assert_trees_close(port.target_params, jalgo.target_params,
                           atol=1e-5)
    for k in jalgo.buffer._cols:
        assert np.array_equal(jalgo.buffer._cols[k], port.buffer._cols[k])
    if which == "dqn":
        np.testing.assert_allclose(port.buffer._sum.value,
                                   jalgo.buffer._sum.value, rtol=1e-5)
    assert port.opt.count == int(jalgo.opt_state[0].count) > 0


@pytest.mark.parametrize("which", ["dqn", "simple_q"])
def test_jax_save_restores_into_the_port_and_back(which):
    jcls, tcls = ((jdqn.DQNConfig, tdqn.DQNConfig) if which == "dqn"
                  else (jdqn.SimpleQConfig, tdqn.SimpleQConfig))
    jalgo = jcls(**SMALL).build()
    jalgo.train()
    jalgo.train()
    saved = jalgo.save()
    port = tcls(**dict(SMALL, seed=4), device="cpu").build()
    port.restore(saved)
    assert port.iteration == 2 and port._timesteps == jalgo._timesteps
    assert_trees_equal(port.params, jalgo.params)
    assert_trees_equal(port.target_params, jalgo.target_params)
    back = port.save()["payload"]
    opt = convert.torch_adam_to_optax(back["opt_state"],
                                      like=np_tree(jalgo.opt_state))
    assert_trees_equal(opt, jalgo.opt_state)
    assert np.isfinite(port.train()["mean_td_loss"])


def test_device_none_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tdqn.DQNConfig(**SMALL).build(),
                 lambda: tdqn.SimpleQConfig(**SMALL).build(),
                 lambda: tdqn.init_q_params(4, 2, (8,), True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
