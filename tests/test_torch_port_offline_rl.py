"""The port's offline RL (JSON IO, importance sampling, BC, MARWIL, CQL)
against the JAX package's on the CPU, in f32.

- each package reads the other's JSON files column for column, and the
  importance-sampling estimates agree exactly;
- two whole ``train()`` iterations of BC, MARWIL and CQL from a JAX
  ``save()`` restored into the port, on the same offline CartPole data:
  the minibatch rows are the same numpy draws, so the params (within
  atol 1e-5), the metrics (within rel 1e-4), MARWIL's moving average of
  the squared advantage and CQL's soft target sync agree.  MARWIL's data
  has value targets of scale 40, so the weight cap of 20 is engaged;
- one ``make_cql_update`` from the same state: params within atol 1e-5,
  loss, TD and gap within rel 1e-4;
- JAX ``save()``s restored into the port and back; a missing
  ``input_path`` and ``device=None`` without a card raise.
"""

import numpy as np
import optax
import pytest
import torch

from _torch_port_rl import (assert_trees_close, assert_trees_equal,
                            jnp_tree, np_tree, t_tree, transition_batch,
                            write_offline_cartpole)
from ray_tpu.rllib import bc as jbc
from ray_tpu.rllib import cql as jcql
from ray_tpu.rllib import offline as joff
from ray_tpu.rllib.sample_batch import SampleBatch as JBatch
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import bc as tbc
from ray_tpu_torch.rllib import cql as tcql
from ray_tpu_torch.rllib import offline as toff
from ray_tpu_torch.rllib import optim
from ray_tpu_torch.rllib.sample_batch import SampleBatch as TBatch


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("offline")
    write_offline_cartpole(path, n_steps=400, value_targets=True)
    return str(path)


def _marwil_with_big_advantages(path, data_dir):
    cols = toff.JsonReader(data_dir).read_all()
    cols["value_targets"] = cols["value_targets"] * 8.0     # scale 40
    w = toff.JsonWriter(str(path))
    w.write(cols)
    w.close()
    return str(path)


def test_json_files_cross_read(tmp_path):
    rng = np.random.default_rng(0)
    b = {"obs": rng.standard_normal((6, 4)).astype(np.float32),
         "actions": rng.integers(0, 2, 6), "logp": np.zeros(6, np.float32)}
    jw = joff.JsonWriter(str(tmp_path / "j"))
    jw.write(JBatch(b))
    jw.close()
    tw = toff.JsonWriter(str(tmp_path / "t"))
    tw.write(TBatch(b))
    tw.write(TBatch(b))
    tw.close()
    got = toff.JsonReader(str(tmp_path / "j")).read_all()
    back = joff.JsonReader(str(tmp_path / "t")).read_all()
    assert back.count == 12 and got.count == 6
    for k, v in b.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v)
        assert np.array_equal(back[k][6:], v)
    with pytest.raises(FileNotFoundError):
        toff.JsonReader(str(tmp_path / "none"))


def test_importance_sampling_estimate_matches():
    rng = np.random.default_rng(1)
    b = {"logp": rng.normal(-0.7, 0.1, 50).astype(np.float32),
         "rewards": rng.standard_normal(50).astype(np.float32)}
    new = rng.normal(-0.7, 0.2, 50).astype(np.float32)
    assert toff.importance_sampling_estimate(TBatch(b), new) == \
        joff.importance_sampling_estimate(JBatch(b), new)


def _two_iterations(jalgo, port, metrics):
    port.restore(jalgo.save())
    assert_trees_equal(port.params, jalgo.params)
    for it in range(2):
        jr, tr = jalgo.train(), port.train()
        for k in metrics:
            np.testing.assert_allclose(tr[k], jr[k], rtol=1e-4, atol=1e-7,
                                       err_msg=f"{k} iteration {it}")
        assert_trees_close(port.params, jalgo.params, atol=1e-5,
                           err=f"iteration {it}")


@pytest.mark.parametrize("which", ["bc", "marwil"])
def test_bc_marwil_two_iterations_match_jax(which, data_dir, tmp_path):
    path = (data_dir if which == "bc"
            else _marwil_with_big_advantages(tmp_path, data_dir))
    jcls, tcls = ((jbc.BCConfig, tbc.BCConfig) if which == "bc"
                  else (jbc.MARWILConfig, tbc.MARWILConfig))
    kw = dict(input_path=path, batch_size=64, hiddens=(32, 32), lr=1e-3,
              seed=0, moving_average_sqd_adv_norm=4.0)
    jalgo, port = jcls(**kw).build(), tcls(**kw, device="cpu").build()
    if which == "marwil":       # the cap engages on this data
        ma = torch.tensor(4.0)
        _, v = tbc.policy_forward(port.params, torch.from_numpy(
            np.asarray(port.data["obs"])))
        adv = torch.from_numpy(np.asarray(port.data["value_targets"])) - v
        assert bool((torch.exp(adv / torch.sqrt(ma + 1e-8)) > 20).any())
    _two_iterations(jalgo, port, ("total_loss", "policy_loss", "vf_loss"))
    np.testing.assert_allclose(port._ma_adv_norm, jalgo._ma_adv_norm,
                               rtol=1e-6)
    obs = np.asarray(port.data["obs"][:50])
    assert np.array_equal(port.compute_actions(obs),
                          jalgo.compute_actions(obs))


def test_cql_update_matches_jax():
    from ray_tpu.rllib import dqn as jdqn
    import jax
    cfg = jcql.CQLConfig(cql_alpha=0.7, gamma=0.95, lr=1e-3)
    p = np_tree(jdqn.init_q_params(4, 3, (32, 32), False,
                                   jax.random.PRNGKey(2)))
    target = {k: {n: a * 0.8 for n, a in v.items()} for k, v in p.items()}
    batch = transition_batch(40, num_actions=3, seed=3)
    tx = optax.adam(cfg.lr)
    jp, _, jl, jtd, jgap = jcql.make_cql_update(cfg, tx)(
        jnp_tree(p), jnp_tree(target), tx.init(jnp_tree(p)),
        jnp_tree(batch))
    tcfg = tcql.CQLConfig(cql_alpha=0.7, gamma=0.95, lr=1e-3)
    tp = optim.params_on(p, "cpu")
    _, _, tl, ttd, tgap = tcql.make_cql_update(tcfg)(
        tp, optim.params_on(target, "cpu", grad=False),
        optim.Adam(tp, tcfg.lr), t_tree(batch))
    assert_trees_close(tp, jp, atol=1e-5)
    for g, w in ((tl, jl), (ttd, jtd), (tgap, jgap)):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-4)


def test_cql_two_iterations_match_jax(data_dir):
    kw = dict(input_path=data_dir, batch_size=32, grad_steps_per_iter=6,
              target_update_freq=4, tau=0.5, hiddens=(32, 32), seed=0)
    jalgo = jcql.CQLConfig(**kw).build()
    port = tcql.CQLConfig(**kw, device="cpu").build()
    _two_iterations(jalgo, port, ("loss", "td_loss", "cql_gap"))
    assert_trees_close(port.target_params, jalgo.target_params, atol=1e-5)
    assert port.compute_action(np.zeros(4, np.float32)) == \
        jalgo.compute_action(np.zeros(4, np.float32))


@pytest.mark.parametrize("which", ["bc", "marwil", "cql"])
def test_jax_save_restores_into_the_port_and_back(which, data_dir):
    jcls, tcls = {"bc": (jbc.BCConfig, tbc.BCConfig),
                  "marwil": (jbc.MARWILConfig, tbc.MARWILConfig),
                  "cql": (jcql.CQLConfig, tcql.CQLConfig)}[which]
    kw = dict(input_path=data_dir, batch_size=32, hiddens=(16,), seed=0)
    if which == "cql":
        kw["grad_steps_per_iter"] = 3
    jalgo = jcls(**kw).build()
    jalgo.train()
    saved = jalgo.save()
    port = tcls(**dict(kw, seed=9), device="cpu").build()
    port.restore(saved)
    assert port.iteration == 1 and port._timesteps == jalgo._timesteps
    back = port.save()["payload"]
    assert_trees_equal(back["params"], jalgo.params)
    if which == "cql":
        assert_trees_equal(back["target_params"], jalgo.target_params)
        assert back["grad_steps"] == 3
    else:
        assert back["ma_adv_norm"] == jalgo._ma_adv_norm
    opt = convert.torch_adam_to_optax(back["opt_state"],
                                      like=np_tree(jalgo.opt_state))
    assert_trees_equal(opt, jalgo.opt_state)
    assert port.train()["training_iteration"] == 2


def test_refusals(monkeypatch, data_dir):
    for cfg in (tbc.BCConfig(device="cpu"), tcql.CQLConfig(device="cpu")):
        with pytest.raises(ValueError, match="input_path"):
            cfg.build()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cfg in (tbc.BCConfig(input_path=data_dir),
                tbc.MARWILConfig(input_path=data_dir),
                tcql.CQLConfig(input_path=data_dir)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cfg.build()
