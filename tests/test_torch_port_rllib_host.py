"""The port's host-side RLlib pieces against the JAX package's: the
ModelCatalog, the connectors and the policy server, on the CPU.

- ``ModelCatalog.get_model`` picks the same trunk and config as the JAX
  package's for flat, image, lstm and attention spaces; its fcnet
  applies params bridged from JAX's init within 1e-6; ``get_action_dist``
  draws the same actions from the same numpy seed;
- every connector and a pipeline of them give the same outputs and
  saved state, exactly; a pipeline saved by either package loads in the
  other and continues the same;
- the policy server: a JAX ``PolicyClient`` drives the port's
  ``PolicyServerInput`` and the port's client drives the JAX server,
  both on 127.0.0.1 with an OS-chosen port and a timeout on every
  request; the actions come from the server's policy, the finished
  episodes arrive as the server package's ``SampleBatch`` with the same
  columns, and an unknown episode is refused.
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib import catalog as jcatalog
from ray_tpu.rllib import connectors as jconn
from ray_tpu.rllib import policy_server as jserver
from ray_tpu.rllib.sample_batch import SampleBatch as JBatch
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.rllib import catalog as tcatalog
from ray_tpu_torch.rllib import connectors as tconn
from ray_tpu_torch.rllib import policy_server as tserver
from ray_tpu_torch.rllib.sample_batch import SampleBatch as TBatch

SPACES = [((4,), {"fcnet_hiddens": (16, 16)}),
          ((8, 8, 3), {"conv_filters": ((4, 3, 2),)}),
          ((5,), {"use_lstm": True, "lstm_cell_size": 8}),
          ((5,), {"use_attention": True, "attention_dim": 16,
                  "attention_num_layers": 1})]


@pytest.mark.parametrize("obs_shape,mc", SPACES)
def test_catalog_picks_the_same_model(obs_shape, mc):
    j = jcatalog.ModelCatalog.get_model(obs_shape, 3, mc)
    t = tcatalog.ModelCatalog.get_model(obs_shape, 3, mc)
    assert vars(j.cfg) == vars(t.cfg)
    assert j.is_recurrent == t.is_recurrent


def test_catalog_fcnet_applies_jax_params_and_draws_the_same():
    mc = {"fcnet_hiddens": (16, 16), "fcnet_activation": "relu"}
    j = jcatalog.ModelCatalog.get_model((4,), 3, mc)
    t = tcatalog.ModelCatalog.get_model((4,), 3, mc)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(j.init)(
        jax.random.PRNGKey(0)))
    obs = np.random.default_rng(0).standard_normal((7, 4)).astype(
        np.float32)
    jl, jv = jax.jit(j.apply)(params, obs)
    tl, tv = t.apply(params_from_numpy(params, device="cpu"),
                     torch.from_numpy(obs))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    logits = np.asarray(jl)
    for det in (True, False):
        a = jcatalog.ModelCatalog.get_action_dist(
            logits, deterministic=det, rng=np.random.default_rng(3))
        b = tcatalog.ModelCatalog.get_action_dist(
            logits, deterministic=det, rng=np.random.default_rng(3))
        assert np.array_equal(a, b)


def _pipelines(pkg):
    return pkg.ConnectorPipeline([pkg.FlattenObs(),
                                  pkg.MeanStdFilter(clip=3.0),
                                  pkg.FrameStack(3)])


def _assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_connectors_match_and_cross_load():
    rng = np.random.default_rng(0)
    jp, tp = _pipelines(jconn), _pipelines(tconn)
    for i in range(12):
        obs = rng.standard_normal((2, 3)) * (i + 1)
        _assert_same(jp(obs), tp(obs))
        if i == 5:
            jp.reset()
            tp.reset()
    assert jp.to_config() == tp.to_config()
    # a pipeline saved by either package loads in the other (the filter's
    # moments are saved, the frame stack's frames are not: reset both)
    for src, dst in ((jp, tconn), (tp, jconn)):
        a, b = src, dst.ConnectorPipeline.from_config(src.to_config())
        assert a.to_config() == b.to_config()
        a.reset()
        for _ in range(3):
            obs = rng.standard_normal((2, 3))
            _assert_same(a(obs), b(obs))
    for pkg_j, pkg_t, x in (
            (jconn.ClipReward(2.0), tconn.ClipReward(2.0), -3.7),
            (jconn.ClipReward(sign=True), tconn.ClipReward(sign=True), 0.2),
            (jconn.ClipActions([-1, 0], [1, 2]),
             tconn.ClipActions([-1, 0], [1, 2]), [3.0, -1.5]),
            (jconn.UnsquashActions([-2, 0], [2, 1]),
             tconn.UnsquashActions([-2, 0], [2, 1]), [0.5, -1.5])):
        _assert_same(pkg_j(x), pkg_t(x))
        assert pkg_j.to_config() == pkg_t.to_config()
    empty = tconn.ConnectorPipeline()
    empty.append(tconn.FlattenObs()).prepend(tconn.ClipReward())
    empty.remove("ClipReward")
    assert [type(c).__name__ for c in empty.connectors] == ["FlattenObs"]


def _drive(client, episodes=2, steps=5):
    """Episodes of a fixed observation stream through ``client`` ->
    the actions it got back."""
    rng = np.random.default_rng(1)
    actions = []
    for e in range(episodes):
        eid = client.start_episode(training_enabled=(e != 1))
        for _ in range(steps):
            a = client.get_action(eid, rng.standard_normal(4))
            actions.append(int(a))
            client.log_returns(eid, 1.0)
        client.end_episode(eid, rng.standard_normal(4))
    client.start_episode(episode_id="late")
    return actions


def policy(obs):
    return int(obs.sum() > 0)


@pytest.mark.parametrize("server_pkg,client_pkg,batch_cls", [
    (tserver, jserver, TBatch), (jserver, tserver, JBatch)],
    ids=["jax_client_port_server", "port_client_jax_server"])
def test_policy_server_talks_across_packages(server_pkg, client_pkg,
                                             batch_cls):
    server = server_pkg.PolicyServerInput(policy, "127.0.0.1", 0)
    try:
        client = client_pkg.PolicyClient(server.address, timeout=10.0)
        got = _drive(client)
        rng = np.random.default_rng(1)
        want = []
        for e in range(2):
            want += [policy(np.asarray(rng.standard_normal(4), np.float32))
                     for _ in range(5)]
            rng.standard_normal(4)
        assert got == want
        batch = server.next_batch(min_steps=5)
        assert isinstance(batch, batch_cls) and batch.count == 5
        assert np.array_equal(batch["actions"], want[:5])
        assert np.array_equal(batch["dones"], [0, 0, 0, 0, 1])
        assert server.episode_returns() == [5.0, 5.0]
        assert server.next_batch() is None       # the second: no training
        with pytest.raises(Exception, match="unknown episode_id|500"):
            client.get_action("nope", np.zeros(4))
    finally:
        server.stop()
