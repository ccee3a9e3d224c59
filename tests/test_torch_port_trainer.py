"""The port's trainer loop against the JAX package's on the CPU.

The same numpy weights (``GPTConfig.tiny``, f32, plain attention) and
the same six distinct token batches go through ``JaxTrainer`` and through
``ray_tpu_torch.train.Trainer``:

- both hosted under the unchanged ``DataParallelTrainer``
  (``ScalingConfig(mesh={"dp": 1}, use_cpu_devices=True)``), the port's
  loop given ``ray_tpu.train.session``'s ``report`` and
  ``get_checkpoint``; each run's data fails once at step 4 and resumes
  from its step-3 checkpoint (``max_failures=1``): reported losses,
  grad norms and evals within rel 1e-4, final params within atol 1e-5;
- the port resuming from the checkpoint ``JaxTrainer`` wrote at step 3
  (its optax state through ``optax_adam_to_torch``) ends where JAX ends;
- the restore keeps the optimizer bound to the live leaves;
- bf16 leaves round-trip through a payload that unpickles without
  ml_dtypes; ``AsyncCheckpointer`` keeps the latest snapshot;
- ``device_batches`` yields the host batches in order and raises a host
  error at its own batch;
- ``TorchPredictor`` against ``JaxPredictor`` (MLP, atol 1e-5), and the
  JAX ``BatchPredictor`` over a ``ray_tpu.data`` dataset with a port
  predictor.
"""

import os
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu.data as rd
from ray_tpu.models import gpt as jgpt
from ray_tpu.models import mlp as jmlp
from ray_tpu.train import (BatchPredictor, DataParallelTrainer, JaxPredictor,
                           JaxTrainer, RunConfig, ScalingConfig, session)
from ray_tpu.train import Checkpoint as JaxCheckpoint
from ray_tpu.train.config import FailureConfig
from ray_tpu_torch.data import device_batches
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import mlp as tmlp
from ray_tpu_torch.models.convert import _leaves
from ray_tpu_torch.train import (Checkpoint, Trainer, TorchPredictor, adam,
                                 checkpoint as port_ckpt, device_batch,
                                 load_state, make_train_step, state_to_host)

LR = 3e-4
STEPS = 6
FAIL_AT = 4            # the step whose batch the first pass fails to give
EVAL = dict(rtol=1e-4)


class FailingBatches:
    """The same batches on every pass; the first pass raises instead of
    giving step ``FAIL_AT``'s batch."""

    def __init__(self, batches, fail_at=FAIL_AT):
        self.batches, self.fail_at, self.passes = batches, fail_at, 0

    def __iter__(self):
        self.passes += 1
        first = self.passes == 1
        for i, b in enumerate(self.batches):
            if first and i + 1 == self.fail_at:
                raise RuntimeError(f"injected failure at step {i + 1}")
            yield b


@pytest.fixture(scope="module")
def setup():
    """Both packages' tiny f32 configs, one set of numpy weights
    (N(0, 0.02), norm scales 1) in the shared stacked layout, six
    distinct b2 s32 token batches and an eval batch."""
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32)
    tcfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    rng = np.random.default_rng(0)

    def draw(name, t):
        if "scale" in name:
            return np.ones(t.shape, np.float32)
        return (rng.standard_normal(t.shape) * 0.02).astype(np.float32)

    shapes = tgpt.init_params(tcfg, 0, device="cpu")
    tree = {k: ({n: draw(n, t) for n, t in v.items()}
                if isinstance(v, dict) else draw(k, v))
            for k, v in shapes.items()}
    batches = [{"tokens": rng.integers(0, jcfg.vocab_size, (2, 33))
                .astype(np.int32)} for _ in range(STEPS)]
    held_out = rng.integers(0, jcfg.vocab_size, (2, 33)).astype(np.int32)
    return jcfg, tcfg, tree, batches, held_out


def _jax_trainer(setup, data, path, name):
    jcfg, _, tree, _, held_out = setup
    jeval = jax.jit(lambda p: jgpt.loss_fn(p, {"tokens": held_out}, jcfg))
    return JaxTrainer(
        loss_fn=lambda p, b: jgpt.loss_fn(p, b, jcfg),
        init_params=lambda rng: jax.tree_util.tree_map(jnp.asarray, tree),
        optimizer=optax.adam(LR), train_data=data, num_steps=STEPS,
        eval_fn=jeval, eval_every=3, report_every=1, checkpoint_every=3,
        scaling_config=ScalingConfig(mesh={"dp": 1}, use_cpu_devices=True),
        run_config=RunConfig(name=name, storage_path=path,
                             failure_config=FailureConfig(max_failures=1)))


def _port_trainer(setup, data, **kw):
    _, tcfg, tree, _, held_out = setup
    held = {"tokens": torch.from_numpy(held_out)}
    return Trainer(
        loss_fn=lambda p, b: tgpt.loss_fn(p, b, tcfg),
        init_params=lambda seed: convert.params_from_numpy(tree,
                                                           device="cpu"),
        optimizer=adam(LR), train_data=data, num_steps=STEPS,
        eval_fn=lambda p: tgpt.loss_fn(p, held, tcfg), eval_every=3,
        report_every=1, checkpoint_every=3, **{"device": "cpu", **kw})


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """JaxTrainer and the port's loop under DataParallelTrainer, each
    failing once at step 4."""
    root = str(tmp_path_factory.mktemp("runs"))
    batches = setup[3]
    jdata, tdata = FailingBatches(batches), FailingBatches(batches)
    jtr = _jax_trainer(setup, jdata, root, "jax")
    jres = jtr.fit()
    port = _port_trainer(setup, tdata)
    host = DataParallelTrainer(
        lambda config: port.train_loop(session.report,
                                       session.get_checkpoint),
        scaling_config=ScalingConfig(mesh={"dp": 1}, use_cpu_devices=True),
        run_config=RunConfig(name="port", storage_path=root,
                             failure_config=FailureConfig(max_failures=1)))
    tres = host.fit()
    return dict(jtr=jtr, jres=jres, jdata=jdata, port=port, tres=tres,
                tdata=tdata)


def _history(res):
    return [{k: v for k, v in m.items() if k != "_checkpoint_path"}
            for m in res.metrics_history]


def _assert_params(got, want, atol=1e-5):
    for g, w in zip(jax.tree_util.tree_leaves(convert.params_to_numpy(got)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=0)


def test_hosted_failover_run_matches_jax_trainer(runs):
    jhist, thist = _history(runs["jres"]), _history(runs["tres"])
    assert runs["jdata"].passes == runs["tdata"].passes == 2
    assert [m["step"] for m in thist] == [m["step"] for m in jhist] \
        == [1, 2, 3, 4, 5, 6]
    assert runs["port"].start_step == 3
    for j, t in zip(jhist, thist):
        assert set(j) == set(t)
        for key in ("loss", "grad_norm", "eval"):
            if key in j:
                np.testing.assert_allclose(t[key], j[key], **EVAL,
                                           err_msg=f"step {j['step']} {key}")
    assert [m["step"] for m in thist if "eval" in m] == [3, 6]
    ckpts = [m["_checkpoint_path"] for m in runs["tres"].metrics_history
             if "_checkpoint_path" in m]
    assert len(ckpts) == 2
    _assert_params(runs["port"].final_state.params,
                   runs["jtr"].final_state.params)


def test_port_checkpoint_payload_is_numpy_with_adam_layout(runs):
    payload = runs["tres"].checkpoint.to_dict()
    assert payload["step"] == STEPS
    opt = payload["opt_state"]
    assert opt["count"] == STEPS and set(opt) == {"count", "mu", "nu"}
    leaves = jax.tree_util.tree_leaves([payload["params"], opt["mu"],
                                        opt["nu"]])
    assert leaves and all(isinstance(a, np.ndarray) for a in leaves)
    # the same moments as optax's, after the same failover
    jopt = convert.optax_adam_to_torch(runs["jtr"].final_state.opt_state)
    assert jopt["count"] == STEPS
    for k in ("mu", "nu"):
        for g, w in zip(jax.tree_util.tree_leaves(opt[k]),
                        jax.tree_util.tree_leaves(jopt[k])):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-6,
                                       rtol=1e-4)


def test_port_resumes_a_jax_trainer_checkpoint(setup, runs, tmp_path):
    """JaxTrainer's step-3 checkpoint, its optax state bridged, resumes
    on the port to JaxTrainer's final params and step 4-6 losses."""
    ck_dir = os.path.join(runs["jres"].path, "checkpoints",
                          "checkpoint_000000")
    payload = JaxCheckpoint(ck_dir).to_dict()
    assert payload["step"] == 3
    payload["opt_state"] = convert.optax_adam_to_torch(payload["opt_state"])
    assert payload["opt_state"]["count"] == 3
    ck = Checkpoint.from_dict(payload, str(tmp_path / "bridged"))
    port = _port_trainer(setup, setup[3], resume_from_checkpoint=ck,
                         storage_path=str(tmp_path / "run"))
    res = port.fit()
    assert port.start_step == 3
    jhist = _history(runs["jres"])[3:]
    thist = _history(res)
    assert [m["step"] for m in thist] == [4, 5, 6]
    for j, t in zip(jhist, thist):
        np.testing.assert_allclose(t["loss"], j["loss"], **EVAL)
    _assert_params(port.final_state.params, runs["jtr"].final_state.params)


def test_restore_keeps_the_optimizer_on_the_live_leaves(setup):
    _, tcfg, tree, batches, _ = setup
    init_fn, step_fn = make_train_step(lambda p, b: tgpt.loss_fn(p, b, tcfg),
                                       adam(1e-2))
    a = init_fn(convert.params_from_numpy(tree, device="cpu"))
    for b in batches[:2]:
        a, _ = step_fn(a, device_batch(b, "cpu"))
    payload = state_to_host(a)
    b_state = init_fn(tgpt.init_params(tcfg, 7, device="cpu"))
    live = _leaves(b_state.params)
    load_state(b_state, payload)
    assert int(b_state.step) == 2
    assert all(x is y for x, y in zip(live, _leaves(b_state.params)))
    bound = b_state.opt_state.param_groups[0]["params"]
    assert all(x is y for x, y in zip(bound, live))
    for p in live:
        st = b_state.opt_state.state[p]
        assert st["step"].device.type == "cpu" and float(st["step"]) == 2
    # a step on the restored state equals the same step on the original
    a, ma = step_fn(a, device_batch(batches[2], "cpu"))
    b_state, mb = step_fn(b_state, device_batch(batches[2], "cpu"))
    assert ma["loss"].item() == mb["loss"].item()
    for x, y in zip(_leaves(a.params), _leaves(b_state.params)):
        assert torch.equal(x, y)


def test_restore_refuses_an_optimizer_on_other_tensors(setup):
    _, tcfg, tree, _, _ = setup
    init_fn, _ = make_train_step(lambda p, b: tgpt.loss_fn(p, b, tcfg),
                                 adam(1e-2))
    state = init_fn(convert.params_from_numpy(tree, device="cpu"))
    payload = state_to_host(state)
    # the trap: params rebound to new tensors the optimizer never saw
    state.params = convert.params_from_numpy(payload["params"], device="cpu")
    with pytest.raises(ValueError, match="not bound"):
        load_state(state, payload)


def test_bf16_leaf_round_trips_without_ml_dtypes(tmp_path):
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(3, 5, generator=gen).to(torch.bfloat16)
    tree = {"w": w, "f": torch.arange(4.0), "n": 7}
    ck = Checkpoint.from_dict(tree, str(tmp_path / "bf16"))
    with open(os.path.join(ck.path, Checkpoint.PAYLOAD), "rb") as f:
        raw = f.read()
    assert b"ml_dtypes" not in raw and b"torch" not in raw
    payload = pickle.loads(raw)
    leaf = payload["w"]
    assert leaf["__dtype__"] == "bfloat16" and leaf["bits"].dtype == np.uint16
    back = port_ckpt.from_host(payload, "cpu")
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], w)
    assert torch.equal(back["f"], tree["f"])
    # a bf16 array the JAX package writes (ml_dtypes) decodes the same
    jbf = np.asarray(jnp.asarray(w.float().numpy(), jnp.bfloat16))
    assert torch.equal(port_ckpt.host_tensor(jbf), w)


def test_async_checkpointer_keeps_the_latest(tmp_path, monkeypatch):
    """A snapshot queued behind a running write is replaced by the next
    one: three saves while the first write is held give two writes, the
    first and the last."""
    started, go, written = threading.Event(), threading.Event(), []
    real = Checkpoint.from_dict.__func__

    def held(cls, data, path=None):
        started.set()
        assert go.wait(timeout=30)
        written.append(path)
        return real(cls, data, path)

    monkeypatch.setattr(Checkpoint, "from_dict", classmethod(held))
    ac = port_ckpt.AsyncCheckpointer()
    paths = [str(tmp_path / f"c{i}") for i in range(3)]
    ac.save({"i": torch.tensor(0)}, paths[0])
    assert started.wait(timeout=30)
    ac.save({"i": torch.tensor(1)}, paths[1])
    ac.save({"i": torch.tensor(2)}, paths[2])
    go.set()
    ac.wait()
    assert written == [paths[0], paths[2]]
    assert ac.last_path == paths[2]
    assert int(Checkpoint(paths[2]).to_dict()["i"]) == 2
    assert not os.path.exists(paths[1])


def test_checkpoint_manager_keeps_n_and_finds_latest(tmp_path):
    mgr = port_ckpt.CheckpointManager(str(tmp_path), num_to_keep=2)
    for i in range(4):
        mgr.save({"i": i})
    assert mgr.latest().to_dict()["i"] == 3
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_000002",
                                            "checkpoint_000003"]


@pytest.mark.parametrize("prefetch", [1, 3])
def test_device_batches_in_order(prefetch):
    rng = np.random.default_rng(1)
    host = [{"x": rng.standard_normal((2, 3)).astype(np.float32),
             "y": np.arange(2) + i} for i in range(5)]
    got = list(device_batches(iter(host), "cpu", prefetch=prefetch))
    assert len(got) == 5
    for g, h in zip(got, host):
        assert set(g) == {"x", "y"}
        for k in h:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), h[k])


def test_device_batches_raise_a_host_error_at_its_batch():
    pulled = []

    def host():
        for i in range(6):
            pulled.append(i)
            if i == 3:
                raise RuntimeError("host failed at 3")
            yield {"i": np.array([i])}

    feed = device_batches(host(), "cpu", prefetch=2)
    got = [int(next(feed)["i"][0]) for _ in range(3)]
    assert got == [0, 1, 2] and pulled == [0, 1, 2, 3]
    with pytest.raises(RuntimeError, match="at 3"):
        next(feed)


def test_entry_points_need_a_card_unless_told(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: _port_trainer(setup, [], device=None),
                 lambda: device_batches([], None),
                 lambda: device_batch({"x": np.zeros(2)}),
                 lambda: TorchPredictor(lambda p, x: x, {})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_trainer_and_device_batch_refuse_a_mesh(setup):
    """The Trainer takes a mesh now (the mesh axes, formed over the world
    by ``form_gang``, here a one-rank dp mesh) and device_batch shards a
    batch over one; the Trainer refuses rules without a mesh and a gang
    of more than one host.  The Trainer on a mesh is held to JaxTrainer
    in tests/test_torch_port_mesh_*.py, the sharded feed to the JAX
    package in tests/test_torch_port_parallel.py."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel import create_mesh, run_ranks
    from ray_tpu_torch.parallel.sharding import DEFAULT_LLM_RULES

    with pytest.raises(ValueError, match="give the mesh"):
        _port_trainer(setup, [], rules=DEFAULT_LLM_RULES)

    def one_rank(rank):
        got = device_batch({"x": np.arange(4)}, mesh=create_mesh(
            {"dp": 1}, device="cpu"))["x"]
        tr = _port_trainer(setup, [], mesh={"dp": -1})
        return (isinstance(got, DTensor), got.full_tensor().tolist(),
                dict(zip(tr.mesh.mesh_dim_names, tr.mesh.shape)))

    assert run_ranks(one_rank, 1, timeout=60) \
        == [(True, [0, 1, 2, 3], {"dp": 1})]


@pytest.fixture(scope="module")
def mlp_case():
    jcfg = jmlp.MLPConfig(in_dim=4, hidden=(8,), out_dim=3)
    tcfg = tmlp.MLPConfig(in_dim=4, hidden=(8,), out_dim=3)
    rng = np.random.default_rng(3)
    tree = {"layer0": {"w": rng.standard_normal((4, 8)).astype(np.float32),
                       "b": rng.standard_normal(8).astype(np.float32)},
            "layer1": {"w": rng.standard_normal((8, 3)).astype(np.float32),
                       "b": rng.standard_normal(3).astype(np.float32)}}
    x = rng.standard_normal((40, 4)).astype(np.float32)
    jpred = JaxPredictor(lambda p, v: jmlp.forward(p, v, jcfg),
                         jax.tree_util.tree_map(jnp.asarray, tree))
    return tcfg, tree, x, jpred


def test_torch_predictor_matches_jax_predictor(mlp_case, tmp_path):
    tcfg, tree, x, jpred = mlp_case
    batch = {"x": x[:5], "row_id": np.arange(5)}
    want = jpred.predict(batch)
    ck = Checkpoint.from_dict(
        {"params": convert.params_from_numpy(tree, device="cpu")},
        str(tmp_path / "mlp"))
    pred = TorchPredictor.from_checkpoint(
        ck, apply_fn=lambda p, v: tmlp.forward(p, v, tcfg), device="cpu")
    got = pred.predict(batch)
    assert set(got) == set(want) == {"row_id", "predictions"}
    np.testing.assert_array_equal(got["row_id"], want["row_id"])
    np.testing.assert_allclose(got["predictions"], want["predictions"],
                               atol=1e-5, rtol=1e-5)


def test_torch_predictor_returns_bf16_as_float32(mlp_case):
    tcfg, tree, x, _ = mlp_case
    pred = TorchPredictor(
        lambda p, v: tmlp.forward(p, v.to(torch.bfloat16), tcfg),
        port_ckpt.to_host(convert.params_from_numpy(
            tree, device="cpu", dtype=torch.bfloat16)), device="cpu")
    out = pred.predict({"x": x[:3]})["predictions"]
    assert out.dtype == np.float32 and out.shape == (3, 3)


def test_jax_batch_predictor_runs_a_port_predictor(mlp_case):
    tcfg, tree, x, jpred = mlp_case
    pred = TorchPredictor(lambda p, v: tmlp.forward(p, v, tcfg), tree,
                          device="cpu")
    ds = rd.from_numpy({"x": x})
    got = BatchPredictor(pred).predict(ds, batch_size=16).take(40)
    want = BatchPredictor(jpred).predict(ds, batch_size=16).take(40)
    assert len(got) == len(want) == 40
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["predictions"], w["predictions"],
                                   atol=1e-5, rtol=1e-5)
