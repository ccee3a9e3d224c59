"""The port's ``Trainer`` on a mesh of threaded ranks and ``JaxTrainer``
on the same axes, on the same run.  Not a test module.

The run: ``__graft_entry__``'s dryrun GPT config (f32, remat; both
packages' from ``dryrun_configs``) on one set of numpy weights, six
distinct [4, 33] token batches (32 inputs a row: they divide over sp),
Adam at ``LR`` (``optax.adam`` and the port's ``adam``), reports every
step, an eval every 3 steps and a checkpoint every 3; each side's data
(each rank's own ``FailingBatches``) fails once at step 4, so the run
resumes from its step-3 checkpoint (``max_failures=1``).

The fixtures ``case`` and ``runs`` and the ``test_*`` functions below are
imported by ``tests/test_torch_port_mesh_trainer*.py``, one file a mesh
(its module's ``MESH``, a name of ``MESHES``), so that each file stays
within its time: every rank calls ``fit()``, each rank's data fails at
step 4 and every rank resumes from the step-3 checkpoint that rank 0
wrote.  Reported loss, grad_norm and eval within rel 1e-4 at every step,
final params within atol 1e-4 (``assert_trajectories_close``'s bounds),
the same checkpoint steps."""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_ranks import MESHES, dryrun_configs, ranks, world
from ray_tpu.models import gpt as jgpt
from ray_tpu.parallel.sharding import DEFAULT_LLM_RULES as JRULES
from ray_tpu.train import Checkpoint as JaxCheckpoint
from ray_tpu.train import JaxTrainer, RunConfig, ScalingConfig
from ray_tpu.train.config import FailureConfig
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.train import Checkpoint, Trainer, adam, shard_batch
from test_torch_port_trainer import FailingBatches

LR = 3e-4
STEPS = 6
FAIL_AT = 4
CKPT_EVERY = 3


def setup():
    """(jax cfg, port cfg, numpy weights, batches, held-out batch)."""
    jcfg, tcfg = dryrun_configs()
    rng = np.random.default_rng(7)

    def draw(name, shape):
        if "scale" in name:
            return np.ones(shape, np.float32)
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    shapes = tgpt.init_params(tcfg, 0, device="cpu")
    tree = {k: ({n: draw(n, t.shape) for n, t in v.items()}
                if isinstance(v, dict) else draw(k, v.shape))
            for k, v in shapes.items()}
    batches = [{"tokens": rng.integers(0, jcfg.vocab_size, (4, 33))
                .astype(np.int32)} for _ in range(STEPS)]
    held = rng.integers(0, jcfg.vocab_size, (4, 33)).astype(np.int32)
    return jcfg, tcfg, tree, batches, held


def jax_fit(case, axes: dict, root: str, data=None, max_failures=1):
    """``JaxTrainer.fit`` on ``axes`` (conftest's CPU devices), failing
    once at step 4 (or as ``data`` fails, up to ``max_failures``
    times): (trainer, result, data)."""
    jcfg, _, tree, batches, held = case

    def loss(p, b, mesh=None, rules=JRULES):
        return jgpt.loss_fn(p, b, jcfg, mesh=mesh, rules=rules)

    jeval = jax.jit(lambda p: jgpt.loss_fn(p, {"tokens": held}, jcfg))
    data = FailingBatches(batches, FAIL_AT) if data is None else data
    tr = JaxTrainer(
        loss_fn=loss,
        init_params=lambda rng: jax.tree_util.tree_map(jnp.asarray, tree),
        optimizer=optax.adam(LR), train_data=data, num_steps=STEPS,
        params_logical=jgpt.param_logical_axes(jcfg), eval_fn=jeval,
        eval_every=3, report_every=1, checkpoint_every=CKPT_EVERY,
        scaling_config=ScalingConfig(mesh=dict(axes), use_cpu_devices=True),
        run_config=RunConfig(name="jax", storage_path=root,
                             failure_config=FailureConfig(
                                 max_failures=max_failures)))
    return tr, tr.fit(), data


def port_trainer(case, path: str, *, mesh=None, data=None, batches=None,
                 num_steps: int = STEPS, optimizer=None, **kw):
    """The port's Trainer on ``case`` (``mesh``: axes or a DeviceMesh;
    None: one CPU device), its eval on the held-out batch; ``data``
    defaults to ``batches`` (the case's unless given) failing at step 4,
    ``optimizer`` to ``adam(LR)``."""
    _, tcfg, tree, case_batches, held = case
    batches = case_batches if batches is None else batches

    def loss(p, b, mesh=None, rules=None):
        return tgpt.loss_fn(p, b, tcfg, mesh=mesh,
                            **({} if rules is None else {"rules": rules}))

    def evaluate(p):
        m = getattr(p["wte"], "device_mesh", None)
        b = {"tokens": held}
        return tgpt.loss_fn(p, shard_batch(b, m) if m is not None else
                            {"tokens": torch.from_numpy(held)}, tcfg,
                            mesh=m)

    opts = dict(
        loss_fn=loss,
        init_params=lambda seed: convert.params_from_numpy(tree,
                                                           device="cpu"),
        optimizer=optimizer or adam(LR), train_data=data if data is not None
        else FailingBatches(batches, FAIL_AT),
        num_steps=num_steps, eval_fn=evaluate, eval_every=3, report_every=1,
        checkpoint_every=CKPT_EVERY, max_failures=1, storage_path=path,
        device="cpu", mesh=mesh,
        params_logical=tgpt.param_logical_axes(tcfg) if mesh else None)
    return Trainer(**{**opts, **kw})


def port_fit(case, name: str, root: str, **kw):
    """The port's ``Trainer.fit`` on mesh ``name`` of ``MESHES``, every
    rank a thread calling ``fit()`` with its own failing data: per rank
    (reported history, start step, data passes, gathered final params,
    the checkpoint paths its manager named)."""
    _, axes = MESHES[name]
    path = os.path.join(root, name)

    def rank(r):
        tr = port_trainer(case, path, mesh=dict(axes), **kw)
        res = tr.fit()
        return (history(res), tr.start_step,
                getattr(tr.train_data, "passes", None),
                convert.params_to_numpy(tr.final_state.params),
                [m.get("_checkpoint_path") for m in res.metrics_history],
                res.checkpoint.path)

    return ranks(rank, world(name))


def history(res) -> list:
    return [{k: v for k, v in m.items()
             if k not in ("_checkpoint_path", "throughput")}
            for m in res.metrics_history]


def assert_histories_close(got: list, want: list):
    """The same steps and keys; loss, grad_norm and eval within rel 1e-4
    at every report."""
    assert [m["step"] for m in got] == [m["step"] for m in want]
    for g, w in zip(got, want):
        assert set(g) == set(w), (g, w)
        for key in ("loss", "grad_norm", "eval"):
            if key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                           err_msg=f"step {w['step']} {key}")


def assert_params_close(got, want, atol=1e-4):
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = dict((jax.tree_util.keystr(p), a)
              for p, a in jax.tree_util.tree_leaves_with_path(want))
    assert len(gl) == len(wl)
    for path, a in gl:
        key = jax.tree_util.keystr(path)
        np.testing.assert_allclose(a, np.asarray(wl[key]), atol=atol,
                                   rtol=0, err_msg=key)


# -- the shared fixtures and tests ------------------------------------------

@pytest.fixture(scope="module")
def case():
    return setup()


@pytest.fixture(scope="module")
def runs(request, case, tmp_path_factory):
    """JaxTrainer and the port's Trainer on the importing module's mesh,
    each failing once at step 4."""
    name = request.module.MESH
    root = str(tmp_path_factory.mktemp(name))
    # JAX compiles on its own thread while the port's ranks run
    with ThreadPoolExecutor(1) as ex:
        jax_run = ex.submit(jax_fit, case, MESHES[name][1], root)
        port = port_fit(case, name, root)
        jtr, jres, jdata = jax_run.result()
    return dict(name=name, jtr=jtr, jres=jres, jdata=jdata, port=port,
                root=root)


def test_mesh_fit_reports_jax_trainers_metrics(runs):
    want = history(runs["jres"])
    assert [m["step"] for m in want] == [1, 2, 3, 4, 5, 6]
    assert [m["step"] for m in want if "eval" in m] == [3, 6]
    assert_histories_close(runs["port"][0][0], want)


def test_every_rank_reports_the_same_and_resumes_at_step_3(runs):
    hist, _, _, _, paths, last = runs["port"][0]
    assert runs["jdata"].passes == 2
    for r, (h, s, p, _, ps, lp) in enumerate(runs["port"]):
        assert (s, p) == (3, 2), f"rank {r}"
        assert h == hist and ps == paths and lp == last, f"rank {r}"


def test_mesh_fit_final_params_match_jax_trainer(runs):
    want = jax.tree_util.tree_map(np.asarray,
                                  runs["jtr"].final_state.params)
    for _, _, _, params, _, _ in runs["port"]:
        assert_params_close(params, want)


def test_only_rank_0_writes_the_same_checkpoint_steps(runs):
    """The port's checkpoints are named and stepped as JaxTrainer's
    (steps 3 and 6), written once, each the whole numpy state: params and
    Adam's moments equal to JaxTrainer's (its optax state bridged)."""
    jdir = os.path.join(runs["jres"].path, "checkpoints")
    tdir = os.path.join(runs["root"], runs["name"], "checkpoints")
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) \
        == ["checkpoint_000000", "checkpoint_000001"]
    for name, step in (("checkpoint_000000", 3), ("checkpoint_000001", 6)):
        jp = JaxCheckpoint(os.path.join(jdir, name)).to_dict()
        tp = Checkpoint(os.path.join(tdir, name)).to_dict()
        assert tp["step"] == jp["step"] == step
        assert tp["opt_state"]["count"] == step
        assert_params_close(tp["params"], jp["params"])
        jopt = convert.optax_adam_to_torch(jp["opt_state"])
        for k in ("mu", "nu"):
            for g, w in zip(jax.tree_util.tree_leaves(tp["opt_state"][k]),
                            jax.tree_util.tree_leaves(jopt[k])):
                assert isinstance(g, np.ndarray) and g.shape == w.shape
                np.testing.assert_allclose(g, np.asarray(w), atol=1e-6,
                                           rtol=1e-4)
