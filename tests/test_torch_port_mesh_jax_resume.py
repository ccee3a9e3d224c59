"""The JAX package's trainer on a mesh and the port's, through a
checkpoint: ``JaxTrainer``'s dp2.tp2 step-3 checkpoint (conftest's CPU
devices), its optax state through ``optax_adam_to_torch``, resumes on
the port's dp2.tp2 threaded ranks to JaxTrainer's step 4-6 metrics (rel
1e-4) and final params (atol 1e-4); the run of
``tests/_torch_port_mesh_train.py`` without a failure.  And the
checkpoint manager of a mesh: one writer, every rank naming the same
directories."""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch.distributed as dist

import _torch_port_mesh_train as mt
from _torch_port_mesh_train import case  # noqa: F401 (the fixture)
from _torch_port_ranks import ranks
from ray_tpu.models import gpt as jgpt
from ray_tpu.parallel.sharding import DEFAULT_LLM_RULES as JRULES
from ray_tpu.train import Checkpoint as JaxCheckpoint
from ray_tpu.train import JaxTrainer, RunConfig, ScalingConfig
from ray_tpu_torch.models import convert
from ray_tpu_torch.train import Checkpoint, CheckpointManager


def test_port_mesh_resumes_a_jax_trainer_mesh_checkpoint(case, tmp_path):
    jcfg, _, tree, batches, _ = case

    def loss(p, b, mesh=None, rules=JRULES):
        return jgpt.loss_fn(p, b, jcfg, mesh=mesh, rules=rules)

    jtr = JaxTrainer(
        loss_fn=loss,
        init_params=lambda rng: jax.tree_util.tree_map(jnp.asarray, tree),
        optimizer=optax.adam(mt.LR), train_data=batches,
        num_steps=mt.STEPS, params_logical=jgpt.param_logical_axes(jcfg),
        report_every=1, checkpoint_every=mt.CKPT_EVERY,
        scaling_config=ScalingConfig(mesh={"dp": 2, "tp": 2},
                                     use_cpu_devices=True),
        run_config=RunConfig(name="jax", storage_path=str(tmp_path)))
    jres = jtr.fit()
    payload = JaxCheckpoint(os.path.join(
        jres.path, "checkpoints", "checkpoint_000000")).to_dict()
    assert payload["step"] == 3
    payload["opt_state"] = convert.optax_adam_to_torch(payload["opt_state"])
    ck = Checkpoint.from_dict(payload, str(tmp_path / "bridged"))
    got = mt.port_fit(case, "dp2_tp2", str(tmp_path), data=batches,
                      resume_from_checkpoint=ck, eval_fn=None)
    want = mt.history(jres)[3:]
    want_params = jax.tree_util.tree_map(np.asarray, jtr.final_state.params)
    for hist, start, _, params, _, _ in got:
        assert start == 3
        mt.assert_histories_close(hist, want)
        mt.assert_params_close(params, want_params)


def test_mesh_checkpoint_manager_has_one_writer(tmp_path):
    """Two ranks' managers over one root: rank 0 writes, rank 1 names
    the same paths and prunes the same list without writing; after each
    save and flush both wait at the barrier, so both ``latest()`` name
    the last checkpoint."""
    root = str(tmp_path / "ckpts")

    def rank(r):
        mgr = CheckpointManager(root, num_to_keep=2, writer=r == 0,
                                barrier=dist.barrier)
        paths = []
        for i in range(3):
            paths.append(mgr.save({"i": i, "rank": r}))
            mgr.flush()          # each write lands (none is overtaken)
        latest = mgr.latest()
        return paths, latest.path, latest.to_dict()

    (p0, l0, d0), (p1, l1, d1) = ranks(rank, 2)
    assert p0 == p1 and l0 == l1 == p0[-1]
    assert d0 == d1 == {"i": 2, "rank": 0}
    assert sorted(os.listdir(root)) == ["checkpoint_000001",
                                        "checkpoint_000002"]


def test_a_rank_building_its_manager_late_names_saves_alike(tmp_path,
                                                            monkeypatch):
    """Rank 1 builds its manager only once rank 0 has reached the world's
    barrier, and rank 0's writes are synchronous here, so a save of rank
    0 that did not wait for rank 1's listing would already be on disk
    when rank 1 lists ``root``: both ranks must still name every save
    alike (``checkpoint_000000`` first), because the manager waits at the
    barrier at the end of ``__init__``."""
    from ray_tpu_torch.parallel import threaded
    from ray_tpu_torch.train import checkpoint as ckpt

    def write_now(self, data, path):
        ckpt.Checkpoint.from_dict(data, path)
        self.last_path = path

    monkeypatch.setattr(ckpt.AsyncCheckpointer, "save", write_now)
    root = str(tmp_path / "late")
    at_barrier = threading.Event()

    def barrier0():
        at_barrier.set()
        dist.barrier()

    def rank(r):
        if r == 1:
            with threaded.waiting_outside_collectives():
                assert at_barrier.wait(30), "rank 0 never reached a barrier"
        mgr = CheckpointManager(root, writer=r == 0,
                                barrier=barrier0 if r == 0 else dist.barrier)
        paths = [mgr.save({"i": i}) for i in range(2)]
        mgr.flush()
        return [os.path.basename(p) for p in paths]

    p0, p1 = ranks(rank, 2)
    assert p0 == p1 == ["checkpoint_000000", "checkpoint_000001"]
    assert sorted(os.listdir(root)) == p0
