"""The port's ``Trainer`` on a dp2.sp2 mesh of threaded ranks (ring
attention over sp), held to the JAX package's sharded step on the same
mesh (``jax_trajectory``), not to ``JaxTrainer``: the JAX package's mesh
step refuses its own second step on sp meshes (ROADMAP Queue C, R1),
which ``jax_trajectory`` works round by re-placing the state between
steps.  One batch of [4, 33] tokens (32 inputs a row: they divide over
sp2) six times, AdamW(1e-3) as ``jax_trajectory``'s; every rank's data
fails at step 4 and the run resumes from the step-3 checkpoint: the
reported loss and grad_norm of every step within rel 1e-4 of the
uninterrupted JAX trajectory, the final params within atol 1e-4."""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import _torch_port_mesh_train as mt
from _torch_port_mesh_train import case  # noqa: F401 (the fixture)
from _torch_port_ranks import jax_mesh, jax_trajectory
from ray_tpu_torch.train import adamw

MESH = "dp2_sp2"


def test_mesh_fit_on_dp2_sp2_matches_the_jax_trajectory(case, tmp_path):
    jcfg, _, tree, batches, _ = case
    tokens = batches[0]["tokens"]
    with ThreadPoolExecutor(1) as ex:
        want = ex.submit(jax_trajectory, jax_mesh(MESH), jcfg, tree, tokens,
                         mt.STEPS)
        got = mt.port_fit(case, MESH, str(tmp_path),
                          batches=[{"tokens": tokens}] * mt.STEPS,
                          optimizer=adamw(1e-3), eval_fn=None)
        want_steps, want_params = want.result()
    for hist, start, passes, params, _, _ in got:
        assert (start, passes) == (3, 2)
        assert [m["step"] for m in hist] == [1, 2, 3, 4, 5, 6]
        for m, (loss, norm) in zip(hist, want_steps):
            np.testing.assert_allclose([m["loss"], m["grad_norm"]],
                                       [loss, norm], rtol=1e-4,
                                       err_msg=f"step {m['step']}")
        mt.assert_params_close(params, want_params)
    assert sorted(os.listdir(tmp_path / MESH / "checkpoints")) == [
        "checkpoint_000000", "checkpoint_000001"]
