"""Checkpoints move between one device and a mesh, both ways: the run of
``tests/_torch_port_mesh_train.py`` without a failure.  One device's
step-3 checkpoint resumes on dp2.tp2 threaded ranks, and a dp2.tp2
step-3 checkpoint (the whole state, gathered) on one device: steps 4-6
and the final params as the uninterrupted one-device run's (rel 1e-4,
atol 1e-4).  The JAX trainer's mesh checkpoint resumed on the port's
mesh is ``tests/test_torch_port_mesh_jax_resume.py``."""

import os

import jax
import pytest

import _torch_port_mesh_train as mt
from _torch_port_mesh_train import case  # noqa: F401 (the fixture)
from ray_tpu_torch.models import convert
from ray_tpu_torch.train import Checkpoint


@pytest.fixture(scope="module")
def one(case, tmp_path_factory):
    """The uninterrupted one-device run: (history, final params, its
    step-3 checkpoint)."""
    root = str(tmp_path_factory.mktemp("one"))
    tr = mt.port_trainer(case, root, data=case[3])
    res = tr.fit()
    ck = os.path.join(root, "checkpoints", "checkpoint_000000")
    assert Checkpoint(ck).to_dict()["step"] == 3
    return (mt.history(res), convert.params_to_numpy(tr.final_state.params),
            Checkpoint(ck))


def test_one_device_checkpoint_resumes_on_a_mesh(case, one, tmp_path):
    hist, params, ck = one
    got = mt.port_fit(case, "dp2_tp2", str(tmp_path), data=case[3],
                      resume_from_checkpoint=ck)
    for h, start, _, p, _, _ in got:
        assert start == 3
        mt.assert_histories_close(h, hist[3:])
        mt.assert_params_close(p, params)


def test_mesh_checkpoint_resumes_on_one_device(case, one, tmp_path):
    hist, params, _ = one
    got = mt.port_fit(case, "dp2_tp2", str(tmp_path), data=case[3],
                      num_steps=3)
    for h, _, _, _, _, last in got:
        mt.assert_histories_close(h, hist[:3])
    payload = Checkpoint(last).to_dict()
    assert payload["step"] == 3
    # the whole state: every leaf at its full shape
    for g, w in zip(jax.tree_util.tree_leaves(payload["params"]),
                    jax.tree_util.tree_leaves(params)):
        assert g.shape == w.shape
    tr = mt.port_trainer(case, str(tmp_path / "one"), data=case[3],
                         resume_from_checkpoint=Checkpoint(last))
    res = tr.fit()
    assert tr.start_step == 3
    mt.assert_histories_close(mt.history(res), hist[3:])
    mt.assert_params_close(convert.params_to_numpy(tr.final_state.params),
                           params)
