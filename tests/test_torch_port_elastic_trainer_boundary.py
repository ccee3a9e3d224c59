"""A readmission that fails at the start of an attempt carries on at the
smaller world (the JAX ``DataParallelTrainer._attempt_multihost``'s
re-gang boundary): a first ``fit()`` of the port's elastic
``Trainer(num_hosts=4)`` shrinks to 2 members when members 1 and 3 die at
step 4 and finishes there; a second ``fit()`` of the same trainer, from
the step-3 checkpoint, tries to re-admit under a fault plan whose
``gang_readmit`` raises, then runs steps 4-6 on the same two members.
Both fits are held to ``JaxTrainer`` on one device whose data fails once
at step 4 (``tests/_torch_port_elastic.py``): the first in full, the
second on steps 4-6 (rel 1e-4) and its final params (atol 1e-4)."""

import os

import jax
import numpy as np

import _torch_port_elastic as el
import _torch_port_mesh_train as mt
from _torch_port_mesh_train import case  # noqa: F401 (the fixture)
from ray_tpu.core import fault_injection as jfi
from ray_tpu_torch.core import fault_injection as tfi
from ray_tpu_torch.train import Checkpoint


def test_a_failed_readmission_at_a_boundary_carries_on(case, tmp_path):
    root = str(tmp_path)
    path = os.path.join(root, "boundary")
    tr = el.elastic_trainer(case, path, el.SHRINK)
    seen = []

    def second_fit():
        plan = jfi.FaultPlan()
        plan.script(lambda ctx: (seen.append(dict(ctx)),
                                 1 / 0), point="gang_readmit", nth=None,
                    times=1)
        tr.resume_from_checkpoint = Checkpoint(
            os.path.join(path, "checkpoints", "checkpoint_000000"))
        with tfi.injected(plan):
            return tr.fit()

    jtr, jres, port = el.run_both(case, root, {1: 4}, {
        "first": lambda: tr.fit(),
        "ids": lambda: tr.gang.member_ids(),
        "second": second_fit,
    })
    mt.assert_histories_close(mt.history(port["first"]), mt.history(jres))
    assert [a["world"] for a in tr.attempts] == [4, 2, 2]
    assert seen == [{"world": 2, "target": 4, "want": 2}]
    third = tr.attempts[2]
    assert third["member_ids"] == port["ids"] and "error" not in third
    assert third["start_step"] == 3 and el.same_reports(third)
    res = port["second"]
    mt.assert_histories_close(mt.history(res), mt.history(jres)[3:])
    want = jax.tree_util.tree_map(np.asarray, jtr.final_state.params)
    mt.assert_params_close(res.checkpoint.to_dict()["params"], want)
    assert res.checkpoint.to_dict()["step"] == 6
