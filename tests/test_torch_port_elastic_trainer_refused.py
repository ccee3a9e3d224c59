"""The port's elastic ``Trainer(num_hosts=4)`` when a readmission is
refused: the readmit run of ``test_torch_port_elastic_trainer_readmit``
under a fault plan (the JAX package's ``FaultPlan`` in the port's gate)
whose ``gang_readmit`` raises.  As in the JAX ``_elastic_recover``'s
fallback, the gang is torn down and the next attempt forms a fresh gang
of 4, four new ids, which finishes with the readmit run's trajectory:
``JaxTrainer`` on one device whose data fails at steps 4 and 5, its
loss, grad_norm and eval at every step within rel 1e-4, its params
within atol 1e-4, its checkpoint steps."""

import os

import _torch_port_elastic as el
from _torch_port_mesh_train import case  # noqa: F401 (the fixture)
from ray_tpu.core import fault_injection as jfi
from ray_tpu_torch.core import fault_injection as tfi


def refused(case, path):
    def boom(ctx):
        raise RuntimeError(f"scripted readmit fault (world={ctx['world']}, "
                           f"want={ctx['want']})")

    plan = jfi.FaultPlan()
    plan.script(boom, point="gang_readmit", nth=None, times=1)
    with tfi.injected(plan):
        out = el.fit(el.elastic_trainer(case, path, el.READMIT,
                                        max_failures=2))
    return out, [(p, d) for (p, _a, d) in plan.log]


def test_refused_readmission_falls_back_to_a_fresh_gang(case, tmp_path):
    root = str(tmp_path)
    jtr, jres, port = el.run_both(case, root, {1: 4, 2: 5}, {
        "refused": lambda: refused(case, os.path.join(root, "refused"))})
    (tr, res), log = port["refused"]
    assert log == [("gang_readmit", 2)]
    first, second, third = tr.attempts
    assert [a["world"] for a in tr.attempts] == [4, 2, 4]
    assert [a["start_step"] for a in tr.attempts] == [0, 3, 3]
    assert first["recovery"] == "shrink" and second["recovery"] == "fresh"
    assert not set(third["member_ids"]) & (set(first["member_ids"])
                                           | set(second["member_ids"]))
    assert el.same_reports(third)
    el.assert_matches_jax(tr, res, jtr, jres)
