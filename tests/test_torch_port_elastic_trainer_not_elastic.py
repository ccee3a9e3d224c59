"""The port's ``Trainer(num_hosts=4, elastic=False)``: members 1 and 3
kill themselves at step 4, and with no elastic recovery the gang is torn
down and a fresh gang of 4 (four new ids) resumes at step 3.  Held to
``JaxTrainer`` on one device whose data fails once at step 4
(``tests/_torch_port_elastic.py``): its loss, grad_norm and eval at
every step within rel 1e-4, its params within atol 1e-4, its checkpoint
steps."""

import os

import _torch_port_elastic as el
from _torch_port_mesh_train import case  # noqa: F401 (the fixture)


def test_without_elastic_a_death_forms_a_fresh_gang(case, tmp_path):
    root = str(tmp_path)
    jtr, jres, port = el.run_both(case, root, {1: 4}, {
        "fit": lambda: el.fit(el.elastic_trainer(
            case, os.path.join(root, "not_elastic"), el.SHRINK,
            elastic=False))})
    tr, res = port["fit"]
    first, second = tr.attempts
    assert first["error"].rank in (1, 3) and first["recovery"] == "fresh"
    assert second["world"] == 4 and second["start_step"] == 3
    assert not set(second["member_ids"]) & set(first["member_ids"])
    assert tr.gang.member_ids() == second["member_ids"]
    assert el.same_reports(second)
    el.assert_matches_jax(tr, res, jtr, jres)
