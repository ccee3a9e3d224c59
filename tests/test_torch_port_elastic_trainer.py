"""The port's elastic ``Trainer(num_hosts=4)`` (in-process gang members,
``{"dp": -1}``) shrinking, against ``JaxTrainer`` on one device whose
data fails once at step 4 (``tests/_torch_port_elastic.py``).

Members 1 and 3 kill themselves at step 4, after the step-3 checkpoint.
The attempt fails naming one of them, ``alive_ranks`` finds the other
dead too, the gang re-forms at 2 with the two survivors' ids and resumes
at step 3, then runs steps 4-6.  It reports JaxTrainer's loss, grad_norm
and eval at every step within rel 1e-4, ends on its params within atol
1e-4 and writes its checkpoint steps."""

import os

import pytest

import _torch_port_elastic as el
from _torch_port_mesh_train import case  # noqa: F401 (the fixture)


@pytest.fixture(scope="module")
def runs(case, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("elastic"))
    return el.run_both(case, root, {1: 4}, {
        "shrink": lambda: el.fit(el.elastic_trainer(
            case, os.path.join(root, "shrink"), el.SHRINK)),
    })


def test_shrink_resumes_at_step_3_on_the_survivors(runs):
    _, _, port = runs
    tr, _ = port["shrink"]
    first, second = tr.attempts
    assert first["world"] == 4 and first["error"].rank in (1, 3)
    assert first["recovery"] == "shrink"
    ids = first["member_ids"]
    assert second["world"] == 2
    assert second["member_ids"] == [ids[0], ids[2]]
    assert second["start_step"] == 3 and "error" not in second
    for rec, steps in ((first, [1, 2, 3]), (second, [4, 5, 6])):
        assert el.same_reports(rec)
        assert all(el.steps_of(r) == steps for r in rec["reports"].values())
    assert tr.gang.member_ids() == [ids[0], ids[2]]


def test_shrink_matches_jax_trainer_on_one_device(runs):
    jtr, jres, port = runs
    el.assert_matches_jax(*port["shrink"], jtr, jres)
