"""The port's elastic ``Trainer(num_hosts=4)`` re-admitting members,
against ``JaxTrainer`` on one device whose data fails at step 4 and then
at step 5 (``max_failures=2``; ``tests/_torch_port_elastic.py``).

Members 1 and 3 die at step 4; the gang shrinks to 2 and resumes at step
3; the data fails at step 5 on every member, all alive, so the gang
re-admits two fresh members, back to world 4, which resumes at step 3
again and finishes.  It reports JaxTrainer's loss, grad_norm and eval at
every step within rel 1e-4, ends on its params within atol 1e-4 and
writes its checkpoint steps."""

import os

import pytest

import _torch_port_elastic as el
from _torch_port_mesh_train import case  # noqa: F401 (the fixture)


@pytest.fixture(scope="module")
def runs(case, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("readmit"))
    return el.run_both(case, root, {1: 4, 2: 5}, {
        "readmit": lambda: el.fit(el.elastic_trainer(
            case, os.path.join(root, "readmit"), el.READMIT,
            max_failures=2)),
    })


def test_readmit_returns_to_world_4_with_two_fresh_members(runs):
    tr, _ = runs[2]["readmit"]
    first, second, third = tr.attempts
    ids = first["member_ids"]
    assert [a["world"] for a in tr.attempts] == [4, 2, 4]
    assert [a.get("recovery") for a in tr.attempts] == \
        ["shrink", "readmit", None]
    assert [a["start_step"] for a in tr.attempts] == [0, 3, 3]
    assert second["member_ids"] == [ids[0], ids[2]]
    assert third["member_ids"][:2] == [ids[0], ids[2]]
    assert not set(third["member_ids"][2:]) & set(ids)
    for rec, steps in ((first, [1, 2, 3]), (second, [4]),
                       (third, [4, 5, 6])):
        assert el.same_reports(rec)
        assert all(el.steps_of(r) == steps for r in rec["reports"].values())


def test_readmit_matches_jax_trainer_on_one_device(runs):
    jtr, jres, port = runs
    el.assert_matches_jax(*port["readmit"], jtr, jres)
