"""The port's elastic ``Trainer(num_hosts=2)`` on member processes
(``ProcessHost``, gloo on the CPU), against ``JaxTrainer`` on one device
whose data fails at step 4 and then at step 5 (``max_failures=2``;
``tests/_torch_port_elastic.py``).

Every callable and the data are module-level in
``tests/_torch_port_proc_trainer.py`` (or ``functools.partial``s of
them), so the trainer's spec travels and the trainer takes process
members.  Rank 1 SIGKILLs its own process at step 4 (``MemberKilled``
out of its data; a marker file makes it once); the gang shrinks to the
survivor, whose process is kept, and resumes at step 3; the data fails at
step 5, so the gang re-admits one fresh process, back to world 2, which
resumes at step 3 and finishes.  It reports JaxTrainer's loss, grad_norm
and eval at every step within rel 1e-4, ends on its params within atol
1e-4 and writes its checkpoint steps; no member process imports JAX or
the JAX package."""

import multiprocessing
import os

import pytest

import _torch_port_elastic as el
import _torch_port_mesh_train as mt
import _torch_port_proc_trainer as pt
from _torch_port_mesh_train import case  # noqa: F401 (the fixture)
from _torch_port_procs import whoami


def port_case(case):
    _, tcfg, tree, _, held = case
    return tcfg, tree, held


@pytest.fixture(scope="module")
def runs(case, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("proc_readmit"))
    path = os.path.join(root, "readmit")
    os.makedirs(path)
    tr = pt.proc_trainer(
        port_case(case), path,
        pt.ProcBatches(case[3], path, deaths={(2, 4): {1}},
                       failures={(1, 5): 1}),
        lr=mt.LR, steps=mt.STEPS, ckpt_every=mt.CKPT_EVERY, max_failures=2)

    def fit():
        pids = tr.gang.member_pids()
        res = tr.fit()
        return pids, res, tr.gang.member_pids(), tr.gang.run(whoami,
                                                             timeout=60)

    try:
        with pytest.MonkeyPatch.context() as mp:
            # each member process one thread: two processes of all the
            # cores' threads each ran a step 10x slower
            mp.setenv("OMP_NUM_THREADS", "1")
            out = el.run_both(case, root, {1: 4, 2: 5}, {"fit": fit})
    finally:
        if tr._gang is not None:
            tr._gang.shutdown()
    return tr, out


def test_members_are_processes_through_shrink_and_readmit(runs):
    tr, (_, _, port) = runs
    pids, _, final, who = port["fit"]
    assert [a["host"] for a in tr.attempts] == ["process"] * 3
    assert [a["world"] for a in tr.attempts] == [2, 1, 2]
    assert [a["start_step"] for a in tr.attempts] == [0, 3, 3]
    assert [a.get("recovery") for a in tr.attempts] == \
        ["shrink", "readmit", None]
    assert tr.attempts[0]["error"].rank == 1
    assert "exit code -9" in str(tr.attempts[0]["error"])
    assert len(set(pids)) == 2 and os.getpid() not in pids + final
    assert final[0] == pids[0] and final[1] not in pids
    ids = tr.attempts[0]["member_ids"]
    assert tr.attempts[1]["member_ids"] == ids[:1]
    assert tr.attempts[2]["member_ids"][0] == ids[0]
    assert tr.attempts[2]["member_ids"][1] not in ids
    for rec, steps in zip(tr.attempts, ([1, 2, 3], [4], [4, 5, 6])):
        assert el.same_reports(rec)
        assert all(el.steps_of(r) == steps for r in rec["reports"].values())
    assert [o["pid"] for o in who] == final
    assert not any(o["jax"] or o["ray_tpu"] for o in who)


def test_process_members_match_jax_trainer_on_one_device(runs):
    tr, (jtr, jres, port) = runs
    _, res, _, _ = port["fit"]
    el.assert_matches_jax(tr, res, jtr, jres)
    assert multiprocessing.active_children() == []

