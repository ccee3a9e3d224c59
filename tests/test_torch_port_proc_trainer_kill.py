"""The port's counterpart of ``tests/test_multihost.py::
test_jax_trainer_multihost_kill_and_restore``: ``Trainer(num_hosts=2,
elastic=False)`` on member processes (``ProcessHost``, gloo on the CPU),
one of them SIGKILLed from outside mid-fit.

The owner forms ``trainer.gang`` first, waits until both members have
written their marker of reaching the hold after their step-3 report and
rank 0's step-3 checkpoint has landed, then SIGKILLs rank 1's pid.  The
members hold until the owner has written a marker after the kill
(``tests/_torch_port_proc_trainer.py`` ``HoldingTrainer``), so the death
lands before step 4 every time, whatever the load: no clock races
another.  With no elastic recovery the gang is
torn down and a fresh gang of two new processes resumes at step 3 from
that checkpoint.  Held to ``JaxTrainer`` on one device whose data fails
once at step 4 (``tests/_torch_port_elastic.py``): loss, grad_norm and
eval at every step within rel 1e-4, params within atol 1e-4, the same
checkpoint steps.  Every wait is bounded (``WORLD_TIMEOUT_S``, 120 s,
the bound of a world's collectives)."""

import multiprocessing
import os
import signal
import threading
import time

import pytest

import _torch_port_elastic as el
import _torch_port_mesh_train as mt
import _torch_port_proc_trainer as pt
from _torch_port_mesh_train import case  # noqa: F401 (the fixture)
from _torch_port_procs import whoami
from ray_tpu_torch.parallel.distributed import WORLD_TIMEOUT_S

WAIT_S = WORLD_TIMEOUT_S


def kill_after_checkpoint(tr, pid: int, seen: dict) -> None:
    """Wait (bounded) until both members hold after step 3 and
    checkpoint_000000 has landed, SIGKILL ``pid``, then write the marker
    that lets the members go on."""
    payload = os.path.join(tr.storage_path, "checkpoints",
                           "checkpoint_000000", "payload.pkl")
    wanted = [payload] + [os.path.join(tr.storage_path, f"held_{r}")
                          for r in range(2)]
    deadline = time.monotonic() + WAIT_S
    while (not all(map(os.path.exists, wanted))
           and time.monotonic() < deadline):
        time.sleep(0.02)
    seen["checkpoint"] = os.path.exists(payload)
    os.kill(pid, signal.SIGKILL)
    seen["killed"] = pid
    with open(os.path.join(tr.storage_path, "killed"), "w"):
        pass


@pytest.fixture(scope="module")
def runs(case, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("proc_kill"))
    path = os.path.join(root, "kill")
    os.makedirs(path)
    _, tcfg, tree, batches, held = case
    tr = pt.proc_trainer((tcfg, tree, held), path,
                         pt.ProcBatches(batches, path), lr=mt.LR,
                         steps=mt.STEPS, ckpt_every=mt.CKPT_EVERY,
                         cls=pt.HoldingTrainer, elastic=False)
    seen: dict = {}

    def fit():
        pids = tr.gang.member_pids()
        killer = threading.Thread(target=kill_after_checkpoint,
                                  args=(tr, pids[1], seen))
        killer.start()
        try:
            res = tr.fit()
        finally:
            killer.join(WAIT_S)
        return pids, res, tr.gang.member_pids(), tr.gang.run(whoami,
                                                             timeout=60)

    try:
        with pytest.MonkeyPatch.context() as mp:
            # each member process one thread (as in the other file)
            mp.setenv("OMP_NUM_THREADS", "1")
            out = el.run_both(case, root, {1: 4}, {"fit": fit})
    finally:
        if tr._gang is not None:
            tr._gang.shutdown()
    return tr, seen, out


def test_an_outside_kill_forms_a_fresh_gang_of_new_processes(runs):
    tr, seen, (_, _, port) = runs
    pids, _, final, who = port["fit"]
    assert seen == {"checkpoint": True, "killed": pids[1]}
    first, second = tr.attempts
    assert [a["host"] for a in tr.attempts] == ["process"] * 2
    assert first["error"].rank == 1 and "exit code -9" in str(first["error"])
    assert first["recovery"] == "fresh"
    assert second["world"] == 2 and second["start_step"] == 3
    assert "error" not in second
    assert not set(second["member_ids"]) & set(first["member_ids"])
    assert not set(final) & set(pids) and os.getpid() not in pids + final
    assert [o["pid"] for o in who] == final
    assert not any(o["jax"] or o["ray_tpu"] for o in who)
    for rec, steps in ((first, [1, 2, 3]), (second, [4, 5, 6])):
        assert el.steps_of(rec["reports"][rec["member_ids"][0]]) == steps
    assert el.same_reports(second)


def test_the_restored_fit_matches_jax_trainer_on_one_device(runs):
    tr, _, (jtr, jres, port) = runs
    _, res, _, _ = port["fit"]
    el.assert_matches_jax(tr, res, jtr, jres)
    assert multiprocessing.active_children() == []
