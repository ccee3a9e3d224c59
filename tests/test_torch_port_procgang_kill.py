"""The process-hosted gang (``MultiHostGang(host=ProcessHost())``, gloo
on the CPU) against the JAX package's elastic contract
(``tests/test_elastic_gang.py``, reform and readmit): the owner's
``os.kill(pid, SIGKILL)`` of an idle member is dropped by
``alive_ranks()``; ``reform`` keeps the survivors' processes and
``readmit`` adds exactly one fresh one (24.0 / 12.0 / 24.0 at worlds 3 /
2 / 3); ``shutdown`` leaves no child process.  Every wait is
bounded."""

import multiprocessing
import os
import signal
import time

from _torch_port_procs import SPMD_SUM, spmd_sum
from ray_tpu_torch.parallel.gang import MultiHostGang, ProcessHost

RUN_S = 60.0


def test_an_owners_kill_is_survived_and_shutdown_leaves_no_child():
    gang = MultiHostGang(3, device="cpu", host=ProcessHost())
    try:
        pids = gang.member_pids()
        assert len(set(pids)) == 3
        assert gang.run(spmd_sum, timeout=RUN_S) == [SPMD_SUM[3]] * 3

        os.kill(pids[1], signal.SIGKILL)
        alive, deadline = [], time.monotonic() + 30
        while time.monotonic() < deadline:
            alive = gang.alive_ranks()
            if alive == [0, 2]:
                break
            time.sleep(0.05)
        assert alive == [0, 2], alive

        gang.reform(alive)
        assert gang.num_members == 2
        assert gang.member_pids() == [pids[0], pids[2]]   # not restarted
        assert gang.run(spmd_sum, timeout=RUN_S) == [SPMD_SUM[2]] * 2

        assert gang.readmit() == 3
        final = gang.member_pids()
        assert final[:2] == [pids[0], pids[2]] and final[2] not in pids
        assert gang.run(spmd_sum, timeout=RUN_S) == [SPMD_SUM[3]] * 3
    finally:
        gang.shutdown()
    assert multiprocessing.active_children() == []
    assert not any(m.alive for m in gang.members)
