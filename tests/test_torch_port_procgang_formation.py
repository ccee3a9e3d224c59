"""Forming the process-hosted gang (``MultiHostGang(host=ProcessHost())``,
gloo on the CPU), as the JAX package's
``test_partial_formation_kills_all_members``: a member whose formation
fails is named, and no child process outlives the failed formation; a
failed readmission reaps its fresh member and leaves a gang that runs on.
The default host stays in-process and spawns nothing."""

import multiprocessing
import os

import pytest

from _torch_port_procs import (SPMD_SUM, FailingReadmitMember,
                               FailingSetupMember, spmd_sum)
from ray_tpu_torch.parallel.gang import (GangMemberDied, InProcessHost,
                                         MultiHostGang, ProcessHost)


def test_a_partial_formation_leaves_no_child():
    with pytest.raises(GangMemberDied, match="injected setup failure") \
            as err:
        MultiHostGang(3, device="cpu", host=ProcessHost(),
                      member_cls=FailingSetupMember)
    assert err.value.rank == 1 and "rank 1/3" in str(err.value)
    assert multiprocessing.active_children() == []


def test_a_failed_readmission_leaves_a_gang_that_runs():
    gang = MultiHostGang(2, device="cpu", host=ProcessHost(),
                         member_cls=FailingReadmitMember)
    try:
        pids = gang.member_pids()
        with pytest.raises(GangMemberDied, match="rank 2/3") as err:
            gang.readmit(1)
        assert err.value.rank == 2
        assert gang.num_members == 2 and gang.member_pids() == pids
        assert len(multiprocessing.active_children()) == 2
        # the survivors left their world to try the larger one: the next
        # run joins a fresh one
        assert gang.run(spmd_sum, timeout=60.0) == [SPMD_SUM[2]] * 2
    finally:
        gang.shutdown()
    assert multiprocessing.active_children() == []


def test_the_default_host_is_in_process():
    gang = MultiHostGang(2, device="cpu")
    try:
        assert isinstance(gang.host, InProcessHost)
        assert gang.member_pids() == [os.getpid()] * 2
        assert multiprocessing.active_children() == []
    finally:
        gang.shutdown()
