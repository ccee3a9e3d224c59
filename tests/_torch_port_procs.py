"""Member functions and member classes for the process-hosted gang's
tests (``MultiHostGang(host=ProcessHost())``): module-level, so a spawned
member imports them by reference, and importing torch and the port only,
so a member process imports no JAX.

``spmd_sum`` is a gloo all-reduce over the whole world whose value
encodes the world's size, as the JAX package's ``_spmd_sum``
(``tests/test_elastic_gang.py``): each rank holds a [1, 4] block of
``rank + 1``, so 3 ranks sum to (1 + 2 + 3) * 4 = 24 and 2 to 12."""

import os
import sys
import time

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.gang import GangMember, current_member

# the JAX gang tests' contract values, by world size
SPMD_SUM = {2: 12.0, 3: 24.0}
# how long a dying member lets its peers settle into the collective
HOLD_S = 0.3


def spmd_sum(rank: int) -> float:
    x = torch.full((1, 4), float(rank + 1))
    dist.all_reduce(x)
    return float(x.sum())


def whoami(rank: int) -> dict:
    return {"rank": rank, "world": dist.get_world_size(),
            "pid": os.getpid(), "member_id": current_member().member_id,
            "jax": "jax" in sys.modules, "ray_tpu": "ray_tpu" in sys.modules}


def die_in_a_collective(rank: int, target: int) -> int:
    """``target`` SIGKILLs its own process while the others wait in an
    all-reduce it never enters."""
    if rank == target:
        time.sleep(HOLD_S)
        current_member().kill()
    dist.all_reduce(torch.ones(4))
    return rank


def fail_on(rank: int, target: int) -> int:
    """``target`` raises while the others wait in a barrier."""
    if rank == target:
        time.sleep(HOLD_S)
        raise ValueError(f"step failed on rank {rank}")
    dist.barrier()
    return rank


class FailingReadmitMember(GangMember):
    """The member that would make a world of 3 fails to prove it formed:
    a readmission that fails."""

    def formed(self):
        if self.world == 3 and self.rank == 2:
            raise RuntimeError("injected readmission failure (rank 2)")
        super().formed()


class FailingSetupMember(GangMember):
    """Rank 1 fails to prove the world formed: the partial-formation
    shape."""

    def formed(self):
        if self.rank == 1:
            raise RuntimeError("injected setup failure (rank 1)")
        super().formed()


class NoiseStream:
    """Gumbel noise drawn in the test process (numpy), handed out in
    order: a member's policy ``gumbel_fn``."""

    def __init__(self, draws):
        self.draws, self.used = list(draws), 0

    def __call__(self):
        g = self.draws[self.used]
        self.used += 1
        return g


def set_noise(worker, rank: int, draws: list) -> None:
    """A DD-PPO worker's rollout policy takes ``draws[rank]`` in order
    (``DDPPO.on_workers``)."""
    worker.worker.policy.gumbel_fn = NoiseStream(draws[rank])
