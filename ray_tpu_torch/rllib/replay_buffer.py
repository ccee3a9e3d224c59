"""Replay buffers: uniform ring, prioritized (segment trees), reservoir.

The port's own copy of ``ray_tpu/rllib/replay_buffer.py``: host-side
numpy structures whose draws come from ``np.random.default_rng(seed)``,
so the same seed and the same adds give the same indices and weights as
the JAX package's buffers.  ``sample()`` returns column batches that a
learner moves to its device in one copy per train step.
"""

from __future__ import annotations

import operator
from typing import Optional

import numpy as np

from ray_tpu_torch.rllib.sample_batch import SampleBatch


class SegmentTree:
    """Array-backed binary segment tree (reference:
    rllib/execution/segment_tree.py)."""

    def __init__(self, capacity: int, operation, neutral: float):
        assert capacity > 0 and capacity & (capacity - 1) == 0, \
            "capacity must be a power of 2"
        self.capacity = capacity
        self.op = operation
        self.neutral = neutral
        self.value = np.full(2 * capacity, neutral, np.float64)

    def __setitem__(self, idx: int, val: float) -> None:
        i = idx + self.capacity
        self.value[i] = val
        i //= 2
        while i >= 1:
            self.value[i] = self.op(self.value[2 * i], self.value[2 * i + 1])
            i //= 2

    def __getitem__(self, idx: int) -> float:
        return float(self.value[idx + self.capacity])

    def reduce(self, start: int = 0, end: Optional[int] = None) -> float:
        """Reduce over [start, end)."""
        if end is None:
            end = self.capacity
        result = self.neutral
        start += self.capacity
        end += self.capacity
        while start < end:
            if start & 1:
                result = self.op(result, self.value[start])
                start += 1
            if end & 1:
                end -= 1
                result = self.op(result, self.value[end])
            start //= 2
            end //= 2
        return float(result)


class SumSegmentTree(SegmentTree):
    def __init__(self, capacity: int):
        super().__init__(capacity, operator.add, 0.0)

    def sum(self, start: int = 0, end: Optional[int] = None) -> float:
        return self.reduce(start, end)

    def find_prefixsum_idx(self, prefixsum: float) -> int:
        """Largest i such that sum(arr[:i]) <= prefixsum."""
        i = 1
        while i < self.capacity:
            if self.value[2 * i] > prefixsum:
                i = 2 * i
            else:
                prefixsum -= self.value[2 * i]
                i = 2 * i + 1
        return i - self.capacity


class MinSegmentTree(SegmentTree):
    def __init__(self, capacity: int):
        super().__init__(capacity, min, float("inf"))

    def min(self, start: int = 0, end: Optional[int] = None) -> float:
        return self.reduce(start, end)


class ReplayBuffer:
    """Uniform FIFO ring buffer of transitions stored as columns
    (reference: rllib/utils/replay_buffers/replay_buffer.py)."""

    def __init__(self, capacity: int = 100_000, seed: int = 0):
        self.capacity = capacity
        self._cols: dict[str, np.ndarray] = {}
        self._next = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: SampleBatch) -> None:
        """Add a batch of rows (columnar)."""
        n = len(batch)
        if not self._cols:
            for k, v in batch.items():
                v = np.asarray(v)
                self._cols[k] = np.zeros((self.capacity, *v.shape[1:]),
                                         v.dtype)
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._cols[k][idx] = np.asarray(v)
        self._next = int((self._next + n) % self.capacity)
        self._size = min(self._size + n, self.capacity)
        self._added_idx = idx  # subclass hook

    def sample(self, num_items: int) -> SampleBatch:
        idx = self._rng.integers(0, self._size, num_items)
        out = SampleBatch({k: v[idx] for k, v in self._cols.items()})
        out["batch_indexes"] = idx
        return out


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (reference:
    rllib/utils/replay_buffers/prioritized_replay_buffer.py)."""

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6,
                 seed: int = 0):
        super().__init__(capacity, seed)
        it_cap = 1
        while it_cap < capacity:
            it_cap *= 2
        self._sum = SumSegmentTree(it_cap)
        self._min = MinSegmentTree(it_cap)
        self._max_priority = 1.0
        self.alpha = alpha

    def add(self, batch: SampleBatch) -> None:
        super().add(batch)
        p = self._max_priority ** self.alpha
        for i in self._added_idx:
            self._sum[int(i)] = p
            self._min[int(i)] = p

    def sample(self, num_items: int, beta: float = 0.4) -> SampleBatch:
        idx = np.empty(num_items, np.int64)
        total = self._sum.sum(0, self._size)
        for j in range(num_items):
            mass = self._rng.random() * total
            idx[j] = min(self._sum.find_prefixsum_idx(mass), self._size - 1)
        p_min = self._min.min(0, self._size) / total
        max_weight = (p_min * self._size) ** (-beta)
        ps = np.array([self._sum[int(i)] for i in idx]) / total
        weights = (ps * self._size) ** (-beta) / max_weight
        out = SampleBatch({k: v[idx] for k, v in self._cols.items()})
        out["weights"] = weights.astype(np.float32)
        out["batch_indexes"] = idx
        return out

    def update_priorities(self, idx: np.ndarray, priorities: np.ndarray
                          ) -> None:
        for i, p in zip(idx, priorities):
            p = float(max(p, 1e-6))
            self._sum[int(i)] = p ** self.alpha
            self._min[int(i)] = p ** self.alpha
            self._max_priority = max(self._max_priority, p)


class ReservoirReplayBuffer(ReplayBuffer):
    """Uniform-over-history reservoir sampling buffer (reference:
    rllib/utils/replay_buffers/reservoir_replay_buffer.py)."""

    def __init__(self, capacity: int = 100_000, seed: int = 0):
        super().__init__(capacity, seed)
        self._seen = 0

    def add(self, batch: SampleBatch) -> None:
        for row in range(len(batch)):
            one = SampleBatch({k: np.asarray(v)[row:row + 1]
                               for k, v in batch.items()})
            if self._size < self.capacity:
                super(ReservoirReplayBuffer, self).add(one)
            else:
                j = self._rng.integers(0, self._seen + 1)
                if j < self.capacity:
                    for k, v in one.items():
                        self._cols[k][j] = np.asarray(v)[0]
            self._seen += 1
