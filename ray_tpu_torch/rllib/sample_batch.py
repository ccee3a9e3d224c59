"""SampleBatch: columnar trajectory data.

The port's own copy of ``ray_tpu/rllib/sample_batch.py``: a thin
dict-of-numpy wrapper, the currency between rollout workers and
learners; a learner moves the columns it trains on to its device.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
NEXT_OBS = "next_obs"
LOGITS = "logits"
LOGP = "logp"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"


class SampleBatch(dict):
    @property
    def count(self) -> int:
        if OBS in self:
            return len(self[OBS])
        for v in self.values():
            return len(v)
        return 0

    def __len__(self):  # row count, matching the reference's semantics
        return self.count

    @staticmethod
    def concat_samples(batches: list["SampleBatch"]) -> "SampleBatch":
        batches = [b for b in batches if b.count]
        if not batches:
            return SampleBatch()
        keys = batches[0].keys()
        return SampleBatch({k: np.concatenate([np.asarray(b[k])
                                               for b in batches])
                            for k in keys})

    def shuffle(self, seed: Optional[int] = None) -> "SampleBatch":
        perm = np.random.default_rng(seed).permutation(self.count)
        return SampleBatch({k: np.asarray(v)[perm] for k, v in self.items()})

    def minibatches(self, size: int, *,
                    seed: Optional[int] = None) -> Iterator["SampleBatch"]:
        b = self.shuffle(seed) if seed is not None else self
        n = b.count
        for s in range(0, n - size + 1, size):
            yield SampleBatch({k: v[s:s + size] for k, v in b.items()})

    def split_time_major(self, t: int) -> "SampleBatch":
        """[T*B, ...] -> [T, B, ...] for vtrace-style learners (the
        inverse of RolloutWorker's flatten, which keeps T outermost).
        Keys whose leading dim is not the row count (e.g. the [B, ...]
        bootstrap_obs) pass through unchanged."""
        rows = self.count
        out = {}
        for k, v in self.items():
            v = np.asarray(v)
            if v.shape[0] != rows:
                out[k] = v
                continue
            assert rows % t == 0, (k, v.shape, t)
            out[k] = v.reshape(t, rows // t, *v.shape[1:])
        return SampleBatch(out)
