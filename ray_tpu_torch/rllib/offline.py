"""Offline RL IO: JSON sample-batch readers and writers, and
off-policy estimation.

The port's own copy of ``ray_tpu/rllib/offline.py``: batches persisted
as newline-delimited JSON, every array a base64-encoded npy payload, so
either package reads what the other wrote; plus the ordinary and
weighted importance-sampling estimates of a new policy's value.
"""

from __future__ import annotations

import base64
import glob
import io
import json
import os
from typing import Iterator

import numpy as np

from ray_tpu_torch.rllib.sample_batch import SampleBatch


def _encode_array(a: np.ndarray) -> dict:
    buf = io.BytesIO()
    np.save(buf, a, allow_pickle=False)
    return {"__npy__": base64.b64encode(buf.getvalue()).decode("ascii")}


def _decode(obj):
    if isinstance(obj, dict) and "__npy__" in obj:
        return np.load(io.BytesIO(base64.b64decode(obj["__npy__"])),
                       allow_pickle=False)
    return obj


class JsonWriter:
    """Append sample batches to newline-delimited JSON files
    (reference: rllib/offline/json_writer.py)."""

    def __init__(self, path: str, max_file_size: int = 64 * 1024 * 1024):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.max_file_size = max_file_size
        self._f = None
        self._index = 0

    def write(self, batch: SampleBatch) -> None:
        if self._f is None or self._f.tell() > self.max_file_size:
            if self._f:
                self._f.close()
            name = os.path.join(self.path, f"output-{self._index:05d}.json")
            self._f = open(name, "a")
            self._index += 1
        row = {k: _encode_array(np.asarray(v)) for k, v in batch.items()}
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


class JsonReader:
    """Read sample batches back (reference: rllib/offline/json_reader.py)."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            self.files = sorted(glob.glob(os.path.join(path, "*.json")))
        else:
            self.files = sorted(glob.glob(path))
        if not self.files:
            raise FileNotFoundError(f"no offline data under {path!r}")

    def read_all(self) -> SampleBatch:
        return SampleBatch.concat_samples(list(self))

    def __iter__(self) -> Iterator[SampleBatch]:
        for f in self.files:
            with open(f) as fh:
                for line in fh:
                    if line.strip():
                        row = json.loads(line)
                        yield SampleBatch(
                            {k: _decode(v) for k, v in row.items()})


def importance_sampling_estimate(batch: SampleBatch, new_logp: np.ndarray
                                 ) -> dict:
    """Ordinary + weighted importance-sampling value estimates of a new
    policy from behavior data (reference:
    rllib/offline/estimators/{importance_sampling.py,
    weighted_importance_sampling.py}).  Per-step IS over flat batches."""
    from ray_tpu_torch.rllib import sample_batch as SB
    old_logp = np.asarray(batch[SB.LOGP])
    rew = np.asarray(batch[SB.REWARDS])
    w = np.exp(np.clip(new_logp - old_logp, -10, 10))
    v_behavior = float(np.mean(rew))
    v_is = float(np.mean(w * rew))
    v_wis = float(np.sum(w * rew) / max(np.sum(w), 1e-8))
    return {"v_behavior": v_behavior, "v_is": v_is, "v_wis": v_wis,
            "mean_is_weight": float(np.mean(w))}
