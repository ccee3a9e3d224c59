"""The device feed, the port's counterpart of
``Dataset.iter_batches_sharded`` (``ray_tpu/data/dataset.py``).

``device_batches`` takes any iterator of host batches (dicts of numpy
columns, e.g. a host's ``Dataset.iter_batches(...)``) and yields the
same batches as tensors on the device, ``prefetch`` batches ahead: while
the step that reads batch k runs, batches k+1 .. k+prefetch are already
on their way.  On a CUDA device each batch is copied into pinned host
memory and then to the card by a ``non_blocking`` copy on a side stream;
the consumer's stream waits on that copy's event before it reads the
batch, and ``record_stream`` keeps the caching allocator from reusing
the batch's memory while the consumer's stream may still read it.

An error raised by the host iterator reaches the consumer at the batch
it was raised for, not earlier when the feed reads ahead, so a failure
injected at step k fails step k.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device


def to_device(batch: dict, device: torch.device) -> dict:
    """A host batch's columns as tensors on ``device``, copied there
    synchronously."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def device_batches(host_batches: Iterable[dict], device=None,
                   prefetch: int = 2) -> Iterator[dict]:
    """Yield each host batch as a dict of tensors on ``device`` (None =
    the CUDA card), with ``prefetch`` batches in flight ahead of the one
    yielded."""
    if prefetch < 1:
        raise ValueError(f"prefetch must be >= 1, got {prefetch}")
    return _feed(iter(host_batches), resolve_device(device), prefetch)


def _feed(it: Iterator[dict], dev: torch.device,
          prefetch: int) -> Iterator[dict]:
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    # (batch, its copy's event, the host iterator's error) in order
    window: deque = deque()

    def enqueue() -> bool:
        try:
            batch = next(it)
        except StopIteration:
            return False
        except Exception as e:  # raised when the consumer gets this far
            window.append((None, None, e))
            return False
        if stream is None:
            window.append((to_device(batch, dev), None, None))
            return True
        pinned = {k: torch.as_tensor(np.asarray(v)).pin_memory()
                  for k, v in batch.items()}
        with torch.cuda.stream(stream):
            out = {k: t.to(dev, non_blocking=True)
                   for k, t in pinned.items()}
            done = torch.cuda.Event()
            done.record(stream)
        window.append((out, done, None))
        return True

    pulling = True
    while True:
        while pulling and len(window) <= prefetch:
            pulling = enqueue()
        if not window:
            return
        out, done, err = window.popleft()
        if err is not None:
            raise err
        if done is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(done)
            for t in out.values():
                t.record_stream(consumer)
        yield out
