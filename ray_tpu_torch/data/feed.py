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
injected at step k fails step k.  So does any other ``BaseException``
the iterator raises (a gang member's scripted death) except the three
that stop the program or the generator, which pass at once.

On a mesh (``mesh=``, a ``DeviceMesh``) every rank reads the same global
host batch and copies only the rows it owns, the block of dim 0 that
``train.step.shard_batch`` cuts for it (``batch_sharding``: split over
the data axes; a 0-d column is replicated), the same way: pinned memory
and the side stream on a card.  Each batch is yielded as DTensors of the
global shape on ``batch_sharding(mesh)``, with no collective.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.parallel.mesh import batch_sharding, replicated


def to_device(batch: dict, device: torch.device) -> dict:
    """A host batch's columns as tensors on ``device``, copied there
    synchronously."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def device_batches(host_batches: Iterable[dict], device=None,
                   prefetch: int = 2, *, mesh=None) -> Iterator[dict]:
    """Yield each host batch as a dict of tensors on ``device`` (None =
    the CUDA card), with ``prefetch`` batches in flight ahead of the one
    yielded.  With ``mesh`` the tensors are DTensors on it, each rank
    holding its rows (the mesh's device; ``device`` is not used)."""
    if prefetch < 1:
        raise ValueError(f"prefetch must be >= 1, got {prefetch}")
    if mesh is None:
        dev = resolve_device(device)
    elif mesh.device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(mesh.device_type)
    return _feed(iter(host_batches), dev, prefetch, mesh)


def _rows(mesh, column: np.ndarray) -> tuple:
    """(this rank's block of a host column as a tensor, its placements):
    the rows ``batch_sharding`` gives the rank, the whole of a 0-d
    column."""
    t = torch.as_tensor(column)
    pl = batch_sharding(mesh) if t.dim() else replicated(mesh)
    shape, offset = compute_local_shape_and_global_offset(t.shape, mesh, pl)
    if t.dim() and shape[0] != t.shape[0]:
        t = t.narrow(0, offset[0], shape[0])
    return t, pl


def _feed(it: Iterator[dict], dev: torch.device, prefetch: int,
          mesh=None) -> Iterator[dict]:
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    # (batch, its copy's event, the host iterator's error) in order
    window: deque = deque()

    def enqueue() -> bool:
        try:
            batch = next(it)
        except StopIteration:
            return False
        except (KeyboardInterrupt, SystemExit, GeneratorExit):
            raise
        except BaseException as e:  # raised when the consumer gets this far
            window.append((None, None, e))
            return False
        cols = {k: np.asarray(v) for k, v in batch.items()}
        if mesh is None:
            local = {k: (torch.as_tensor(a), None) for k, a in cols.items()}
        else:
            local = {k: _rows(mesh, a) for k, a in cols.items()}
        if stream is None:
            out = {k: t.to(dev) for k, (t, _) in local.items()}
            done = None
        else:
            pinned = {k: t.pin_memory() for k, (t, _) in local.items()}
            with torch.cuda.stream(stream):
                out = {k: t.to(dev, non_blocking=True)
                       for k, t in pinned.items()}
                done = torch.cuda.Event()
                done.record(stream)
        if mesh is not None:
            out = {k: _as_dtensor(out[k], mesh, pl, cols[k].shape)
                   for k, (_, pl) in local.items()}
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
                (t.to_local() if isinstance(t, DTensor)
                 else t).record_stream(consumer)
        yield out


def _as_dtensor(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    """``local`` (this rank's block) as the DTensor of global ``shape``
    (contiguous) that ``shard_batch`` makes of the same column."""
    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)
