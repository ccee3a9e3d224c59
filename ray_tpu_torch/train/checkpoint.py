"""Checkpoints: dict <-> directory, with the disk write in the background.

The port's own copy of ``ray_tpu/train/checkpoint.py``: ``Checkpoint``,
``AsyncCheckpointer`` and ``CheckpointManager`` with the same directory
layout (``checkpoint_%06d/payload.pkl`` beside ``ckpt_meta.json``), so
either package's manager finds the other's checkpoints.

A payload unpickles with numpy alone: every tensor leaf becomes a numpy
array in plain dicts.  numpy has no bfloat16, so a bf16 tensor is stored
as ``{"__dtype__": "bfloat16", "bits": <its bits as uint16>}``;
``from_host`` decodes that, and also a numpy array whose dtype is
ml_dtypes' ``bfloat16`` (what the JAX package writes for a bf16 leaf).

``to_host`` is the snapshot: it copies every CUDA tensor of the tree
into one pinned host buffer with asynchronous copies and waits for them,
so the copy is over when it returns and only the disk write is left to
the background thread.  The returned arrays are views of that buffer;
when the last of them is dropped the buffer goes back to torch's cached
pinned memory for the next snapshot.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

BF16_TAG = "__dtype__"
_ALIGN = 256        # byte alignment of each leaf in the pinned buffer


def _walk(fn, tree):
    """Apply ``fn`` to every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(fn, v) for v in tree)
    return fn(tree)


def _tensors(tree) -> list:
    out = []
    _walk(lambda x: out.append(x) if isinstance(x, torch.Tensor) else None,
          tree)
    return out


def _to_numpy(t: torch.Tensor):
    """A host tensor -> numpy (a view), bf16 as its tagged uint16 bits."""
    if t.dtype == torch.bfloat16:
        return {BF16_TAG: "bfloat16",
                "bits": t.view(torch.int16).numpy().view(np.uint16)}
    return t.numpy()


def to_host(tree):
    """Tensors of ``tree`` -> numpy arrays on the host (a copy: the train
    step updates its tensors in place); other leaves pass through.  CUDA
    tensors go through one pinned buffer; the copies are complete when
    this returns."""
    tensors = _tensors(tree)
    on_card = {}
    cuda = [t for t in tensors if t.is_cuda]
    if cuda:
        sizes = [-(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
                 for t in cuda]
        buf = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=True)
        off = 0
        for t, n in zip(cuda, sizes):
            view = buf[off:off + t.numel() * t.element_size()].view(
                t.dtype).view(t.shape)
            view.copy_(t.detach(), non_blocking=True)
            on_card[id(t)] = view
            off += n
        for dev in {t.device for t in cuda}:
            torch.cuda.current_stream(dev).synchronize()

    def leaf(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.is_cuda:
            return _to_numpy(on_card[id(x)])
        return _to_numpy(x.detach().cpu().clone())
    return _walk(leaf, tree)


def is_bf16_leaf(x) -> bool:
    return isinstance(x, dict) and x.get(BF16_TAG) == "bfloat16"


def host_tensor(a) -> torch.Tensor:
    """One payload leaf -> a CPU tensor (bf16 leaves decoded)."""
    if is_bf16_leaf(a):
        return torch.from_numpy(np.array(a["bits"], dtype=np.uint16).view(
            np.int16)).view(torch.bfloat16)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' array
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def from_host(tree, device) -> dict:
    """A payload's nested dict of arrays -> the same nesting of tensors on
    ``device``."""
    if is_bf16_leaf(tree) or not isinstance(tree, dict):
        return host_tensor(tree).to(device)
    return {k: from_host(v, device) for k, v in tree.items()}


class Checkpoint:
    """A checkpoint is a directory; a dict payload is pickled into it."""

    PAYLOAD = "payload.pkl"
    META = "ckpt_meta.json"

    def __init__(self, path: str):
        self.path = path

    @classmethod
    def from_dict(cls, data: dict, path: str) -> "Checkpoint":
        os.makedirs(path, exist_ok=True)
        host = to_host(data)
        tmp = os.path.join(path, cls.PAYLOAD + ".tmp")
        with open(tmp, "wb") as f:
            pickle.dump(host, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, os.path.join(path, cls.PAYLOAD))
        with open(os.path.join(path, cls.META), "w") as f:
            json.dump({"format": "dict", "time": time.time()}, f)
        return cls(path)

    def to_dict(self) -> dict:
        with open(os.path.join(self.path, self.PAYLOAD), "rb") as f:
            return pickle.load(f)

    def __repr__(self):
        return f"Checkpoint({self.path!r})"


class AsyncCheckpointer:
    """Snapshot now, write in the background: one writer thread and a
    latest-wins queue of depth 1 (a checkpoint is a restart point, not a
    log, so a snapshot overtaken before its write starts is dropped)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: Optional[tuple] = None
        self._thread: Optional[threading.Thread] = None
        self._running = False     # the drain loop's liveness, under _lock
        self._error: Optional[BaseException] = None
        self.last_path: Optional[str] = None

    def save(self, data: dict, path: str) -> None:
        host = to_host(data)       # the device-to-host copy is synchronous
        with self._lock:
            self._pending = (host, path)
            # _running turns false only under this lock (in _drain), so a
            # save racing the thread's exit always starts a new one
            if not self._running:
                self._running = True
                self._thread = threading.Thread(target=self._drain,
                                                daemon=True)
                self._thread.start()

    def _drain(self):
        while True:
            with self._lock:
                if self._pending is None:
                    self._running = False
                    return
                host, path = self._pending
                self._pending = None
            try:
                Checkpoint.from_dict(host, path)
                self.last_path = path
            except Exception as e:  # raised again by wait()
                self._error = e

    def wait(self):
        while True:
            with self._lock:
                t = self._thread
                busy = self._running or self._pending is not None
            if not busy:
                break
            if t is not None:
                t.join(timeout=0.05)
        if self._error is not None:
            err, self._error = self._error, None
            raise err


class CheckpointManager:
    """Keeps the last ``num_to_keep`` checkpoints under ``root``, each
    written in the background by an ``AsyncCheckpointer``.

    On a mesh every rank keeps a manager over the same ``root`` and only
    one writes (``writer=True`` on rank 0): the others name each save as
    the writer does and keep the same list, writing nothing.  ``barrier``
    (the world's, on a mesh) runs on every rank after each ``save`` and
    ``flush``: after a ``flush`` the writer's last save is on disk, so
    every rank's ``latest()`` then names the same directory.  It also
    runs once at the end of ``__init__``, after this rank listed
    ``root``: no writer saves before every rank has numbered its saves
    from the same listing."""

    def __init__(self, root: str, num_to_keep: Optional[int] = None, *,
                 writer: bool = True,
                 barrier: Optional[Callable[[], None]] = None):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.num_to_keep = num_to_keep
        self.writer = writer
        self._barrier = barrier
        self._seq = 0
        self._kept: list[str] = list(self._existing())
        self._async = AsyncCheckpointer()
        self._sync()

    def _existing(self):
        out = sorted(d for d in os.listdir(self.root)
                     if d.startswith("checkpoint_"))
        if out:
            self._seq = int(out[-1].split("_")[1]) + 1
        return (os.path.join(self.root, d) for d in out)

    def _sync(self):
        if self._barrier is not None:
            self._barrier()

    def save(self, data: dict) -> str:
        path = os.path.join(self.root, f"checkpoint_{self._seq:06d}")
        self._seq += 1
        if self.writer:
            self._async.save(data, path)
        self._kept.append(path)
        while (self.num_to_keep is not None
               and len(self._kept) > self.num_to_keep):
            victim = self._kept.pop(0)
            if self.writer:
                self._async.wait()
                shutil.rmtree(victim, ignore_errors=True)
        self._sync()
        return path

    def latest(self) -> Optional[Checkpoint]:
        self.flush()
        for d in os.listdir(self.root):
            path = os.path.join(self.root, d)
            if d.startswith("checkpoint_") and path not in self._kept:
                self._kept.append(path)
        self._kept.sort()
        if self._kept:
            last = self._kept[-1]
            self._seq = max(self._seq,
                            int(os.path.basename(last).split("_")[1]) + 1)
        for path in reversed(self._kept):
            if os.path.exists(os.path.join(path, Checkpoint.PAYLOAD)):
                return Checkpoint(path)
        return None

    def flush(self, sync: bool = True):
        """Wait for the writes in flight, then (``sync``) at the
        barrier."""
        self._async.wait()
        if sync:
            self._sync()
