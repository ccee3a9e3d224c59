"""The trainer loop on one device: the port of ``JaxTrainer``
(``ray_tpu/train/jax_trainer.py``), of ``BaseTrainer.fit``'s single-host
restart loop (``ray_tpu/train/trainer.py``) and of ``Result``
(``ray_tpu/train/result.py``).

``Trainer.train_loop(report, get_checkpoint)`` is ``JaxTrainer``'s
``_train_loop``: it builds the step, restores params, Adam's moments and
the step from the checkpoint it is given, replays a fresh iterator of
``train_data`` to the resume point, feeds the batches through
``data.device_batches``, reports every ``report_every`` steps (``loss``,
``grad_norm``, ``step``, ``throughput`` in tokens/s since the attempt
began, and ``eval`` every ``eval_every`` steps) and hands ``report`` a
numpy checkpoint payload every ``checkpoint_every`` steps and at the
last step.  ``Trainer.fit()`` runs that body under the port's own session
and ``CheckpointManager`` and restarts a failed attempt from the latest
checkpoint, up to ``max_failures`` times.  A host runs the same body under
its own trainer by passing its session's two functions.
"""

from __future__ import annotations

import logging
import os
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.data.feed import device_batches
from ray_tpu_torch.models.convert import _map
from ray_tpu_torch.train import session as _session
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.step import (_no_mesh, load_state,
                                      make_train_step, state_to_host)

logger = logging.getLogger("ray_tpu_torch.train")


class TrainingFailedError(RuntimeError):
    pass


@dataclass
class Result:
    metrics: dict = field(default_factory=dict)     # last reported metrics
    checkpoint: Optional[Checkpoint] = None
    error: Optional[BaseException] = None
    path: Optional[str] = None                      # run directory
    metrics_history: list = field(default_factory=list)


class Trainer:
    """loss_fn(params, batch) -> 0-d loss; init_params(seed) -> the
    params tree (moved to ``device``); optimizer: a port ``tx`` such as
    ``adamw(3e-4)``; train_data: an iterable of host batches (dicts of
    numpy columns), iterated afresh by each attempt; eval_fn(params) ->
    a number.  ``storage_path`` is the run directory (checkpoints go to
    its ``checkpoints/``).  ``device=None`` is the CUDA card."""

    def __init__(self, *, loss_fn: Callable,
                 init_params: Callable[[int], Any],
                 optimizer: Callable,
                 train_data: Iterable,
                 num_steps: int,
                 eval_fn: Optional[Callable] = None,
                 eval_every: int = 0,
                 report_every: int = 10,
                 checkpoint_every: int = 0,
                 seed: int = 0,
                 storage_path: Optional[str] = None,
                 num_to_keep: Optional[int] = None,
                 max_failures: int = 0,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 mesh=None,
                 device=None):
        _no_mesh(mesh, "Trainer", "the sharded train state's checkpoints "
                 "and the loop over a mesh come with a later slice")
        self.device = resolve_device(device)
        self.loss_fn, self.init_params = loss_fn, init_params
        self.optimizer, self.train_data = optimizer, train_data
        self.num_steps, self.seed = num_steps, seed
        self.eval_fn, self.eval_every = eval_fn, eval_every
        self.report_every = report_every
        self.checkpoint_every = checkpoint_every
        self.storage_path = storage_path or os.path.join(
            os.getcwd(), "ray_tpu_torch_results", "run")
        self.num_to_keep, self.max_failures = num_to_keep, max_failures
        self.resume_from_checkpoint = resume_from_checkpoint
        self.final_state = None
        self.start_step = 0          # where the last attempt began
        self.feed_wait_s: list = []  # host seconds in the feed, per step

    def train_loop(self, report: Callable, get_checkpoint: Callable) -> None:
        """One attempt: ``report(metrics, checkpoint=payload or None)``
        and ``get_checkpoint() -> an object with to_dict() or None`` are
        the session's."""
        init_fn, step_fn = make_train_step(self.loss_fn, self.optimizer)
        params = _map(lambda t: t.to(self.device),
                      self.init_params(self.seed))
        state = init_fn(params)
        start = 0
        restored = get_checkpoint()
        if restored is not None:
            # the full state: re-initialising the moments would restart
            # Adam's bias correction and spike the step after a failover
            payload = restored.to_dict()
            start = int(payload.get("step", 0))
            load_state(state, payload)
            del payload
        self.start_step = start

        data_iter = iter(self.train_data)
        # replay to the resume point so a deterministic feed does not
        # consume the leading batches again
        for _ in range(start):
            next(data_iter)
        feed = device_batches(data_iter, self.device)
        self.feed_wait_s = []
        t0 = time.perf_counter()
        tokens_done = 0
        for i in range(start, self.num_steps):
            t = time.perf_counter()
            batch = next(feed)
            self.feed_wait_s.append(time.perf_counter() - t)
            state, metrics = step_fn(state, batch)
            leaf = next(iter(batch.values()))
            tokens_done += int(leaf.shape[0]) * (
                int(leaf.shape[1]) if leaf.dim() > 1 else 1)

            is_last = i + 1 == self.num_steps
            if (i + 1) % self.report_every == 0 or is_last:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                m.update(step=i + 1, throughput=tokens_done / max(dt, 1e-9))
                if (self.eval_fn is not None and self.eval_every
                        and (i + 1) % self.eval_every == 0):
                    with torch.no_grad():
                        m["eval"] = float(self.eval_fn(state.params))
                ckpt = None
                if (self.checkpoint_every
                        and (i + 1) % self.checkpoint_every == 0) or is_last:
                    ckpt = state_to_host(state)
                report(m, checkpoint=ckpt)
        self.final_state = state

    def fit(self) -> Result:
        run_dir = self.storage_path
        os.makedirs(run_dir, exist_ok=True)
        manager = CheckpointManager(os.path.join(run_dir, "checkpoints"),
                                    num_to_keep=self.num_to_keep)
        restore = self.resume_from_checkpoint or manager.latest()
        attempt, error = 0, None
        results: list = []
        while True:
            st = _session._start(checkpoint_cb=manager.save,
                                 latest_checkpoint=restore)
            try:
                self.train_loop(_session.report, _session.get_checkpoint)
                error = None
                break
            except StopIteration:    # the data ran out: the run ends
                error = None
                break
            except Exception as e:   # restart from the last checkpoint
                error = e
                attempt += 1
                logger.warning("training attempt %d failed: %s", attempt, e)
                if attempt > self.max_failures:
                    break
                manager.flush()
                restore = manager.latest()
            finally:
                results.extend(st.results)
                _session._end()

        manager.flush()
        res = Result(metrics=results[-1] if results else {},
                     checkpoint=manager.latest(), error=error, path=run_dir,
                     metrics_history=results)
        if error is not None:
            raise TrainingFailedError(
                f"training failed after {attempt} attempt(s): {error}\n"
                + "".join(traceback.format_exception(error))) from error
        return res
