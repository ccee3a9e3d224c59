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

On a mesh (``mesh=``: a ``DeviceMesh``, or axes such as ``{"dp": 2, "tp":
2}`` that ``parallel.form_gang`` lays over the world) ``fit()`` is called
on every rank, SPMD, as torchrun would call it.  The loss function gets
the mesh and the rules bound when it takes them (as ``JaxTrainer`` binds
them), the step is ``make_train_step(mesh=, params_logical=, rules=)``,
each rank feeds its rows of every global batch (``device_batches(mesh=)``)
and ``tokens_done`` counts the global batch.  A checkpoint holds the whole
state (``state_to_host`` gathers it on every rank); only rank 0's manager
writes, and every rank waits for it (``CheckpointManager(writer=,
barrier=)``), so every rank restores the same checkpoint, each its own
blocks.  Every rank reports the same metrics.

Failures on a mesh of more than one rank: the ranks agree after every
host batch (an all-reduce of who failed to get it), so an error of the
host iterator at step k, on any rank, is raised on every rank at step k
(``HostDataError``) and every rank restarts from the same checkpoint.
Any other error of a rank is not retried there: that rank's ``fit``
raises and the run ends (the others, waiting in a collective it will
never join, are the launcher's to stop).  A failure of one rank alone is
what the multi-host arm recovers from.

The multi-host arm (``num_hosts > 1``, the port of the JAX
``DataParallelTrainer``'s): ``fit()`` is called once, by the process
that owns the gang, not on its members.  It forms a
``parallel.gang.MultiHostGang`` of ``num_hosts`` members (threads of this
process sharing ``device``) and each attempt runs the same ``train_loop``
on every member, over a mesh of the axes given (default ``{"dp": -1}``,
which fills each world).  Every member feeds its rows of each global
batch, so a change of world reshards the stream at the resume step with
no data movement; rank 0's manager writes the checkpoints and the owner's
manager, over the same root, finds them.  The reports are rank 0's (kept from failed attempts too, as on one
device); ``attempts`` records each attempt's world, member ids, resume
step and every member's reports.  After an attempt fails, recovery is
``_elastic_recover``'s, as in the JAX package: members dead, shrink to
the survivors (the resume attempt runs at the smaller world, from the
latest checkpoint); every member alive and the gang below target,
re-admit; alive and at target, re-form in place; fewer than ``min_hosts``
alive, or re-forming failed, tear the gang down and form a fresh one.  A
fresh attempt at a re-gang boundary re-admits first, and carries on at
the smaller world when that fails.  The final state is the last
checkpoint's (``Result.checkpoint``; ``final_state`` stays None: the
members' tensors belong to a world that has ended).
"""

from __future__ import annotations

import copy
import functools
import inspect
import logging
import os
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.data.feed import device_batches
from ray_tpu_torch.models.convert import _map
from ray_tpu_torch.parallel.gang import (GangConfig, MultiHostGang,
                                         TpuGang, current_member, form_gang)
from ray_tpu_torch.parallel.sharding import DEFAULT_LLM_RULES, Rules
from ray_tpu_torch.train import session as _session
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.step import (load_state, make_train_step,
                                      state_to_host)

logger = logging.getLogger("ray_tpu_torch.train")


class TrainingFailedError(RuntimeError):
    pass


class HostDataError(RuntimeError):
    """The host iterator of some rank of a mesh failed to give its batch
    at a step: raised on every rank at that step, so all restart alike."""


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
    its ``checkpoints/``).  ``device=None`` is the CUDA card.

    ``mesh``: a ``DeviceMesh`` or the axes of one (formed here over the
    world, on ``device``); ``params_logical`` places the params on it
    (every leaf replicated without it) by ``rules``; the module note
    says how the loop runs there.

    ``num_hosts > 1``: the multi-host arm (``ScalingConfig``'s
    ``num_hosts``, ``elastic`` and ``min_hosts``); ``mesh`` is then the
    axes each world lays over its members."""

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
                 params_logical: Any = None,
                 rules: Optional[Rules] = None,
                 device=None,
                 num_hosts: int = 1,
                 elastic: bool = True,
                 min_hosts: int = 1):
        self.num_hosts, self.elastic = num_hosts, elastic
        self.min_hosts = min_hosts
        self.mesh_axes = None
        if num_hosts > 1:
            if mesh is not None and not isinstance(mesh, dict):
                raise ValueError("with num_hosts > 1 give the mesh as axes: "
                                 "each world of the gang lays its own")
            self.mesh_axes = dict(mesh or {"dp": -1})
            mesh = None
        elif mesh is None and (params_logical is not None
                               or rules is not None):
            raise ValueError("params_logical and rules place the params on "
                             "a mesh; give the mesh too")
        if isinstance(mesh, dict):
            mesh = form_gang(mesh, device=device).mesh
        self.mesh = mesh
        self.params_logical = params_logical
        self.rules = rules if rules is not None else DEFAULT_LLM_RULES
        if mesh is None:
            self.device = resolve_device(device)
        elif mesh.device_type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device(mesh.device_type)
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
        self._gang: Optional[MultiHostGang] = None
        # set by an elastic shrink, so the resume attempt right after it
        # runs at the smaller world (replacements wait for the next
        # boundary)
        self._elastic_shrunk = False
        self.attempts: list = []     # the multi-host arm's, one a try

    def train_loop(self, report: Callable, get_checkpoint: Callable) -> None:
        """One attempt: ``report(metrics, checkpoint=payload or None)``
        and ``get_checkpoint() -> an object with to_dict() or None`` are
        the session's."""
        mesh = self.mesh
        init_fn, step_fn = make_train_step(
            self._bound_loss(), self.optimizer, mesh=mesh,
            params_logical=self.params_logical, rules=self.rules)
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
        feed = device_batches(data_iter, self.device, mesh=mesh)
        self.feed_wait_s = []
        t0 = time.perf_counter()
        tokens_done = 0
        for i in range(start, self.num_steps):
            t = time.perf_counter()
            batch = self._next_batch(feed, i + 1)
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
                        ev = self.eval_fn(state.params)
                        if isinstance(ev, DTensor):
                            ev = ev.full_tensor()
                        m["eval"] = float(ev)
                ckpt = None
                if (self.checkpoint_every
                        and (i + 1) % self.checkpoint_every == 0) or is_last:
                    ckpt = state_to_host(state)
                report(m, checkpoint=ckpt)
        self.final_state = state

    def _bound_loss(self) -> Callable:
        """The loss with the mesh and the rules bound, when it takes them
        (``JaxTrainer._train_loop``'s binding)."""
        if self.mesh is None:
            return self.loss_fn
        try:
            takes = "mesh" in inspect.signature(self.loss_fn).parameters
        except (ValueError, TypeError):
            takes = False
        if not takes:
            return self.loss_fn
        return functools.partial(self.loss_fn, mesh=self.mesh,
                                 rules=self.rules)

    def _world(self) -> tuple:
        """(this rank, the world's size): (0, 1) off a mesh."""
        if self.mesh is None:
            return 0, 1
        return dist.get_rank(), dist.get_world_size()

    def _next_batch(self, feed, step: int):
        """The feed's next batch.  On a mesh of more than one rank every
        rank then learns which ranks failed to get theirs (one all-reduce
        of a flag a rank): a host error anywhere is raised on every rank
        as ``HostDataError`` (from the rank's own error where it has
        one), and a feed that ran out ends the run on every rank.  The
        flags are read back, a host sync a step on a world of more than
        one rank (the previous step's work must finish first)."""
        rank, world = self._world()
        try:
            batch, err, done = next(feed), None, False
        except StopIteration:
            batch, err, done = None, None, True
        except Exception as e:        # noqa: BLE001 (agreed on below)
            batch, err, done = None, e, False
        if world == 1:
            if err is not None:
                raise err
            if done:
                raise StopIteration
            return batch
        flags = torch.zeros(2 * world, dtype=torch.int64,
                            device=self.device)
        if err is not None:
            flags[rank] = 1
        if done:
            flags[world + rank] = 1
        dist.all_reduce(flags)
        flags = flags.tolist()
        failed = [r for r in range(world) if flags[r]]
        if failed:
            raise HostDataError(
                f"the host data failed at step {step} on rank(s) {failed}"
                + (f": {err!r}" if err is not None else "")) from err
        if any(flags[world:]):
            raise StopIteration
        return batch

    def fit(self) -> Result:
        if self.num_hosts > 1:
            return self._fit_gang()
        rank, world = self._world()
        os.makedirs(self.storage_path, exist_ok=True)
        manager = CheckpointManager(
            os.path.join(self.storage_path, "checkpoints"),
            num_to_keep=self.num_to_keep, writer=rank == 0,
            barrier=dist.barrier if world > 1 else None)

        def attempt(restore, results):
            st = _session._start(checkpoint_cb=manager.save,
                                 latest_checkpoint=restore,
                                 world_rank=rank, world_size=world)
            try:
                self.train_loop(_session.report, _session.get_checkpoint)
            except StopIteration:    # the data ran out: the run ends
                pass
            finally:
                results.extend(st.results)
                _session._end()

        # on a mesh only a failure every rank agreed on restarts
        return self._restart_loop(
            manager, attempt,
            lambda e: world == 1 or isinstance(e, HostDataError))

    def _restart_loop(self, manager: CheckpointManager,
                      attempt: Callable, restarts: Callable) -> Result:
        """``attempt(restore, results)`` until one ends, each failure that
        ``restarts(error)`` accepts restarting from ``manager``'s latest
        checkpoint, up to ``max_failures`` times; ``results`` collects the
        reports of every attempt."""
        restore = self.resume_from_checkpoint or manager.latest()
        tries, error = 0, None
        results: list = []
        while True:
            try:
                attempt(restore, results)
                error = None
                break
            except Exception as e:   # restart from the last checkpoint
                error = e
                tries += 1
                logger.warning("training attempt %d failed: %s", tries, e)
                if tries > self.max_failures or not restarts(e):
                    break
                manager.flush()
                restore = manager.latest()

        if error is not None and not restarts(error):
            # this rank failed alone: the others wait in a collective it
            # will never join, so it waits at no barrier either
            manager.flush(sync=False)
        else:
            manager.flush()
            res = Result(metrics=results[-1] if results else {},
                         checkpoint=manager.latest(), error=error,
                         path=self.storage_path, metrics_history=results)
        if error is not None:
            raise TrainingFailedError(
                f"training failed after {tries} attempt(s): {error}\n"
                + "".join(traceback.format_exception(error))) from error
        return res

    # -- the multi-host arm --------------------------------------------------

    @property
    def gang(self) -> MultiHostGang:
        """The multi-host arm's gang, formed on first use (again after a
        teardown)."""
        if self._gang is None:
            self._gang = MultiHostGang(self.num_hosts, device=self.device)
        return self._gang

    def _fit_gang(self) -> Result:
        """``fit()`` of the gang's owner: every failed attempt on the gang
        restarts (the owner reads the checkpoints rank 0 writes)."""
        os.makedirs(self.storage_path, exist_ok=True)
        manager = CheckpointManager(
            os.path.join(self.storage_path, "checkpoints"),
            num_to_keep=self.num_to_keep, writer=False)
        self.final_state = None
        return self._restart_loop(manager, self._attempt_gang,
                                  lambda e: True)

    def _elastic_recover(self, gang: MultiHostGang) -> Optional[str]:
        """In-place recovery after a failed attempt: the gang re-formed
        from its surviving members, which the next attempt reuses
        ("shrink" to them; "readmit" toward the target when this boundary
        saw no death; "reform" in place), or None: tear down and form a
        fresh gang."""
        if not self.elastic:
            return None
        try:
            alive = gang.alive_ranks()
        except Exception:
            return None
        if len(alive) < max(1, self.min_hosts):
            return None
        try:
            if len(alive) < gang.num_members:
                kind = "shrink"
                logger.warning("elastic re-gang: %d/%d members survive; "
                               "shrinking and resuming from the latest "
                               "checkpoint", len(alive), gang.num_members)
                gang.reform(alive)
                self._elastic_shrunk = True
            elif gang.num_members < gang.target_members:
                kind = "readmit"
                logger.warning("elastic re-gang: re-admitting %d "
                               "replacement member(s)",
                               gang.target_members - gang.num_members)
                gang.readmit()
            else:
                # every member alive: the failure was the attempt's, so
                # the world is rebuilt in place for the retry
                kind = "reform"
                gang.reform(list(range(gang.num_members)))
        except Exception:
            logger.warning("elastic re-gang failed; falling back to a "
                           "fresh gang", exc_info=True)
            return None
        self._gang = gang
        return kind

    def _attempt_gang(self, restore: Optional[Checkpoint],
                      results: list) -> None:
        """One attempt on every member of the gang: each runs
        ``train_loop`` on a copy of this trainer over the world's mesh
        (``TpuGang`` of ``num_hosts=world``), with a checkpoint manager
        over the run's root (rank 0 writes) and the checkpoint
        ``restore`` names.  Rank 0's reports go to ``results``."""
        gang = self.gang
        if (self.elastic and not self._elastic_shrunk
                and gang.num_members < gang.target_members):
            # a fresh attempt at a re-gang boundary (not the resume right
            # after a shrink): back to the target world
            try:
                gang.readmit()
            except Exception:
                logger.warning("replacement re-admission failed; "
                               "continuing at world=%d", gang.num_members,
                               exc_info=True)
        self._elastic_shrunk = False
        world = gang.num_members
        # what the attempt ran on and saw; "error" and "recovery" (shrink,
        # readmit, reform or fresh) when it failed
        record = {"world": world, "member_ids": gang.member_ids(),
                  "start_step": None, "reports": {}}
        self.attempts.append(record)
        ckpt_dir = os.path.join(self.storage_path, "checkpoints")
        restore_path = restore.path if restore is not None else None

        def member_attempt(rank):
            tr = copy.copy(self)
            tr.mesh = TpuGang(GangConfig(self.mesh_axes, num_hosts=world,
                                         device=self.device.type)).mesh
            tr.device = (torch.device("cuda", torch.cuda.current_device())
                         if self.device.type == "cuda" else self.device)
            mgr = CheckpointManager(ckpt_dir, num_to_keep=self.num_to_keep,
                                    writer=rank == 0, barrier=dist.barrier)
            st = _session._start(
                checkpoint_cb=mgr.save, world_rank=rank, world_size=world,
                latest_checkpoint=(Checkpoint(restore_path)
                                   if restore_path else None))
            st.results = record["reports"].setdefault(
                current_member().member_id, [])
            try:
                tr.train_loop(_session.report, _session.get_checkpoint)
            except StopIteration:    # the data ran out: the run ends
                pass
            finally:
                # the writer's last save lands before the world ends;
                # no barrier: a peer may be dead
                mgr.flush(sync=False)
                _session._end()
                if rank == 0:
                    record["start_step"] = tr.start_step
                    results.extend(st.results)
            return tr.start_step

        try:
            gang.run(member_attempt)
        except Exception as e:
            record["error"] = e
            record["recovery"] = self._elastic_recover(gang)
            if record["recovery"] is None:
                # too few survivors, or re-forming failed: the next
                # attempt forms a fresh gang
                record["recovery"] = "fresh"
                gang.shutdown()
                self._gang = None
            raise
        self._gang = gang
        self.start_step = record["start_step"]
