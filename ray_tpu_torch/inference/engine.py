"""Continuous-batching inference engine over a paged KV cache, with
speculative decoding, and the slot engine beside it.

Port of ``ray_tpu/inference/engine.py``.  One background loop owns the
model state and runs one decode step per iteration over all rows at
once; between steps it admits waiting requests, advances prefills, and
evicts finished requests, so requests join and leave in the middle of
their neighbours' decode.

The default cache is the paged BlockPool (``EngineConfig.paged``):

  * Admission is block-budget accounting: a request is admitted when a
    decode row is free and the pool covers its prompt after the prefix
    hit (LRU-evicting unreferenced cached prefixes under pressure).
  * The radix prefix index lets a prompt whose head is cached adopt
    those blocks by refcount; finished and preempted requests donate
    their clean KV chains back to it.
  * Prefill runs in fixed-width chunks interleaved with decode,
    shortest-remaining-first.  A cold long prompt (``2 * n > max_seq``)
    on a lightly loaded engine takes one full-width prefill instead: the
    model forward, whose attention is the Hopper flash kernel.
  * Decode growth that finds the pool dry evicts cached prefixes, then
    preempts the youngest lowest-priority request (its blocks go to the
    prefix index and it re-queues with its emitted tokens folded into
    its prompt, so its stream continues exactly).
  * Speculative decoding (``EngineConfig.speculate``): a drafter proposes
    up to ``speculate_k`` tokens per greedy row per pass, the host-side
    n-gram prompt lookup ("ngram") or the truncated-layer self-draft
    ("self"), and ONE widened verify step scores every row's window.
    Greedy accept/reject against the verify argmaxes is token-exact.
    Drafted positions are charged to the block budget up front (alloc
    and prefix eviction only: hoped-for tokens never preempt), and the
    rejected tail's charge rolls back after the pass.

``paged=False`` is the slot engine: one ``[max_seq]`` stripe per request
(``cache.KVCacheManager``), admitted by a full-width prefill of the
prompt padded to the cache width (the flash kernel), decoded by
``decode.make_decode_step``.  It has no speculation path.

Sampling shares ``gpt.sample_token`` with the full-recompute oracle, so
greedy decode is token-identical by construction.  A request with
``temperature > 0`` owns a ``torch.Generator`` seeded from its ``seed``.

The engine half of the cluster prefix plane: ``prefix_export`` drains
the record of prompt heads published to the local prefix index,
``prefix_extract`` gathers a cached block-aligned prefix's K/V to the
host, and ``prefix_install`` writes such a payload into fresh local
blocks and publishes them, so the next admission adopts them like a
locally computed prefix.  Extract and install touch the pool and the
index, which belong to the loop thread, so they run there as queued ops
between passes (``_run_op``).

With a ``mesh`` the engine serves tensor parallel: its params and pool
(or the slot engine's cache) are split over the tp ranks of an executor
(``inference/tp.py``), every step body, full-width prefill and cache
update runs on each rank, and the loop thread samples from rank 0's
gathered logits with the engine's one generator, so the ranks stay in
lockstep.  The scheduler, tables, refcounts, prefix index and the slot
free list stay here.
A step failure on the ranks fails the in-flight requests and resets
every rank's pool, and the engine serves on; ranks that died leave it
stopped (failed closed).

The fault plane's hooks (``_chaos``: ``infer_admit``,
``infer_block_alloc``, ``infer_speculate``, and on a mesh
``infer_shard_commit`` after each decode step's commit) and the flight
recorder's (``_fr_note``: one ``engine_request`` event per finished
request, with the serving geometry on a mesh) read the port's gates in
``ray_tpu_torch.core``; unarmed, each costs one global load.
"""

from __future__ import annotations

import itertools
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.core import fault_injection as _fi
from ray_tpu_torch.core import flight_recorder as _fr
from ray_tpu_torch.inference import tp as _tp
from ray_tpu_torch.inference.cache import (BlockPool, KVCacheManager,
                                           RadixIndex)
from ray_tpu_torch.inference.decode import (MoEDecodeUnsupported,
                                            SpeculationUnsupported,
                                            make_chunk_prefill_fn,
                                            make_decode_step,
                                            make_paged_decode_step,
                                            make_paged_draft_step,
                                            make_prefill_fn,
                                            make_spec_verify_step,
                                            ngram_propose)
from ray_tpu_torch.models import gpt
from ray_tpu_torch.models.gpt import GPTConfig
from ray_tpu_torch.parallel.sharding import DEFAULT_LLM_RULES, Rules
from ray_tpu_torch.serve.qos import (PRIORITY_BATCH,  # noqa: F401
                                     PRIORITY_INTERACTIVE,
                                     EngineDrainingError,
                                     PrefixInstallPressure,
                                     PrefixUnavailable, ReplicaDeadError,
                                     StalePrefixGeneration, parse_priority)


@dataclass
class EngineConfig:
    """Engine knobs.  ``max_slots`` is the decode-batch width (the
    concurrency cap); memory is ``n_blocks`` x ``kv_block_size`` tokens
    when paged, or ``max_slots`` x ``max_seq`` tokens in slot mode."""
    max_slots: int = 8
    max_seq: Optional[int] = None        # cache width; None = model max_seq
    eos_token: Optional[int] = None      # None = never stop early
    default_max_new: int = 64
    max_waiting: int = 1024              # admission-queue bound (backpressure)
    idle_wait_s: float = 0.05            # loop park interval when empty
    # ---- paged cache (False = the slot engine)
    paged: bool = True
    kv_block_size: int = 16              # tokens per block
    n_blocks: Optional[int] = None       # usable blocks; None = max_slots
    #                                      * ceil(max_seq/block)
    prefill_chunk: int = 32              # chunked-prefill window width
    prefix_cache: bool = True            # radix prefix reuse on/off
    # ---- speculative decoding (paged engine only): None = off, "ngram"
    # = prompt lookup in the request's own prompt and history, "self" =
    # the first ``draft_layers`` layers straight into the head.  Greedy
    # requests emit the exact non-speculative stream; temperature > 0
    # requests decode one token a step.
    speculate: Optional[str] = None      # None | "ngram" | "self"
    speculate_k: int = 4                 # drafted tokens per verify pass
    draft_layers: int = 1                # self-drafter depth ("self" mode)


class EngineStoppedError(ReplicaDeadError):
    """The engine was shut down with this request queued or mid-decode."""


class GenerationRequest:
    """One in-flight generation: a mailbox the engine appends tokens to
    and consumers drain via ``stream()`` / ``result()``."""

    def __init__(self, req_id: int, prompt: np.ndarray, max_new: int,
                 temperature: float,
                 generator: Optional[torch.Generator],
                 priority: int = PRIORITY_BATCH):
        self.id = req_id
        self.prompt = prompt
        self.max_new = max_new
        self.temperature = temperature
        self.priority = priority
        self.generator = generator
        # emitted tokens already folded into ``prompt`` by a preemption
        self._consumed = 0
        self.tokens: list[int] = []
        self.done = False
        self.cancelled = False
        self.error: Optional[BaseException] = None
        self._cond = threading.Condition()
        self.created_s = time.perf_counter()
        self.created_wall = time.time()
        self.first_token_s: Optional[float] = None
        self.finished_s: Optional[float] = None
        # per-token arrival stamps (perf_counter): consecutive differences
        # are the request's inter-token latencies
        self.token_times: list[float] = []
        # speculation accounting of this stream
        self.spec_drafted = 0
        self.spec_accepted = 0

    # ---- engine side -----------------------------------------------------

    def _emit(self, token: int) -> None:
        with self._cond:
            now = time.perf_counter()
            if self.first_token_s is None:
                self.first_token_s = now
            self.token_times.append(now)
            self.tokens.append(int(token))
            self._cond.notify_all()

    def _finish(self, error: Optional[BaseException] = None) -> None:
        with self._cond:
            self.error = error
            self.done = True
            self.finished_s = time.perf_counter()
            self._cond.notify_all()

    # ---- consumer side ---------------------------------------------------

    def cancel(self) -> None:
        """Abandon the request: the engine drops it from the waiting
        queue, or evicts it at the next decode iteration.  Idempotent."""
        with self._cond:
            self.cancelled = True
            self._cond.notify_all()

    def stream(self, timeout: Optional[float] = None) -> Iterator[int]:
        """Yield generated tokens as they arrive; returns at completion,
        raises the engine-side error if the request failed."""
        i = 0
        deadline = (time.perf_counter() + timeout
                    if timeout is not None else None)
        while True:
            with self._cond:
                while len(self.tokens) <= i and not self.done:
                    remain = 0.5
                    if deadline is not None:
                        remain = min(remain, deadline - time.perf_counter())
                        if remain <= 0:
                            raise TimeoutError(
                                f"request {self.id}: no token within "
                                f"{timeout}s")
                    self._cond.wait(timeout=remain)
                if len(self.tokens) > i:
                    tok = self.tokens[i]
                else:                      # done, mailbox drained
                    if self.error is not None:
                        raise self.error
                    return
            yield tok
            i += 1

    def result(self, timeout: Optional[float] = None) -> list[int]:
        """Block until completion; returns the generated tokens."""
        deadline = (time.perf_counter() + timeout
                    if timeout is not None else None)
        with self._cond:
            while not self.done:
                remain = 0.5
                if deadline is not None:
                    remain = min(remain, deadline - time.perf_counter())
                    if remain <= 0:
                        raise TimeoutError(
                            f"request {self.id} not done within {timeout}s")
                self._cond.wait(timeout=remain)
            if self.error is not None:
                raise self.error
            return list(self.tokens)


# engines by name, for metrics_snapshot (weak: an engine that is dropped
# leaves the registry with it)
_ENGINES: "weakref.WeakValueDictionary[str, InferenceEngine]" = \
    weakref.WeakValueDictionary()
_engine_seq = itertools.count()
_registry_lock = threading.Lock()


def _engine_loop(ref: "weakref.ref[InferenceEngine]") -> None:
    """The loop thread's body.  It holds the engine strongly only during a
    pass, so an engine dropped without shutdown() is still collected."""
    while True:
        eng = ref()
        if eng is None:
            return
        try:
            alive = eng._loop_pass()
        except BaseException:
            eng._drain_pending()
            raise
        if not alive:
            eng._drain_pending()
            return
        del eng


class InferenceEngine:
    """Continuous-batching engine over one parameter set.

    >>> eng = InferenceEngine(params, cfg, EngineConfig(max_slots=8))
    >>> req = eng.submit([1, 2, 3], max_new=16)
    >>> for tok in req.stream(): ...
    """

    def __init__(self, params, cfg: GPTConfig,
                 engine_cfg: Optional[EngineConfig] = None, *,
                 device=None, name: Optional[str] = None,
                 labels: Optional[dict] = None, mesh=None,
                 rules: Rules = DEFAULT_LLM_RULES):
        self.cfg = cfg
        # extra label pairs on this engine's metrics_snapshot series
        self.labels = dict(labels) if labels else {}
        self.engine_cfg = engine_cfg or EngineConfig()
        ec = self.engine_cfg
        n = ec.max_slots
        self._paged = bool(ec.paged)
        self._spec = ec.speculate
        if self._spec is not None:
            # the capability boundary, at construction: the slot engine
            # has no speculation path
            if self._spec not in ("ngram", "self"):
                raise ValueError(
                    f"speculate must be None, 'ngram' or 'self', got "
                    f"{self._spec!r}")
            if not self._paged:
                raise SpeculationUnsupported(
                    "speculative decoding needs the paged engine "
                    "(EngineConfig.paged=True); the slot engine is the "
                    "non-speculative baseline")
            if ec.speculate_k < 1:
                raise ValueError(
                    f"speculate_k must be >= 1, got {ec.speculate_k}")
        with _registry_lock:
            self.name = name or f"engine-{next(_engine_seq)}"
        self.device = (_tp.mesh_device(mesh, device) if mesh is not None
                       else resolve_device(device))
        self.params = _to_device(params, self.device)
        # the full-width prefill: the slot engine's admission, and the
        # paged engine's cold long prompt on a lightly loaded engine
        self._prefill = make_prefill_fn(cfg)
        self._ranks = None                   # the tp ranks (mesh only)
        if mesh is not None:
            self._ranks = self._open_ranks(mesh, rules)
            self.params = self._prefill = None
        if self._paged:
            bs = ec.kv_block_size
            per_seq = -(-int(ec.max_seq or cfg.max_seq) // bs)
            n_blocks = ec.n_blocks if ec.n_blocks is not None else n * per_seq
            try:
                self.pool = BlockPool(cfg, n_blocks, bs, max_seq=ec.max_seq,
                                      device=self.device, mesh=self._ranks)
            except BaseException:
                if self._ranks is not None:
                    self._ranks.close()
                raise
            self.cache = None
            self.max_seq = self.pool.max_seq
            self.trie = RadixIndex(self.pool) if ec.prefix_cache else None
            T = self.pool.blocks_per_seq
            if self._ranks is not None:
                self._step = self._ranks.body("step")
                self._chunk = self._ranks.body("chunk")
                if self._spec is not None:
                    self._verify = self._ranks.body("verify")
                    self._draft = (self._ranks.body("draft")
                                   if self._spec == "self" else None)
            else:
                self._step = make_paged_decode_step(cfg, block_size=bs,
                                                    n_table=T)
                self._chunk = make_chunk_prefill_fn(
                    cfg, chunk=ec.prefill_chunk, block_size=bs, n_table=T)
                if self._spec is not None:
                    self._verify = make_spec_verify_step(
                        cfg, width=ec.speculate_k + 1, block_size=bs,
                        n_table=T)
                    # raises SpeculationUnsupported on a bad draft_layers
                    self._draft = (make_paged_draft_step(
                        cfg, draft_layers=ec.draft_layers,
                        k=ec.speculate_k, block_size=bs, n_table=T)
                        if self._spec == "self" else None)
            self._tables = np.zeros((n, T), np.int64)
            self._row_blocks: dict[int, list[int]] = {}
            self._free_rows = list(range(n - 1, -1, -1))
            self._prefilling: dict[int, int] = {}   # row -> next prefill pos
        else:
            self.pool = None
            self.trie = None
            try:
                self.cache = KVCacheManager(cfg, n, max_seq=ec.max_seq,
                                            device=self.device,
                                            mesh=self._ranks)
            except BaseException:
                if self._ranks is not None:
                    self._ranks.close()
                raise
            self.max_seq = self.cache.max_seq
            self._step = (self._ranks.body("step") if self._ranks is not None
                          else make_decode_step(cfg))

        self._slot_req: dict[int, GenerationRequest] = {}
        self._tokens = np.zeros(n, np.int64)      # current input token
        self._positions = np.zeros(n, np.int64)   # where it will be written
        self._active = np.zeros(n, bool)
        self._waiting: list[GenerationRequest] = []
        self._req_seq = itertools.count()
        self._cond = threading.Condition()
        self._stopped = False
        self._draining = False
        # ops other threads queue for the loop thread, which alone
        # touches the pool and the prefix index: (fn, result box) pairs
        # run between passes (_run_op, _run_ops_locked)
        self._ops: list = []
        # prefixes published to the local index since the last
        # prefix_export() (bounded; the oldest is dropped first)
        self._prefix_outbox: list = []

        self._mlock = threading.Lock()
        self._generated_tokens = 0
        self._requests_completed = 0
        self._decode_iterations = 0
        self._occupancy_sum = 0.0      # sum of active/max_slots per iteration
        self._prefix_hit_tokens = 0
        self._prefix_lookup_tokens = 0
        self._preemptions = 0
        self._peak_active = 0
        self._full_prefills = 0        # full-width prefills (flash kernel)
        self._chunk_prefills = 0       # chunk-prefill calls
        self._spec_drafted = 0         # drafted tokens offered to verify
        self._spec_accepted = 0        # drafted tokens accepted
        self._spec_passes = 0          # verify passes run
        # per-row step accounting: tokens_per_step = row_tokens /
        # row_steps is exactly 1.0 for plain decode and 1 + accepted per
        # row pass under speculation, whatever the batch width
        self._row_steps = 0            # (row, step call) pairs
        self._row_tokens = 0           # tokens those pairs emitted

        with _registry_lock:
            _ENGINES[self.name] = self
        self._thread = threading.Thread(
            target=_engine_loop, args=(weakref.ref(self),), daemon=True,
            name=f"ray_tpu_torch-inference-{self.name}")
        self._thread.start()

    def _open_ranks(self, mesh, rules: Rules) -> "_tp.EngineRanks":
        """Open this engine on the tp ranks of ``mesh``: every rank cuts
        its shards of the params and builds its step bodies for the
        engine's geometry (the slot engine's: its slots and cache width);
        the cache's tensors are then the ranks' alone."""
        ec, cfg = self.engine_cfg, self.cfg
        if not self._paged and cfg.n_experts:   # before any rank starts
            raise MoEDecodeUnsupported(cfg)
        ex = _tp.executor_for(mesh, device=self.device)
        if not self._paged:
            return ex.open(self.name, cfg, self.params, rules, {
                "slots": ec.max_slots,
                "max_seq": int(ec.max_seq or cfg.max_seq)})
        return ex.open(
            self.name, cfg, self.params, rules, {
                "block_size": ec.kv_block_size,
                "n_table": -(-int(ec.max_seq or cfg.max_seq)
                             // ec.kv_block_size),
                "chunk": ec.prefill_chunk,
                "width": (ec.speculate_k + 1 if self._spec is not None
                          else None),
                "draft_layers": (ec.draft_layers if self._spec == "self"
                                 else None)})

    # ------------------------------------------------------------ submit

    def submit(self, prompt: Sequence[int], *,
               max_new: Optional[int] = None,
               temperature: float = 0.0,
               seed: int = 0,
               priority: int = PRIORITY_BATCH) -> GenerationRequest:
        """Queue a generation; returns the request mailbox at once.
        Admission happens at the next prefill boundary, in (priority,
        arrival) order.  On a speculating engine a greedy request rides
        draft-then-verify and emits the exact non-speculative stream; a
        ``temperature > 0`` request is accepted and decodes one token a
        step, never drafted."""
        ec = self.engine_cfg
        prompt = np.asarray(list(prompt), np.int64)
        max_new = int(max_new if max_new is not None else ec.default_max_new)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token list")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            raise ValueError(
                f"prompt tokens out of range [0, {self.cfg.vocab_size})")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        total = int(prompt.size) + max_new
        if total > self.max_seq:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new ({max_new}) = {total} "
                f"exceeds the cache width {self.max_seq}")
        gen = (torch.Generator(device=self.device).manual_seed(int(seed))
               if temperature > 0.0 else None)
        req = GenerationRequest(next(self._req_seq), prompt, max_new,
                                float(temperature), gen,
                                priority=int(priority))
        with self._cond:
            if self._stopped:
                raise EngineStoppedError("engine is shut down")
            if self._draining:
                raise EngineDrainingError(
                    "engine is draining (planned scale-down)")
            if len(self._waiting) >= ec.max_waiting:
                raise RuntimeError(
                    f"engine admission queue full ({ec.max_waiting})")
            self._waiting.append(req)
            self._cond.notify_all()
        return req

    def generate(self, prompt: Sequence[int], *,
                 max_new: Optional[int] = None, temperature: float = 0.0,
                 seed: int = 0, timeout: Optional[float] = None) -> list[int]:
        """Synchronous convenience wrapper around submit()+result()."""
        return self.submit(prompt, max_new=max_new, temperature=temperature,
                           seed=seed).result(timeout=timeout)

    # ------------------------------------------------------------- loop

    def _loop_pass(self) -> bool:
        """One scheduler pass (reap, admit, prefill, decode); False when
        stopped."""
        with self._cond:
            while (not self._stopped and not self._ops
                   and not self._active.any()
                   and not (self._paged and self._prefilling)
                   and not (self._waiting and self._admission_possible())):
                self._cond.wait(self.engine_cfg.idle_wait_s)
            if self._stopped:
                return False
            if self._ops:
                self._run_ops_locked()
            # reap cancelled waiters even when the pool is full
            live = []
            for r in self._waiting:
                if r.cancelled:
                    r._finish()
                else:
                    live.append(r)
            self._waiting = live
            admits = []
            if self._paged:
                self._paged_admit_locked()
            else:
                # freed slots go to the most urgent class first (stable
                # within a class: the sort key is (priority, submit id))
                self._waiting.sort(key=lambda r: (r.priority, r.id))
                while self._waiting and self.cache.n_free > 0:
                    req = self._waiting.pop(0)
                    admits.append((self.cache.alloc(), req))
        for i, (slot, req) in enumerate(admits):
            # per-admit isolation: a failed prefill fails ONE request and
            # returns its slot, unless the tp ranks died under it: then
            # the engine stops (fails closed)
            try:
                self._admit(slot, req)
            except Exception as e:
                self.cache.free(slot)
                req._finish(e)
                if self._ranks is not None and not self._ranks.alive:
                    for s, r in admits[i + 1:]:
                        self.cache.free(s)
                        r._finish(e)
                    return self._fail_all(e)
        try:
            if self._paged:
                if self._prefilling:
                    self._prefill_chunk_pass()
                if self._active.any():
                    self._paged_decode_iteration()
            elif self._active.any():
                self._decode_iteration()
        except Exception as e:                # step failure: fail the
            # in-flight requests and keep serving, unless the tp ranks
            # died: then the engine stops (fails closed)
            return self._fail_all(e)
        return True

    def _admission_possible(self) -> bool:
        if not self._paged:
            return self.cache.n_free > 0
        return bool(self._free_rows) and (
            self.pool.n_free > 0
            or (self.trie is not None and self.trie.cached_blocks > 0))

    def _drain_pending(self) -> None:
        """Terminal cleanup: fail everything still queued or in flight."""
        with self._cond:
            self._stopped = True
            pending = list(self._slot_req.values()) + self._waiting
            self._slot_req.clear()
            self._waiting.clear()
            ops, self._ops = self._ops, []
            for _fn, box in ops:
                # a queued op on a dying engine resolves as a dead replica
                box["error"] = EngineStoppedError("engine shut down")
                box["done"] = True
            self._cond.notify_all()
        err = EngineStoppedError("engine shut down")
        for r in pending:
            if not r.done:
                r._finish(err)

    def _admit(self, slot: int, req: GenerationRequest) -> None:
        """Slot admission: the prompt, padded to the cache width, runs one
        full-width prefill (the flash kernel) that seeds the slot's
        stripe; its last position samples the first token."""
        if req.cancelled:                 # abandoned while queued
            self.cache.free(slot)
            req._finish()
            return
        n = int(req.prompt.size)
        padded = torch.zeros((1, self.cache.max_seq), dtype=torch.long,
                             device=self.device)
        padded[0, :n] = torch.from_numpy(req.prompt)
        if self._ranks is not None:
            # every rank writes its heads of the K/V into the slot
            last = self._ranks.run("prefill", slot, padded, n)
        else:
            logits, k_new, v_new = self._prefill(self.params, padded)
            self.cache.write_prefill(slot, k_new[:, 0], v_new[:, 0])
            last = logits[0, n - 1]
        with self._mlock:
            self._full_prefills += 1
        tok = int(gpt.sample_token(last, temperature=req.temperature,
                                   generator=req.generator))
        req._emit(tok)
        if self._request_finished(req, tok):
            self.cache.free(slot)
            req._finish()
            self._note_done(req)
            return
        self._slot_req[slot] = req
        self._tokens[slot] = tok
        self._positions[slot] = n
        self._active[slot] = True
        with self._mlock:
            self._peak_active = max(self._peak_active, self.cache.n_active)

    # ----------------------------------------------------------- paged path

    def _chaos(self, point: str, **ctx) -> Optional[dict]:
        """Fault-plane hook (``infer_admit``, ``infer_block_alloc``,
        ``infer_speculate``): one global load when no plan is installed.
        Returns the ctx dict when a plan ran; the plan may have set a
        verdict in it (``ctx["reject_all"] = True``)."""
        fi = _fi._active
        if fi is None:
            return None
        ctx["engine"] = self.name
        fi.on_infer(point, ctx)
        return ctx

    @property
    def _heads_shards(self) -> int:
        """The shards the cache's heads dim is split into (tp on a mesh,
        the paged pool's or the slot cache's alike)."""
        return (self.pool if self._paged else self.cache).heads_shards

    def _fr_note(self, req: GenerationRequest) -> None:
        """Flight-recorder copy of a finished request (armed only): an
        ``engine_request`` event, one engine slice per request on the
        timeline, with its speculation counts."""
        rec = _fr._active
        if rec is None:
            return
        rec.note_ingress({
            "t": time.time(), "kind": "engine_request",
            "engine": self.name, "req": req.id,
            "start_t": req.created_wall,
            "tokens": len(req.tokens),
            "spec_accepted": req.spec_accepted,
            "spec_rejected": req.spec_drafted - req.spec_accepted,
            # the serving geometry: which mesh served the request
            **({"mesh_devices": self._ranks.executor.mesh_devices,
                "tp_shards": self._heads_shards}
               if self._ranks is not None else {}),
        })

    def _paged_admit_locked(self) -> None:
        """Block-budget admission (under ``_cond``): admit while a row is
        free and the pool covers the prompt after the prefix hit.  Head
        of line within (priority, arrival) order: a large request that
        does not fit yet is not overtaken."""
        if not (self._waiting and self._free_rows):
            return
        self._waiting.sort(key=lambda r: (r.priority, r.id))
        while self._waiting and self._free_rows:
            req = self._waiting[0]
            try:
                if not self._try_admit_paged(req):
                    break
            except Exception as e:
                self._waiting.pop(0)
                req._finish(e)
                continue
            self._waiting.pop(0)

    def _try_admit_paged(self, req: GenerationRequest) -> bool:
        bs = self.pool.block_size
        prompt = req.prompt
        n_prompt = int(prompt.size)
        p_blocks = -(-n_prompt // bs)
        ids, hit = (self.trie.match(prompt) if self.trie is not None
                    else ([], 0))
        need = p_blocks - len(ids)
        if self.pool.n_free < need and self.trie is not None:
            # pressure: evict unreferenced cached prefixes, LRU-first
            # (the just-matched chain is protected by its new refcount)
            self.trie.evict(need - self.pool.n_free)
        if self.pool.n_free < need:
            for bid in ids:
                self.pool.decref(bid)
            return False
        try:
            self._chaos("infer_admit", req=req.id, need=need,
                        hit_tokens=hit)
        except BaseException:
            for bid in ids:
                self.pool.decref(bid)
            raise
        row = self._free_rows.pop()
        blocks = list(ids)
        for _ in range(need):
            blocks.append(self.pool.alloc())
        self._tables[row, :] = 0
        self._tables[row, :len(blocks)] = blocks
        self._row_blocks[row] = blocks
        self._slot_req[row] = req
        self._prefilling[row] = hit          # prefill resumes past the hit
        occupied = self.engine_cfg.max_slots - len(self._free_rows)
        with self._mlock:
            self._prefix_hit_tokens += hit
            self._prefix_lookup_tokens += n_prompt
            self._peak_active = max(self._peak_active, occupied)
        return True

    def _take_block(self, row: int) -> Optional[int]:
        """A fresh block for ``row``: free list, else LRU prefix
        eviction, else preempt the youngest lowest-priority occupied row
        (``row`` itself last).  None = ``row`` was the victim."""
        while True:
            self._chaos("infer_block_alloc", row=row)
            bid = self.pool.alloc()
            if bid is not None:
                return bid
            if self.trie is not None and self.trie.evict(1):
                continue
            victim = self._pick_victim()
            if victim is None:
                return None
            self._preempt_row(victim)
            if victim == row:
                return None

    def _pick_victim(self) -> Optional[int]:
        occupied = list(self._slot_req)
        if not occupied:
            return None
        return max(occupied,
                   key=lambda r: (self._slot_req[r].priority,
                                  self._slot_req[r].id))

    def _sequence(self, req: GenerationRequest) -> np.ndarray:
        """The request's prompt plus the tokens emitted since it was last
        (re)admitted."""
        return np.concatenate(
            [req.prompt, np.asarray(req.tokens[req._consumed:], np.int64)])

    def _valid_len(self, row: int) -> int:
        return (int(self._positions[row]) if self._active[row]
                else self._prefilling.get(row, 0))

    def _preempt_row(self, row: int) -> None:
        """Block-pressure preemption: donate the row's clean KV chain to
        the prefix index, release the blocks, and requeue the request
        with its emitted tokens folded into the prompt."""
        req = self._slot_req[row]
        seq = self._sequence(req)
        self._insert_prefix(row, seq[:self._valid_len(row)])
        self._release_row(row)
        req.prompt = seq
        req._consumed = len(req.tokens)
        with self._mlock:
            self._preemptions += 1
        with self._cond:
            stopped = self._stopped
            if not stopped:
                self._waiting.append(req)
            self._cond.notify_all()
        if stopped:       # raced with shutdown: never leave it hanging
            req._finish(EngineStoppedError("engine shut down"))

    def _insert_prefix(self, row: int, seq: np.ndarray) -> None:
        if self.trie is None or len(seq) == 0:
            return
        self.trie.insert(seq, self._row_blocks[row])

    def _release_row(self, row: int) -> None:
        """Drop the row's references (blocks survive only if the prefix
        index kept them) and return the row to the free list."""
        self._slot_req.pop(row, None)
        self._active[row] = False
        self._prefilling.pop(row, None)
        for bid in self._row_blocks.pop(row, []):
            self.pool.decref(bid)
        self._tables[row, :] = 0
        with self._cond:
            self._free_rows.append(row)
            self._cond.notify_all()

    def _cow_block(self, row: int, bidx: int) -> bool:
        """Copy-on-write: make table entry ``bidx`` exclusively owned
        before a write touches it.  False = ``row`` was preempted while
        hunting for the copy's block."""
        bid = self._row_blocks[row][bidx]
        if self.pool.refcount(bid) == 1:
            return True
        nb = self._take_block(row)
        if nb is None:
            return False
        self.pool.copy_block(bid, nb)
        self.pool.decref(bid)
        self._row_blocks[row][bidx] = nb
        self._tables[row, bidx] = nb
        return True

    def _prefill_chunk_pass(self) -> None:
        """Advance prefills.  At healthy decode occupancy (>= half the
        rows active) one chunk per pass bounds the active streams'
        stall; below it, run as many chunks as there are prefilling rows
        before the next decode iteration."""
        n = self.engine_cfg.max_slots
        if 2 * int(self._active.sum()) >= n:
            self._prefill_one_chunk()
            return
        for _ in range(len(self._prefilling)):
            if (not self._prefilling
                    or 2 * int(self._active.sum()) >= n):
                break
            self._prefill_one_chunk()

    def _prefill_one_chunk(self) -> None:
        """Advance ONE prefilling request, shortest-remaining-first (ties
        by arrival), so cold duplicates of one head serialize and the
        rest adopt the published chain.  On prompt completion the last
        row's logits sample the first token and the row turns active."""
        row = min(self._prefilling,
                  key=lambda r: (int(self._slot_req[r].prompt.size)
                                 - self._prefilling[r],
                                 self._slot_req[r].id))
        req = self._slot_req[row]
        if req.cancelled:                  # abandoned mid-prefill
            self._release_row(row)
            req._finish()
            self._note_done(req)
            return
        pos = self._prefilling[row]
        bs = self.pool.block_size
        C = self.engine_cfg.prefill_chunk
        prompt = req.prompt
        n = int(prompt.size)
        if self.trie is not None:
            # re-match every advance: a sibling may have published the
            # shared head since this row was admitted
            ids2, hit2 = self.trie.match(prompt)
            if hit2 > pos:
                blocks = self._row_blocks[row]
                for i, nb in enumerate(ids2):
                    self.pool.decref(blocks[i])
                    blocks[i] = nb
                    self._tables[row, i] = nb
                with self._mlock:
                    self._prefix_hit_tokens += hit2 - pos
                pos = self._prefilling[row] = hit2
            else:
                for bid in ids2:
                    self.pool.decref(bid)
        if (pos == 0 and 2 * n > self.max_seq
                and 2 * int(self._active.sum())
                < self.engine_cfg.max_slots):
            # cold LONG prompt at low decode occupancy: ONE full-width
            # forward seeds every block through the table scatter (pos ==
            # 0 also means no adopted blocks: the table is exclusive)
            padded = torch.zeros((1, self.max_seq), dtype=torch.long,
                                 device=self.device)
            padded[0, :n] = torch.from_numpy(prompt)
            last = self._full_prefill(self._tables[row], padded, n)
            with self._mlock:
                self._full_prefills += 1
            self._finish_prefill(row, req, last)
            return
        # the write window [pos, pos+C) must only touch exclusively owned
        # blocks; only the first can be shared (an adopted partial tail)
        first = pos // bs
        last = min(-(-(pos + C) // bs), len(self._row_blocks[row]))
        for bidx in range(first, last):
            if not self._cow_block(row, bidx):
                return                     # row preempted under pressure
        n_q = min(C, n - pos)
        chunk_toks = np.zeros(C, np.int64)
        chunk_toks[:n_q] = prompt[pos:pos + n_q]
        logits = self._chunk(
            self.params, self.pool.k, self.pool.v,
            torch.from_numpy(self._tables[row]).to(self.device),
            torch.from_numpy(chunk_toks).to(self.device), pos)
        with self._mlock:
            self._chunk_prefills += 1
        new_pos = pos + n_q
        if new_pos < n:
            self._prefilling[row] = new_pos
            return
        self._finish_prefill(row, req, logits[n_q - 1])

    def _full_prefill(self, table: np.ndarray, padded, n: int):
        """One full-width prefill of ``padded`` [1, max_seq] seeding the
        blocks of ``table``; returns the last prompt position's logits
        [V].  On a mesh every rank writes its heads of the K/V, which
        never leave the ranks."""
        if self._ranks is not None:
            return self._ranks.run("prefill", table, padded, n)
        logits, k_new, v_new = self._prefill(self.params, padded)
        self.pool.write_prefill(table, k_new[:, 0], v_new[:, 0])
        return logits[0, n - 1]

    def _finish_prefill(self, row: int, req: GenerationRequest,
                        last_logits) -> None:
        """Prompt fully cached: publish its full blocks, sample the first
        token; the row turns active (or evicts on EOS / max_new == 1)."""
        del self._prefilling[row]
        if self.trie is not None:
            # full blocks only: decode writes the partial tail
            full = (int(req.prompt.size) // self.pool.block_size) \
                * self.pool.block_size
            if full > 0:
                self._insert_prefix(row, req.prompt[:full])
                self._note_prefix_published(
                    req.prompt[:full],
                    self._row_blocks[row][:full // self.pool.block_size])
        tok = int(gpt.sample_token(last_logits,
                                   temperature=req.temperature,
                                   generator=req.generator))
        req._emit(tok)
        if self._request_finished(req, tok):
            self._paged_evict(row)
            return
        self._tokens[row] = tok
        self._positions[row] = int(req.prompt.size)
        self._active[row] = True

    def _grow_row(self, row: int) -> bool:
        """Pre-step: make the row's write-target block exist and be
        exclusively owned.  False = ``row`` was preempted."""
        pos = int(self._positions[row])
        bidx = pos // self.pool.block_size
        blocks = self._row_blocks[row]
        if bidx < len(blocks):
            return self._cow_block(row, bidx)
        nb = self._take_block(row)
        if nb is None:
            return False
        blocks.append(nb)
        self._tables[row, bidx] = nb
        return True

    # ------------------------------------------------- speculative decode

    def _spec_cover(self, row: int, upto: int) -> int:
        """Charge the block budget for speculative positions up front:
        grow the row's chain to cover positions through ``upto`` (the
        write block at ``positions[row]`` exists and is exclusive:
        ``_grow_row`` ran).  Allocation and prefix eviction only:
        speculation never preempts a neighbour for tokens that are only
        hoped for.  Granted blocks join ``_row_blocks[row]`` at once, so a
        later preemption of the row refunds them with the rest of the
        chain.  Returns the last position actually covered."""
        bs = self.pool.block_size
        pos = int(self._positions[row])
        blocks = self._row_blocks[row]
        for bidx in range(pos // bs + 1, upto // bs + 1):
            if bidx < len(blocks):
                continue
            bid = self.pool.alloc()
            if bid is None and self.trie is not None \
                    and self.trie.evict(1):
                bid = self.pool.alloc()
            if bid is None:
                return bidx * bs - 1      # covered through the prior block
            blocks.append(bid)
            self._tables[row, bidx] = bid
        return upto

    def _spec_rollback(self, row: int) -> None:
        """Refund the rejected part of the speculative charge: drop the
        chain's blocks past the row's next write position (that block is
        kept; freeing it would thrash against ``_grow_row``).  Rejected
        lanes' K/V past the committed length is masked and overwritten
        later, so rollback is budget accounting only."""
        keep = int(self._positions[row]) // self.pool.block_size + 1
        blocks = self._row_blocks[row]
        old = len(blocks)
        if self.pool.release_tail(blocks, keep):
            self._tables[row, len(blocks):old] = 0

    def _spec_propose(self) -> tuple:
        """This pass's drafts: ``(drafts [n, k] int64, want [n] int64)``,
        row r offering ``want[r]`` tokens (0 = a plain one-token lane).
        Sampled rows and rows at their max_new boundary never draft; the
        block charge (``_spec_cover``) caps a draft the pool cannot
        hold."""
        ec = self.engine_cfg
        n, k = ec.max_slots, ec.speculate_k
        drafts = np.zeros((n, k), np.int64)
        want = np.zeros(n, np.int64)
        props = {}
        active_rows = 0
        for row in list(self._slot_req):
            if not self._active[row]:
                continue
            active_rows += 1
            req = self._slot_req[row]
            if req.temperature != 0.0:
                continue                  # one token a step (submit())
            w = min(k, req.max_new - len(req.tokens) - 1)
            if w <= 0:
                continue
            if self._spec == "ngram":
                prop = ngram_propose(self._sequence(req), w)
                if prop.size == 0:
                    continue
                props[row] = prop
                w = min(w, int(prop.size))
            want[row] = w
        # batch-coverage gate: the widened verify prices every active row
        # at W lanes, so speculate only when at least half the batch
        # drafts.  Decided before blocks are charged or drafts run, so a
        # skipped pass pays nothing.
        if int((want > 0).sum()) * 2 < active_rows:
            want[:] = 0
            return drafts, want
        for row in np.nonzero(want)[0]:
            pos = int(self._positions[row])
            w = min(int(want[row]),
                    self._spec_cover(row, pos + int(want[row])) - pos)
            if w <= 0:                    # the pool cannot hold a draft
                want[row] = 0
                continue
            want[row] = w
            if self._spec == "ngram":
                drafts[row, :w] = props[row][:w]
        if self._spec == "self" and want.any():
            self._spec_self_draft(drafts, want)
        return drafts, want

    def _spec_self_draft(self, drafts: np.ndarray, want: np.ndarray) -> None:
        """Fill ``drafts`` from ONE draft-burst call: the k-step
        truncated-layer loop runs without a host round trip per token.
        Its K/V for layers < draft_layers lands in the real pool, equal to
        what the full model writes there; the verify pass rewrites every
        drafted position at all layers anyway."""
        dev = self.device
        w = np.where(self._active, want, 0)
        toks = self._draft(
            self.params, self.pool.k, self.pool.v,
            torch.from_numpy(self._tables).to(dev),
            torch.from_numpy(self._tokens).to(dev),
            torch.from_numpy(self._positions).to(dev),
            torch.from_numpy(w).to(dev)).cpu().numpy()
        m = np.arange(toks.shape[1])[None, :] < w[:, None]
        drafts[m] = toks[m]

    def _speculative_iteration(self) -> bool:
        """One draft-then-verify pass over the whole batch; False = no
        drafts this pass (the caller runs the plain step).  Greedy accept:
        lane j's logits are the next-token logits given the drafted
        prefix, so walking lanes while argmax == draft, and emitting the
        argmax at the first mismatch, reproduces the non-speculative
        greedy stream exactly (>= 1 token a row).  Committed lanes' K/V is
        already in the pool from the verify scatter; the rejected tail's
        block charge is rolled back."""
        drafts, want = self._spec_propose()
        if not want.any():
            return False
        # a plan may force every draft to be rejected: verify still runs
        # and emits the plain step's token, and the rollback path runs
        ctx = self._chaos("infer_speculate", rows=int((want > 0).sum()),
                          drafted=int(want.sum()))
        force_reject = ctx is not None and bool(ctx.get("reject_all"))
        n = self.engine_cfg.max_slots
        W = self.engine_cfg.speculate_k + 1
        tok_mat = np.zeros((n, W), np.int64)
        tok_mat[:, 0] = self._tokens
        tok_mat[:, 1:] = drafts
        n_tok = np.where(self._active, want + 1, 1)
        dev = self.device
        logits = self._verify(
            self.params, self.pool.k, self.pool.v,
            torch.from_numpy(self._tables).to(dev),
            torch.from_numpy(tok_mat).to(dev),
            torch.from_numpy(self._positions).to(dev),
            torch.from_numpy(self._active).to(dev),
            torch.from_numpy(n_tok).to(dev))            # [n, W, V]
        with self._mlock:
            self._decode_iterations += 1
            self._spec_passes += 1
            self._occupancy_sum += (float(self._active.sum())
                                    / self.engine_cfg.max_slots)
        greedy = gpt.sample_token(logits, temperature=0.0).cpu().numpy()
        stepped = emitted = 0
        for row in list(self._slot_req):
            if not self._active[row]:     # prefilling rows ride along
                continue
            req = self._slot_req[row]
            w = int(want[row])
            if req.temperature != 0.0:
                # lane 0 holds the plain step's logits: one token from the
                # request's own generator, as without speculation
                tok = int(gpt.sample_token(logits[row, 0],
                                           temperature=req.temperature,
                                           generator=req.generator))
                req._emit(tok)
                stepped += 1
                emitted += 1
                self._positions[row] += 1
                self._tokens[row] = tok
                if self._request_finished(req, tok):
                    self._paged_evict(row)
                continue
            accepted = 0
            finished = False
            for j in range(w + 1):
                tok = int(greedy[row, j])
                req._emit(tok)
                emitted += 1
                self._positions[row] += 1
                self._tokens[row] = tok
                if self._request_finished(req, tok):
                    finished = True       # EOS / max_new mid-burst
                    break
                if j < w and not force_reject \
                        and int(drafts[row, j]) == tok:
                    accepted += 1         # lane j+1's input was right
                    continue
                break                     # first mismatch: corrected
            stepped += 1
            req.spec_drafted += w
            req.spec_accepted += accepted
            with self._mlock:
                self._spec_drafted += w
                self._spec_accepted += accepted
            if finished:
                self._paged_evict(row)    # releases the whole chain
            else:
                self._spec_rollback(row)
        with self._mlock:
            self._row_steps += stepped
            self._row_tokens += emitted
        return True

    def _paged_decode_iteration(self) -> None:
        for row in [r for r in list(self._slot_req) if self._active[r]]:
            req = self._slot_req.get(row)
            if req is None or not self._active[row]:
                continue                  # preempted by an earlier row's
            #                               block hunt this very pass
            if req.cancelled:
                self._paged_evict(row, cache_prefix=False)
                continue
            self._grow_row(row)           # False = row preempted; skip
        if not self._active.any():
            return
        # draft-then-verify when configured; False = no row drafted this
        # pass and the plain step runs.  A speculative pass spans several
        # plain steps' time while the loop advances one prefill chunk a
        # pass, so two more chunks follow it: admission latency (TTFT)
        # stays flat, and decode-only passes pay nothing.
        if self._spec is not None and self._speculative_iteration():
            for _ in range(2):
                if not self._prefilling:
                    break
                self._prefill_one_chunk()
            return
        dev = self.device
        logits = self._step(
            self.params, self.pool.k, self.pool.v,
            torch.from_numpy(self._tables).to(dev),
            torch.from_numpy(self._tokens).to(dev),
            torch.from_numpy(self._positions).to(dev),
            torch.from_numpy(self._active).to(dev))
        if self._ranks is not None:
            # every rank has committed its heads of the step's K/V
            self._chaos("infer_shard_commit",
                        tp_shards=self.pool.heads_shards)
        self._emit_step(logits, self._paged_evict)

    def _emit_step(self, logits, evict) -> None:
        """Sample and emit one token for every active row from a plain
        step's logits [n, V]; ``evict`` releases a finished row."""
        with self._mlock:
            self._decode_iterations += 1
            self._occupancy_sum += (float(self._active.sum())
                                    / self.engine_cfg.max_slots)
        greedy = gpt.sample_token(logits, temperature=0.0).cpu().numpy()
        stepped = 0
        for row in list(self._slot_req):
            if not self._active[row]:     # prefilling rows ride along
                continue
            req = self._slot_req[row]
            if req.temperature == 0.0:
                tok = int(greedy[row])
            else:
                tok = int(gpt.sample_token(logits[row],
                                           temperature=req.temperature,
                                           generator=req.generator))
            req._emit(tok)
            stepped += 1
            self._positions[row] += 1
            self._tokens[row] = tok
            if self._request_finished(req, tok):
                evict(row)
        with self._mlock:
            self._row_steps += stepped
            self._row_tokens += stepped

    def _paged_evict(self, row: int, cache_prefix: bool = True) -> None:
        """Natural eviction (EOS / max-tokens / cancel): donate the clean
        KV chain to the prefix index, then release the row."""
        req = self._slot_req[row]
        if cache_prefix and not req.cancelled:
            self._insert_prefix(row,
                                self._sequence(req)[:self._valid_len(row)])
        self._release_row(row)
        req._finish()
        self._note_done(req)

    # ------------------------------------------------------------ slot path

    def _decode_iteration(self) -> None:
        # a cancelled slot frees for live work before the step, as a
        # cancelled row does on the paged path
        for slot in [s for s in list(self._slot_req)
                     if self._slot_req[s].cancelled]:
            self._evict(slot)
        if not self._active.any():
            return
        dev = self.device
        logits = self._step(
            self.params, self.cache.k, self.cache.v,
            torch.from_numpy(self._tokens).to(dev),
            torch.from_numpy(self._positions).to(dev),
            torch.from_numpy(self._active).to(dev))
        self._emit_step(logits, self._evict)

    def _evict(self, slot: int) -> None:
        req = self._slot_req.pop(slot)
        self._active[slot] = False
        self.cache.free(slot)
        req._finish()
        self._note_done(req)
        with self._cond:
            self._cond.notify_all()   # wake the loop: admits may be waiting

    def _request_finished(self, req: GenerationRequest, tok: int) -> bool:
        with self._mlock:
            self._generated_tokens += 1
        eos = self.engine_cfg.eos_token
        return (len(req.tokens) >= req.max_new
                or (eos is not None and tok == eos))

    def _note_done(self, req: GenerationRequest) -> None:
        with self._mlock:
            self._requests_completed += 1
        self._fr_note(req)

    def _fail_all(self, e: BaseException) -> bool:
        """A failed step leaves the cache's content in doubt: fail the
        in-flight requests and zero the cache (every rank's shard on a
        mesh).  Paged: also drop every block reference and the prefix
        index (cached prefixes would point at zeroed blocks).  False when
        the tp ranks died: the engine cannot serve on."""
        failed = {row: self._slot_req.pop(row) for row in list(self._slot_req)}
        self._active[:] = False
        alive = self._ranks is None or self._ranks.alive
        if self._paged:
            self._prefilling.clear()
            self._row_blocks.clear()
            self._tables[:, :] = 0
            if self.trie is not None:
                self.trie.clear()
            if alive:
                try:
                    self.pool.reset()
                except _tp.TPRanksDead:
                    alive = False
            with self._cond:
                self._free_rows = list(
                    range(self.engine_cfg.max_slots - 1, -1, -1))
                self._cond.notify_all()
        else:
            for slot in failed:
                self.cache.free(slot)
            if alive:
                try:
                    self.cache.reset_arrays()
                except _tp.TPRanksDead:
                    alive = False
        for req in failed.values():
            req._finish(e)
        return alive

    # ------------------------------------------------------------- admin

    def drain(self) -> None:
        """Graceful drain: admit nothing new (``submit()`` raises
        EngineDrainingError), hand queued waiters back with the same
        error, let in-flight rows decode to completion."""
        with self._cond:
            if self._stopped or self._draining:
                return
            self._draining = True
            waiting, self._waiting = self._waiting, []
            self._cond.notify_all()
        err = EngineDrainingError("engine is draining (planned scale-down)")
        for r in waiting:
            if not r.done:
                r._finish(err)

    # ------------------------------------------- cluster prefix plane

    def _run_ops_locked(self) -> None:
        """Run the queued ops on the loop thread (under ``_cond``).  An
        op's error goes to its caller's box; the loop never dies for a
        bad op.  Ops must not take ``_cond`` (they run holding it): the
        pool and the index are safe to touch, the row helpers are not."""
        while self._ops:
            fn, box = self._ops.pop(0)
            try:
                box["result"] = fn()
            except Exception as e:
                box["error"] = e
            box["done"] = True
        self._cond.notify_all()

    def _run_op(self, fn, timeout: float = 10.0):
        """Run ``fn`` on the loop thread and return its result, or raise
        its error; EngineStoppedError on an engine that is shut down or
        dies first, PrefixUnavailable when it has not run in
        ``timeout`` seconds."""
        box = {"done": False, "result": None, "error": None}
        deadline = time.monotonic() + timeout
        with self._cond:
            if self._stopped:
                raise EngineStoppedError("engine is shut down")
            self._ops.append((fn, box))
            self._cond.notify_all()
            while not box["done"]:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise PrefixUnavailable(
                        f"engine op timed out after {timeout}s")
                self._cond.wait(left)
        if box["error"] is not None:
            raise box["error"]
        return box["result"]

    def _note_prefix_published(self, tokens: np.ndarray, blocks) -> None:
        """Record a publication to the local prefix index for
        ``prefix_export``; at most 64 records are kept."""
        with self._mlock:
            if len(self._prefix_outbox) >= 64:
                self._prefix_outbox.pop(0)
            self._prefix_outbox.append({
                "tokens": [int(t) for t in tokens],
                "blocks": [int(b) for b in blocks],
                "block_size": self.pool.block_size,
                "generation": self.pool.generation,
                "engine": self.name,
            })

    def _prefix_geometry(self, tokens) -> tuple:
        """(tokens as int64, n_tokens, block_size) of a prefix-plane call;
        PrefixUnavailable without a prefix index or for a prefix that is
        not a whole number of blocks."""
        if not self._paged or self.trie is None:
            raise PrefixUnavailable("engine has no prefix index")
        toks = np.asarray(list(tokens), np.int64)
        bs = self.pool.block_size
        n = int(toks.size)
        if n < bs or n % bs:
            raise PrefixUnavailable(
                f"prefix length {n} is not block-aligned (bs={bs})")
        return toks, n, bs

    def _probe_match(self, toks: np.ndarray) -> tuple:
        """The index's match for the prefix ``toks`` (blocks increfed).
        The index caps a match at len - 1 tokens, so one probe token past
        the prefix lets the whole chain match."""
        return self.trie.match(np.append(toks, 0))

    def prefix_export(self) -> list:
        """Drain the record of prefixes published to the local index
        since the last call ([] without a prefix index)."""
        if not self._paged or self.trie is None:
            return []
        with self._mlock:
            out, self._prefix_outbox = self._prefix_outbox, []
        return out

    def prefix_extract(self, tokens, generation: int) -> dict:
        """The holder's side of a prefix adoption: the K/V of the cached,
        block-aligned prefix ``tokens`` as host arrays, ``{"k", "v"}``
        ``[L, T, h, bs, hd]`` each, with ``generation``, ``n_tokens`` and
        ``block_size``.  Checks, in order: block alignment, then the pool
        generation (StalePrefixGeneration after a reset: old block ids
        are never served), then that the index still holds every token
        (PrefixUnavailable).  Runs on the loop thread."""
        toks, n, bs = self._prefix_geometry(tokens)
        want = int(generation)

        def op():
            if want != self.pool.generation:
                raise StalePrefixGeneration(
                    f"pool generation is {self.pool.generation}, the "
                    f"prefix was published at {want} (the pool was reset "
                    "since)")
            ids, hit = self._probe_match(toks)
            try:
                if hit < n:
                    raise PrefixUnavailable(
                        f"only {hit}/{n} prefix tokens still cached "
                        "(evicted since publish)")
                k, v = self.pool.read_blocks(ids[:n // bs])
            finally:
                for bid in ids:
                    self.pool.decref(bid)
            return {"k": k, "v": v, "generation": self.pool.generation,
                    "n_tokens": n, "block_size": bs}
        return self._run_op(op)

    def prefix_install(self, tokens, payload: dict) -> dict:
        """The adopter's side: write a ``prefix_extract`` payload into
        fresh local blocks and publish them to the local index, so the
        next admission adopts them by refcount like a locally computed
        prefix.  A prefix the index already holds is left as it is
        (``already``).  Fresh blocks come from the free list, else from
        evicting unreferenced cached prefixes; a live row is never
        preempted: PrefixInstallPressure, with every block taken given
        back.  Returns ``{"installed": blocks, "already": bool}``."""
        toks, n, bs = self._prefix_geometry(tokens)
        if int(payload.get("block_size", -1)) != bs:
            raise PrefixUnavailable(
                f"holder block_size {payload.get('block_size')} != local "
                f"{bs} (geometry mismatch)")
        n_b = n // bs
        k_new, v_new = payload["k"], payload["v"]
        cfg = self.cfg
        expect = (cfg.n_layers, n_b, cfg.n_heads, bs, cfg.head_dim)
        if tuple(np.shape(k_new)) != expect \
                or tuple(np.shape(v_new)) != expect:
            raise PrefixUnavailable(
                f"payload shape {np.shape(k_new)} != expected {expect}")

        def op():
            ids, hit = self._probe_match(toks)
            for bid in ids:
                self.pool.decref(bid)
            if hit >= n:
                return {"installed": 0, "already": True}
            fresh = []
            for _ in range(n_b):
                bid = self.pool.alloc()
                while bid is None and self.trie.evict(1):
                    bid = self.pool.alloc()
                if bid is None:
                    for b in fresh:
                        self.pool.decref(b)
                    raise PrefixInstallPressure(
                        f"pool cannot hold a {n_b}-block adopted prefix "
                        "without preempting live requests")
                fresh.append(bid)
            self.pool.write_blocks_at(fresh, k_new, v_new)
            self.trie.insert(toks, fresh)
            # the index holds its own references now (chunks it already
            # had were deduped); dropping ours frees exactly those
            for b in fresh:
                self.pool.decref(b)
            return {"installed": n_b, "already": False}
        return self._run_op(op)

    def stats(self) -> dict:
        with self._cond:
            waiting = len(self._waiting)
            interactive = sum(1 for r in self._waiting
                              if r.priority <= PRIORITY_INTERACTIVE)
            stopped = self._stopped
            draining = self._draining
            occupied = (self.engine_cfg.max_slots - len(self._free_rows)
                        if self._paged else None)
        with self._mlock:
            iters = self._decode_iterations
            drafted, accepted = self._spec_drafted, self._spec_accepted
            row_steps, row_tokens = self._row_steps, self._row_tokens
            lookup = self._prefix_lookup_tokens
            out = {
                "max_slots": self.engine_cfg.max_slots,
                "waiting_requests": waiting,
                "waiting_interactive": interactive,
                "stopped": stopped,
                "draining": draining,
                "batch_occupancy": (self._occupancy_sum / iters
                                    if iters else 0.0),
                "generated_tokens": self._generated_tokens,
                "requests_completed": self._requests_completed,
                "decode_iterations": iters,
                # tokens emitted per (row, step call) pair: exactly 1.0 for
                # plain decode, 1 + accepted per row pass when speculating
                "tokens_per_step": (row_tokens / row_steps
                                    if row_steps else 0.0),
                "row_steps": row_steps,
                "row_tokens": row_tokens,
                "full_prefills": self._full_prefills,
                "chunk_prefills": self._chunk_prefills,
                "paged": self._paged,
                # zeros when speculate is None or on the slot engine
                "speculate": self._spec,
                "spec_drafted_tokens": drafted,
                "spec_accepted_tokens": accepted,
                "spec_accept_rate": accepted / drafted if drafted else 0.0,
                "spec_passes": self._spec_passes,
                # serving geometry (1 and {} on one device)
                "mesh_devices": (self._ranks.executor.mesh_devices
                                 if self._ranks is not None else 1),
                "mesh_axes": (dict(self._ranks.executor.mesh_axes)
                              if self._ranks is not None else {}),
                "tp_shards": self._heads_shards,
                "peak_active_requests": self._peak_active,
            }
            if self._paged:
                out.update({
                    "prefix_hit_tokens": self._prefix_hit_tokens,
                    "prefix_lookup_tokens": lookup,
                    "prefix_hit_rate": (self._prefix_hit_tokens / lookup
                                        if lookup else 0.0),
                    "preemptions": self._preemptions,
                })
        if not self._paged:
            cache = self.cache.stats()
            out.update({
                "active_slots": cache["active_slots"],
                "free_slots": cache["free_slots"],
                "cache_bytes": cache["bytes_total"],
                "cache_bytes_per_device": cache["bytes_per_device"],
            })
            return out
        pool = self.pool.stats()
        total = pool["blocks_total"]
        out.update({
            # occupied rows (decoding and prefilling)
            "active_slots": occupied,
            "free_slots": self.engine_cfg.max_slots - occupied,
            "cache_bytes": pool["bytes_total"],
            "cache_bytes_per_device": pool["bytes_per_device"],
            "block_size": pool["block_size"],
            # the same count on every tp rank: heads are what is split
            "blocks_total": total,
            "blocks_per_device": pool["blocks_per_device"],
            "blocks_free": pool["blocks_free"],
            "block_utilization": (pool["blocks_used"] / total
                                  if total else 0.0),
            "prefix_cached_blocks": (self.trie.cached_blocks
                                     if self.trie is not None else 0),
        })
        return out

    def shutdown(self, timeout: float = 5.0) -> None:
        """Stop the loop; on a mesh, then drop the engine from its ranks
        (the executor stops with its last engine)."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)
        if self._ranks is not None:
            self._ranks.close()


def metrics_snapshot() -> list:
    """Per-engine gauges and counters as ``(name, kind, help, {labels:
    value})`` tuples, the JAX package's series names and format; labels
    are ``engine`` and the engine's own ``labels``."""
    with _registry_lock:
        engines = dict(_ENGINES)
    series = [  # (name, kind, help, stats key)
        ("ray_tpu_inference_active_slots", "gauge",
         "Cache slots currently decoding, per engine", "active_slots"),
        ("ray_tpu_inference_waiting_requests", "gauge",
         "Requests queued for a free slot, per engine", "waiting_requests"),
        ("ray_tpu_inference_batch_occupancy_ratio", "gauge",
         "Mean active/max_slots per decode iteration", "batch_occupancy"),
        ("ray_tpu_inference_generated_tokens_total", "counter",
         "Tokens generated since engine start", "generated_tokens"),
        ("ray_tpu_inference_requests_completed_total", "counter",
         "Generation requests completed since engine start",
         "requests_completed"),
        ("ray_tpu_inference_block_utilization_ratio", "gauge",
         "Paged KV pool blocks in use / usable blocks", "block_utilization"),
        ("ray_tpu_inference_prefix_hit_rate", "gauge",
         "Prompt tokens adopted from the radix prefix cache / prompt "
         "tokens seen", "prefix_hit_rate"),
        ("ray_tpu_inference_prefix_cached_blocks", "gauge",
         "Blocks held by the radix prefix index", "prefix_cached_blocks"),
        ("ray_tpu_inference_preemptions_total", "counter",
         "Requests requeued by block-pressure preemption", "preemptions"),
        ("ray_tpu_inference_tokens_per_step", "gauge",
         "Tokens emitted per decode/verify step call (speculative "
         "decoding pushes this above 1)", "tokens_per_step"),
        ("ray_tpu_inference_spec_accept_rate", "gauge",
         "Drafted tokens accepted by the verify pass / drafted tokens "
         "offered", "spec_accept_rate"),
        ("ray_tpu_inference_spec_accepted_tokens_total", "counter",
         "Drafted tokens accepted since engine start",
         "spec_accepted_tokens"),
        ("ray_tpu_inference_mesh_devices", "gauge",
         "Devices in the engine's mesh (1 = unmeshed single device)",
         "mesh_devices"),
        ("ray_tpu_inference_tp_shards", "gauge",
         "Tensor-parallel shards of the paged KV pool's heads dim",
         "tp_shards"),
    ]
    values = {name: {} for name, _, _, _ in series}
    for name, eng in sorted(engines.items()):
        st = eng.stats()
        key = (("engine", name),) + tuple(sorted(eng.labels.items()))
        for metric, _, _, stat in series:
            # slot engines report 0 for the paged-only keys
            values[metric][key] = float(st.get(stat, 0.0))
    zero = {(("engine", "none"),): 0.0}
    return [(metric, kind, doc, values[metric] or zero)
            for metric, kind, doc, _ in series]


def _to_device(tree, device):
    return {k: (_to_device(v, device) if isinstance(v, dict)
                else v.to(device))
            for k, v in tree.items()}
