"""Continuous-batching inference engine over the paged KV cache.

Port of ``ray_tpu/inference/engine.py``'s paged path.  One background
loop owns the model state and runs one decode step per iteration over
all rows at once; between steps it admits waiting requests, advances
prefills, and evicts finished requests, so requests join and leave in
the middle of their neighbours' decode.

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

Sampling shares ``gpt.sample_token`` with the full-recompute oracle, so
greedy decode is token-identical by construction.  A request with
``temperature > 0`` owns a ``torch.Generator`` seeded from its ``seed``.

Not ported yet: speculative decoding, the slot engine, the cluster
prefix plane, the chaos and flight-recorder hooks, and meshes.
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
from ray_tpu_torch.inference.cache import BlockPool, RadixIndex
from ray_tpu_torch.inference.decode import (make_chunk_prefill_fn,
                                            make_paged_decode_step,
                                            make_prefill_fn)
from ray_tpu_torch.models import gpt
from ray_tpu_torch.models.gpt import GPTConfig
from ray_tpu_torch.serve.qos import (PRIORITY_BATCH,  # noqa: F401
                                     PRIORITY_INTERACTIVE,
                                     EngineDrainingError, ReplicaDeadError,
                                     parse_priority)


@dataclass
class EngineConfig:
    """Engine knobs.  ``max_slots`` is the decode-batch width (the
    concurrency cap); memory is ``n_blocks`` x ``kv_block_size`` tokens."""
    max_slots: int = 8
    max_seq: Optional[int] = None        # cache width; None = model max_seq
    eos_token: Optional[int] = None      # None = never stop early
    default_max_new: int = 64
    max_waiting: int = 1024              # admission-queue bound (backpressure)
    idle_wait_s: float = 0.05            # loop park interval when empty
    kv_block_size: int = 16              # tokens per block
    n_blocks: Optional[int] = None       # usable blocks; None = max_slots
    #                                      * ceil(max_seq/block)
    prefill_chunk: int = 32              # chunked-prefill window width
    prefix_cache: bool = True            # radix prefix reuse on/off


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
        self.first_token_s: Optional[float] = None
        self.finished_s: Optional[float] = None

    # ---- engine side -----------------------------------------------------

    def _emit(self, token: int) -> None:
        with self._cond:
            if self.first_token_s is None:
                self.first_token_s = time.perf_counter()
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

    _names = itertools.count()

    def __init__(self, params, cfg: GPTConfig,
                 engine_cfg: Optional[EngineConfig] = None, *,
                 device=None, name: Optional[str] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.engine_cfg = engine_cfg or EngineConfig()
        ec = self.engine_cfg
        n = ec.max_slots
        bs = ec.kv_block_size
        per_seq = -(-int(ec.max_seq or cfg.max_seq) // bs)
        n_blocks = ec.n_blocks if ec.n_blocks is not None else n * per_seq
        self.pool = BlockPool(cfg, n_blocks, bs, max_seq=ec.max_seq,
                              device=self.device)
        self.max_seq = self.pool.max_seq
        self.trie = RadixIndex(self.pool) if ec.prefix_cache else None
        # the full-width prefill: a cold long prompt on a lightly loaded
        # engine seeds all its blocks from one model forward
        self._prefill = make_prefill_fn(cfg)
        self._step = make_paged_decode_step(
            cfg, block_size=bs, n_table=self.pool.blocks_per_seq)
        self._chunk = make_chunk_prefill_fn(
            cfg, chunk=ec.prefill_chunk, block_size=bs,
            n_table=self.pool.blocks_per_seq)
        self._tables = np.zeros((n, self.pool.blocks_per_seq), np.int64)
        self._row_blocks: dict[int, list[int]] = {}
        self._free_rows = list(range(n - 1, -1, -1))
        self._prefilling: dict[int, int] = {}   # row -> next prefill pos

        self._slot_req: dict[int, GenerationRequest] = {}
        self._tokens = np.zeros(n, np.int64)      # current input token
        self._positions = np.zeros(n, np.int64)   # where it will be written
        self._active = np.zeros(n, bool)
        self._waiting: list[GenerationRequest] = []
        self._req_seq = itertools.count()
        self._cond = threading.Condition()
        self._stopped = False
        self._draining = False

        self._mlock = threading.Lock()
        self._generated_tokens = 0
        self._requests_completed = 0
        self._decode_iterations = 0
        self._occupancy_sum = 0.0      # sum of active/max_slots per iteration
        self._prefix_hit_tokens = 0
        self._prefix_lookup_tokens = 0
        self._preemptions = 0
        self._peak_active = 0
        self._full_prefills = 0        # cold long prompts prefilled full-width
        self._chunk_prefills = 0       # chunk-prefill calls

        self.name = name or f"engine-{next(self._names)}"
        self._thread = threading.Thread(
            target=_engine_loop, args=(weakref.ref(self),), daemon=True,
            name=f"ray_tpu_torch-inference-{self.name}")
        self._thread.start()

    # ------------------------------------------------------------ submit

    def submit(self, prompt: Sequence[int], *,
               max_new: Optional[int] = None,
               temperature: float = 0.0,
               seed: int = 0,
               priority: int = PRIORITY_BATCH) -> GenerationRequest:
        """Queue a generation; returns the request mailbox at once.
        Admission happens at the next prefill boundary, in (priority,
        arrival) order."""
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
            while (not self._stopped and not self._active.any()
                   and not self._prefilling
                   and not (self._waiting and self._admission_possible())):
                self._cond.wait(self.engine_cfg.idle_wait_s)
            if self._stopped:
                return False
            # reap cancelled waiters even when the pool is full
            live = []
            for r in self._waiting:
                if r.cancelled:
                    r._finish()
                else:
                    live.append(r)
            self._waiting = live
            self._admit_locked()
        try:
            if self._prefilling:
                self._prefill_chunk_pass()
            if self._active.any():
                self._decode_iteration()
        except Exception as e:                # step failure: fail the
            self._fail_all(e)                 # in-flight requests, keep serving
        return True

    def _admission_possible(self) -> bool:
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
            self._cond.notify_all()
        err = EngineStoppedError("engine shut down")
        for r in pending:
            if not r.done:
                r._finish(err)

    def _admit_locked(self) -> None:
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
                if not self._try_admit(req):
                    break
            except Exception as e:
                self._waiting.pop(0)
                req._finish(e)
                continue
            self._waiting.pop(0)

    def _try_admit(self, req: GenerationRequest) -> bool:
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
            self._note_done()
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
            logits, k_new, v_new = self._prefill(self.params, padded)
            self.pool.write_prefill(self._tables[row], k_new[:, 0],
                                    v_new[:, 0])
            with self._mlock:
                self._full_prefills += 1
            self._finish_prefill(row, req, logits[0, n - 1])
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
        tok = int(gpt.sample_token(last_logits,
                                   temperature=req.temperature,
                                   generator=req.generator))
        req._emit(tok)
        if self._request_finished(req, tok):
            self._evict(row)
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

    def _decode_iteration(self) -> None:
        for row in [r for r in list(self._slot_req) if self._active[r]]:
            req = self._slot_req.get(row)
            if req is None or not self._active[row]:
                continue                  # preempted by an earlier row's
            #                               block hunt this very pass
            if req.cancelled:
                self._evict(row, cache_prefix=False)
                continue
            self._grow_row(row)           # False = row preempted; skip
        if not self._active.any():
            return
        dev = self.device
        logits = self._step(
            self.params, self.pool.k, self.pool.v,
            torch.from_numpy(self._tables).to(dev),
            torch.from_numpy(self._tokens).to(dev),
            torch.from_numpy(self._positions).to(dev),
            torch.from_numpy(self._active).to(dev))
        with self._mlock:
            self._decode_iterations += 1
            self._occupancy_sum += (float(self._active.sum())
                                    / self.engine_cfg.max_slots)
        greedy = gpt.sample_token(logits, temperature=0.0).cpu().numpy()
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
            self._positions[row] += 1
            self._tokens[row] = tok
            if self._request_finished(req, tok):
                self._evict(row)

    def _evict(self, row: int, cache_prefix: bool = True) -> None:
        """Natural eviction (EOS / max-tokens / cancel): donate the clean
        KV chain to the prefix index, then release the row."""
        req = self._slot_req[row]
        if cache_prefix and not req.cancelled:
            self._insert_prefix(row,
                                self._sequence(req)[:self._valid_len(row)])
        self._release_row(row)
        req._finish()
        self._note_done()

    def _request_finished(self, req: GenerationRequest, tok: int) -> bool:
        with self._mlock:
            self._generated_tokens += 1
        eos = self.engine_cfg.eos_token
        return (len(req.tokens) >= req.max_new
                or (eos is not None and tok == eos))

    def _note_done(self) -> None:
        with self._mlock:
            self._requests_completed += 1

    def _fail_all(self, e: BaseException) -> None:
        """A failed step leaves the pool's content in doubt: fail the
        in-flight requests, zero the pool, drop every reference and the
        prefix index (cached prefixes would point at zeroed blocks)."""
        failed = [self._slot_req.pop(row) for row in list(self._slot_req)]
        self._active[:] = False
        self._prefilling.clear()
        self._row_blocks.clear()
        self._tables[:, :] = 0
        if self.trie is not None:
            self.trie.clear()
        self.pool.reset()
        with self._cond:
            self._free_rows = list(
                range(self.engine_cfg.max_slots - 1, -1, -1))
            self._cond.notify_all()
        for req in failed:
            req._finish(e)

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

    def stats(self) -> dict:
        with self._cond:
            waiting = len(self._waiting)
            interactive = sum(1 for r in self._waiting
                              if r.priority <= PRIORITY_INTERACTIVE)
            stopped = self._stopped
            draining = self._draining
            occupied = self.engine_cfg.max_slots - len(self._free_rows)
        with self._mlock:
            iters = self._decode_iterations
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
                "full_prefills": self._full_prefills,
                "chunk_prefills": self._chunk_prefills,
                "prefix_hit_tokens": self._prefix_hit_tokens,
                "prefix_lookup_tokens": self._prefix_lookup_tokens,
                "prefix_hit_rate": (self._prefix_hit_tokens
                                    / self._prefix_lookup_tokens
                                    if self._prefix_lookup_tokens else 0.0),
                "preemptions": self._preemptions,
                "peak_active_requests": self._peak_active,
            }
        pool = self.pool.stats()
        total = pool["blocks_total"]
        out.update({
            "active_slots": occupied,
            "free_slots": self.engine_cfg.max_slots - occupied,
            "cache_bytes": pool["bytes_total"],
            "block_size": pool["block_size"],
            "blocks_total": total,
            "blocks_free": pool["blocks_free"],
            "block_utilization": (pool["blocks_used"] / total
                                  if total else 0.0),
            "prefix_cached_blocks": (self.trie.cached_blocks
                                     if self.trie is not None else 0),
        })
        return out

    def shutdown(self, timeout: float = 5.0) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)


def _to_device(tree, device):
    return {k: (_to_device(v, device) if isinstance(v, dict)
                else v.to(device))
            for k, v in tree.items()}
