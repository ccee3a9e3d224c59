"""KV-cache pools: the paged block pool with its radix prefix index, and
the slot pool of the ``paged=False`` engine.

Port of ``ray_tpu/inference/cache.py``'s ``KVCacheManager``,
``BlockPool``, ``_TrieNode`` and ``RadixIndex``.

``KVCacheManager`` preallocates one ``[max_seq]`` stripe per sequence
(``[n_layers, n_slots, n_heads, max_seq, head_dim]`` x2, the two halves
of one ``SlotShard``) and hands out whole slots.  ``BlockPool`` is
preallocated and handed out in fixed-size token blocks (``[n_layers,
n_blocks + 1, n_heads, block_size, head_dim]`` x2); a request's block
table maps positions to blocks, and per-block refcounts let requests
share blocks (prefix reuse) with copy-on-write before a shared block is
written.  Block id 0 is a reserved scratch block: masked rows and
out-of-range writes land there so no write needs a branch.

Where the JAX package donated the pool buffers to a jitted update and
swapped the results in, the port updates the pool tensors in place
(``index_put_``/``copy_``).  The K and V pools are the two halves of one
tensor (``KVShard``), so a prefix transfer gathers or scatters both in
one indexing op (``read_blocks``, ``write_blocks_at``).

With a ``mesh`` (the tp ranks of an engine, ``inference.tp``) the pool
is split over the heads dim (``decode.POOL_AXES``): every rank holds
every block with its own heads, in a ``KVShard`` of its own; the slot
cache is split the same way, every rank holding every slot's stripe of
its heads in a ``SlotShard``.  Block ids, tables, refcounts, the radix
index and copy-on-write stay here on the host and know nothing of
shards; each tensor update runs on every rank, and ``read_blocks``
gives full-width host arrays whatever the layout.

``RadixIndex`` is a trie over block-sized token chunks (plus partial
tail leaves): a prompt whose head matches a cached prefix adopts those
blocks by refcount instead of re-running prefill.  Unreferenced cached
prefixes are LRU-evicted under pool pressure.
"""

from __future__ import annotations

import heapq
import threading
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.gpt import GPTConfig


class KVCacheManager:
    """Owns the preallocated slot pool and its free list: one ``[max_seq]``
    stripe per sequence.

    alloc/free and the tensor updates happen on the engine loop thread;
    ``stats()`` may be read from any thread (the lock guards the free
    list).

    ``mesh``: the tp ranks that hold the cache split over heads, as
    ``BlockPool(mesh=)`` splits its pool: each rank holds every slot's
    stripe of its own heads, ``[L, n_slots, h/tp, S, hd]`` (a
    ``SlotShard``), and the free list stays here.  ``k`` and ``v`` are
    then None; ``bytes_total`` counts every rank's bytes."""

    def __init__(self, cfg: GPTConfig, n_slots: int,
                 max_seq: Optional[int] = None, dtype=None, device=None,
                 mesh=None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_slots = int(n_slots)
        self.max_seq = int(max_seq or cfg.max_seq)
        if self.max_seq > cfg.max_seq:
            raise ValueError(
                f"cache max_seq {self.max_seq} exceeds model max_seq "
                f"{cfg.max_seq} (wpe table bound)")
        self.dtype = dtype or cfg.dtype
        self.mesh = mesh
        if cfg.n_heads % self.heads_shards:
            raise ValueError(
                f"n_heads {cfg.n_heads} is not divisible by the heads "
                f"(tp) shard count {self.heads_shards}")
        self._shard = self.k = self.v = None
        if mesh is None:
            self._shard = SlotShard(cfg, self.n_slots, self.max_seq,
                                    self.dtype, self.device)
            self.k, self.v = self._shard.k, self._shard.v
        else:
            mesh.run("slots_zeros", self.n_slots, self.max_seq, self.dtype)
        self._lock = threading.Lock()
        self._free = list(range(self.n_slots - 1, -1, -1))  # pop() -> slot 0
        self._allocated: set[int] = set()

    @property
    def heads_shards(self) -> int:
        """The shards the heads dim is split into: the tp degree, 1 on
        one device."""
        return 1 if self.mesh is None else self.mesh.heads_shards

    def alloc(self) -> Optional[int]:
        """Hand out a slot, or None when the pool is exhausted (the
        caller queues the request: memory never grows)."""
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop()
            self._allocated.add(slot)
            return slot

    def free(self, slot: int) -> None:
        with self._lock:
            if slot not in self._allocated:
                raise ValueError(f"slot {slot} is not allocated "
                                 "(double free or never alloc'd)")
            self._allocated.remove(slot)
            self._free.append(slot)

    @property
    def n_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def n_active(self) -> int:
        with self._lock:
            return len(self._allocated)

    def _apply(self, method: str, *args):
        """``SlotShard.<method>(*args)`` here, or on every rank's shard."""
        if self.mesh is None:
            return getattr(self._shard, method)(*args)
        return self.mesh.run("pool", method, *args)

    def write_prefill(self, slot: int, k_new: torch.Tensor,
                      v_new: torch.Tensor) -> None:
        """Seed a slot from a prefill (``[L, h, s, hd]`` each), in place.
        A prefill shorter than the stripe is zero-padded on the right;
        the kv-length masks hide the tail and decode overwrites it.  On a
        mesh each rank writes its heads (the engine's meshed prefill
        writes them on the ranks, never gathered)."""
        self._apply("write_prefill", slot, k_new, v_new)

    def read_slots(self, slots) -> tuple:
        """Slots' stripes on the host, ``(k, v)`` of ``[L, T, h, S, hd]``
        each (T = len(slots)), full width on a mesh too (the ranks' heads
        gathered over tp).  A bf16 cache reads back as its exact f32
        upcast."""
        if self.mesh is None:
            return host_kv(self._shard.read_blocks(slots))
        return self.mesh.run("pool_read", list(slots))

    def reset_arrays(self) -> None:
        """Zero the pool (every rank's shard on a mesh) after a failed
        step left its content in doubt (the caller fails every in-flight
        request)."""
        self._apply("zero_")

    def bytes_total(self) -> int:
        """The whole cache's bytes, over every rank on a mesh."""
        cfg = self.cfg
        n = 2 * cfg.n_layers * self.n_slots * cfg.n_heads * self.max_seq \
            * cfg.head_dim
        return n * torch.empty((), dtype=self.dtype).element_size()

    def stats(self) -> dict:
        with self._lock:
            active = len(self._allocated)
        return {
            "n_slots": self.n_slots,
            "active_slots": active,
            "free_slots": self.n_slots - active,
            "max_seq": self.max_seq,
            "bytes_total": self.bytes_total(),
            "bytes_per_device": self.bytes_total() // self.heads_shards,
            "tp_shards": self.heads_shards,
        }


class SlotShard:
    """The slot cache's tensor on one device: ``[2, L, n_slots, h, S,
    hd]`` (k and v its two halves, the step's ``[L, b, h, S, hd]``
    caches), ``h`` all the heads or a tp rank's block of them (``heads``
    = (first head, count)).  The tensor side of ``KVCacheManager``; every
    update is in place."""

    def __init__(self, cfg: GPTConfig, n_slots: int, max_seq: int, dtype,
                 device, heads: Optional[tuple] = None):
        self.h0, self.hl = heads if heads is not None else (0, cfg.n_heads)
        self.max_seq = int(max_seq)
        self.kv = torch.zeros(
            (2, cfg.n_layers, int(n_slots), self.hl, self.max_seq,
             cfg.head_dim), dtype=dtype, device=device)
        self.k, self.v = self.kv.unbind(0)

    def write_prefill(self, slot: int, k_new: torch.Tensor,
                      v_new: torch.Tensor) -> None:
        """``KVCacheManager.write_prefill`` on this shard (``k_new``/
        ``v_new`` [L, h, s, hd] of its heads, or full width)."""
        for pool, new in ((self.k, k_new), (self.v, v_new)):
            if new.shape[1] != self.hl:
                new = new[:, self.h0:self.h0 + self.hl]
            pad = self.max_seq - new.shape[2]
            if pad > 0:
                new = torch.nn.functional.pad(new, (0, 0, 0, pad))
            pool[:, int(slot)] = new.to(pool.dtype)

    def read_blocks(self, slots) -> torch.Tensor:
        """[2, L, T, h, S, hd] on the device: the stripes of ``slots``
        (the layout of ``KVShard.read_blocks``, heads at dim 3)."""
        return self.kv[:, :, _table(slots, self.kv.device)]

    def zero_(self) -> None:
        self.kv.zero_()


class KVShard:
    """The pool's tensor on one device: ``[2, L, N+1, h, bs, hd]`` (k and
    v its two halves), ``h`` all the heads, or a tp rank's block of them
    (``heads`` = (first head, count) of ``n_heads``).  The tensor side of
    ``BlockPool``: every update is in place."""

    def __init__(self, cfg: GPTConfig, n_blocks: int, block_size: int,
                 dtype, device, heads: Optional[tuple] = None):
        self.h0, self.hl = heads if heads is not None else (0, cfg.n_heads)
        self.block_size = int(block_size)
        self.kv = torch.zeros(
            (2, cfg.n_layers, int(n_blocks) + 1, self.hl, self.block_size,
             cfg.head_dim), dtype=dtype, device=device)
        self.k, self.v = self.kv.unbind(0)

    def _heads(self, t):
        """This shard's heads of a full-width [L, T, h, ...] value (the
        value itself when it has this shard's width already)."""
        if t.shape[2] == self.hl:
            return t
        return t[:, :, self.h0:self.h0 + self.hl]

    def copy_block(self, src: int, dst: int) -> None:
        self.kv[:, :, dst].copy_(self.kv[:, :, src])

    def write_prefill(self, table, k_new: torch.Tensor,
                      v_new: torch.Tensor) -> None:
        """``BlockPool.write_prefill`` on this shard (``k_new``/``v_new``
        [L, h, S, hd] of its heads, or full width)."""
        T = len(table)
        span = T * self.block_size
        t = torch.as_tensor(np.asarray(table), dtype=torch.long,
                            device=self.kv.device)
        for pool, new in ((self.k, k_new), (self.v, v_new)):
            L, h, s, hd = new.shape
            if h != self.hl:
                new = new[:, self.h0:self.h0 + self.hl]
            if s < span:
                new = torch.nn.functional.pad(new, (0, 0, 0, span - s))
            blocks = new.reshape(L, self.hl, T, self.block_size, hd) \
                .permute(0, 2, 1, 3, 4)
            pool[:, t] = blocks.to(pool.dtype)       # in-place index_put_

    def read_blocks(self, ids) -> torch.Tensor:
        """[2, L, T, h, bs, hd] on the device: ONE gather of both pools."""
        return self.kv[:, :, _table(ids, self.kv.device)]

    def write_blocks_at(self, ids, k_new, v_new) -> None:
        """Scatter host arrays ``[L, T, h, bs, hd]`` (full width, or this
        shard's heads) into blocks ``ids``: ONE scatter of both pools."""
        t = _table(ids, self.kv.device)
        L, _, h, bs, hd = self.k.shape
        new = torch.empty((2, L, len(t), h, bs, hd), dtype=self.kv.dtype,
                          device=self.kv.device)
        new[0].copy_(self._heads(torch.as_tensor(np.asarray(k_new))))
        new[1].copy_(self._heads(torch.as_tensor(np.asarray(v_new))))
        self.kv[:, :, t] = new                       # in-place index_put_

    def zero_(self) -> None:
        self.kv.zero_()


def _table(ids, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(list(ids), np.int64), device=device)


def host_kv(kv: torch.Tensor) -> tuple:
    """A gathered [2, L, T, h, bs, hd] block chain as host ``(k, v)``; a
    bf16 pool, which numpy cannot hold, reads back as its exact f32
    upcast."""
    if kv.dtype == torch.bfloat16:
        kv = kv.float()
    kv = kv.cpu().numpy()
    return kv[0], kv[1]


class BlockPool:
    """Refcounted fixed-size token-block pool (the paged KV cache).

    ``alloc()`` returns a block with refcount 1; every additional holder
    (a sharing request, the prefix trie) ``incref``s; ``decref`` frees
    the block at zero.  A holder about to write a block must own it
    alone (refcount 1), or copy-on-write first (``copy_block``).

    alloc/incref/decref and the tensor updates happen on the engine loop
    thread; ``stats()`` may be read from any thread (the lock guards the
    free list and refcounts).

    ``mesh``: the tp ranks that hold the pool split over heads (the
    module note); ``n_blocks`` is then both the admission budget and
    every rank's block count, and a rank's bytes are ``bytes_total() /
    tp``.  ``k``, ``v`` and ``_kv`` are None: the tensors live on the
    ranks."""

    def __init__(self, cfg: GPTConfig, n_blocks: int, block_size: int,
                 max_seq: Optional[int] = None, dtype=None, device=None,
                 mesh=None):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.block_size = int(block_size)
        self.max_seq = int(max_seq or cfg.max_seq)
        if self.max_seq > cfg.max_seq:
            raise ValueError(
                f"cache max_seq {self.max_seq} exceeds model max_seq "
                f"{cfg.max_seq} (wpe table bound)")
        # block-table width: enough blocks to cover one max_seq sequence
        self.blocks_per_seq = -(-self.max_seq // self.block_size)
        if n_blocks < self.blocks_per_seq:
            raise ValueError(
                f"n_blocks {n_blocks} cannot hold one max_seq={self.max_seq} "
                f"sequence ({self.blocks_per_seq} blocks of {block_size})")
        self.n_blocks = int(n_blocks)             # usable (excludes scratch)
        self.dtype = dtype or cfg.dtype
        self.mesh = mesh
        shards = self.heads_shards
        if cfg.n_heads % shards:
            raise ValueError(
                f"n_heads {cfg.n_heads} is not divisible by the heads "
                f"(tp) shard count {shards}: the pool splits the heads dim "
                f"evenly over the ranks")
        self._shard = self._zeros()
        # [2, L, N+1, h, bs, hd]: k and v are views of its two halves
        self._kv = self.k = self.v = None
        if self._shard is not None:
            self._kv, self.k, self.v = (self._shard.kv, self._shard.k,
                                        self._shard.v)
        self._lock = threading.Lock()
        # pop() -> block 1 first; id 0 (scratch) is never in the list
        self._free = list(range(self.n_blocks, 0, -1))
        self._rc = [0] * (self.n_blocks + 1)
        # bumped by every reset(): block ids published before a reset
        # (to the cluster prefix plane) are fenced by it, so a reset
        # pool's old ids are never served
        self.generation = 0

    # ------------------------------------------------------------- blocks

    def alloc(self) -> Optional[int]:
        """Hand out a block (refcount 1), or None when the pool is dry
        (the caller evicts cached prefixes, preempts, or queues)."""
        with self._lock:
            if not self._free:
                return None
            bid = self._free.pop()
            self._rc[bid] = 1
            return bid

    def incref(self, bid: int) -> None:
        with self._lock:
            if self._rc[bid] < 1:
                raise ValueError(f"block {bid} is not allocated")
            self._rc[bid] += 1

    def decref(self, bid: int) -> int:
        """Drop one reference; frees the block at zero.  Returns the
        remaining count."""
        with self._lock:
            if self._rc[bid] < 1:
                raise ValueError(f"block {bid} is not allocated "
                                 "(double free or never alloc'd)")
            self._rc[bid] -= 1
            rc = self._rc[bid]
            if rc == 0:
                self._free.append(bid)
            return rc

    def release_tail(self, blocks: list, keep: int) -> int:
        """Speculative rollback: decref the chain's blocks past the first
        ``keep``, the refund of a block charge taken for drafted tokens
        the verify pass rejected.  ``blocks`` (the caller's row chain) is
        truncated in place, so a later preemption releases exactly what
        the row still holds.  Returns the number released."""
        keep = max(int(keep), 0)
        dropped = 0
        while len(blocks) > keep:
            self.decref(blocks.pop())
            dropped += 1
        return dropped

    def refcount(self, bid: int) -> int:
        with self._lock:
            return self._rc[bid]

    @property
    def n_free(self) -> int:
        with self._lock:
            return len(self._free)

    # ------------------------------------------------------------- tensors

    @property
    def heads_shards(self) -> int:
        """The shards the heads dim is split into: the tp degree, 1 on
        one device."""
        return 1 if self.mesh is None else self.mesh.heads_shards

    def _zeros(self) -> Optional[KVShard]:
        """The zeroed pool: a ``KVShard`` here, or on a mesh one per rank,
        each allocated by its rank at its own heads (None returned)."""
        if self.mesh is None:
            return KVShard(self.cfg, self.n_blocks, self.block_size,
                           self.dtype, self.device)
        self.mesh.run("pool_zeros", self.n_blocks, self.block_size,
                      self.dtype)
        return None

    def _apply(self, method: str, *args):
        """``KVShard.<method>(*args)`` here, or on every rank's shard."""
        if self.mesh is None:
            return getattr(self._shard, method)(*args)
        return self.mesh.run("pool", method, *args)

    def copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write: duplicate src's K/V into dst, in place in both
        pools."""
        self._apply("copy_block", src, dst)

    def write_prefill(self, table, k_new: torch.Tensor,
                      v_new: torch.Tensor) -> None:
        """Seed a request's blocks from a full prefill (``[L, h, S, hd]``
        each): the sequence, zero-padded to the table span, scatters
        through the block table in place.  Unowned table entries point
        at the scratch block, whose content the kv-length masks hide
        (duplicate scratch writes collide harmlessly).  On a mesh each
        rank writes its heads."""
        self._apply("write_prefill", np.asarray(table), k_new, v_new)

    def read_blocks(self, ids) -> tuple:
        """A block chain's K/V on the host, the export side of a prefix
        transfer: ``(k, v)`` numpy arrays of shape ``[L, T, h, bs, hd]``
        each (T = len(ids)), from ONE gather of both pools and one copy
        to the host, full width on a mesh too (the ranks' heads gathered
        over tp).  A bf16 pool reads back as its exact f32 upcast."""
        if self.mesh is None:
            return host_kv(self._shard.read_blocks(ids))
        return self.mesh.run("pool_read", list(ids))

    def write_blocks_at(self, ids, k_new, v_new) -> None:
        """Scatter fetched K/V (``read_blocks``' layout, ``[L, T, h, bs,
        hd]`` each, host arrays) into blocks ``ids``, cast to the pool's
        dtype: the install side of a prefix transfer, ONE scatter of both
        pools (on a mesh each rank takes its heads).  The caller owns
        ``ids`` alone (fresh blocks), so no copy-on-write is needed."""
        self._apply("write_blocks_at", list(ids), np.asarray(k_new),
                    np.asarray(v_new))

    def reset(self) -> None:
        """Zero the pool (every rank's shard on a mesh), drop every
        reference and bump ``generation``, after a failed step left the
        pool's content in doubt.  The caller fails all in-flight requests
        and clears the prefix index (cached prefixes would otherwise
        point at zeroed blocks)."""
        self._apply("zero_")
        with self._lock:
            self._free = list(range(self.n_blocks, 0, -1))
            self._rc = [0] * (self.n_blocks + 1)
            self.generation += 1

    # ------------------------------------------------------------- stats

    def bytes_total(self) -> int:
        """The whole pool's bytes, over every rank on a mesh."""
        cfg = self.cfg
        n = (2 * cfg.n_layers * (self.n_blocks + 1) * cfg.n_heads
             * self.block_size * cfg.head_dim)
        return n * torch.empty((), dtype=self.dtype).element_size()

    def stats(self) -> dict:
        with self._lock:
            free = len(self._free)
        shards = self.heads_shards
        return {
            "block_size": self.block_size,
            # block counts are the same on every tp rank (heads are what
            # is split): the admission budget and each rank's count
            "blocks_total": self.n_blocks,
            "blocks_per_device": self.n_blocks,
            "blocks_free": free,
            "blocks_used": self.n_blocks - free,
            "max_seq": self.max_seq,
            "bytes_total": self.bytes_total(),
            "bytes_per_device": self.bytes_total() // shards,
            "tp_shards": shards,
            "generation": self.generation,
        }


# ---------------------------------------------------------------------------
# radix prefix index


class _TrieNode:
    __slots__ = ("key", "block", "n_valid", "children", "parent", "lru")

    def __init__(self, key, block, n_valid, parent):
        self.key = key            # tuple of tokens (len == block_size for
        #                           interior/full nodes, < for tail leaves)
        self.block = block        # pool block id holding these tokens' KV
        self.n_valid = n_valid    # valid token count in the block
        self.children: dict = {}
        self.parent = parent
        self.lru = 0


class RadixIndex:
    """Trie over cached prompt prefixes, keyed on block-sized token
    chunks; holds one pool reference per cached block.

    * ``insert(tokens, block_ids)`` caches a request's prefix chain: full
      blocks become interior nodes, a partial tail a leaf.  Chunks
      already cached dedupe to the existing node.
    * ``match(prompt)`` returns the longest cached chain that prefixes
      the prompt, capped at ``len(prompt) - 1`` tokens so at least one
      token runs prefill.  Matched blocks are increfed for the caller.
    * ``evict(n)`` drops unreferenced leaves LRU-first.

    Single-threaded: called only from the engine loop thread."""

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self.bs = pool.block_size
        self.root = _TrieNode((), 0, 0, None)
        self._clock = 0
        self._nodes = 0

    def _touch(self, node: _TrieNode) -> None:
        self._clock += 1
        while node is not None and node is not self.root:
            node.lru = self._clock
            node = node.parent

    @property
    def cached_blocks(self) -> int:
        return self._nodes

    def match(self, prompt: np.ndarray) -> tuple:
        """(block_ids, n_tokens): the adopted chain, blocks increfed.
        The caller decrefs each id when done (release or CoW)."""
        bs = self.bs
        n = len(prompt)
        node, ids, matched = self.root, [], 0
        while matched + bs < n:        # full block AND >= 1 token left over
            key = tuple(int(t) for t in prompt[matched:matched + bs])
            child = node.children.get(key)
            if child is None or child.n_valid != bs:
                break
            ids.append(child.block)
            matched += bs
            node = child
        # partial tail leaves: the longest whose whole content prefixes
        # the rest of the prompt (still leaving >= 1 token for prefill)
        best = None
        for key, child in node.children.items():
            m = len(key)
            if m >= bs or m >= n - matched:
                continue
            if tuple(int(t) for t in prompt[matched:matched + m]) != key:
                continue
            if best is None or m > len(best.key):
                best = child
        if best is not None:
            ids.append(best.block)
            matched += len(best.key)
            node = best
        for bid in ids:
            self.pool.incref(bid)
        if node is not self.root:
            self._touch(node)
        return ids, matched

    def insert(self, tokens: np.ndarray, block_ids: list) -> None:
        """Cache the chain for ``tokens`` backed by ``block_ids`` (the
        request's table, in order).  Kept blocks gain a trie reference;
        chunks already cached dedupe and the caller's copy is not kept."""
        bs = self.bs
        n = len(tokens)
        node = self.root
        for i in range(n // bs):
            key = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                bid = block_ids[i]
                child = _TrieNode(key, bid, bs, node)
                node.children[key] = child
                self.pool.incref(bid)
                self._nodes += 1
            node = child
        j = n % bs
        if j:
            key = tuple(int(t) for t in tokens[n - j:])
            if key not in node.children:
                bid = block_ids[n // bs]
                leaf = _TrieNode(key, bid, j, node)
                node.children[key] = leaf
                self.pool.incref(bid)
                self._nodes += 1
                node = leaf
        self._touch(node)

    def _leaves(self) -> list:
        out, stack = [], [self.root]
        while stack:
            node = stack.pop()
            kids = list(node.children.values())
            if not kids and node is not self.root:
                out.append(node)
            stack.extend(kids)
        return out

    def evict(self, n: int) -> int:
        """Free up to ``n`` blocks by dropping unreferenced cached
        prefixes, LRU-first, leaves-up; returns the blocks freed.  One
        trie walk seeds a heap of evictable leaves, and evicting a leaf
        pushes its parent when that exposes it."""
        freed = 0
        heap = [(leaf.lru, id(leaf), leaf) for leaf in self._leaves()
                if self.pool.refcount(leaf.block) == 1]
        heapq.heapify(heap)
        while heap and freed < n:
            _, _, node = heapq.heappop(heap)
            # an entry may be stale (re-referenced since the walk)
            if (node.children
                    or node.parent.children.get(node.key) is not node
                    or self.pool.refcount(node.block) != 1):
                continue
            del node.parent.children[node.key]
            self.pool.decref(node.block)
            self._nodes -= 1
            freed += 1
            p = node.parent
            if (p is not self.root and not p.children
                    and self.pool.refcount(p.block) == 1):
                heapq.heappush(heap, (p.lru, id(p), p))
        return freed

    def clear(self) -> None:
        """Drop the whole index without touching refcounts; used only
        after ``BlockPool.reset()``, which already zeroed them."""
        self.root = _TrieNode((), 0, 0, None)
        self._nodes = 0
