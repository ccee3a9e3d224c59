"""The rank side of a tensor-parallel engine: ``TPExecutor``.

The JAX package's engine is one controller over its mesh: XLA runs each
step on every device of it.  A torch mesh is SPMD: every rank must run
every step body and every pool update, in the same order, on the same
host inputs.  So a meshed ``InferenceEngine`` keeps its one scheduler
and loop thread, and hands each body call and each pool update to an
executor as (engine name, operation, inputs).  Every rank runs it on its
own shards of that engine's params and pool (Megatron tensor
parallelism, ``decode.TPShard``), and rank 0's result goes back to the
loop thread: the whole logits, which the engine samples on the host.

Two kinds of world run the same rank loop (``_rank_loop``):

  * threaded ranks: ``mesh`` is the axes of a mesh, ``{"tp": n}`` or a
    ``MeshSpec``.  ``run_ranks`` starts n ranks as threads of this
    process for the executor's life, on the engine's device (the CPU in
    tests, one card on the chip).  Each rank reads its operations from
    a queue of its own, filled in one order under one lock.  The
    threaded process group is process-wide: one such executor at a
    time, and ``executor_for`` raises for a second mesh rather than
    hang.
  * a process world: ``mesh`` is a ``DeviceMesh`` of the caller's world
    and this process is tp rank 0 of it.  Its rank loop runs on a thread
    of this process and broadcasts each operation over the tp group
    (``broadcast_object_list``) to the other processes, which run
    ``serve_rank(mesh)``.

Each rank keeps its state per engine name, so the variants of one
multiplexed ``GPTServer`` share one set of ranks, as the JAX variants
share one mesh.  The executor stops when its last engine closes.

Failures: an operation that raises on every rank (a step failure) fails
that call and the ranks serve on; the engine then fails its in-flight
requests and resets every rank's pool.  A rank that dies, or that
raises while the others wait for it in a collective, stops every rank
(threaded ranks are woken from their collectives): every call then
raises ``TPRanksDead`` and the engine fails closed, never hung.  Only
rank threads wake the others: a dead rank's thread as it ends
(``run_ranks``), or a rank that reads the stop sentinel ``_WAKE``.  A
caller's thread waking them, as the ranks unwound, corrupted the heap
under load (a segfault in the garbage collector).

The paged engine and the slot engine run here alike: the slot engine's
ranks hold its slot cache split over heads (``cache.SlotShard``), write a
prompt's K/V from the mesh prefill into a slot and run the dense step
(``decode.make_decode_step(tp=)``).

Only the tp axis is ported: a serving mesh on which another axis is
larger than 1 raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.inference.cache import KVShard, SlotShard, host_kv
from ray_tpu_torch.inference.decode import (POOL_AXES, TPShard,
                                            make_chunk_prefill_fn,
                                            make_decode_step,
                                            make_paged_decode_step,
                                            make_paged_draft_step,
                                            make_spec_verify_step)
from ray_tpu_torch.models import gpt
from ray_tpu_torch.models.gpt import GPTConfig
from ray_tpu_torch.parallel import spmd
from ray_tpu_torch.parallel.collectives import allgather
from ray_tpu_torch.parallel.mesh import MeshSpec, create_mesh, mesh_shape
from ray_tpu_torch.parallel.sharding import Rules, sharding_for
from ray_tpu_torch.parallel.threaded import (run_ranks,
                                             waiting_outside_collectives,
                                             wake_collectives)
from ray_tpu_torch.serve.qos import ReplicaDeadError

# how long the other ranks have to fail alike once one rank's operation
# raised; after it the ranks are stopped (they would wait in a
# collective the failed rank never joins)
FAILURE_GRACE_S = 30.0
# the stop sentinel on which a threaded rank first wakes the ranks waiting
# in a collective (``TPExecutor._died``)
_WAKE = object()


class TPRanksDead(ReplicaDeadError):
    """The executor's ranks stopped: a rank died, or failed alone while
    the others waited for it.  The engine fails closed."""


def serving_axes(mesh) -> dict:
    """``{axis: size}`` of a serving mesh: a dict, a ``MeshSpec`` or a
    ``DeviceMesh``.  Raises ``NotImplementedError`` for anything else and
    when an axis other than tp is larger than 1 (only tp serving is
    ported)."""
    if hasattr(mesh, "mesh_dim_names"):          # a DeviceMesh
        axes = mesh_shape(mesh)
    elif isinstance(mesh, (dict, MeshSpec)):
        axes = dict(mesh.axes if isinstance(mesh, MeshSpec) else mesh)
        if any(int(v) < 1 for v in axes.values()):
            raise ValueError(f"serving mesh {axes}: every axis needs a "
                             "size >= 1 (no -1 fill: the ranks are made "
                             "here)")
    else:
        raise NotImplementedError(
            f"serving on a {type(mesh).__name__}: a serving mesh is the "
            f"axes of a tp mesh (a dict or MeshSpec) or a DeviceMesh")
    other = {a: int(n) for a, n in axes.items() if a != "tp" and int(n) > 1}
    if other:
        raise NotImplementedError(
            f"serving on a mesh with {other}: only the tp-sharded paged "
            f"decode and slot decode are ported (tensor-parallel "
            f"serving); dp, sp, pp and ep serving meshes are not")
    return {a: int(n) for a, n in axes.items()}


def mesh_device(mesh, device=None) -> torch.device:
    """The device a serving mesh's ranks run on: a ``DeviceMesh``'s own
    (this process's card, or the CPU), else ``device`` (None: the
    card)."""
    if not isinstance(mesh, DeviceMesh):
        return resolve_device(device)
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# -- the ranks' shards -----------------------------------------------------

def _span(mesh: DeviceMesh, rules: Rules, axes, shape, dim) -> tuple:
    return spmd.local_span(shape, mesh, sharding_for(axes, rules, mesh), dim)


def local_params(params: dict, cfg: GPTConfig, mesh: DeviceMesh,
                 rules: Rules) -> tuple:
    """(this rank's params for the step bodies, its ``TPShard``), cut from
    whole ``params`` as the rules split "heads", "mlp" and "vocab" over
    tp.  Views where the block is one: each rank's wqkv holds the q, k
    and v columns of its own heads (a copy), wo and w_down the rows of
    its heads and of its block of the hidden dim, w_up and b_up those
    columns, and ``w_head`` [d, V/tp] its block of the vocab of the tied
    embedding (or of lm_head).  The embedding tables stay whole."""
    L, d, h, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim
    f, V = cfg.d_ff, cfg.vocab_size
    h0, hl = _span(mesh, rules, POOL_AXES, (L, 1, h, 1, hd), 2)
    f0, fl = _span(mesh, rules, ("embed", "mlp"), (d, f), 1)
    v0, vl = _span(mesh, rules, ("vocab", "embed"), (V, d), 0)
    lay = dict(params["layers"])
    if hl < h:
        lay["wqkv"] = lay["wqkv"].reshape(L, d, 3, h, hd)[
            :, :, :, h0:h0 + hl].reshape(L, d, 3 * hl * hd)
        lay["wo"] = lay["wo"][:, h0 * hd:(h0 + hl) * hd]
    if fl < f:
        lay["w_up"] = lay["w_up"][..., f0:f0 + fl]
        lay["b_up"] = lay["b_up"][..., f0:f0 + fl]
        lay["w_down"] = lay["w_down"][..., f0:f0 + fl, :]
    head = (params["wte"][v0:v0 + vl].T if cfg.tie_embeddings
            else params["lm_head"][:, v0:v0 + vl])
    local = {"wte": params["wte"], "wpe": params["wpe"],
             "ln_f_scale": params["ln_f_scale"],
             "ln_f_bias": params["ln_f_bias"], "w_head": head,
             "layers": lay}
    return local, TPShard(mesh, hl, hl < h, fl < f, vl < V)


class _EngineState:
    """One engine's state on one rank: its params (whole, placed as
    DTensors for the prefill, and the rank's shards for the bodies), its
    cache shard (``pool``: a ``KVShard`` of the paged pool, or a
    ``SlotShard`` of the slot cache) and its step bodies."""

    def __init__(self, mesh: DeviceMesh, cfg: GPTConfig, params: dict,
                 rules: Rules, geometry: dict):
        self.cfg, self.mesh, self.rules = cfg, mesh, rules
        self.dparams = spmd.place_tree(params, gpt.param_logical_axes(cfg),
                                       rules, mesh)
        self.params, self.tp = local_params(params, cfg, mesh, rules)
        L, h, hd = cfg.n_layers, cfg.n_heads, cfg.head_dim
        self.heads = _span(mesh, rules, POOL_AXES, (L, 1, h, 1, hd), 2)
        self.pool = None
        tp = self.tp
        if geometry.get("slots"):
            # the slot engine: one dense step over every slot's stripe
            self.bodies = {"step": make_decode_step(cfg, tp=tp)}
            return
        bs, T = geometry["block_size"], geometry["n_table"]
        self.bodies = {
            "step": make_paged_decode_step(cfg, block_size=bs, n_table=T,
                                           tp=tp),
            "chunk": make_chunk_prefill_fn(cfg, chunk=geometry["chunk"],
                                           block_size=bs, n_table=T, tp=tp)}
        if geometry.get("width"):
            self.bodies["verify"] = make_spec_verify_step(
                cfg, width=geometry["width"], block_size=bs, n_table=T,
                tp=tp)
        if geometry.get("draft_layers"):
            self.bodies["draft"] = make_paged_draft_step(
                cfg, draft_layers=geometry["draft_layers"],
                k=geometry["width"] - 1, block_size=bs, n_table=T, tp=tp)


class RankContext:
    """What an operation sees on a rank: its tp index, its mesh, its
    device and its engines' states by name."""

    def __init__(self, rank: int, mesh: DeviceMesh, device):
        self.rank, self.mesh, self.device = rank, mesh, device
        self.engines: dict = {}


def _op_open(ctx: RankContext, name, cfg, params, rules, geometry):
    st = ctx.engines[name] = _EngineState(ctx.mesh, cfg, params, rules,
                                          geometry)
    return st.heads[1]


def _op_close(ctx: RankContext, name):
    ctx.engines.pop(name, None)


def _op_pool_zeros(ctx: RankContext, name, n_blocks, block_size, dtype):
    st = ctx.engines[name]
    st.pool = KVShard(st.cfg, n_blocks, block_size, dtype, ctx.device,
                      heads=st.heads)


def _op_slots_zeros(ctx: RankContext, name, n_slots, max_seq, dtype):
    st = ctx.engines[name]
    st.pool = SlotShard(st.cfg, n_slots, max_seq, dtype, ctx.device,
                        heads=st.heads)


def _op_pool(ctx: RankContext, name, method, *args):
    return getattr(ctx.engines[name].pool, method)(*args)


def _op_pool_read(ctx: RankContext, name, ids):
    """Full-width host K/V of blocks ``ids`` (of slots ``ids`` for a slot
    cache; rank 0 returns them): each rank gathers its heads, then the
    heads are gathered over tp."""
    st = ctx.engines[name]
    kv = st.pool.read_blocks(ids)                  # [2, L, T, hl, bs, hd]
    if st.tp.split_heads:
        kv = allgather(kv, "tp", axis=3, mesh=ctx.mesh)
    return host_kv(kv) if ctx.rank == 0 else None


@torch.no_grad()
def _op_prefill(ctx: RankContext, name, table, tokens, n: int):
    """The full-width prefill on the mesh (``gpt.forward(mesh=,
    return_kv=True)``): every rank writes its heads of the K/V through
    the table into its pool shard (into slot ``table`` of a slot cache),
    never gathered; returns the last-position logits [V], gathered over
    tp."""
    st = ctx.engines[name]
    tok = DTensor.from_local(tokens, ctx.mesh, (Replicate(),) * ctx.mesh.ndim,
                             run_check=False)
    logits, (k, v) = gpt.forward(st.dparams, tok, st.cfg, mesh=ctx.mesh,
                                 rules=st.rules, return_kv=True)
    st.pool.write_prefill(table, k.to_local()[:, 0], v.to_local()[:, 0])
    last = logits.to_local()[0, n - 1]
    if st.tp.split_vocab:
        last = allgather(last, "tp", axis=0, mesh=ctx.mesh)
    return last


def _op_body(ctx: RankContext, name, body, *args):
    st = ctx.engines[name]
    return st.bodies[body](st.params, st.pool.k, st.pool.v, *args)


def _op_call(ctx: RankContext, fn, *args):
    return fn(ctx, *args)


_OPS = {"open": _op_open, "close": _op_close, "pool_zeros": _op_pool_zeros,
        "slots_zeros": _op_slots_zeros, "pool": _op_pool,
        "pool_read": _op_pool_read, "prefill": _op_prefill, "body": _op_body,
        "call": _op_call}


# -- the executor ------------------------------------------------------------

class _Call:
    """One operation's mailbox: a result or an error from each rank that
    posts (every rank of a threaded world; rank 0 in a process world)."""

    def __init__(self):
        self.results: dict = {}
        self.errors: dict = {}

    def posted(self) -> int:
        return len(self.results) + len(self.errors)


class TPExecutor:
    """The tp ranks that run meshed engines' bodies and pool updates (the
    module note).  ``mesh``: the axes of a threaded mesh, or a
    ``DeviceMesh`` of the caller's world of which this process is tp
    rank 0.  ``device``: the threaded ranks' device (None: the card)."""

    def __init__(self, mesh, *, device=None):
        axes = serving_axes(mesh)
        self.mesh_axes = axes
        self.mesh_devices = math.prod(axes.values())
        self.tp = axes.get("tp", 1)
        self._cond = threading.Condition()
        self._error: Optional[BaseException] = None
        self._engines: set = set()
        self._closed = False
        self.threaded = not isinstance(mesh, DeviceMesh)
        self.device = mesh_device(mesh, device)
        if self.threaded:
            self._inboxes = [queue.Queue() for _ in range(self.tp)]
            target = self._run_threaded
        else:
            if mesh_shape(mesh).get("tp", 1) > 1 \
                    and mesh.get_local_rank("tp") != 0:
                raise ValueError("the engine runs on tp rank 0 of a "
                                 "process world; the others run "
                                 "serve_rank(mesh)")
            self._inboxes = [queue.Queue()]
            target = self._run_process
        self._mesh = mesh
        self._thread = threading.Thread(target=target, daemon=True,
                                        name="ray_tpu_torch-tp-executor")
        self._thread.start()

    # ---- the worlds

    def _run_threaded(self) -> None:
        axes = dict(self.mesh_axes)

        def rank(r: int):
            mesh = create_mesh(axes, device=self.device)
            ctx = RankContext(r, mesh, self.device)
            _rank_loop(ctx, lambda: self._recv(r), self._post, self._died)

        try:
            run_ranks(rank, self.tp, timeout=None)
        except Exception as e:           # a rank's error: the callers get it
            self._died(e, wake=False)        # every rank has ended
        self._died(TPRanksDead("the tp executor stopped"), wake=False)

    def _run_process(self) -> None:
        mesh = self._mesh
        if mesh.device_type == "cuda":
            torch.cuda.set_device(self.device)
        ctx = RankContext(0, mesh, self.device)
        try:
            _rank_loop(ctx, self._process_recv(mesh), self._post,
                       self._died)
        except Exception:                # the loop gave it to the callers
            pass
        self._died(TPRanksDead("the tp executor stopped"), wake=False)

    def _recv(self, r: int):
        with waiting_outside_collectives():
            return self._inboxes[r].get()

    def _process_recv(self, mesh: DeviceMesh) -> Callable:
        group = _tp_group(mesh)

        def recv():
            cmd = self._inboxes[0].get()
            if group is not None:
                # the other ranks get the operation without its mailbox
                wire = [None if cmd is None else (None,) + tuple(cmd[1:])]
                dist.broadcast_object_list(
                    wire, src=dist.get_global_rank(group, 0), group=group)
            return cmd
        return recv

    # ---- posting and failing

    def _post(self, call: Optional[_Call], rank: int, result=None,
              error: Optional[BaseException] = None) -> None:
        if call is None:
            return
        with self._cond:
            if error is not None:
                call.errors[rank] = error
            else:
                call.results[rank] = result
            self._cond.notify_all()

    def _died(self, error: BaseException, wake: bool = True) -> None:
        """The ranks stop: record why (the first reason), wake every
        waiting caller and send every rank still reading its queue the stop
        sentinel; with ``wake``, ``_WAKE``, on which a threaded rank stops
        the ranks waiting in a collective (for one that will never join
        them) from its own thread."""
        with self._cond:
            if self._error is None:
                self._error = error
            self._cond.notify_all()
        stop = _WAKE if wake and self.threaded else None
        for box in self._inboxes:
            box.put(stop)

    @property
    def alive(self) -> bool:
        return self._error is None

    # ---- calls

    def run_all(self, name: Optional[str], op: str, *args) -> list:
        """Run ``op`` on every rank; the posting ranks' results in rank
        order, or the first rank's error raised here.  ``TPRanksDead``
        once the ranks stopped."""
        posting = self.tp if self.threaded else 1
        call = _Call()
        cmd = (call, name, op, args)
        with self._cond:
            if self._error is not None:
                raise TPRanksDead(f"tp ranks stopped: {self._error}") \
                    from self._error
            # one order on every rank's queue
            for box in self._inboxes:
                box.put(cmd)
            deadline = None
            while call.posted() < posting and self._error is None:
                if call.errors and deadline is None:
                    deadline = time.monotonic() + FAILURE_GRACE_S
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if left is not None and left <= 0:
                    # a rank failed alone: the others wait in a
                    # collective it will never join
                    r = min(call.errors)
                    self._error = TPRanksDead(
                        f"rank {r} failed while the others ran on: "
                        f"{call.errors[r]!r}")
                    self._cond.notify_all()
                    break
                self._cond.wait(left)
            error = self._error if call.posted() < posting else None
        if error is not None:
            self._died(error)
            raise TPRanksDead(f"tp ranks stopped: {error}") from error
        if call.errors:
            raise call.errors[min(call.errors)]
        return [call.results[r] for r in sorted(call.results)]

    def run(self, name: Optional[str], op: str, *args):
        """Rank 0's result of ``op`` (``run_all``)."""
        return self.run_all(name, op, *args)[0]

    def on_ranks(self, fn: Callable, *args) -> list:
        """``fn(ctx, *args)`` on every rank (``ctx`` a ``RankContext``):
        the posting ranks' results.  For inspection and measurement."""
        return self.run_all(None, "call", fn, *args)

    # ---- engines

    def open(self, name: str, cfg: GPTConfig, params: dict, rules: Rules,
             geometry: dict) -> "EngineRanks":
        """Open engine ``name`` on every rank: its params (whole tensors,
        each rank cutting its shards) and step bodies for ``geometry``:
        the paged engine's (``block_size``, ``n_table``, ``chunk``, and
        for speculation ``width`` and ``draft_layers``), or the slot
        engine's (``slots`` and the cache width ``max_seq``)."""
        with self._cond:
            if self._closed:
                raise TPRanksDead("the tp executor is shut down")
            if name in self._engines:
                raise ValueError(f"engine {name!r} is open on these ranks "
                                 f"already")
            self._engines.add(name)
        try:
            for what, n in (("n_heads", cfg.n_heads), ("d_ff", cfg.d_ff),
                            ("vocab_size", cfg.vocab_size)):
                if n % self.tp:
                    raise ValueError(f"{what} {n} is not divisible by tp "
                                     f"{self.tp}")
            heads = self.run(name, "open", cfg, params, rules, geometry)
        except BaseException:
            self._release(name)
            raise
        return EngineRanks(self, name, cfg.n_heads // heads)

    def _release(self, name: str) -> None:
        with self._cond:
            self._engines.discard(name)
            last = not self._engines
        if last:
            self.shutdown()

    def close(self, name: str) -> None:
        """Drop engine ``name``'s state from every rank; the executor
        shuts down with its last engine."""
        with self._cond:
            if name not in self._engines:
                return
        try:
            if self.alive:
                self.run(name, "close")
        finally:
            self._release(name)

    def shutdown(self) -> None:
        """Stop every rank and join them (idempotent)."""
        with self._cond:
            self._closed = True
        _unregister(self)
        self._died(TPRanksDead("the tp executor is shut down"), wake=False)
        if threading.current_thread() is not self._thread:
            self._thread.join()


class EngineRanks:
    """One engine's handle on its executor's ranks (``BlockPool(mesh=)``
    and the engine call through it); ``heads_shards`` is the number of
    blocks the rules split the heads into (tp, or 1)."""

    def __init__(self, executor: TPExecutor, name: str, heads_shards: int):
        self.executor, self.name = executor, name
        self.heads_shards = heads_shards

    @property
    def alive(self) -> bool:
        return self.executor.alive

    def run(self, op: str, *args):
        return self.executor.run(self.name, op, *args)

    def body(self, body: str) -> Callable:
        """A step body's caller with the one-device signature: ``(params,
        k_pool, v_pool, *inputs)``, the first three ignored (the ranks
        hold them)."""
        def call(_params, _k, _v, *inputs):
            return self.executor.run(self.name, "body", body, *inputs)
        call.__name__ = f"tp_{body}"
        return call

    def close(self) -> None:
        self.executor.close(self.name)


def _rank_loop(ctx: RankContext, recv: Callable, post: Callable,
               died: Callable) -> None:
    """A rank's life: run each operation it receives until a stop
    sentinel (None, or ``_WAKE``: wake the ranks waiting in a collective
    first).  An operation's error is posted to its caller and the rank
    reads on; anything that ends the loop otherwise stops every rank
    (``died``)."""
    try:
        while True:
            cmd = recv()
            if cmd is _WAKE:
                wake_collectives()
                return
            if cmd is None:
                return
            call, name, op, args = cmd
            # a process world's tensors arrive on the sender's device
            args = [spmd.tree_map(lambda t: t.to(ctx.device)
                                  if isinstance(t, torch.Tensor) else t, a)
                    for a in args]
            try:
                if name is None:
                    out = _OPS[op](ctx, *args)
                else:
                    out = _OPS[op](ctx, name, *args)
            except Exception as e:           # noqa: BLE001 (posted)
                post(call, ctx.rank, error=e)
            else:
                post(call, ctx.rank, result=out)
    except BaseException as e:
        died(e)
        raise


def _tp_group(mesh: DeviceMesh):
    """The tp process group of a process world, None with one rank."""
    if mesh_shape(mesh).get("tp", 1) < 2:
        return None
    return mesh.get_group(mesh.mesh_dim_names.index("tp"))


def serve_rank(mesh: DeviceMesh, device=None) -> None:
    """The life of tp rank r > 0 of a process world: receive each
    operation that rank 0 broadcasts over the tp group and run it on this
    rank's shards, until rank 0's executor shuts down."""
    group = _tp_group(mesh)
    if group is None or mesh.get_local_rank("tp") == 0:
        raise ValueError("serve_rank runs on tp ranks > 0 of a process "
                         "world; rank 0 runs the engine")
    dev = resolve_device(device)
    ctx = RankContext(mesh.get_local_rank("tp"), mesh, dev)

    def recv():
        wire = [None]
        dist.broadcast_object_list(
            wire, src=dist.get_global_rank(group, 0), group=group)
        return wire[0]

    _rank_loop(ctx, recv, lambda *a, **k: None, lambda e: None)


# -- one executor per process ----------------------------------------------

_executor: Optional[TPExecutor] = None
_executor_key: Any = None
_registry_lock = threading.Lock()


def _key(mesh) -> Any:
    if isinstance(mesh, DeviceMesh):
        return ("world", id(mesh))
    return ("threads", tuple(sorted(serving_axes(mesh).items())))


def executor_for(mesh, *, device=None) -> TPExecutor:
    """The process's executor for ``mesh``, started on first use.  A
    live executor for another mesh raises: the threaded process group is
    process-wide."""
    global _executor, _executor_key
    key = _key(mesh)
    with _registry_lock:
        ex = _executor
        if ex is not None and not ex.alive:
            ex._thread.join()            # its world is torn down first
        elif ex is not None and not ex._closed:
            if key != _executor_key or (ex.threaded and resolve_device(
                    device) != ex.device):
                raise RuntimeError(
                    f"a tp executor for {ex.mesh_axes} on {ex.device} is "
                    f"running in this process; one at a time (the "
                    f"threaded process group is process-wide)")
            return ex
        _executor = TPExecutor(mesh, device=device)
        _executor_key = key
        return _executor


def _unregister(ex: TPExecutor) -> None:
    global _executor, _executor_key
    with _registry_lock:
        if _executor is ex:
            _executor = _executor_key = None


__all__ = ["TPExecutor", "EngineRanks", "TPRanksDead", "RankContext",
           "executor_for", "local_params", "serve_rank", "serving_axes"]
