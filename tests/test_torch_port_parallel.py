"""The port's parallel layer against the JAX package on the CPU.

The port's ranks run as threads of this process (``_torch_port_ranks``),
the JAX package's on the 8-device CPU mesh of tests/conftest.py; the same
numpy inputs (from a seed) go through both, in f32.

- ``MeshSpec.resolved`` over a table of specs, the -1 fill and the
  errors included; ``mesh_shape``, ``data_axes`` and ``spec_for`` over
  every leaf of GPT's (dense) and BERT's logical axes, on dp2.tp4,
  dp2.sp4, dp2.fsdp2.tp2 and dcn2.dp2.tp2; ``infer_param_logical_axes``
  on GPT's params.
- ``shard_batch``: each rank's rows are the rows of JAX's addressable
  shard on the device at the same mesh position (dp2.fsdp2.tp2,
  dcn2.dp2.tp2).
- The in-mesh collectives under ``shard_fn`` on 4 ranks against the
  JAX package's under ``shard_map``.
- Ring attention on 4 sp ranks, forward and gradients, against JAX's
  ``mha_reference`` at tests/test_ops.py's sizes and tolerance; the
  causal case, in which every rank but the last holds fully masked kv
  blocks, stays finite.
- GPT's loss on dp2.tp4 and dp2.sp4 and BERT's on dp2.tp4 against the JAX
  package's ``loss_fn(..., mesh=)`` at tests/test_models.py's shapes,
  rtol 1e-4, params entering through ``params_from_numpy(..., mesh=)``
  and gathered back bit-exact.
- On a dp2.tp2 mesh with remat "dots", each rank runs the flash op as
  often a step as one device does (the counts of the kernels on the
  card), at its local [b/2, h/2, s, hd] shape.
- The mesh arms not ported (the prefill on a mesh, Trainer on a mesh,
  the tp-sharded paged decode) raise ``NotImplementedError``; the rank
  helper fails on a rank's exception and on a hung rank.

The training trajectories are in tests/test_torch_port_parallel_train.py
and tests/test_torch_port_parallel_hybrid.py (each file stays under 20 s
alone)."""

import importlib
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from _torch_port_ranks import jax_mesh, port_mesh, ranks, world
from _torch_port_trees import weights
from ray_tpu.models import bert as jbert
from ray_tpu.models import gpt as jgpt
from ray_tpu.ops.attention import mha_reference as jmha_reference
from ray_tpu.parallel import collectives as jcoll
from ray_tpu.parallel.jax_compat import shard_map
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.parallel.mesh import batch_sharding as jbatch_sharding
from ray_tpu.parallel.mesh import data_axes as jdata_axes
from ray_tpu.parallel.mesh import mesh_shape as jmesh_shape
from ray_tpu.parallel.sharding import DEFAULT_LLM_RULES as JRULES
from ray_tpu.parallel.sharding import spec_for as jspec_for
from ray_tpu_torch.models import bert as tbert
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.parallel import (DEFAULT_LLM_RULES, MeshSpec, RankError,
                                    collectives, create_mesh, data_axes,
                                    mesh_shape, run_ranks, spec_for)
from ray_tpu_torch.train.step import shard_batch

port_flash = importlib.import_module("ray_tpu_torch.ops.flash_attention")

RING_TOL = dict(atol=2e-4, rtol=2e-4)      # tests/test_ops.py on the CPU


def _leaves_with_axes(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves_with_axes(v, prefix + k + ".")
        else:
            yield prefix + k, v


# -- meshes and specs ----------------------------------------------------------

SPECS = [({"dp": -1}, 8), ({"dp": 2, "tp": -1}, 8), ({"tp": 4, "dp": 2}, 8),
         ({"sp": 2, "fsdp": 2, "dp": -1}, 8), ({"dp": 1, "tp": 1}, 1),
         ({"tp": 1}, 4), ({"x": 2, "dp": 2}, 4), ({}, 4),
         ({"dp": -1, "tp": -1}, 8), ({"dp": 3, "tp": -1}, 8),
         ({"dp": 2, "tp": 2}, 8)]


@pytest.mark.parametrize("axes,n", SPECS)
def test_meshspec_resolved_matches_jax(axes, n):
    try:
        want = JMeshSpec(dict(axes)).resolved(n)
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc)[:20]):
            MeshSpec(dict(axes)).resolved(n)
        return
    got = MeshSpec(dict(axes)).resolved(n)
    assert list(got.items()) == list(want.items())


@pytest.mark.parametrize("name", ["dp2_tp4", "dp2_sp4", "dp2_fsdp2_tp2",
                                  "dcn2_dp2_tp2"])
def test_mesh_and_specs_match_jax(name):
    logical = {"gpt": tgpt.param_logical_axes(tgpt.GPTConfig.tiny()),
               "bert": tbert.param_logical_axes(tbert.BERTConfig.tiny())}

    def rank(r):
        mesh = port_mesh(name)
        return (mesh_shape(mesh), data_axes(mesh),
                {m: {leaf: spec_for(axes, DEFAULT_LLM_RULES, mesh)
                     for leaf, axes in _leaves_with_axes(tree)}
                 for m, tree in logical.items()})

    got = ranks(rank, world(name))
    assert all(g == got[0] for g in got)
    shape, axes, specs = got[0]
    jmesh = jax_mesh(name)
    assert list(shape.items()) == list(jmesh_shape(jmesh).items())
    assert axes == jdata_axes(jmesh)
    jlogical = {"gpt": jgpt.param_logical_axes(jgpt.GPTConfig.tiny()),
                "bert": jbert.param_logical_axes(jbert.BERTConfig.tiny())}
    for m, tree in jlogical.items():
        want = {leaf: tuple(jspec_for(a, JRULES, jmesh))
                for leaf, a in _leaves_with_axes(tree)}
        assert specs[m] == want, m


def test_a_mesh_spans_the_world():
    """Every rank of the world must be in the mesh (each creates every
    mesh dim's groups): fewer ranks than the world raise, where the JAX
    package takes a prefix of its devices."""
    def rank(r):
        with pytest.raises(ValueError, match="need 2 devices, have 4"):
            create_mesh({"dp": 2}, device="cpu")
        return mesh_shape(create_mesh({"dp": 2, "tp": -1}, device="cpu"))

    assert ranks(rank, 4) == [{"dp": 2, "tp": 2}] * 4


def test_infer_param_logical_axes_matches_jax():
    from ray_tpu.parallel.sharding import infer_param_logical_axes as jinfer
    from ray_tpu_torch.parallel import infer_param_logical_axes

    tree = weights(jgpt.init_params, jgpt.GPTConfig.tiny(), 0)
    got = infer_param_logical_axes(convert.params_from_numpy(tree, "cpu"))
    assert dict(_leaves_with_axes(got)) == dict(
        _leaves_with_axes(jinfer(tree)))


@pytest.mark.parametrize("name", ["dp2_fsdp2_tp2", "dcn2_dp2_tp2"])
def test_shard_batch_rows_match_jax(name):
    rows = np.arange(8 * 3, dtype=np.int32).reshape(8, 3)

    def rank(r):
        got = shard_batch({"tokens": rows, "n": np.int32(5)}, port_mesh(name))
        return got["tokens"].to_local().numpy(), int(got["n"].to_local())

    got = ranks(rank, world(name))
    jmesh = jax_mesh(name)
    arr = jax.device_put(rows, jbatch_sharding(jmesh))
    by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    for r, (local, n) in enumerate(got):
        np.testing.assert_array_equal(local, by_device[jmesh.devices.flat[r]])
        assert n == 5


# -- collectives and ring attention --------------------------------------------

def test_collectives_match_shard_map():
    """Each collective on 4 ranks; rank r's result against the r-th block
    of the JAX package's ``shard_map`` result (out spec P("dp"))."""
    x = np.random.default_rng(0).uniform(0.5, 1.5, (16, 3)).astype(np.float32)
    perm = jcoll.ring_perm(4)

    def ops(c, a):
        return {"sum": c.allreduce(a, "dp"), "mean": c.allreduce(a, "dp", "mean"),
                "max": c.allreduce(a, "dp", "max"),
                "min": c.allreduce(a, "dp", "min"),
                "prod": c.allreduce(a, "dp", "prod"),
                "gather": c.allgather(a, "dp", axis=1),
                "stack": c.allgather(a, "dp", axis=0, tiled=False)[0],
                "scatter": c.reducescatter(a, "dp", axis=0),
                "bcast": c.broadcast(a, "dp", root=1),
                "permute": c.permute(a, "dp", perm)}

    jm = jax.sharding.Mesh(np.array(jax.devices("cpu")[:4]), ("dp",))
    keys = ["sum", "mean", "max", "min", "prod", "gather", "stack",
            "scatter", "bcast", "permute"]
    want = jax.jit(shard_map(
        lambda a: tuple(ops(jcoll, a)[k] for k in keys), mesh=jm,
        in_specs=P("dp"), out_specs=(P("dp"),) * len(keys),
        check_vma=False))(x)
    want = dict(zip(keys, (np.asarray(w) for w in want)))

    def rank(r):
        mesh = create_mesh({"dp": 4}, device="cpu")
        spec = ("dp", None)
        run = collectives.shard_fn(mesh, (spec,), [spec] * len(keys))(
            lambda a: tuple(ops(collectives, a)[k] for k in keys))
        from ray_tpu_torch.parallel.sharding import local_shard, placements_for
        out = run(local_shard(torch.from_numpy(x), mesh,
                              placements_for(spec, mesh)))
        return {k: o.to_local().numpy() for k, o in zip(keys, out)}

    got = ranks(rank, 4)
    for k in keys:
        blocks = np.split(want[k], 4, axis=0)
        for r in range(4):
            np.testing.assert_allclose(got[r][k], blocks[r], rtol=1e-6,
                                       atol=1e-6, err_msg=f"{k} rank {r}")
    assert collectives.ring_perm(4) == perm


def _ring(q, k, v, causal, grads):
    """The port's ring attention over 4 sp ranks on numpy q, k, v: the
    output and, with ``grads``, d(sum(out ** 2)) for q, k, v."""
    spec = (None, None, "sp", None)

    def rank(r):
        from ray_tpu_torch.parallel.sharding import local_shard, placements_for
        mesh = create_mesh({"sp": 4}, device="cpu")
        pl = placements_for(spec, mesh)
        qd, kd, vd = (local_shard(torch.from_numpy(a), mesh, pl)
                      .requires_grad_(grads) for a in (q, k, v))
        ring = collectives.shard_fn(mesh, (spec,) * 3, spec)(
            lambda a, b, c: ring_attention(a, b, c, "sp", causal=causal))
        out = ring(qd, kd, vd)
        gs = (torch.autograd.grad((out * out).sum(), [qd, kd, vd])
              if grads else [])
        return [t.full_tensor().detach().numpy() for t in [out, *gs]]

    return ranks(rank, 4)[0]


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_reference(causal):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 2, 256, 32)).astype(np.float32)
               for _ in range(3))
    (out,) = _ring(q, k, v, causal, grads=False)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(jmha_reference(
        q, k, v, causal=causal)), **RING_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_grad(causal):
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((1, 2, 128, 16)).astype(np.float32)
               for _ in range(3))
    got = _ring(q, k, v, causal, grads=True)
    want = jax.jit(jax.grad(lambda *a: jnp.sum(jmha_reference(
        *a, causal=causal) ** 2), argnums=(0, 1, 2)))(q, k, v)
    for g, w in zip(got[1:], want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), **RING_TOL)


# -- model losses ----------------------------------------------------------------

def _gpt_loss_case(name, seq, seed):
    cfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32)
    tree = weights(jgpt.init_params, jcfg, seed)
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, seq + 1)).astype(np.int32)
    jmesh = jax_mesh(name)
    want = float(jax.jit(lambda p, b: jgpt.loss_fn(p, b, jcfg, mesh=jmesh))(
        tree, {"tokens": toks}))

    def rank(r):
        mesh = port_mesh(name)
        params = convert.params_from_numpy(
            tree, mesh=mesh, logical=tgpt.param_logical_axes(cfg))
        loss = tgpt.loss_fn(params, shard_batch({"tokens": toks}, mesh), cfg,
                            mesh=mesh)
        back = convert.params_to_numpy(params)
        return loss.to_local().item(), back

    got = ranks(rank, world(name))
    return tree, want, got


@pytest.mark.parametrize("name,seq", [("dp2_tp4", 32), ("dp2_sp4", 64)])
def test_gpt_loss_on_a_mesh_matches_jax(name, seq):
    tree, want, got = _gpt_loss_case(name, seq, seed=2)
    for loss, _ in got:
        np.testing.assert_allclose(loss, want, rtol=1e-4)
    for leaf, a in _leaves_with_axes(tree):
        b = got[0][1]
        for part in leaf.split("."):
            b = b[part]
        assert a.tobytes() == b.tobytes(), leaf


def test_bert_loss_on_a_mesh_matches_jax():
    name = "dp2_tp4"
    cfg = tbert.BERTConfig.tiny()
    jcfg = jbert.BERTConfig.tiny()
    tree = weights(jbert.init_params, jcfg, 5)
    ids = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = np.where(np.arange(16) % 3 == 0, ids, cfg.ignore_index)
    batch = {"input_ids": ids, "labels": labels.astype(np.int32)}
    jmesh = jax_mesh(name)
    want = float(jax.jit(lambda p, b: jbert.loss_fn(p, b, jcfg, mesh=jmesh))(
        tree, batch))

    def rank(r):
        mesh = port_mesh(name)
        params = convert.params_from_numpy(
            tree, mesh=mesh, logical=tbert.param_logical_axes(cfg))
        loss = tbert.loss_fn(params, shard_batch(batch, mesh), cfg, mesh=mesh)
        return loss.to_local().item()

    for loss in ranks(rank, world(name)):
        np.testing.assert_allclose(loss, want, rtol=1e-4)


# -- the kernels' launches on a mesh ---------------------------------------------

def test_flash_runs_per_rank_at_the_local_shape(monkeypatch):
    """Remat "dots" on dp2.tp2: every rank runs the flash forward 2L and
    its backward L times a step, as one device does, on its [b/2, h/2, s,
    hd] shard.  On the CPU the op runs its plain versions; they are
    counted here per thread."""
    cfg = tgpt.GPTConfig.tiny(dtype=torch.float32, remat=True,
                              remat_policy="dots", attn_impl="flash",
                              attn_block_q=32, attn_block_k=32)
    tree = weights(jgpt.init_params, jgpt.GPTConfig.tiny(), 6)
    toks = np.random.default_rng(6).integers(0, 512, (4, 65)).astype(np.int32)
    calls: list = []
    for name in ("flash_attention_reference",
                 "flash_attention_backward_reference"):
        fn = getattr(port_flash, name)

        def counted(q, *a, _fn=fn, _name=name, **kw):
            import threading
            calls.append((threading.current_thread().name, _name,
                          tuple(q.shape)))
            return _fn(q, *a, **kw)
        monkeypatch.setattr(port_flash, name, counted)

    def grads(params, batch, mesh=None):
        loss = tgpt.loss_fn(params, batch, cfg, mesh=mesh)
        leaves = convert._leaves(params)
        return torch.autograd.grad(loss, leaves)

    one = convert._map(lambda t: t.requires_grad_(True),
                       convert.params_from_numpy(tree, device="cpu"))
    grads(one, {"tokens": torch.from_numpy(toks)})
    single = [c[1:] for c in calls]
    calls.clear()

    def rank(r):
        mesh = create_mesh({"dp": 2, "tp": 2}, device="cpu")
        params = convert._map(
            lambda t: t.requires_grad_(True), convert.params_from_numpy(
                tree, mesh=mesh, logical=tgpt.param_logical_axes(cfg)))
        grads(params, shard_batch({"tokens": toks}, mesh), mesh)

    ranks(rank, 4)
    L = cfg.n_layers
    assert sorted(single) == sorted(
        [("flash_attention_reference", (4, 4, 64, 16))] * 2 * L
        + [("flash_attention_backward_reference", (4, 4, 64, 16))] * L)
    for r in range(4):
        mine = sorted(c[1:] for c in calls if c[0] == f"rank{r}")
        assert mine == sorted(
            [("flash_attention_reference", (2, 2, 64, 16))] * 2 * L
            + [("flash_attention_backward_reference", (2, 2, 64, 16))] * L)


# -- what is not ported ----------------------------------------------------------

def test_unported_mesh_arms_raise():
    """The pipelines and expert parallelism are ported (tests/
    test_torch_port_pipeline*.py, test_torch_port_moe_*.py), and so are
    the prefill on a tp mesh and the tp-sharded paged decode (tests/
    test_torch_port_tp_*.py); Trainer on a mesh, and the prefill and
    serving on a mesh split over another axis (dp here) still raise."""
    from ray_tpu_torch.inference.serving import GPTServer
    from ray_tpu_torch.train import Trainer

    dp = SimpleNamespace(mesh_dim_names=("dp",), shape=(2,))
    toks = torch.zeros((2, 8), dtype=torch.long)
    cases = [
        ("tp-sharded decode", lambda: tgpt.forward(
            {}, toks, tgpt.GPTConfig.tiny(), mesh=dp, return_kv=True)),
        ("mesh", lambda: Trainer(loss_fn=None, init_params=None,
                                 optimizer=None, train_data=[], num_steps=1,
                                 mesh=dp, device="cpu")),
        ("tp-sharded paged decode", lambda: GPTServer(mesh=dp,
                                                      device="cpu")),
    ]
    for match, call in cases:
        with pytest.raises(NotImplementedError, match=match):
            call()


# -- the rank helper -------------------------------------------------------------

def test_a_failing_rank_reports_its_traceback():
    def rank(r):
        if r == 1:
            raise KeyError("rank one's own error")
        dist.barrier()      # rank 0 waits in a collective rank 1 never joins

    with pytest.raises(RankError, match="rank 1 of 2 failed") as err:
        run_ranks(rank, 2, timeout=30)
    assert "rank one's own error" in str(err.value)
    assert not dist.is_initialized()


def test_a_hung_rank_fails_within_its_timeout():
    def rank(r):
        if r == 1:
            dist.barrier()  # alone: rank 0 has returned

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[1\] of 2"):
        run_ranks(rank, 2, timeout=1)
    assert time.monotonic() - t0 < 15
    assert not dist.is_initialized()
    assert ranks(lambda r: r * 10, 2) == [0, 10]
