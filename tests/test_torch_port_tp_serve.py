"""The port's tensor-parallel serving surface against the JAX package's
sharded engine on the CPU: ``GPTConfig.tiny`` in f32 with ``max_seq=64``,
JAX's ``init_params`` bridged through numpy; the port's tp ranks are
threads of this process, the JAX engine runs on a {tp: 2} mesh of
conftest's 8 virtual CPU devices.

The scenarios: the JAX sharded engine and the port's on the same traffic
under the same ``FaultPlan`` on ``infer_shard_commit`` and an armed
recorder (equal replies, equal points, the serving geometry in stats,
the ``engine_request`` events and the gauges); the prefix plane across
layouts (tp2 to one device and back); ``GPTServer(mesh=)`` with two
variants on one executor, hosted through the ``PortReplica``/``host``
glue; the serving meshes that are not ported; one executor per process;
ranks that die or fail alone leave the engine stopped (health False),
never hung; and a process world of one rank (gloo) serving token-exact.
No subprocess, no sleep."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ray_tpu import serve
from ray_tpu.core import fault_injection as jfi
from ray_tpu.core import flight_recorder as jfr
from ray_tpu.inference import EngineConfig as JEngineConfig
from ray_tpu.inference import InferenceEngine as JInferenceEngine
from ray_tpu.inference import metrics_snapshot as jmetrics_snapshot
from ray_tpu.models import gpt as jgpt
from ray_tpu.parallel.mesh import create_mesh as jcreate_mesh
from ray_tpu_torch.core import fault_injection as tfi
from ray_tpu_torch.core import flight_recorder as tfr
from ray_tpu_torch.inference import (EngineConfig, GPTServer,
                                     InferenceEngine, build_gpt_deployment,
                                     metrics_snapshot)
from ray_tpu_torch.inference import tp
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt

from test_torch_port_serve import _glue, host

JCFG = jgpt.GPTConfig.tiny(dtype=jnp.float32, max_seq=64)
TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32, max_seq=64)
PAGED = dict(max_slots=2, kv_block_size=8, prefill_chunk=16)
REP = [5, 6, 7, 5, 6, 7, 5, 6, 7]
_jax_generate = jax.jit(jgpt.generate,
                        static_argnames=("cfg", "max_new", "temperature"))


@pytest.fixture(scope="module")
def model():
    jparams = jax.jit(jgpt.init_params, static_argnums=0)(
        JCFG, jax.random.PRNGKey(0))
    return jparams, convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


@pytest.fixture(autouse=True)
def _clean():
    yield
    tfi.uninstall()
    tfr.disable()
    jfi.uninstall()
    jfr.disable()
    serve.shutdown()
    assert tp._executor is None, "a test left its tp executor running"


def _ref(jparams, prompt, max_new):
    out = _jax_generate(jparams, JCFG, jnp.asarray([prompt], jnp.int32),
                        max_new=max_new, temperature=0.0)
    return np.asarray(out)[0, len(prompt):].tolist()


def _port(params, n=2, **ec):
    return InferenceEngine(params, TCFG, EngineConfig(**{**PAGED, **ec}),
                           device="cpu", name="tp", mesh={"tp": n})


def _assert_no_block_leak(st):
    assert st["blocks_free"] + st["prefix_cached_blocks"] \
        == st["blocks_total"], f"block leak: {st}"


# ------------------------------------------- the JAX sharded engine, alike


def test_same_traffic_plan_and_geometry_as_jax_sharded_engine(model):
    """One traffic (a cold 40-token prompt: a full-width prefill on the
    mesh; a repetitive prompt the n-gram drafter speculates on; the
    same again: prefix reuse) through the port's tp2 engine and the JAX
    sharded engine, each under the JAX package's ``FaultPlan`` recording
    every ``infer_shard_commit`` ctx and its ``FlightRecorder``: the
    replies equal each other and JAX's ``generate``, the plans log the
    same points with the same ctx, the stats report the same serving
    geometry and counters, the ``engine_request`` events are equal apart
    from their times and carry ``mesh_devices``/``tp_shards``, and the
    gauges read 2 and 2."""
    jparams, params = model
    cold = np.random.default_rng(3).integers(0, 512, 40).tolist()
    traffic = [(cold, 8), (REP, 8), (REP, 8)]
    spec = dict(speculate="ngram", speculate_k=4)
    runs = []
    for side in ("port", "jax"):
        plan = jfi.FaultPlan()
        plan.seen = []
        plan.add(jfi.Rule("infer_shard_commit", "script",
                          fn=lambda ctx, plan=plan: plan.seen.append(
                              dict(ctx))))
        rec = jfr.FlightRecorder()
        if side == "port":
            eng, gates = _port(params, **spec), (tfi, tfr)
        else:
            eng = JInferenceEngine(jparams, JCFG,
                                   JEngineConfig(**PAGED, **spec),
                                   mesh=jcreate_mesh(
                                       {"tp": 2},
                                       devices=jax.devices("cpu")[:2]),
                                   name="tp")
            gates = (jfi, jfr)
        gates[1]._active = rec
        try:
            with gates[0].injected(plan):
                replies = [eng.generate(p, max_new=m, timeout=300)
                           for p, m in traffic]
            st = eng.stats()
            snap = {t[0]: t[3] for t in (metrics_snapshot() if side == "port"
                                         else jmetrics_snapshot())}
        finally:
            gates[1]._active = None
            eng.shutdown()
        events = [{k: v for k, v in e.items() if k not in ("t", "start_t")}
                  for e in rec.export_ingress()
                  if e.get("kind") == "engine_request"]
        runs.append((replies, plan, st, snap, events))
    (replies, plan, st, snap, events), (jreplies, jplan, jst, jsnap,
                                        jevents) = runs
    assert replies == jreplies == [_ref(jparams, p, m) for p, m in traffic]
    assert [p for p, _, _ in plan.log] == [p for p, _, _ in jplan.log]
    assert plan.seen == jplan.seen
    assert plan.seen and plan.seen[0] == {"tp_shards": 2, "engine": "tp"}
    for key in ("mesh_devices", "mesh_axes", "tp_shards", "blocks_total",
                "blocks_per_device", "blocks_free", "cache_bytes",
                "cache_bytes_per_device", "prefix_hit_tokens",
                "decode_iterations", "spec_drafted_tokens",
                "spec_accepted_tokens"):
        assert st[key] == jst[key], key
    assert st["mesh_devices"] == st["tp_shards"] == 2
    assert st["mesh_axes"] == {"tp": 2}
    assert st["blocks_per_device"] == st["blocks_total"]
    assert st["cache_bytes_per_device"] == st["cache_bytes"] // 2
    assert st["full_prefills"] == 1 and st["spec_accepted_tokens"] > 0
    _assert_no_block_leak(st)
    assert sorted(events, key=lambda e: e["req"]) \
        == sorted(jevents, key=lambda e: e["req"])
    assert {(e["mesh_devices"], e["tp_shards"]) for e in events} == {(2, 2)}
    key = (("engine", "tp"),)
    for name in ("ray_tpu_inference_mesh_devices",
                 "ray_tpu_inference_tp_shards"):
        assert snap[name][key] == jsnap[name][key] == 2.0


# --------------------------------------------- the pool, the prefix plane


def test_block_pool_on_a_mesh_matches_one_device(model):
    """``BlockPool(mesh=)`` of a tp2 engine against a one-device
    ``BlockPool`` under the same updates: a full-width prefill written
    through a table (each rank takes its heads), a copy-on-write and a
    full-width install; ``read_blocks`` gives the same full-width host
    arrays, every rank holds its heads, and ``reset`` zeroes every
    rank's shard."""
    _, params = model
    from ray_tpu_torch.inference import BlockPool

    rng = np.random.default_rng(0)
    L, h, hd = TCFG.n_layers, TCFG.n_heads, TCFG.head_dim
    k, v = (torch.from_numpy(rng.standard_normal((L, h, 64, hd)).astype(
        np.float32)) for _ in range(2))
    ik, iv = (rng.standard_normal((L, 2, h, 8, hd)).astype(np.float32)
              for _ in range(2))
    table = np.arange(1, 9)
    eng = _port(params)
    try:
        one = BlockPool(TCFG, eng.pool.n_blocks, 8, device="cpu")
        for pool in (one, eng.pool):
            pool.write_prefill(table, k, v)
            pool.copy_block(3, 12)
            pool.write_blocks_at([13, 14], ik, iv)
        ids = [1, 3, 8, 12, 13, 14]
        for got, want in zip(eng.pool.read_blocks(ids), one.read_blocks(ids)):
            np.testing.assert_array_equal(got, want)
        assert eng.pool.k is None and eng.pool.stats()["tp_shards"] == 2
        shards = eng._ranks.executor.on_ranks(
            lambda ctx: ctx.engines["tp"].pool.kv.clone())
        for r, kv in enumerate(shards):
            np.testing.assert_array_equal(
                kv.numpy(), one._kv[:, :, :, 2 * r:2 * r + 2].numpy())
        eng.pool.reset()
        assert [float(kv.abs().sum()) for kv in eng._ranks.executor.on_ranks(
            lambda ctx: ctx.engines["tp"].pool.kv)] == [0.0, 0.0]
    finally:
        eng.shutdown()




def test_prefix_plane_across_layouts(model):
    """A tp2 engine's cached prefix is extracted full width (its ranks'
    heads gathered) and installed into a one-device engine, and a
    one-device engine's into a tp2 engine (each rank takes its heads):
    the payloads of the two layouts agree within 1e-5, and each
    adopter's reply is token-exact without a prefill of the head."""
    jparams, params = model
    head = list(range(100, 132))                      # 4 blocks of 8
    prompt = head + [7, 7, 7]
    want = _ref(jparams, prompt, 8)

    def one(name):
        return InferenceEngine(params, TCFG, EngineConfig(**PAGED),
                               device="cpu", name=name)

    engines = [_port(params), one("one")]
    try:
        payloads = []
        for holder in engines:
            assert holder.generate(head + [1], max_new=2, timeout=120) \
                == _ref(jparams, head + [1], 2)
            ex = holder.prefix_export()[-1]
            assert ex["tokens"] == head
            payloads.append(holder.prefix_extract(head, ex["generation"]))
        for k in ("k", "v"):
            assert payloads[0][k].shape == (2, 4, 4, 8, 16)
            np.testing.assert_allclose(payloads[0][k], payloads[1][k],
                                       atol=1e-5, rtol=0)
        engines += [one("one-adopter"),
                    InferenceEngine(params, TCFG, EngineConfig(**PAGED),
                                    device="cpu", name="tp-adopter",
                                    mesh={"tp": 2})]
        for adopter, payload in zip(engines[2:], payloads):
            assert adopter.prefix_install(head, payload) \
                == {"installed": 4, "already": False}
            assert adopter.generate(prompt, max_new=8, timeout=120) == want
            st = adopter.stats()
            assert st["full_prefills"] == 0
            assert st["chunk_prefills"] == 1          # the 3-token tail
            assert st["prefix_hit_tokens"] == 32
    finally:
        for eng in engines:
            eng.shutdown()


# ------------------------------------------------------ GPTServer(mesh=)


def test_gpt_server_mesh_variants_share_one_executor_hosted():
    """``build_gpt_deployment(mesh={"tp": 2}, variants=...)`` hosted
    under ``ray_tpu.serve`` through the glue: both variants' engines
    open on ONE executor's ranks (as the JAX variants share one mesh),
    each answers with its own seed's weights token-exact against the
    port's one-device ``generate``, ``fleet_stats`` reports 2 devices
    and 2 shards, and teardown stops the executor."""
    dep = build_gpt_deployment(cfg=TCFG, device="cpu", mesh={"tp": 2},
                               engine_cfg=EngineConfig(**PAGED),
                               variants={"base": 0, "alt": 1},
                               multiplex_capacity=2)
    assert dep.init_kwargs["mesh"] == {"tp": 2}
    handle = serve.run(host(dep), use_actors=False)
    prompt = [3, 1, 4, 1, 5]
    for model_id, seed in (("base", 0), ("alt", 1)):
        out = handle.remote({"prompt": prompt, "max_tokens": 6,
                             "model": model_id}).result(timeout=120)
        w = tgpt.init_params(TCFG, seed, device="cpu")
        want = tgpt.generate(w, TCFG, torch.tensor([prompt]), 6,
                             temperature=0.0)[0, len(prompt):].tolist()
        assert out["tokens"] == want
    srv = _glue().server
    engines = srv._engines()
    assert [e.name for e in engines] == ["v1#0:base", "v1#0:alt"]
    assert engines[0]._ranks.executor is engines[1]._ranks.executor
    st = _glue().fleet_stats()
    assert st["mesh_devices"] == st["tp_shards"] == 2
    assert _glue().health()
    serve.shutdown()
    assert tp._executor is None


def test_serving_meshes_other_than_tp_are_not_ported(model):
    """A serving mesh on which an axis other than tp is larger than 1
    raises ``NotImplementedError`` naming it, before any rank starts, for
    the slot engine too (which serves on a tp mesh now: tests/
    test_torch_port_tp_slot.py); a second executor for another mesh in
    one process raises instead of hanging."""
    _, params = model
    for axes in ({"dp": 2}, {"sp": 2}, {"tp": 2, "pp": 2}, {"ep": 2}):
        with pytest.raises(NotImplementedError, match=next(
                a for a in axes if a != "tp")):
            GPTServer(TCFG, EngineConfig(**PAGED), params=params,
                      device="cpu", mesh=axes)
    with pytest.raises(NotImplementedError, match="dp"):
        InferenceEngine(params, TCFG, EngineConfig(paged=False),
                        device="cpu", mesh={"tp": 2, "dp": 2})
    eng = _port(params)
    try:
        with pytest.raises(RuntimeError, match="one at a time"):
            _port(params, n=4)
        with pytest.raises(ValueError, match="open on these ranks"):
            _port(params)                    # the same name twice
    finally:
        eng.shutdown()


@pytest.mark.parametrize("how", ["rank_dies", "rank_fails_alone"])
def test_dead_ranks_leave_the_server_stopped_never_hung(how, model,
                                                        monkeypatch):
    """A rank that dies (its thread ends) or whose step raises while the
    other rank waits for it in a collective stops every rank: the request
    in flight fails with ``TPRanksDead``, the engine stops, and the
    replica's ``health()`` is False.  Nothing hangs: the grace a lone
    failure is given is cut to 0.2 s here."""
    _, params = model
    monkeypatch.setattr(tp, "FAILURE_GRACE_S", 0.2)
    srv = GPTServer(TCFG, EngineConfig(**PAGED), params=params,
                    device="cpu", mesh={"tp": 2})
    eng = srv.engine
    try:
        assert srv({"prompt": [1, 2, 3], "max_tokens": 2})["n"] == 2

        def arm(ctx):
            if ctx.rank != 1:
                return
            st = ctx.engines[eng.name]

            def fail(*a):
                if how == "rank_dies":
                    raise SystemExit("rank 1 dies")
                raise RuntimeError("rank 1 fails alone")
            st.bodies["chunk"] = fail

        eng._ranks.executor.on_ranks(arm)
        with pytest.raises(tp.TPRanksDead):
            srv({"prompt": [4, 5, 6], "max_tokens": 4})
        eng._thread.join(timeout=60)
        assert not eng._thread.is_alive()
        assert not srv.health() and srv.fleet_stats()["stopped"]
        assert not eng._ranks.alive
    finally:
        srv.teardown()


def test_process_world_of_one_rank_serves_token_exact(model):
    """``mesh`` a ``DeviceMesh`` of the caller's world (gloo, world size
    1, a {tp: 1} mesh): the executor's rank loop runs on a thread of this
    process, and the engine's replies equal JAX's ``generate``."""
    jparams, params = model
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("tp",))
        eng = InferenceEngine(params, TCFG, EngineConfig(**PAGED),
                              device="cpu", mesh=mesh)
        try:
            cold = list(range(200, 240))
            for p in (cold, REP):
                assert eng.generate(p, max_new=8, timeout=120) \
                    == _ref(jparams, p, 8)
            st = eng.stats()
            assert st["mesh_devices"] == st["tp_shards"] == 1
            assert st["mesh_axes"] == {"tp": 1}
            assert st["full_prefills"] == 1
        finally:
            eng.shutdown()
    finally:
        dist.destroy_process_group()
