"""The port's replica contract against the JAX package's, on the CPU, and
the port's GPTServer hosted under the unchanged ``ray_tpu.serve``.

``GPTConfig.tiny`` in f32 with ``max_seq=64``; one set of weights (JAX's
``init_params`` bridged through numpy) wherever tokens are compared with
the JAX package.  Multiplexed variants draw their own weights from their
catalog seeds (torch's generator, not ``jax.random``), so their replies
are held to the port's ``generate`` under that seed.

The host glue (``PortReplica``, ``host``) lives here, outside both
packages: it is a replica body that ``ray_tpu.serve`` builds.  Under the
JAX package's replica context it enters the port's with the same
deployment name and tag, builds the port's GPTServer from the port
deployment, and maps the port's typed errors onto the JAX package's
classes of the same name, so the fleet re-routes a draining or stopped
port replica exactly as it re-routes a JAX one.

The scenarios: tests/test_fleet.py's multiplexer LRU and multiplexed
replica, its drain re-route through both HTTP proxies, and its probe
keys; tests/test_inference_serve.py's JSON, string prompt, error and
streaming round trips over HTTP, token-exact against the JAX deployment;
tests/test_prefix_cluster.py's adoption across two replicas."""

import contextlib
import dataclasses
import json
import socket
import threading
import time
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import serve
from ray_tpu.inference import EngineConfig as JEngineConfig
from ray_tpu.inference import build_gpt_deployment as j_build_gpt_deployment
from ray_tpu.inference import parse_stream_chunks as j_parse_stream_chunks
from ray_tpu.inference.engine import EngineStoppedError as JEngineStoppedError
from ray_tpu.inference.serving import GPTServer as JGPTServer
from ray_tpu.models import gpt as jgpt
from ray_tpu.serve import controller as jcontroller
from ray_tpu.serve import fleet
from ray_tpu.serve import qos as jqos
from ray_tpu.serve.fleet import FleetConfig
from ray_tpu.serve.fleet import multiplex as jmultiplex
from ray_tpu_torch.inference import (EngineConfig, EngineDrainingError,
                                     EngineStoppedError, GPTServer,
                                     build_gpt_deployment,
                                     parse_stream_chunks)
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.serve import context as tcontext
from ray_tpu_torch.serve import deployment as tdeployment
from ray_tpu_torch.serve import multiplex as tmultiplex
from ray_tpu_torch.serve import qos as tqos

JCFG = jgpt.GPTConfig.tiny(dtype=jnp.float32, max_seq=64)
TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32, max_seq=64)
SPEC = dict(max_slots=4, kv_block_size=8, prefill_chunk=16,
            speculate="ngram", speculate_k=4)
_jax_generate = jax.jit(jgpt.generate,
                        static_argnames=("cfg", "max_new", "temperature"))


# ------------------------------------------------------------ host glue

# the port's typed errors -> the JAX package's classes of the same name,
# which the fleet's re-route and fallback decisions test with isinstance
_ERRORS = {
    tqos.ReplicaDeadError: jqos.ReplicaDeadError,
    tqos.EngineDrainingError: jqos.EngineDrainingError,
    EngineStoppedError: JEngineStoppedError,
    tqos.PrefixTransferError: jqos.PrefixTransferError,
    tqos.StalePrefixGeneration: jqos.StalePrefixGeneration,
    tqos.PrefixUnavailable: jqos.PrefixUnavailable,
    tqos.PrefixInstallPressure: jqos.PrefixInstallPressure,
    tmultiplex.UnknownModelError: jmultiplex.UnknownModelError,
}


@contextlib.contextmanager
def _jax_errors():
    """Re-raise a port error as the JAX package's class of the same name
    (the most derived one mapped), chained to the original."""
    try:
        yield
    except Exception as e:
        cls = next((c for c in type(e).__mro__ if c in _ERRORS), None)
        if cls is None:
            raise
        raise _ERRORS[cls](*e.args) from e


def _jax_errors_stream(gen):
    # ``yield from`` passes a consumer's close() through to the port's
    # stream, which then cancels its request
    with _jax_errors():
        yield from gen


class PortReplica:
    """A ``ray_tpu.serve`` replica body serving the port's GPTServer."""

    def __init__(self, port_deployment):
        ctx = jcontroller.get_replica_context()
        scope = (tcontext.replica_context(ctx.deployment, ctx.replica_tag)
                 if ctx is not None else contextlib.nullcontext())
        with scope, _jax_errors():
            self.server = port_deployment.build_replica()

    def __call__(self, req):
        with _jax_errors():
            out = self.server(req)
        if isinstance(out, types.GeneratorType):
            return _jax_errors_stream(out)
        return out


def _forward(name):
    def method(self, *args, **kwargs):
        with _jax_errors():
            return getattr(self.server, name)(*args, **kwargs)
    method.__name__ = name
    return method


for _name in ("fleet_stats", "health", "drain", "teardown",
              "prefix_export", "prefix_extract", "prefix_install"):
    setattr(PortReplica, _name, _forward(_name))


def host(port_deployment) -> serve.Deployment:
    """The JAX package's Deployment of PortReplica for a port deployment
    (its name, replica count, query cap and autoscaling)."""
    o = port_deployment.options
    auto = (serve.AutoscalingConfig(**dataclasses.asdict(o.autoscaling))
            if o.autoscaling is not None else None)
    return serve.Deployment(
        PortReplica,
        serve.DeploymentOptions(
            name=o.name, num_replicas=o.num_replicas,
            max_concurrent_queries=o.max_concurrent_queries,
            autoscaling=auto),
        init_kwargs={"port_deployment": port_deployment})


# ------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def model():
    jparams = jgpt.init_params(JCFG, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jparams, params


@pytest.fixture(autouse=True)
def _cleanup():
    yield
    serve.shutdown()


def _ref_tokens(jparams, prompt, max_new):
    out = _jax_generate(jparams, JCFG, jnp.asarray([prompt], jnp.int32),
                        max_new=max_new, temperature=0.0)
    return np.asarray(out)[0, len(prompt):].tolist()


def _variant_tokens(seed, prompt, max_new):
    """The port's ``generate`` on the weights a variant's seed draws."""
    params = tgpt.init_params(TCFG, seed, device="cpu")
    out = tgpt.generate(params, TCFG, torch.tensor([prompt]), max_new,
                        temperature=0.0)
    return out[0, len(prompt):].tolist()


def _post(addr, path, payload, timeout=120):
    req = urllib.request.Request(
        addr + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _host_port(params, num_replicas=1, http=False, **kw):
    """Serve the port's deployment "v1" through the glue."""
    kw.setdefault("engine_cfg", EngineConfig(max_slots=4))
    dep = build_gpt_deployment(cfg=TCFG, params=params, device="cpu",
                               num_replicas=num_replicas, **kw)
    return serve.run(host(dep), use_actors=False, http=http)


def _glue(i=0) -> PortReplica:
    return serve.get_handle("v1")._state.replicas[i].impl._user


# ------------------------------------------------------------ contract


def _lru_trace(mux_cls, dead_error):
    loads, unloads = [], []
    mux = mux_cls({"a": 1, "b": 2, "c": 3},
                  loader=lambda mid, spec: loads.append(mid) or f"body-{mid}",
                  unloader=lambda body: unloads.append(body), capacity=2)
    got = [mux.get(m) for m in ("a", "b", "a", "c")]
    after_c = list(unloads)
    loaded = sorted(mux.loaded_models())
    got.append(mux.get("b"))
    with pytest.raises(ValueError, match="unknown model"):
        mux.get("nope")
    stats = mux.stats()
    mux.unload_all()
    with pytest.raises(dead_error):
        mux.get("a")
    return got, after_c, loaded, loads, unloads, stats


def test_multiplexer_lru_eviction_and_reload_matches_jax():
    """tests/test_fleet.py's LRU scenario on both multiplexers: a hit
    refreshes recency, a miss at capacity evicts the least recently
    used, an evicted variant reloads, an unknown one raises, a shut-down
    multiplexer raises ReplicaDeadError."""
    port = _lru_trace(tmultiplex.ModelMultiplexer, tqos.ReplicaDeadError)
    ref = _lru_trace(jmultiplex.ModelMultiplexer, jqos.ReplicaDeadError)
    assert port == ref
    got, after_c, loaded, loads, unloads, stats = port
    assert got == ["body-a", "body-b", "body-a", "body-c", "body-b"]
    assert after_c == ["body-b"] and loaded == ["a", "c"]
    assert loads == ["a", "b", "c", "b"]
    assert unloads == ["body-b", "body-a", "body-c", "body-b"]
    assert stats["loads"] == 4 and stats["evictions"] == 2
    assert issubclass(tmultiplex.UnknownModelError, ValueError)


def test_multiplexer_concurrent_misses_share_one_load():
    """Eight threads miss on one variant while its load is in flight:
    one load, every thread gets the same body."""
    started, release = threading.Event(), threading.Event()
    loads = []

    def loader(mid, spec):
        loads.append(mid)
        started.set()
        assert release.wait(10)
        return object()

    mux = tmultiplex.ModelMultiplexer({"a": 0}, loader, capacity=1)
    got = []
    threads = [threading.Thread(target=lambda: got.append(mux.get("a")))
               for _ in range(8)]
    threads[0].start()
    assert started.wait(10)
    for t in threads[1:]:
        t.start()
    release.set()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert loads == ["a"] and len(got) == 8 and len(set(map(id, got))) == 1
    assert mux.stats()["loads"] == 1


def test_build_gpt_deployment_fields_and_stream_chunks():
    """The deployment's name, options and init kwargs equal the JAX
    package's (the port adds ``device``); what is not a serving mesh,
    and rules without a mesh, are refused; both
    ``parse_stream_chunks`` read the same bytes alike."""
    auto = serve.AutoscalingConfig(min_replicas=1, max_replicas=3)
    kw = dict(name="gen", engine_cfg=None, seed=7, num_replicas=2,
              max_concurrent_queries=16, variants={"base": 0},
              multiplex_capacity=1, warm_on_init=True)
    ref = j_build_gpt_deployment(cfg=JCFG, autoscaling=auto, **kw)
    dep = build_gpt_deployment(
        cfg=TCFG, device="cpu", autoscaling=tdeployment.AutoscalingConfig(
            **dataclasses.asdict(auto)), **kw)
    assert dep.name == ref.name == "gen"
    assert dataclasses.asdict(dep.options) == dataclasses.asdict(ref.options)
    assert set(dep.init_kwargs) == set(ref.init_kwargs) | {"device"}
    for k, v in ref.init_kwargs.items():
        if k != "cfg":
            assert dep.init_kwargs[k] == v, k
    assert dep.init_args == ref.init_args == ()
    assert dep._target is GPTServer and dep.init_kwargs["cfg"] is TCFG
    assert build_gpt_deployment().name == j_build_gpt_deployment().name
    with pytest.raises(NotImplementedError):
        build_gpt_deployment(mesh=object())
    with pytest.raises(NotImplementedError):
        GPTServer(TCFG, rules={}, device="cpu")
    docs = [{"token": 5, "index": 0}, {"token": 7, "index": 1},
            {"done": True, "n": 2, "latency_s": 0.5}]
    raw = b""
    for d in docs:
        body = json.dumps(d).encode()
        raw += f"{len(body):x}\r\n".encode() + body + b"\r\n"
    raw += b"0\r\n\r\n"
    assert parse_stream_chunks(raw) == j_parse_stream_chunks(raw) == docs
    assert parse_stream_chunks(b"") == j_parse_stream_chunks(b"") == []


def test_fleet_stats_keys_and_counters_match_jax(model):
    """The same requests through a JAX GPTServer and the port's, both
    speculating: ``fleet_stats`` has the same keys and every counter and
    ratio is equal.  Multiplexed replicas report the same keys, models
    and summed slots, and refuse ``engine_stats``."""
    jparams, params = model
    jsrv = JGPTServer(JCFG, JEngineConfig(**SPEC), params=jparams)
    srv = GPTServer(TCFG, EngineConfig(**SPEC), params=params, device="cpu")
    try:
        for req in ({"prompt": [1, 2, 3, 4] * 6, "max_tokens": 8},
                    {"prompt": [1, 2, 3, 4] * 6 + [9], "max_tokens": 6},
                    {"prompt": "abc", "max_tokens": 4}):
            assert srv(req)["tokens"] == jsrv(req)["tokens"]
        got, want = srv.fleet_stats(), jsrv.fleet_stats()
        assert got == want
        assert got["prefix_hit_tokens"] > 0
        assert got["spec_accepted_tokens"] > 0
        assert srv.loaded_variants() == jsrv.loaded_variants() == []
        assert srv.multiplex_stats() is jsrv.multiplex_stats() is None
    finally:
        srv.teardown()
        jsrv.teardown()
    variants = {"base": 0, "alt": 1}
    jmux = JGPTServer(JCFG, JEngineConfig(max_slots=2), variants=variants)
    mux = GPTServer(TCFG, EngineConfig(max_slots=2), variants=variants,
                    device="cpu")
    try:
        for s in (mux, jmux):
            s._engine_for({"model": "alt"})
        got, want = mux.fleet_stats(), jmux.fleet_stats()
        assert set(got) == set(want)
        for k in ("max_slots", "blocks_total", "blocks_free", "models",
                  "stopped", "draining"):
            assert got[k] == want[k], k
        assert got["models"] == ["base", "alt"] and got["max_slots"] == 4
        for s in (mux, jmux):
            with pytest.raises(RuntimeError, match="fleet_stats"):
                s.engine_stats()
        with pytest.raises(ValueError, match="mutually exclusive"):
            GPTServer(TCFG, params=params, variants=variants, device="cpu")
    finally:
        mux.teardown()
        jmux.teardown()


def test_replica_context_names_engines_as_jax(model):
    """Built under a replica context, both servers name their engines
    ``tag[:model]`` and label them with deployment, replica and model."""
    jparams, params = model
    names = []
    for pkg in ("port", "jax"):
        with contextlib.ExitStack() as stack:
            if pkg == "port":
                stack.enter_context(tcontext.replica_context("v1", "v1#3"))
                assert tcontext.get_replica_context() == \
                    tcontext.ReplicaContext("v1", "v1#3")
                one = GPTServer(TCFG, params=params, device="cpu")
                mux = GPTServer(TCFG, variants={"base": 0}, device="cpu")
            else:
                jcontroller._replica_ctx.ctx = jcontroller.ReplicaContext(
                    "v1", "v1#3")
                stack.callback(setattr, jcontroller._replica_ctx, "ctx",
                               None)
                one = JGPTServer(JCFG, params=jparams)
                mux = JGPTServer(JCFG, variants={"base": 0})
        try:
            names.append([(e.name, e.labels) for s in (one, mux)
                          for e in s._engines()] + [one.replica_tag])
        finally:
            one.teardown()
            mux.teardown()
    assert tcontext.get_replica_context() is None
    assert names[0] == names[1] == [
        ("v1#3", {"deployment": "v1", "replica": "v1#3"}),
        ("v1#3:base", {"deployment": "v1", "replica": "v1#3",
                       "model": "base"}), "v1#3"]


def test_drain_health_and_teardown(model):
    """``drain``: a request in flight completes token-exact, a new one
    raises EngineDrainingError; ``teardown``: ``health`` reads False,
    requests raise EngineStoppedError, no block is left referenced."""
    jparams, params = model
    srv = GPTServer(TCFG, EngineConfig(max_slots=2), params=params,
                    warm_on_init=True, device="cpu")
    assert srv.engine_stats()["requests_completed"] == 1   # the warm-up
    assert srv.health() is True
    gen = srv({"prompt": [4, 2], "max_tokens": 12, "stream": True})
    first = next(gen)
    srv.drain()
    st = srv.fleet_stats()
    assert st["draining"] is True and st["stopped"] is False
    with pytest.raises(EngineDrainingError):
        srv({"prompt": [1], "max_tokens": 2})
    rest = list(gen)
    toks = [first["token"]] + [c["token"] for c in rest if "token" in c]
    assert toks == _ref_tokens(jparams, [4, 2], 12)
    assert rest[-1]["done"] is True
    srv.teardown()
    assert srv.health() is False and srv.fleet_stats()["stopped"] is True
    with pytest.raises(EngineStoppedError):
        srv({"prompt": [1], "max_tokens": 2})
    assert srv.prefix_export() == []
    pool = srv.engine.pool
    srv.engine.trie.evict(pool.n_blocks)
    assert pool.n_free == pool.n_blocks


def test_glue_maps_every_port_error_to_jax():
    """Every typed port error, raised by a call or inside a stream,
    reaches the host as the JAX package's class of the same name; other
    errors pass through unchanged."""
    for port_cls, jax_cls in _ERRORS.items():
        assert port_cls.__name__ == jax_cls.__name__
        glue = PortReplica.__new__(PortReplica)

        def boom(*a, cls=port_cls):
            raise cls("typed")
        glue.server = types.SimpleNamespace(health=boom)
        with pytest.raises(jax_cls, match="typed") as ei:
            glue.health()
        assert type(ei.value) is jax_cls
        assert isinstance(ei.value.__cause__, port_cls)

        def stream(cls=port_cls):
            yield {"token": 1}
            raise cls("mid-stream")
        gen = _jax_errors_stream(stream())
        assert next(gen) == {"token": 1}
        with pytest.raises(jax_cls, match="mid-stream"):
            next(gen)
    with pytest.raises(KeyError):
        with _jax_errors():
            raise KeyError("untyped")


# ----------------------------------------------- hosted under ray_tpu


def _run_http_pair(model):
    """The port's deployment "v1" (through the glue) and the JAX
    package's "jax", one set of weights, behind the asyncio proxy."""
    jparams, params = model
    _host_port(params, http=True)
    serve.run(j_build_gpt_deployment(
        name="jax", cfg=JCFG, engine_cfg=JEngineConfig(max_slots=4),
        params=jparams), use_actors=False, http=True)
    return serve.proxy_address()


def test_hosted_v1_generate_json_string_prompt_and_errors(model):
    """tests/test_inference_serve.py's JSON round trip, string prompt and
    missing-prompt error, against the JAX deployment on the same
    weights."""
    addr = _run_http_pair(model)
    for body in ({"prompt": [3, 1, 4, 1, 5], "max_tokens": 6},
                 {"prompt": "hi", "max_tokens": 3}):
        out = _post(addr, "/v1/generate", body)["result"]
        ref = _post(addr, "/jax/generate", body)["result"]
        assert out["tokens"] == ref["tokens"]
        assert out["n"] == ref["n"] == body["max_tokens"]
        assert out["latency_s"] >= out["ttft_s"] >= 0
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(addr, "/v1/generate", {"max_tokens": 3})
    assert ei.value.code == 500
    assert "prompt" in ei.value.read().decode()


def test_hosted_v1_generate_streaming_chunks(model):
    """Token chunks reach the wire while the generation runs, and the
    stream equals the JAX deployment's reply."""
    addr = _run_http_pair(model)
    host_, port = addr[len("http://"):].split(":")
    prompt, max_tokens = [9, 2, 6], 48
    body = json.dumps({"prompt": prompt, "max_tokens": max_tokens,
                       "stream": True}).encode()
    with socket.create_connection((host_, int(port)), timeout=120) as s:
        s.sendall(b"POST /v1/generate HTTP/1.1\r\n"
                  b"Host: x\r\nContent-Type: application/json\r\n"
                  + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        s.settimeout(120)
        buf = b""
        first_chunk_at = None
        while b"0\r\n\r\n" not in buf:
            data = s.recv(4096)
            assert data, "connection closed before the terminal chunk"
            buf += data
            if first_chunk_at is None and b"\r\n\r\n" in buf:
                if parse_stream_chunks(buf.split(b"\r\n\r\n", 1)[1]):
                    first_chunk_at = time.perf_counter()
        done_at = time.perf_counter()
    headers, payload = buf.split(b"\r\n\r\n", 1)
    assert b"Transfer-Encoding: chunked" in headers
    chunks = parse_stream_chunks(payload)
    assert first_chunk_at is not None and first_chunk_at <= done_at
    ref = _post(addr, "/jax/generate",
                {"prompt": prompt, "max_tokens": max_tokens})["result"]
    assert [c["token"] for c in chunks if "token" in c] == ref["tokens"]
    assert chunks[-1]["done"] is True and chunks[-1]["n"] == max_tokens


def test_hosted_multiplexed_replica_serves_variants_and_advertises():
    """tests/test_fleet.py's multiplexed replica, hosted: each variant
    answers with its own seed's weights, the replica advertises both,
    and an unknown model is the JAX package's UnknownModelError."""
    dep = build_gpt_deployment(cfg=TCFG, device="cpu",
                               engine_cfg=EngineConfig(max_slots=2),
                               variants={"base": 0, "alt": 1},
                               multiplex_capacity=2)
    handle = serve.run(host(dep), use_actors=False)
    f = fleet.enable("v1", FleetConfig(rate=500, burst=64))
    for model_id, seed in (("base", 0), ("alt", 1)):
        out = handle.remote({"prompt": [3, 1, 4], "max_tokens": 4,
                             "model": model_id}).result(timeout=120)
        assert out["tokens"] == _variant_tokens(seed, [3, 1, 4], 4)
    srv = _glue().server
    assert sorted(srv.loaded_variants()) == ["alt", "base"]
    assert srv.multiplex_stats()["loads"] == 2
    assert sorted(_glue().fleet_stats()["models"]) == ["alt", "base"]
    assert [e.name for e in srv._engines()] == ["v1#0:base", "v1#0:alt"]
    with pytest.raises(jmultiplex.UnknownModelError, match="unknown model"):
        handle.remote({"prompt": [1], "max_tokens": 2,
                       "model": "ghost"}).result(timeout=60)
    assert f.fleet_snapshot()["resumed_failure"] == 0


def test_hosted_engine_draining_error_reroutes_never_500_both_proxies(model):
    """tests/test_fleet.py's route/drain race on two port replicas: one
    replica's engine drains while the replica stays routable; both HTTP
    proxies see re-routed successes (never a 500), counted as
    ``resumed_scale_down``, with no failure."""
    from ray_tpu.serve.http_proxy import HttpProxy
    jparams, params = model
    _host_port(params, num_replicas=2, http=True)
    f = fleet.enable("v1", FleetConfig(rate=500, burst=64))
    threaded = HttpProxy(serve._get_controller())
    threaded.start()
    try:
        addr_threaded = f"http://{threaded.host}:{threaded.port}"
        body = {"prompt": [3, 1, 4], "max_tokens": 4}
        ref = _ref_tokens(jparams, [3, 1, 4], 4)
        for eng in _glue(0).server._engines():
            eng.drain()
        for addr in (serve.proxy_address(), addr_threaded):
            out = [_post(addr, "/v1/generate", body) for _ in range(4)]
            assert all(o["result"]["tokens"] == ref for o in out)
        snap = f.fleet_snapshot()
        assert snap["resumed_scale_down"] >= 1
        assert snap["resumed_failure"] == 0 and snap["errored"] == 0
        assert snap["admitted"] == snap["completed"]
    finally:
        threaded.stop()


def test_hosted_adopt_across_replicas_token_parity(model):
    """tests/test_prefix_cluster.py's adoption: replica A pays the
    prefill, replica B adopts A's blocks through the fleet's directory,
    extract and install, and B's reply is token-exact against JAX's
    ``generate``; no block is left referenced outside the indexes."""
    jparams, params = model
    _host_port(params, num_replicas=2, engine_cfg=EngineConfig(
        max_slots=4, kv_block_size=4, default_max_new=8))
    f = fleet.enable("v1", FleetConfig(rate=500, burst=64,
                                       cluster_prefix=True))
    prompt = list(range(1, 21))
    req = {"prompt": prompt, "max_tokens": 6, "temperature": 0.0}
    r1 = f.remote((req,), {}).result(timeout=120)
    assert len(f.prefix.directory) > 0
    hit = f.prefix.directory.lookup(f.prefix._keys(None, prompt[:-1]))
    other = next(r for r in f.state.replicas if r.tag != hit["holder"])
    r2 = f._call(other, (req,), {}, "__call__")
    assert r2["tokens"] == r1["tokens"] == _ref_tokens(jparams, prompt, 6)
    c = f.prefix.counters()
    assert c["prefix_remote_hits"] == 1
    assert c["prefix_remote_fetch_failures"] == 0
    st = other.impl.handle_request("fleet_stats", (), {})
    assert st["prefix_hit_tokens"] >= 16
    fleet.join_worker_threads()
    for r in f.state.replicas:
        eng = r.impl._user.server.engine
        assert eng.pool.stats()["blocks_used"] == eng.trie.cached_blocks
