"""Serve deployment for the inference engine: POST /v1/generate.

Port of ``ray_tpu/inference/serving.py``.  Each replica owns one
InferenceEngine (its own KV pool and decode loop), or, with
``variants``, an LRU of per-variant engines (model multiplexing behind
one deployment).  A request is the JSON object the HTTP route takes:

    {"prompt": [1, 2, 3] | "text",     # token ids, or a string encoded
                                       #   bytewise modulo the vocab
     "max_tokens": 16,                 # default engine_cfg.default_max_new
     "temperature": 0.0,               # 0 = greedy
     "seed": 0,
     "stream": false,
     "priority": "interactive",        # or "batch" (default)
     "model": "variant-id"}            # multiplexed deployments only

Replies hold plain ints and floats: ``{"tokens": [...], "n": n,
"ttft_s": ..., "latency_s": ...}``; ``stream: true`` returns a generator
of ``{"token": t, "index": i}`` documents and a final ``{"done": true}``.

The replica contract a serve controller and fleet router read:
``fleet_stats`` (the router's probe, the JAX package's keys),
``health``, ``drain``, ``teardown``, ``loaded_variants``,
``multiplex_stats`` and the cluster prefix plane's ``prefix_export`` /
``prefix_extract`` / ``prefix_install``.  ``build_gpt_deployment``
wraps the server in a ``serve.deployment.Deployment``.  The port has no
controller: a host runs its replicas (README, "Hosting the port under
ray_tpu.serve").
"""

from __future__ import annotations

import json
from typing import Optional, Sequence, Union

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.inference.engine import (EngineConfig, EngineStoppedError,
                                            InferenceEngine)
from ray_tpu_torch.inference.tp import serving_axes
from ray_tpu_torch.models import gpt
from ray_tpu_torch.models.gpt import GPTConfig
from ray_tpu_torch.serve.context import get_replica_context
from ray_tpu_torch.serve.deployment import (AutoscalingConfig, Deployment,
                                            DeploymentOptions)
from ray_tpu_torch.serve.multiplex import ModelMultiplexer
from ray_tpu_torch.serve.qos import EngineDrainingError, parse_priority

DEFAULT_ROUTE = "v1"


def _serving_mesh(mesh, rules) -> None:
    """Refuse, before any engine or rank starts, a serving mesh that is
    not ported (``tp.serving_axes``) and rules without a mesh (they say
    how a mesh splits the params)."""
    if mesh is not None:
        serving_axes(mesh)
    elif rules is not None:
        raise NotImplementedError(
            "rules without a mesh: the rules place the params on a serving "
            "mesh; one device takes none")


def encode_prompt(prompt: Union[str, Sequence[int]],
                  vocab_size: int) -> list[int]:
    """Token ids pass through; strings encode bytewise modulo the vocab
    (the repo ships no tokenizer)."""
    if isinstance(prompt, str):
        if not prompt:
            raise ValueError("empty prompt")
        return [b % vocab_size for b in prompt.encode("utf-8")]
    return [int(t) for t in prompt]


class GPTServer:
    """Replica body: one engine per replica, or, with ``variants``
    ({model_id: seed}), an LRU of per-variant engines.

    Params come from ``seed`` (drawn on the device, so every replica
    built from one seed answers greedy requests identically) or are
    passed in.  When built under a replica context the replica tag names
    the engine(s) and labels their ``metrics_snapshot`` series.  With
    ``mesh`` (and ``rules``) every engine of the replica, multiplexed
    variants included, serves tensor parallel on one set of tp ranks
    (``InferenceEngine(mesh=)``)."""

    def __init__(self, cfg: Optional[GPTConfig] = None,
                 engine_cfg: Optional[EngineConfig] = None,
                 seed: int = 0, params=None,
                 engine_name: Optional[str] = None,
                 variants: Optional[dict] = None,
                 multiplex_capacity: int = 2,
                 warm_on_init: bool = False,
                 mesh=None, rules=None, device=None):
        _serving_mesh(mesh, rules)
        self.cfg = cfg or GPTConfig.tiny()
        self.engine_cfg = engine_cfg or EngineConfig()
        # tensor-parallel serving: every engine this replica builds
        # shares the one mesh (and so one executor's ranks)
        self.mesh = mesh
        self.rules = rules
        self.device = resolve_device(device)
        self._warm = warm_on_init
        self._closed = False
        self._draining = False
        ctx = get_replica_context()
        self.replica_tag = (ctx.replica_tag if ctx is not None
                            else (engine_name or ""))
        self._labels = ({"deployment": ctx.deployment,
                         "replica": ctx.replica_tag}
                        if ctx is not None else {})
        self._mux = None
        self.engine = None
        if variants and params is not None:
            raise ValueError(
                "params and variants are mutually exclusive: each "
                "variant derives its own params from its catalog seed")
        if variants:
            self._mux = ModelMultiplexer(
                variants,
                lambda mid, spec: self._build_engine(mid, int(spec)),
                lambda eng: eng.shutdown(timeout=2.0),
                capacity=multiplex_capacity)
            # the default variant is resident from birth; a warm replica
            # preloads a full working set
            preload = (list(variants)[:multiplex_capacity]
                       if warm_on_init else [None])
            for mid in preload:
                self._mux.get(mid)
        else:
            self.engine = self._build_engine(None, seed, params=params,
                                             name_override=engine_name)

    def _build_engine(self, model_id: Optional[str], seed: int,
                      params=None, name_override=None) -> InferenceEngine:
        if params is None:
            params = gpt.init_params(self.cfg, seed, device=self.device)
        name = name_override
        if name is None and self.replica_tag:
            name = self.replica_tag + (f":{model_id}" if model_id else "")
        labels = dict(self._labels)
        if model_id:
            labels["model"] = model_id
        kw = {}
        if self.mesh is not None:
            kw["mesh"] = self.mesh
            if self.rules is not None:
                kw["rules"] = self.rules
        eng = InferenceEngine(params, self.cfg, self.engine_cfg,
                              device=self.device, name=name, labels=labels,
                              **kw)
        if self._warm:
            # the first prefill and decode run off the request path
            eng.generate([1], max_new=2, timeout=300)
        return eng

    def _engine_for(self, req: dict) -> InferenceEngine:
        """The engine that serves ``req`` (its ``model`` picks the
        variant on a multiplexed replica).  A closed replica raises
        EngineStoppedError, a draining one EngineDrainingError: both
        tell a router to re-route."""
        if self._closed:
            raise EngineStoppedError("replica closed")
        if self._draining:
            raise EngineDrainingError("replica is draining (scale-down)")
        if self._mux is None:
            return self.engine
        return self._mux.get(req.get("model"))

    def __call__(self, req):
        if not isinstance(req, dict):
            raise ValueError(
                "expected a JSON object body, e.g. "
                '{"prompt": [1, 2, 3], "max_tokens": 16}')
        if "prompt" not in req:
            raise ValueError('missing required field "prompt"')
        prompt = encode_prompt(req["prompt"], self.cfg.vocab_size)
        handle = self._engine_for(req).submit(
            prompt,
            max_new=req.get("max_tokens"),
            temperature=float(req.get("temperature", 0.0)),
            seed=int(req.get("seed", 0)),
            priority=parse_priority(req.get("priority")))
        if req.get("stream"):
            return self._stream(handle)
        try:
            toks = handle.result(timeout=float(req.get("timeout", 120.0)))
        except TimeoutError:
            # nobody will read the abandoned generation: free its row
            handle.cancel()
            raise
        return {
            "tokens": toks,
            "n": len(toks),
            "ttft_s": (handle.first_token_s or 0) - handle.created_s,
            "latency_s": (handle.finished_s or 0) - handle.created_s,
        }

    @staticmethod
    def _stream(handle):
        def gen():
            i = 0
            try:
                for tok in handle.stream():
                    yield {"token": int(tok), "index": i}
                    i += 1
                yield {"done": True, "n": i,
                       "latency_s": (handle.finished_s or 0)
                       - handle.created_s}
            finally:
                # a consumer that stops reading closes the generator:
                # stop decoding for nobody
                if not handle.done:
                    handle.cancel()
        return gen()

    def _engines(self) -> list:
        if self._mux is not None:
            return self._mux.loaded_bodies()
        return [self.engine] if self.engine is not None else []

    def engine_stats(self) -> dict:
        if self._mux is not None:
            raise RuntimeError("multiplexed replica: use fleet_stats()")
        return self.engine.stats()

    def fleet_stats(self) -> dict:
        """The router's probe: engine load and loaded variants, summed
        over the resident engines of a multiplexed replica."""
        engines = self._engines()
        stats = [e.stats() for e in engines]
        blocks_total = sum(s.get("blocks_total", 0) for s in stats)
        blocks_free = sum(s.get("blocks_free", 0) for s in stats)
        hit = sum(s.get("prefix_hit_tokens", 0) for s in stats)
        lookup = sum(s.get("prefix_lookup_tokens", 0) for s in stats)
        drafted = sum(s.get("spec_drafted_tokens", 0) for s in stats)
        s_accept = sum(s.get("spec_accepted_tokens", 0) for s in stats)
        row_steps = sum(s.get("row_steps", 0) for s in stats)
        row_tokens = sum(s.get("row_tokens", 0) for s in stats)
        return {
            "max_slots": sum(s["max_slots"] for s in stats),
            "active_slots": sum(s["active_slots"] for s in stats),
            "waiting_requests": sum(s["waiting_requests"] for s in stats),
            "waiting_interactive": sum(s["waiting_interactive"]
                                       for s in stats),
            # block pressure, not just row counts (0 on slot engines)
            "blocks_total": blocks_total,
            "blocks_free": blocks_free,
            "block_utilization": ((blocks_total - blocks_free)
                                  / blocks_total if blocks_total else 0.0),
            # serving geometry (max, not sum: multiplexed engines share
            # the one mesh)
            "mesh_devices": max((s.get("mesh_devices", 1)
                                 for s in stats), default=1),
            "tp_shards": max((s.get("tp_shards", 1)
                              for s in stats), default=1),
            "prefix_hit_tokens": hit,
            "prefix_lookup_tokens": lookup,
            "prefix_hit_rate": (hit / lookup) if lookup else 0.0,
            "spec_drafted_tokens": drafted,
            "spec_accepted_tokens": s_accept,
            "spec_accept_rate": (s_accept / drafted) if drafted else 0.0,
            "tokens_per_step": (row_tokens / row_steps) if row_steps
                               else 0.0,
            "models": (self._mux.loaded_models()
                       if self._mux is not None else []),
            "stopped": self._closed or not engines
            or all(s["stopped"] for s in stats),
            # the replica's own drain flag, not the engines': an engine
            # drained out of band is the route/drain race, which the
            # typed EngineDrainingError out of submit() covers
            "draining": self._draining,
        }

    # ---- cluster prefix plane: all failures are PrefixTransferError or
    # ReplicaDeadError shapes, which a caller maps to local recompute

    def prefix_export(self) -> list:
        """Drain the resident engines' records of published prefixes,
        each tagged with its ``model`` on a multiplexed replica ([] once
        the replica is closed)."""
        if self._closed:
            return []
        out = []
        if self._mux is not None:
            for mid, eng in zip(self._mux.loaded_models(),
                                self._mux.loaded_bodies()):
                for ex in eng.prefix_export():
                    ex["model"] = mid
                    out.append(ex)
        elif self.engine is not None:
            out.extend(self.engine.prefix_export())
        return out

    def prefix_extract(self, model, tokens, generation: int) -> dict:
        """The holder's side of a prefix adoption
        (``InferenceEngine.prefix_extract``)."""
        req = {"model": model} if model is not None else {}
        return self._engine_for(req).prefix_extract(tokens, generation)

    def prefix_install(self, model, tokens, payload: dict) -> dict:
        """The adopter's side (``InferenceEngine.prefix_install``)."""
        req = {"model": model} if model is not None else {}
        return self._engine_for(req).prefix_install(tokens, payload)

    def loaded_variants(self) -> list:
        return self._mux.loaded_models() if self._mux is not None else []

    def multiplex_stats(self) -> Optional[dict]:
        return self._mux.stats() if self._mux is not None else None

    def drain(self) -> None:
        """Stop admitting: queued engine waiters are handed back as
        EngineDrainingError, in-flight requests decode to completion.
        A controller polls ``fleet_stats`` until active_slots is 0."""
        self._draining = True
        for eng in self._engines():
            eng.drain()

    def health(self) -> bool:
        return not self.fleet_stats()["stopped"]

    def teardown(self) -> None:
        """Stop the engine loop(s) and release their KV pools."""
        self._closed = True
        if self._mux is not None:
            self._mux.unload_all()
        elif self.engine is not None:
            self.engine.shutdown(timeout=2.0)

    def __del__(self):   # best effort: teardown() is the real path
        try:
            for eng in self._engines():
                eng.shutdown(timeout=0.5)
        except Exception:
            pass


def build_gpt_deployment(*, name: str = DEFAULT_ROUTE,
                         cfg: Optional[GPTConfig] = None,
                         engine_cfg: Optional[EngineConfig] = None,
                         seed: int = 0,
                         num_replicas: int = 1,
                         max_concurrent_queries: int = 64,
                         autoscaling: Optional[AutoscalingConfig] = None,
                         params=None,
                         variants: Optional[dict] = None,
                         multiplex_capacity: int = 2,
                         warm_on_init: bool = False,
                         mesh=None, rules=None, device=None) -> Deployment:
    """A deployment wrapping GPTServer, routed at /<name>/... (the
    default "v1" makes POST /v1/generate work).  ``variants``
    ({model_id: seed}) makes each replica model-multiplexed, at most
    ``multiplex_capacity`` variants resident, LRU-evicted; requests pick
    one with the ``model`` field.  ``warm_on_init`` runs a first prefill
    and decode at replica construction.  ``mesh`` (and ``rules``) serves
    every replica tensor parallel (``GPTServer``)."""
    _serving_mesh(mesh, rules)
    return Deployment(
        GPTServer,
        DeploymentOptions(name=name, num_replicas=num_replicas,
                          max_concurrent_queries=max_concurrent_queries,
                          autoscaling=autoscaling),
        init_args=(),
        init_kwargs=dict(cfg=cfg, engine_cfg=engine_cfg, seed=seed,
                         params=params, variants=variants,
                         multiplex_capacity=multiplex_capacity,
                         warm_on_init=warm_on_init,
                         mesh=mesh, rules=rules, device=device))


def parse_stream_chunks(raw: bytes) -> list[dict]:
    """Decode the chunked-transfer JSON documents of a streamed
    /v1/generate response (one dict per chunk, in arrival order)."""
    out = []
    rest = raw
    while rest:
        head, _, rest = rest.partition(b"\r\n")
        if not head:
            continue
        n = int(head, 16)
        if n == 0:
            break
        out.append(json.loads(rest[:n]))
        rest = rest[n:]
        if rest.startswith(b"\r\n"):
            rest = rest[2:]
    return out
