"""In-process GPT server: the ``/v1/generate`` request body over the
inference engine.

Port of ``ray_tpu/inference/serving.py``'s ``GPTServer`` (in process)
and ``encode_prompt``.  A request is the JSON object the HTTP route
takes:

    {"prompt": [1, 2, 3] | "text",     # token ids, or a string encoded
                                       #   bytewise modulo the vocab
     "max_tokens": 16,                 # default engine_cfg.default_max_new
     "temperature": 0.0,               # 0 = greedy
     "seed": 0,
     "stream": false,
     "priority": "interactive"}        # or "batch" (default)

Replies hold plain ints and floats: ``{"tokens": [...], "n": n,
"ttft_s": ..., "latency_s": ...}``; ``stream: true`` returns a generator
of ``{"token": t, "index": i}`` documents and a final ``{"done": true}``.
The replica half of the cluster prefix plane is ``prefix_export``,
``prefix_extract`` and ``prefix_install`` (the engine's, through the
same closed/draining gate as requests).  The serve controller,
multiplexing and ``build_gpt_deployment`` come with the slice that ports
``serve/``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.inference.engine import (EngineConfig, EngineStoppedError,
                                            InferenceEngine)
from ray_tpu_torch.models import gpt
from ray_tpu_torch.models.gpt import GPTConfig
from ray_tpu_torch.serve.qos import EngineDrainingError, parse_priority


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
    """One engine over one parameter set.  Params come from ``seed``
    (drawn on the device, so every server built from one seed answers
    greedy requests identically) or are passed in."""

    def __init__(self, cfg: Optional[GPTConfig] = None,
                 engine_cfg: Optional[EngineConfig] = None,
                 seed: int = 0, params=None,
                 engine_name: Optional[str] = None, device=None):
        self.cfg = cfg or GPTConfig.tiny()
        self.engine_cfg = engine_cfg or EngineConfig()
        self.device = resolve_device(device)
        self._closed = False
        self._draining = False
        if params is None:
            params = gpt.init_params(self.cfg, seed, device=self.device)
        self.engine = InferenceEngine(params, self.cfg, self.engine_cfg,
                                      device=self.device, name=engine_name)

    def _engine_for(self, req: dict) -> InferenceEngine:
        """The engine that serves ``req``: the one engine (``req``'s
        ``model`` picks nothing without a multiplexer).  A closed replica
        raises EngineStoppedError, a draining one EngineDrainingError."""
        if self._closed:
            raise EngineStoppedError("replica closed")
        if self._draining:
            raise EngineDrainingError("replica is draining (scale-down)")
        return self.engine

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

    # ---- cluster prefix plane: all failures are PrefixTransferError or
    # ReplicaDeadError shapes, which a caller maps to local recompute

    def prefix_export(self) -> list:
        """Drain the engine's record of published prefixes ([] once the
        replica is closed)."""
        if self._closed:
            return []
        return self.engine.prefix_export()

    def prefix_extract(self, model, tokens, generation: int) -> dict:
        """The holder's side of a prefix adoption
        (``InferenceEngine.prefix_extract``)."""
        req = {"model": model} if model is not None else {}
        return self._engine_for(req).prefix_extract(tokens, generation)

    def prefix_install(self, model, tokens, payload: dict) -> dict:
        """The adopter's side (``InferenceEngine.prefix_install``)."""
        req = {"model": model} if model is not None else {}
        return self._engine_for(req).prefix_install(tokens, payload)

    def engine_stats(self) -> dict:
        return self.engine.stats()

    def drain(self) -> None:
        """Stop admitting; in-flight requests decode to completion."""
        self._draining = True
        self.engine.drain()

    def teardown(self) -> None:
        """Stop the engine loop and release its KV pool."""
        self._closed = True
        self.engine.shutdown(timeout=2.0)
