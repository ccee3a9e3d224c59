"""Continuous-batching GPT inference over a paged KV cache: the port of
``ray_tpu.inference``'s paged engine.

  * cache.py   -- BlockPool (refcounted token blocks, copy-on-write,
                  scratch block 0) and RadixIndex (prefix reuse, LRU).
  * decode.py  -- full-width prefill (the model forward, flash kernel),
                  chunked prefill and the paged decode step.
  * engine.py  -- the iteration-level scheduler: block-budget admission
                  with prefix credit, chunked prefill, preemption.
  * serving.py -- GPTServer: the /v1/generate request body, in process.
"""

from ray_tpu_torch.inference.cache import BlockPool, RadixIndex
from ray_tpu_torch.inference.decode import (make_chunk_prefill_fn,
                                            make_paged_decode_step,
                                            make_prefill_fn)
from ray_tpu_torch.inference.engine import (PRIORITY_BATCH,
                                            PRIORITY_INTERACTIVE,
                                            EngineConfig,
                                            EngineDrainingError,
                                            EngineStoppedError,
                                            GenerationRequest,
                                            InferenceEngine)
from ray_tpu_torch.inference.serving import GPTServer, encode_prompt

__all__ = [
    "BlockPool", "RadixIndex",
    "make_chunk_prefill_fn", "make_paged_decode_step", "make_prefill_fn",
    "EngineConfig", "EngineDrainingError", "EngineStoppedError",
    "GenerationRequest", "InferenceEngine", "PRIORITY_BATCH",
    "PRIORITY_INTERACTIVE", "GPTServer", "encode_prompt",
]
