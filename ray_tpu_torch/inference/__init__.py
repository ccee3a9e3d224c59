"""Continuous-batching GPT inference over a paged KV cache, with
speculative decoding, and the slot engine: the port of
``ray_tpu.inference``.

  * cache.py   -- BlockPool (refcounted token blocks, copy-on-write,
                  scratch block 0, speculative rollback; split over
                  heads on a tp mesh, a KVShard on each rank),
                  RadixIndex (prefix reuse, LRU) and KVCacheManager (one
                  stripe per sequence, the slot engine's pool).
  * decode.py  -- full-width prefill (the model forward, flash kernel),
                  chunked prefill, the paged decode step, the speculative
                  verify step and self-draft burst (each also on a tp
                  rank's shards, TPShard), the n-gram drafter, and the
                  slot decode step.
  * engine.py  -- the iteration-level scheduler: block-budget admission
                  with prefix credit, chunked prefill, preemption,
                  draft-then-verify, on one device or a tp mesh; or,
                  with ``paged=False``, slot admission; and
                  ``metrics_snapshot``.
  * tp.py      -- the executor whose tp ranks run a meshed engine's
                  bodies and pool updates.
  * serving.py -- GPTServer: the /v1/generate replica body (one engine,
                  or an LRU of per-variant engines, on one device or a
                  tp mesh), its fleet probe, drain and teardown;
                  build_gpt_deployment and parse_stream_chunks.
"""

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
from ray_tpu_torch.inference.engine import (PRIORITY_BATCH,
                                            PRIORITY_INTERACTIVE,
                                            EngineConfig,
                                            EngineDrainingError,
                                            EngineStoppedError,
                                            GenerationRequest,
                                            InferenceEngine,
                                            metrics_snapshot)
from ray_tpu_torch.inference.serving import (GPTServer,
                                             build_gpt_deployment,
                                             encode_prompt,
                                             parse_stream_chunks)

__all__ = [
    "BlockPool", "KVCacheManager", "RadixIndex",
    "MoEDecodeUnsupported", "SpeculationUnsupported",
    "make_chunk_prefill_fn", "make_decode_step",
    "make_paged_decode_step", "make_paged_draft_step", "make_prefill_fn",
    "make_spec_verify_step", "ngram_propose",
    "EngineConfig", "EngineDrainingError", "EngineStoppedError",
    "GenerationRequest", "InferenceEngine", "PRIORITY_BATCH",
    "PRIORITY_INTERACTIVE", "metrics_snapshot", "GPTServer",
    "build_gpt_deployment", "encode_prompt", "parse_stream_chunks",
]
