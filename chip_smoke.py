#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. environment: a CUDA card must be present; prints the card's name and
   power limit, builds every Hopper kernel from ops/csrc (one nvcc per
   source, started together) and prints the build time and ptxas report;
2. kernels against their plain versions on the card: the flash forward
   at the serving path's shape and at cross-length, ragged, strided,
   non-causal and wider-head shapes, in bf16 and f32; prints the
   kernel's, the plain version's and SDPA's times and the bound;
3. the serving slice in f32: GPTServer at GPT-2 124M width from seeded
   random weights answers a cold 600-token prompt (full-width prefill on
   the flash kernel) and three short ones (two share a 48-token head);
   every reply must be token-exact against the port's ``generate``, the
   kernel must have launched n_layers times per full-width prefill, and
   the prefix cache must have hit;
4. the same requests served in bf16 (the served configuration): the
   full-width prefill's last-position logits are held against a prefill
   on plain attention, and each request's tokens, TTFT and tokens/s are
   printed.

The line before the last is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# (substring of the card's name, memory bytes/s, dense bf16 FLOP/s), from
# NVIDIA's data sheets; the first match wins
CARD_RATES = [("H100 PCIe", 2.0e12, 756e12), ("H100 NVL", 3.9e12, 835e12),
              ("H200", 4.8e12, 989e12), ("H100", 3.35e12, 989e12)]
# f32 work on the card's f32 CUDA cores; the 16-bit types on tensor cores
F32_FLOPS = 67e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bf16 logits of the served model: flash vs plain-attention prefill
BF16_LOGIT_TOL = 0.125
SEED = 0


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def rates(name: str):
    for key, bw, flops in CARD_RATES:
        if key in name:
            return bw, flops
    raise SmokeFailure(f"no published rates for card {name!r}")


def time_ms(fn, reps: int = 15, inner: int = 10) -> float:
    """Median over ``reps`` of CUDA-event time per call, ``inner`` calls
    per timed window, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def attention_work(b, h, sq, skv, d, causal, itemsize):
    """(bytes, FLOPs) the attention forward needs: q, k, v read once and
    o written once; QK^T and PV over the visible (row, key) pairs."""
    off = skv - sq
    if causal:
        vis = sum(min(skv, max(0, i + off + 1)) for i in range(sq))
    else:
        vis = sq * skv
    return (b * h * (2 * sq + 2 * skv) * d * itemsize,
            4 * b * h * vis * d)


def phase_environment():
    from ray_tpu_torch.ops import _build

    check(torch.cuda.is_available(), "no CUDA device")
    name = torch.cuda.get_device_name(0)
    line = card_line()
    print(line)                          # nvidia-smi's name, power.limit
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices "
          f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"[env] built {sorted(built) or 'nothing new'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for kname, (secs, log) in built.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "error" in ln:
                print(f"[env] {kname} ptxas: {ln.strip()}")
    return name, line


def phase_kernels(name: str, card: str) -> dict:
    import torch.nn.functional as F

    from ray_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference, flash_attention_with_lse)

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    cases = [  # (label, b, h, sq, skv, d, causal, lse)
        ("path", 1, 12, 1024, 1024, 64, True, False),
        ("path+lse", 1, 12, 1024, 1024, 64, True, True),
        ("non-causal", 1, 12, 1024, 1024, 64, False, True),
        ("cross q128/kv384", 1, 12, 128, 384, 64, True, True),
        ("ragged q96/kv200", 1, 12, 96, 200, 64, True, True),
        ("ragged non-causal", 2, 3, 96, 200, 64, False, False),
        ("d128", 1, 8, 512, 512, 128, True, True),
        ("d256", 1, 4, 256, 256, 256, True, True),
    ]
    path_err = None
    for dtype in (torch.bfloat16, torch.float32):
        for label, b, h, sq, skv, d, causal, lse in cases:
            q, k, v = (rand((b, h, n, d), dtype) for n in (sq, skv, skv))
            if lse:
                out, got_lse = flash_attention_with_lse(q, k, v,
                                                        causal=causal)
            else:
                out, got_lse = flash_attention(q, k, v, causal=causal), None
            torch.cuda.synchronize()
            # the plain version on the same values, upcast exactly to f32
            ref, ref_lse = flash_attention_reference(
                q.float(), k.float(), v.float(), causal=causal)
            err = (out.float() - ref).abs().max().item()
            if got_lse is not None:
                err = max(err, (got_lse - ref_lse).abs().max().item())
            ok = err <= TOL[dtype]
            print(f"[kernel] flash_fwd {label} [{b},{h},{sq}/{skv},{d}] "
                  f"{str(dtype).split('.')[-1]} causal={causal} "
                  f"max_abs_err {err:.3e} (bound {TOL[dtype]:g}) "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"flash_fwd {label} {dtype}: error {err} > "
                      f"{TOL[dtype]}")
            if label == "path" and dtype == torch.bfloat16:
                path_err = err

    # q, k, v as the model hands them over: strided views of one qkv
    qkv = rand((1, 1024, 3 * 768), torch.bfloat16)
    q, k, v = (t.reshape(1, 1024, 12, 64).transpose(1, 2)
               for t in qkv.split(768, dim=-1))
    out = flash_attention(q, k, v, causal=True)
    ref, _ = flash_attention_reference(q.float(), k.float(), v.float())
    err = (out.float() - ref).abs().max().item()
    print(f"[kernel] flash_fwd strided qkv views bf16 max_abs_err "
          f"{err:.3e} (bound {TOL[torch.bfloat16]:g})")
    check(err <= TOL[torch.bfloat16], f"strided case error {err}")

    # times at the serving path's shape, [1, 12, 1024, 64] bf16 causal
    q, k, v = (rand((1, 12, 1024, 64), torch.bfloat16) for _ in range(3))
    ms = time_ms(lambda: flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: flash_attention_reference(q, k, v,
                                                         causal=True),
                       reps=5, inner=3)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    bw, flops = rates(name)
    nbytes, nflop = attention_work(1, 12, 1024, 1024, 64, True, 2)
    t_bytes, t_ops = nbytes / bw * 1e3, nflop / flops * 1e3
    bound = max(t_bytes, t_ops)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    ms32 = time_ms(lambda: flash_attention(q32, k32, v32, causal=True))
    b32, f32 = attention_work(1, 12, 1024, 1024, 64, True, 4)
    bound32 = max(b32 / bw, f32 / F32_FLOPS) * 1e3
    print(f"[kernel] flash_fwd [1,12,1024,64] bf16 causal on {card}: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
          f"{lib_ms:.4f} ms, bound {bound:.5f} ms "
          f"({nbytes / 1e6:.2f} MB -> {t_bytes:.5f} ms, "
          f"{nflop / 1e9:.3f} GFLOP -> {t_ops:.5f} ms); f32 kernel "
          f"{ms32:.4f} ms vs f32 bound {bound32:.5f} ms")
    return {"name": "flash_fwd", "route": "cuda",
            "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
            "replaces": "ray_tpu/ops/flash_attention.py:38",
            "launches": None, "max_abs_err": path_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms}


def requests(vocab: int, seed: int = SEED) -> list:
    """One cold 600-token prompt (2n > max_seq: full-width prefill) and
    three short ones, two of which share a 48-token head."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, 48).tolist()
    return [rng.integers(0, vocab, 600).tolist(),
            head + rng.integers(0, vocab, 10).tolist(),
            head + rng.integers(0, vocab, 20).tolist(),
            rng.integers(0, vocab, 30).tolist()]


def serve(cfg, card: str, label: str):
    """Serve the requests one after another through GPTServer; returns
    (server, prompts, replies, flash launches during the run).  A first
    pass over other prompts of the same lengths warms the card's
    libraries, so the printed times are not first-call times."""
    from ray_tpu_torch.inference import EngineConfig, GPTServer

    # the module, not the function the ops package re-exports by its name
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    srv = GPTServer(cfg, EngineConfig(), seed=SEED)
    for p in requests(cfg.vocab_size, seed=SEED + 1):
        srv({"prompt": p, "max_tokens": 16})
    prompts = requests(cfg.vocab_size)
    st0 = srv.engine_stats()
    torch.cuda.synchronize()
    fa.launches = 0                      # the serving path's run starts here
    replies = [srv({"prompt": p, "max_tokens": 16, "temperature": 0.0})
               for p in prompts]
    torch.cuda.synchronize()
    launches = fa.launches               # ... and ends here
    st = {k: v - st0[k] for k, v in srv.engine_stats().items()
          if k in ("full_prefills", "chunk_prefills", "prefix_hit_tokens",
                   "decode_iterations")}
    for p, r in zip(prompts, replies):
        decode_s = r["latency_s"] - r["ttft_s"]
        print(f"[{label}] prompt {len(p)} tokens -> {r['tokens']} "
              f"ttft {r['ttft_s'] * 1e3:.2f} ms, decode "
              f"{(r['n'] - 1) / decode_s:.1f} tokens/s, end to end "
              f"{r['n'] / r['latency_s']:.1f} tokens/s on {card}")
    print(f"[{label}] flash launches {launches}, full-width prefills "
          f"{st['full_prefills']}, chunk prefills {st['chunk_prefills']}, "
          f"prefix hit tokens {st['prefix_hit_tokens']}, decode "
          f"iterations {st['decode_iterations']}")
    check(st["full_prefills"] >= 1, "the cold long prompt did not take "
          "the full-width prefill")
    check(launches == cfg.n_layers * st["full_prefills"],
          f"flash kernel launched {launches} times for "
          f"{st['full_prefills']} full-width prefills of {cfg.n_layers} "
          f"layers")
    check(st["prefix_hit_tokens"] > 0, "no prefix-cache hit")
    for r in replies:
        check(r["n"] == 16 and all(type(t) is int and 0 <= t < cfg.vocab_size
                                   for t in r["tokens"]),
              f"malformed reply {r}")
    return srv, prompts, replies, launches


def phase_serving_f32(card: str):
    from ray_tpu_torch.models import gpt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt.GPTConfig.gpt2_124m(dtype=torch.float32)
    srv, prompts, replies, _ = serve(cfg, card, "serve f32")
    try:
        for p, r in zip(prompts, replies):
            want = gpt.generate(srv.engine.params, cfg,
                                torch.tensor([p], device="cuda"), 16,
                                temperature=0.0)[0, len(p):].tolist()
            check(r["tokens"] == want,
                  f"f32 reply for a {len(p)}-token prompt differs from "
                  f"generate: {r['tokens']} vs {want}")
        print("[serve f32] every reply token-exact against generate")
    finally:
        srv.teardown()


def phase_serving_bf16(card: str) -> int:
    from ray_tpu_torch.inference import make_prefill_fn
    from ray_tpu_torch.models import gpt

    cfg = gpt.GPTConfig.gpt2_124m()      # bf16 activations, f32 params
    srv, prompts, _, launches = serve(cfg, card, "serve bf16")
    try:
        p = prompts[0]
        padded = torch.zeros((1, cfg.max_seq), dtype=torch.long,
                             device="cuda")
        padded[0, :len(p)] = torch.tensor(p)
        flash_fn = make_prefill_fn(cfg)
        plain_fn = make_prefill_fn(
            dataclasses.replace(cfg, attn_impl="reference"))
        flash_logits = flash_fn(srv.engine.params, padded)[0]
        plain_logits = plain_fn(srv.engine.params, padded)[0]
        # the prefill layer end to end: what the kernel's share of it is
        t_flash = time_ms(lambda: flash_fn(srv.engine.params, padded),
                          reps=5, inner=2)
        t_plain = time_ms(lambda: plain_fn(srv.engine.params, padded),
                          reps=5, inner=2)
        print(f"[serve bf16] full-width prefill [1, {cfg.max_seq}] on "
              f"{card}: {t_flash:.3f} ms with the flash kernel, "
              f"{t_plain:.3f} ms with plain attention")
        a, b = flash_logits[0, len(p) - 1], plain_logits[0, len(p) - 1]
        err = (a - b).abs().max().item()
        print(f"[serve bf16] full-width prefill last-position logits, "
              f"flash vs plain attention: max_abs_err {err:.4e} (bound "
              f"{BF16_LOGIT_TOL}), |logits| max {b.abs().max().item():.3f},"
              f" argmax {int(a.argmax())} vs {int(b.argmax())}")
        check(bool(torch.isfinite(a).all()), "non-finite bf16 logits")
        check(err <= BF16_LOGIT_TOL, f"bf16 logits differ by {err}")
    finally:
        srv.teardown()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    name, card = phase_environment()
    kernel = phase_kernels(name, card)
    phase_serving_f32(card)
    kernel["launches"] = phase_serving_bf16(card)
    print(f"[done] {time.perf_counter() - t0:.1f} s on {card}")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
