#!/usr/bin/env python3
"""Time builds of the flash backward kernels side by side on one card.

    python3 flash_times.py SOURCE [SOURCE ...]

Each SOURCE is a copy of ``ray_tpu_torch/ops/csrc/flash_bwd.cu`` (for
example this checkout's and a parent commit's, unpacked with ``git
archive`` into a git-ignored directory); it is compiled with ``nvcc`` as
``ops/_build.py`` compiles it, against the ``tc.cuh`` beside it, and its
library is swapped in under this checkout's wrapper, whose C interface
every version shares.  For each build the script prints ptxas's registers
and spills of the f32 d = 64 kernels, holds both kernels against their
plain versions in f32 (q and k scaled by 4 too), and prints the device
time (``chip_smoke.device_ms``) of ``flash_bwd_kv`` and ``flash_bwd_dq``
in f32 at [16, 12, 1024, 64] and [2, 12, 1024, 64] causal, the builds
timed in turns (first to last, then last to first), with the card's name
and power limit.  Needs a CUDA card and nvcc; builds into a temporary
directory."""

import ctypes
import importlib
import os
import subprocess
import sys
import tempfile

import torch

import chip_smoke as cs
from ray_tpu_torch.ops import _build

SHAPES = ((16, 12, 1024, 64), (2, 12, 1024, 64))


def build(sources, tmp):
    """{source: loaded library}, every nvcc started at once; prints each
    build's ptxas report of the f32 d = 64 kernels."""
    procs = {}
    for i, src in enumerate(sources):
        lib = os.path.join(tmp, f"lib{i}.so")
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", lib,
               src]
        procs[src] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for src, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc failed for {src}:\n{log}")
        entry = None
        for ln in log.splitlines():
            m = cs.kernel_entry(ln)
            if "Compiling entry function" in ln and m:
                entry = m
            elif entry and "<f32, 64>" in entry and (
                    "registers" in ln or "spill" in ln):
                print(f"[times] {src} {entry}: {ln.strip()}")
        libs[src] = ctypes.CDLL(lib)
    return libs


def main(sources) -> int:
    cs.check(torch.cuda.is_available(), "no CUDA device")
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 6)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, tmp)
        for shape, qk in ((SHAPES[1], 1.0), ((1, 12, 1024, 64), 4.0)):
            q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                           for _ in range(4))
            q, k = q * qk, k * qk
            out, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
            delta = fa._delta(out, do)
            s = shape[-1] ** -0.5
            ref = (fa._bwd_dq_reference(q, k, v, do, lse, delta, s, True,
                                        512, 512),
                   *fa._bwd_kv_reference(q, k, v, do, lse, delta, s, True,
                                         512, 512))
            for src in sources:
                _build._loaded["flash_bwd"] = libs[src]
                dk, dv = fa._launch_bwd_kv(q, k, v, do, lse, delta, s, True)
                got = (fa._launch_bwd_dq(q, k, v, do, lse, delta, s, True),
                       dk, dv)
                errs = [cs.grad_err(g, r, torch.float32)
                        for g, r in zip(got, ref)]
                print(f"[times] {src} {list(shape)} q, k x {qk:g}: max abs "
                      f"error dq, dk, dv " + ", ".join(
                          f"{e:.3e}{'' if ok else ' FAIL'}" for e, ok in errs)
                      + " (bound 1e-4 (1 + max |ref|): " + ", ".join(
                          f"{1e-4 * (1 + r.abs().max().item()):.3e}"
                          for r in ref) + ")")
                cs.check(all(ok for _, ok in errs), f"{src}: outside bound")
        for shape in SHAPES:
            q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                           for _ in range(4))
            out, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
            delta = fa._delta(out, do)
            for src in sources + sources[::-1]:
                _build._loaded["flash_bwd"] = libs[src]
                kv = cs.device_ms(lambda: fa._launch_bwd_kv(
                    q, k, v, do, lse, delta, 0.125, True))
                dq = cs.device_ms(lambda: fa._launch_bwd_dq(
                    q, k, v, do, lse, delta, 0.125, True))
                print(f"[times] {src} {list(shape)} f32 causal on {card}: "
                      f"flash_bwd_kv {kv:.4f} ms, flash_bwd_dq {dq:.4f} ms")
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main([os.path.abspath(p) for p in sys.argv[1:]]))
