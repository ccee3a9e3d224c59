#!/usr/bin/env python3
"""Kill a tp rank over and over, in several processes at once, beside busy
loops: the flake of the tp serving tests' ``rank_dies`` cases.

    python3 tp_death_stress.py [--root ROOT] [--procs 6] [--reps 200]
                               [--busy 8]

Each of ``--procs`` processes imports ``ray_tpu_torch`` from ROOT (a
checkout of this repo, default this one; a parent commit unpacked with
``git archive`` into a git-ignored directory for a comparison) and
``--reps`` times opens a ``GPTServer`` of ``GPTConfig.tiny`` in f32 on a
tp2 mesh of threaded ranks on the CPU (the paged engine in the odd
processes, the slot engine in the even ones), serves a request, makes
rank 1's next step raise ``SystemExit`` while rank 0 waits in a
collective, checks that the request fails with ``TPRanksDead``, collects
garbage and tears the server down.  ``--busy`` processes spin meanwhile.
Prints, per process, the deaths it got through and how it ended (a
negative code is the signal that killed it: -11 a segfault), then the
totals.  Runs on the CPU only; nothing is written."""

import argparse
import gc
import os
import subprocess
import sys
import time


def one(reps: int, paged: bool) -> None:
    import torch

    from ray_tpu_torch.inference import EngineConfig, GPTServer, tp
    from ray_tpu_torch.models import gpt

    cfg = gpt.GPTConfig.tiny(dtype=torch.float32, max_seq=64)
    params = gpt.init_params(cfg, 0, device="cpu")
    tp.FAILURE_GRACE_S = 0.2
    geometry = (dict(max_slots=2, kv_block_size=8, prefill_chunk=16)
                if paged else dict(paged=False, max_slots=2))
    body = "chunk" if paged else "step"
    for i in range(reps):
        srv = GPTServer(cfg, EngineConfig(**geometry), params=params,
                        device="cpu", mesh={"tp": 2})
        eng = srv.engine
        try:
            assert srv({"prompt": [1, 2, 3], "max_tokens": 2})["n"] == 2

            def arm(ctx):
                if ctx.rank == 1:
                    def fail(*a):
                        raise SystemExit("rank 1 dies")
                    ctx.engines[eng.name].bodies[body] = fail

            eng._ranks.executor.on_ranks(arm)
            try:
                srv({"prompt": [4, 5, 6], "max_tokens": 4})
            except tp.TPRanksDead:
                pass
            else:
                raise AssertionError("the request outlived rank 1")
            eng._thread.join(timeout=60)
            gc.collect()
        finally:
            srv.teardown()
        print(f"death {i + 1}", flush=True)


def spin(seconds: float) -> None:
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        pass


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--procs", type=int, default=6)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--busy", type=int, default=8)
    ap.add_argument("--one", choices=["paged", "slot"])
    ap.add_argument("--spin", type=float)
    a = ap.parse_args()
    if a.spin is not None:
        spin(a.spin)
        return 0
    if a.one is not None:
        sys.path.insert(0, os.path.abspath(a.root))
        one(a.reps, a.one == "paged")
        return 0
    me = os.path.abspath(__file__)
    env = dict(os.environ, PYTHONFAULTHANDLER="1")
    busy = [subprocess.Popen([sys.executable, me, "--spin", "3600"])
            for _ in range(a.busy)]
    try:
        runs = [subprocess.Popen(
            [sys.executable, me, "--root", a.root, "--reps", str(a.reps),
             "--one", "paged" if i % 2 == 0 else "slot"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for i in range(a.procs)]
        outs = [(p, p.communicate()[0]) for p in runs]
    finally:
        for p in busy:
            p.kill()
            p.wait()
    deaths = crashed = 0
    for i, (p, out) in enumerate(outs):
        n = out.count("death ")
        deaths += n
        crashed += p.returncode != 0
        tail = "" if p.returncode == 0 else "\n    " + "\n    ".join(
            out.strip().splitlines()[-12:])
        print(f"process {i} ({'paged' if i % 2 == 0 else 'slot'}): {n} of "
              f"{a.reps} deaths, exit code {p.returncode}{tail}")
    print(f"{deaths} deaths in {a.procs} processes beside {a.busy} busy "
          f"ones, {crashed} processes ended early")
    return 1 if crashed else 0


if __name__ == "__main__":
    sys.exit(main())
