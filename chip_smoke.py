#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. environment: a CUDA card must be present; prints the card's name and
   power limit, builds every Hopper kernel from ops/csrc (one nvcc per
   source, started together) and prints the build time and ptxas report;
   the bf16 forward and both bf16 backward kernels (the tensor-core
   routes) must hold HMMA instructions at every head dim, and the f32
   backward kernels (the scalar route) none (cuobjdump -sass of the built
   libraries); the bf16 d = 64 instantiations of all three spill nothing;
2. kernels against their plain versions on the card: the flash forward
   at the serving path's shape and at cross-length, ragged (kv 77 too),
   decode-like (q 1 / kv 1000), key-less-row (q 300 / kv 100: output 0,
   lse -inf), strided, misaligned (a view at a 1-element offset, which
   the bf16 route copies), non-causal, wider-head and BERT-base training
   ([32, 12, 512, 64] non-causal) shapes, in bf16 and f32; prints the
   kernel's, the plain version's and SDPA's times and the bound (device
   time, and time per call), and the f32 kernel's, its plain version's
   and f32 SDPA's device time at the serving path's shape, and the bf16
   times at the BERT-base shape;
3. the backward kernels (flash_bwd_kv, flash_bwd_dq) against their plain
   versions on the card: f32 and bf16, causal and not, head dims 64, 128
   and 256, ragged (kv 77 too), cross-length, decode-like (q 1 / kv
   1000) and key-less rows, strided qkv views, a non-contiguous
   cotangent and 1-element-offset views (which the bf16 route copies);
   autograd through the flash op against autograd through plain
   attention; times at the training shape [16, 12, 1024, 64] bf16 causal
   and at BERT-base's [32, 12, 512, 64] bf16 non-causal (device time, and
   time per call) beside the bound, the plain versions and SDPA's
   backward;
4. the serving slice in f32: GPTServer at GPT-2 124M width from seeded
   random weights answers a cold 600-token prompt (full-width prefill on
   the flash kernel) and three short ones (two share a 48-token head);
   every reply must be token-exact against the port's ``generate``, the
   kernel must have launched n_layers times per full-width prefill, and
   the prefix cache must have hit;
5. the same requests served in bf16 (the served configuration): the
   full-width prefill's last-position logits are held against a prefill
   on plain attention, and each request's tokens, TTFT and tokens/s are
   printed;
6. the slot engine and speculative decoding.  In f32 (TF32 off) the
   slot engine (``EngineConfig(paged=False)``) and the paged engine
   speculating with the n-gram drafter (k 8) and with the self-drafter
   (k 4, 2 draft layers) each serve, all at once, the cold 600-token
   prompt, the two shared-head prompts and a repetitive one: every reply
   must be token-exact against the port's ``generate``, the flash kernel
   must have launched n_layers times per full-width prefill (one per
   admission on the slot engine), the n-gram engine must accept drafts
   (tokens per step above 1), the self-drafter must draft, and both
   paged engines must end with every block returned.  In bf16, the
   serve bench's engine arms at its quick sizes (request builders copied
   from benchmarks/serve_bench.py): shared-prefix requests/s on the slot
   and paged engines, and TTFT/ITL percentiles, tokens per step, accept
   rate, wall time and the share of replies equal to the plain arm's for
   speculation off, n-gram and self-draft (printed, not gated);
7. the training slice: GPT-2 124M at full width and depth, b16 s1024
   bf16, five make_train_step steps of AdamW(3e-4, weight_decay=0.1) on
   one repeated batch under remat_policy "dots" and then "dots_flash".
   Every step must launch the flash forward 24 / 12 times and each
   backward kernel 12 times, loss and grad_norm must be finite, the loss
   must fall, and step 1 must agree with the same step on plain
   attention; prints step time, tokens/s and MFU (bench.py's
   flops-per-token over 989e12);
8. mixture-of-experts serving: GPT-2 124M widths with 4 experts, top-2
   (``GPTConfig.gpt2_124m(n_experts=4, expert_top_k=2)``), at capacity
   factor 4.0 (capacity never binds).  In f32 (TF32 off) the paged
   engine and both speculating engines serve phase 6's four requests at
   once: every reply token-exact against ``generate``, n_layers flash
   launches per full-width prefill, no leaked block; the slot engine
   must raise ``MoEDecodeUnsupported`` at construction.  In bf16 the
   paged engine's TTFT and decode ms per step beside the dense model's
   (printed);
9. mixture-of-experts training: the same config at its default capacity
   factor 1.25 (capacity binds), trained as in phase 7 with the same
   gates; MFU over the active parameters; one step of the MoE and of
   the dense model under ``torch.cuda.set_sync_debug_mode("warn")``: the
   MoE step may add no host sync;
10. the cluster prefix plane: two paged engines at GPT-2 124M width in
   f32; the holder serves a cold 512-token prompt (a full-width
   prefill), ``prefix_extract`` takes its 32 blocks to the host and the
   adopter's ``prefix_install`` writes them; the adopter's reply to the
   prompt plus an 8-token tail must equal the holder's and
   ``generate``'s without a full-width prefill; no block may leak, and
   after a pool reset the holder must refuse the old generation with
   ``StalePrefixGeneration``; prints the transfer times and rates;
11. the replica contract at GPT-2 124M width in f32 (TF32 off).
   Multiplexing: ``build_gpt_deployment(variants={"base": 0, "alt": 1},
   multiplex_capacity=1).build_replica()`` under a replica context
   answers cold 600-token prompts to base, alt and base again, each
   token-exact against ``generate`` on that variant's seed, with n_layers
   flash launches per load, 3 loads and 2 evictions, and device memory
   back at the one-variant level after each eviction; prints the load
   and evict times.  The surface: ``fleet_stats`` has the JAX package's
   keys, ``health`` is True; after ``drain`` a new request raises
   ``EngineDrainingError`` while one in flight completes token-exact;
   after ``teardown`` ``health`` is False and no block is referenced.
   Chaos, a scripted plan in the port's gate: ``infer_speculate`` with
   ``reject_all`` on the n-gram engine (replies token-exact, 0 tokens
   accepted, no leak); ``infer_block_alloc`` raising on its 2nd call
   (every request in flight fails with the injected error, the pool's
   generation moves on, the next request is token-exact, no leak); the
   ``infer_admit`` ctx carries ``engine``, ``req``, ``need`` and
   ``hit_tokens``.  The flight recorder, armed: one ``engine_request``
   event per finished request, whose ``spec_accepted`` sum to the
   engine's accepted tokens.  Prints decode ms per step with a no-op
   plan installed beside the same run with none.
12. the other models.  In f32 with TF32 off (cuDNN's too), on the card
   against the same call on the CPU within 1e-4 (1 + the largest
   value): ResNet tiny at 16x16 and 15x15 and ResNet-50 at width 8 with
   the ImageNet stem at 64x64, train=True and train=False (logits and BN
   state); ActorCritic fcnet, visionnet (84x84x4 uint8), lstm (two
   windows, carry threaded) and gtrxl at their published widths, and the
   MLP; none may launch a flash kernel.  ResNet-18 at CIFAR-10 widths,
   b256 bf16, five hand-written AdamW steps with the BN state carried
   and ten timed: the loss must fall, every running stat move, and
   train=False leave the state equal.  BERT-base, b32 s512 bf16, remat
   on: five make_train_step steps of AdamW(1e-4, weight_decay=0.01) and
   ten timed, each launching the flash forward 24 times and each
   backward kernel 12 times, finite and falling loss, step 1 against
   plain attention as in phase 7; a batch with the last 64 positions of
   half its rows padded launches no kernel and gives a finite loss; on
   a tiny f32 config with head dim 64 the loss without a mask (the
   kernel) equals the loss with an all-ones mask (plain attention)
   within 1e-5.  Prints step ms, images/s or tokens/s and MFU, and the
   kernel share of a profiled BERT step.

13. the trainer loop: GPT-2 124M at full width and depth, b16 s1024 bf16,
   remat "dots", AdamW(3e-4, weight_decay=0.1), through ``Trainer.fit``
   for 12 steps (report every 2, checkpoint every 4, keep 2) on distinct
   seeded host batches through ``device_batches``.  The first fit's data
   raises at step 7, so it resumes from the step-4 checkpoint; a second
   fit runs the same batches uninterrupted.  Gates: the resume starts at
   step 4; every reported loss of the first fit equals the second's
   within rel 1e-5; every step launches 24 / 12 / 12; the loss is finite
   and falls; the last checkpoint loads into a fresh state bit-equal to
   the run's final params, moments and step; ``TorchPredictor.
   from_checkpoint`` gives the forward's logits within 1e-6.  Prints the
   steady step ms (from the trainer's reported throughput) beside phase
   7's "dots" step, tokens/s, MFU, the checkpoint's bytes, the D2H
   snapshot's ms and GB/s, the async write, the restore and the feed's
   wait per step;
14. PPO on CartPole at tests/test_rllib.py's settings for 18 iterations,
   learner and policies on the card.  Gates: best mean return above 60;
   one update on a fixed batch with fixed permutations equal on the card
   and the CPU within 1e-4 (1 + scale), f32 with TF32 off;
   ``save``/``restore`` round-trips; no flash launch.  Prints env steps/s
   and rollout and learner ms per iteration.
15. the sharded training step, GPT-2 124M at full width and depth, bf16,
   remat "dots", AdamW(3e-4, weight_decay=0.1).  15a: NCCL at world
   size 1, ``create_mesh({"dp": 1})``, b16 s1024, three checked steps
   and ten timed of ``make_train_step(mesh=, params_logical=)``: each
   loss within rel 1e-5 of the single-device step on the same params
   and batch, 24 / 12 / 12 launches a step; prints the steady step ms
   beside one device's.  15b: four ranks as threads sharing the card
   (the threaded process group), b8 s1024, on dp2.tp2 and dp2.sp2,
   three steps each: every rank's loss within rel 5e-3 and grad_norm
   within rel 5e-2 of the single-device step; on dp2.tp2 every rank
   launches 24 / 12 / 12 a step at [4, 6, 1024, 64], on dp2.sp2 none
   (ring attention).  Then the three kernels at [4, 6, 1024, 64] bf16
   causal against their plain versions, timed beside their bound, the
   plain versions and SDPA (the kernels' ``tp_shape`` records).
16. the pipelines and experts on four threaded ranks sharing the card,
   GPT-2 124M (bf16, remat "dots", AdamW(3e-4, weight_decay=0.1)) and
   BERT-base.  16a: GPipe on pp2.dp2, b16, M 4, three steps; 16b: one
   GPipe and one 1F1B pass on pp4, b16, M 8 (loss within the reference's
   1e-3 + 1e-3 |ref| of one device, grad_norm rel 5e-2, a nonzero
   gradient on every leaf; the peak device memory each adds, printed),
   then ``train_step_1f1b`` on pp4 (its own checks); 16c: MoE (4
   experts, top-2, capacity factor 1.25) on dp2.ep2 and on pp2.ep2 (M
   4), b8, three steps each; 16d: BERT-base on pp2.dp2, b32 s512, M 4,
   one step.  Each step's loss and grad_norm on every rank within rel
   5e-3 / 5e-2 of one device's on the same params (gathered before the
   step) and batch; every rank's flash launches a step equal to its
   schedule's count (every stage runs its layers at each of the M + S -
   1 ticks; 1F1B's F without a graph, its B with the recompute).  Then
   the three kernels at [2, 12, 1024, 64] and [4, 12, 1024, 64] bf16
   causal and [4, 12, 512, 64] non-causal against their plain versions,
   timed beside their bound, the plain versions and SDPA (the kernels'
   ``pp_shape``, ``ep_shape`` and ``bert_pp_shape`` records).

17. tensor-parallel serving, GPT-2 124M at full width and depth.  17a:
   NCCL at world size 1 on a {tp: 1} ``DeviceMesh``, the paged engine in
   bf16 at phase 5's settings (the executor's process world): the
   replies to phase 4's requests token-exact against the one-device
   engine's on the same params, the ITL medians printed side by side (the
   difference is the executor's host cost).  17b: tp2 and tp4 as ranks
   on threads sharing the card, f32 with TF32 off, phase 6's paged
   settings with n-gram drafts of 8, phase 6's four requests at once
   (phase 4's cold prompt and two sharing a head, a repetitive one):
   every reply token-exact against ``generate``; each rank launches the
   flash forward 12 times per full-width prefill at [1, 12/tp, 1024, 64]
   and nowhere else; prefix
   hits, chunked prefill and accepted drafts; no leaked block; a step
   failure injected on every rank fails its request, every rank's pool
   shard is zeroed and the next reply is token-exact.  17c: the same in
   bf16 on one device, tp2 and tp4: TTFT and ITL p50/p99 and tokens/s
   printed; the full-width prefill's last-position logits on each mesh
   within 0.125 of the same prefill on plain attention.  Then the flash
   forward at [1, 6, 1024, 64] and [1, 3, 1024, 64], bf16 and f32 causal,
   against its plain version, timed beside its bound, the plain version
   and SDPA (the kernel's ``serve_tp{2,4}_shape_{bfloat16,float32}``
   records).
18. the trainer on a mesh.  18a: ``Trainer.fit`` on a {dp: 1} mesh at
   NCCL world size 1, GPT-2 124M at full width and depth, b16 s1024 bf16
   "dots", AdamW(3e-4, weight_decay=0.1), six steps on phase 13's first
   six batches, a checkpoint every 3, the data failing at step 4: the
   fit resumes at step 3 from its checkpoint, every step launches
   24 / 12 / 12, and the losses at steps 2, 4 and 6 are within rel 1e-3
   of phase 13's uninterrupted one-device fit.  18b: four ranks as
   threads sharing the card on dp2.tp2, GPT-2 124M widths cut to four
   layers, b8 s1024, each rank calling ``fit()`` with its own data
   failing at step 4: every rank resumes at step 3 from the checkpoint
   rank 0 wrote and reports the same, each rank launches 8 / 4 / 4 a
   step at [4, 6, 1024, 64], and each step's loss and grad_norm are
   within rel 5e-3 / 5e-2 of the same fit on one device.
19. the slot engine on tp, GPT-2 124M at full width and depth.  19a:
   NCCL at world size 1 on a {tp: 1} ``DeviceMesh``, the slot engine in
   bf16: phase 4's requests token-exact against the one-device slot
   engine, the ITL medians printed side by side.  19b: tp2 and tp4 as
   ranks on threads sharing the card, f32 with TF32 off, two slots for
   phase 6's four requests: every reply token-exact against
   ``generate``, each rank 12 flash launches per admission at
   [1, 12/tp, 1024, 64] and none in the decode steps, every slot free
   after, each rank's cache [2, 12, 2, 12/tp, 1024, 64].  19c: the same
   traffic in bf16 on one device, tp2 and tp4, TTFT and ITL beside one
   device's; the slot prefill's last-position logits at the rank shape
   within 0.125 of plain attention.

20. the single-learner RLlib tail (``phase_rllib_tail``), f32 with TF32
   off, learners and policies on the card.  One update (or scoring) per
   algorithm on a fixed host batch with fixed draws equal on the card
   and the CPU within 1e-4 (1 + scale): PG, A2C (optax's clip engaged),
   IMPALA, APPO (target refreshed), DQN, SimpleQ, SAC, DDPG, TD3 (an
   actor step and a delayed one, fixed target noise), BC, MARWIL, CQL,
   DT (full width: d 64, 4 heads, 2 layers, 60 tokens), LinUCB, LinTS
   (fixed draw), ES, ARS (fixed perturbations), Learner and
   LearnerGroup.  Then the learning runs at the settings and bars of the
   JAX package's tests, each stopping once its bar is met: PG best above
   90 (40 iterations at most), A2C above 40, IMPALA above 50, APPO's
   last at least its first, DQN above 50, SAC above 40 (CartPole); TD3's
   mean of the last 20 returns above -500 on Pendulum; LinUCB's regret
   below 0.6x its first, LinTS's below its first; ES above its first +
   10; ARS's filter moments; on offline data that rollouts of a
   balancing controller (a one-unit policy net on the card) write to a
   temporary directory: BC's accuracy above 0.9 (400 iterations; the
   test's 60 are on N(0, 1) observations), MARWIL finite, CQL's gap not
   up by 1, DT's loss falling (its return conditioned on 500 printed);
   the Learner's loss falling.  Every algorithm's ``save`` restores into
   a fresh one whose ``save`` is equal and which trains on; the flash
   launch counts, zeroed at the start, are 0 / 0 / 0 at the end.
   Prints each run's metric per iteration, env steps/s and learner ms
   per iteration, and the phase's seconds by part.
21. the rest of single-learner RLlib (``phase_rllib_rest``), f32 with
   TF32 off, learners and policies on the card.  One update per module
   at its default widths on a fixed host batch with fixed draws, equal
   on the card and the CPU within 1e-4 (1 + scale): multi-agent PPO (one
   policy's epochs with fixed permutations), R2D2 (burn-in, double Q,
   h-rescaling), QMIX, MADDPG, SlateQ, AlphaZero's train step, MAML's
   second-order meta-update, MB-MPO's ensemble fit (fixed bootstrap
   rows) and meta-update (fixed Gumbel noise), and Dreamer's model,
   actor and critic update (fixed Gaussian noise).  Then the learning
   runs at the settings and bars of the JAX package's tests, each
   stopping once its bar is met: multi-agent PPO's mean reward above its
   first; R2D2's TD loss falling over 3 iterations; QMIX's mean of the
   last 50 returns above 6.0 (16 iterations at most; the test's 10);
   MADDPG's mean of the last 20 returns up by 3; AlphaZero's mean of the
   last 24 above 0.6 (24 at most; the test's 12); SlateQ's mean of the
   last 30 above 1.15x random slates' (24 at most; the test's 16);
   MAML's post-adaptation loss below 2.0 and 0.55x the unadapted one;
   Dreamer's noise-free return above random + 10 with obs_loss below 0.3
   (20 at most; the test's 14); MB-MPO's best mean return above 48 with
   a falling model loss.  Every algorithm's ``save`` restores into a
   fresh one whose ``save`` is equal and which trains on; the flash
   launch counts, zeroed at the start, are 0 / 0 / 0 at the end.

22. the elastic gang (``phase_elastic``).  22a: GPT-2 124M at full width
   and depth, b16 s1024 bf16 "dots", ``Trainer(num_hosts=4)`` on four
   in-process gang members sharing the card, ``{"dp": -1}``, 18a's six
   batches, a checkpoint every 3 steps: members 1 and 3 kill themselves
   at step 4, the gang re-forms at 2 (the survivors' ids kept) and
   resumes at step 3; a data failure at step 5 re-admits two fresh
   members, back to 4, which resume at step 3 and finish.  Gates: the
   attempts' worlds, resume steps and recoveries, every member of an
   attempt reporting the same, 24 / 12 / 12 launches every member-step at
   [4, 12, 1024, 64] (world 4) and [8, 12, 1024, 64] (world 2), the
   losses and grad_norm at steps 2, 4 and 6 within rel 5e-3 and 5e-2 of
   phase 13's one-device fit; prints the wall time and the peak memory;
   the three kernels at [8, 12, 1024, 64] bf16 causal are checked and
   timed (``elastic_shape`` in the kernels JSON).  22b: DD-PPO on two
   members sharing the card, f32 with TF32 off: two updates on the same
   host batches equal on the card and the CPU within 1e-4 (1 + scale),
   the card's ranks bit-equal; then the JAX test's learning run (best
   mean return above 90 within 25 iterations), both ranks bit-equal
   after it, env steps/s printed, 0 / 0 / 0 flash launches.

``main`` runs phases 8, 10, 11, 12, 13, 14, 20, 21, 17 and 19 before phase 7,
and 15, 16, 18 and 22 after 9: no serving phase runs after the profiler.  The line
before the last is the kernels' JSON record; the last is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

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
# [batch, heads, seq, head dim] of phase 12's BERT-base step
BERT_SHAPE = (32, 12, 512, 64)


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


def device_ms(fn, reps: int = 10, windows: int = 3) -> float:
    """Device time per call: the median over ``windows`` of CUDA-event
    time over ``reps`` calls queued behind a spinning kernel
    (``torch.cuda._sleep``) that outlasts their enqueueing, so the card
    runs them back to back.  Unlike ``time_ms`` it leaves out the host's
    time between launches, which sets a fast kernel's CUDA-event time
    when one call dispatches in more time than its kernel runs.  ``fn``
    must not wait on the card."""
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(10 ** 6)
    b.record()
    b.synchronize()
    cycles_per_ms = 10 ** 6 / a.elapsed_time(b)
    sleep_ms, per_call = 5.0, []
    while len(per_call) < windows:
        check(sleep_ms < 60e3, "the host cannot queue the calls ahead")
        torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
        t0 = time.perf_counter()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        b.synchronize()
        if queued_ms < 0.8 * sleep_ms:  # the card never waited on the host
            per_call.append(a.elapsed_time(b) / reps)
        else:
            sleep_ms *= 2
    return statistics.median(per_call)


def visible_pairs(sq, skv, causal):
    """(row, key) pairs attention computes for one head."""
    if not causal:
        return sq * skv
    off = skv - sq
    return sum(min(skv, max(0, i + off + 1)) for i in range(sq))


def attention_work(b, h, sq, skv, d, causal, itemsize):
    """(bytes, FLOPs) the attention forward needs: q, k, v read once and
    o written once; QK^T and PV over the visible (row, key) pairs."""
    return (b * h * (2 * sq + 2 * skv) * d * itemsize,
            4 * b * h * visible_pairs(sq, skv, causal) * d)


def backward_work(kernel, b, h, sq, skv, d, causal, itemsize):
    """(bytes, FLOPs) a backward kernel needs.  Both read q, do, k, v
    once and lse, delta (f32) once; flash_bwd_kv writes dk, dv and does
    four products over the visible pairs (QK^T, dO V^T, P^T dO, dS^T Q),
    flash_bwd_dq writes dq and does three (QK^T, dO V^T, dS K)."""
    reads = (2 * sq + 2 * skv) * d * itemsize + 2 * sq * 4
    if kernel == "flash_bwd_kv":
        writes, products = 2 * skv * d * itemsize, 4
    else:
        writes, products = sq * d * itemsize, 3
    return (b * h * (reads + writes),
            2 * products * b * h * visible_pairs(sq, skv, causal) * d)


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
    spills = {}
    for kname in _build.SOURCES:
        entry = kname
        for ln in _build.build_log(kname).splitlines():
            m = kernel_entry(ln)
            if "Compiling entry function" in ln and m:
                entry = m
            elif "registers" in ln or "spill" in ln or "error" in ln:
                print(f"[env] {entry} ptxas: {ln.strip()}")
                if "spill" in ln:
                    spills[entry] = ln.strip()
    # the bf16 kernels: no spills on the path's head dim, and tensor-core
    # products in every instantiation; the f32 backward stays scalar
    for kern in ("flash_fwd", "flash_bwd_kv", "flash_bwd_dq"):
        d64 = spills.get(f"{kern}_kernel<bf16, 64>", "not reported")
        check("0 bytes spill stores, 0 bytes spill loads" in d64,
              f"{kern}_kernel<bf16, 64> spills: {d64}")
    for lib_name, kerns in (("flash_fwd", ("flash_fwd",)),
                            ("flash_bwd", ("flash_bwd_kv", "flash_bwd_dq"))):
        hmma = sass_hmma_counts(_build._target(lib_name)[1])
        print(f"[env] HMMA instructions per {lib_name} instantiation "
              f"(cuobjdump -sass): {hmma}")
        for kern in kerns:
            for d in (64, 128, 256):
                check(hmma.get(f"{kern}_kernel<bf16, {d}>", 0) > 0,
                      f"{kern}_kernel<bf16, {d}> holds no HMMA instruction")
                if lib_name == "flash_bwd":
                    check(hmma.get(f"{kern}_kernel<f32, {d}>") == 0,
                          f"{kern}_kernel<f32, {d}>: "
                          f"{hmma.get(f'{kern}_kernel<f32, {d}>')} HMMA "
                          f"instructions, expected the scalar route's 0")
    lib = importlib.import_module(
        "ray_tpu_torch.ops.flash_attention")._bwd_lib()
    for d in (64, 128, 256):
        print(f"[env] dynamic shared memory per CTA at d={d}: flash_bwd_kv "
              f"{lib.flash_bwd_smem_bytes(0, d)} B (f32), "
              f"{lib.flash_bwd_smem_bytes(2, d)} B (bf16); flash_bwd_dq "
              f"{lib.flash_bwd_smem_bytes(1, d)} B (f32), "
              f"{lib.flash_bwd_smem_bytes(3, d)} B (bf16)")
    return name, line


def kernel_entry(text: str):
    """``flash_fwd_kernel<bf16, 64>`` for a line naming that kernel's
    mangled symbol (...16flash_fwd_kernelI13__nv_bfloat16Li64EE...),
    else None."""
    m = re.search(r"(flash_(?:fwd|bwd_kv|bwd_dq)_kernel)"
                  r"I(f|13__nv_bfloat16)Li(\d+)E", text)
    return (f"{m[1]}<{'f32' if m[2] == 'f' else 'bf16'}, {m[3]}>"
            if m else None)


def sass_hmma_counts(lib_path: str) -> dict:
    """{kernel instantiation: number of HMMA (tensor-core) instructions}
    in the SASS of a built library, from the toolkit's cuobjdump."""
    from ray_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, entry = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            entry = kernel_entry(ln)
            if entry:
                counts[entry] = 0
        elif entry and "HMMA" in ln:
            counts[entry] += 1
    return counts


def phase_kernels(name: str, card: str) -> dict:
    import torch.nn.functional as F

    from ray_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference, flash_attention_with_lse)

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
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
        ("decode-like q1/kv1000", 1, 12, 1, 1000, 64, True, True),
        ("rows without keys q300/kv100", 1, 12, 300, 100, 64, True, True),
        ("ragged kv77", 1, 12, 77, 77, 64, True, True),
        ("ragged kv77 non-causal", 2, 3, 40, 77, 64, False, True),
        ("training shape", 16, 12, 1024, 1024, 64, True, True),
        ("prefix plane width", 1, 12, 896, 896, 64, True, False),
        ("BERT-base training shape", 32, 12, 512, 512, 64, False, True),
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
            err = forward_err(label, out, got_lse, q, k, v, causal)
            ok = err <= TOL[dtype]
            print(f"[kernel] flash_fwd {label} [{b},{h},{sq}/{skv},{d}] "
                  f"{str(dtype).split('.')[-1]} causal={causal} "
                  f"max_abs_err {err:.3e} (bound {TOL[dtype]:g}) "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"flash_fwd {label} {dtype}: error {err} > "
                      f"{TOL[dtype]}")
            if label == "path" and dtype == torch.bfloat16:
                path_err = err
            if label.startswith("BERT") and dtype == torch.bfloat16:
                bert_err = err

    # q, k, v as the model hands them over: strided views of one qkv
    qkv = rand((1, 1024, 3 * 768), torch.bfloat16)
    q, k, v = (t.reshape(1, 1024, 12, 64).transpose(1, 2)
               for t in qkv.split(768, dim=-1))
    check(all(fa._cp_async_aligned(t) for t in (q, k, v)),
          "the model's qkv views should need no alignment copy")
    out = flash_attention(q, k, v, causal=True)
    ref, _ = flash_attention_reference(q.float(), k.float(), v.float())
    err = (out.float() - ref).abs().max().item()
    print(f"[kernel] flash_fwd strided qkv views bf16 max_abs_err "
          f"{err:.3e} (bound {TOL[torch.bfloat16]:g})")
    check(err <= TOL[torch.bfloat16], f"strided case error {err}")

    # q, k, v contiguous at a 1-element offset: not 16-byte aligned, so
    # the bf16 route copies them (the f32 route reads them as they are)
    for dtype in (torch.bfloat16, torch.float32):
        shape = (1, 12, 200, 64)
        q, k, v = (rand((int(np.prod(shape)) + 1,), dtype)[1:].view(shape)
                   for _ in range(3))
        check(not fa._cp_async_aligned(q), "a 1-element offset view "
              "should not pass the alignment check")
        n0 = fa.launches
        out, got_lse = flash_attention_with_lse(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = forward_err("offset", out, got_lse, q, k, v, True)
        ok = err <= TOL[dtype] and fa.launches == n0 + 1
        print(f"[kernel] flash_fwd 1-element offset views [1,12,200,64] "
              f"{str(dtype).split('.')[-1]} max_abs_err {err:.3e} (bound "
              f"{TOL[dtype]:g}), launches {fa.launches - n0} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"offset-view case {dtype}: error {err}, "
                  f"{fa.launches - n0} launches")

    # times at the serving path's shape, [1, 12, 1024, 64] bf16 causal
    # (device time; CUDA-event time per call beside it)
    q, k, v = (rand((1, 12, 1024, 64), torch.bfloat16) for _ in range(3))

    def kernel():
        return flash_attention(q, k, v, causal=True)

    def plain():
        return flash_attention_reference(q, k, v, causal=True)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    ms, call_ms = device_ms(kernel), time_ms(kernel)
    plain_ms, plain_call = device_ms(plain, 3), time_ms(plain, 5, 3)
    lib_ms, lib_call = device_ms(sdpa), time_ms(sdpa)
    bw, flops = rates(name)
    nbytes, nflop = attention_work(1, 12, 1024, 1024, 64, True, 2)
    t_bytes, t_ops = nbytes / bw * 1e3, nflop / flops * 1e3
    bound = max(t_bytes, t_ops)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    ms32 = device_ms(lambda: flash_attention(q32, k32, v32, causal=True))
    plain32 = device_ms(lambda: flash_attention_reference(
        q32, k32, v32, causal=True), 3)
    lib32 = device_ms(lambda: F.scaled_dot_product_attention(
        q32, k32, v32, is_causal=True))
    b32, f32 = attention_work(1, 12, 1024, 1024, 64, True, 4)
    bound32 = max(b32 / bw, f32 / F32_FLOPS) * 1e3
    print(f"[kernel] flash_fwd [1,12,1024,64] bf16 causal on {card}: "
          f"kernel {ms:.4f} ms ({nflop / ms / 1e9:.1f} TFLOP/s; per call "
          f"{call_ms:.4f} ms), plain {plain_ms:.4f} ms (per call "
          f"{plain_call:.4f}), SDPA {lib_ms:.4f} ms (per call "
          f"{lib_call:.4f}), bound {bound:.5f} ms "
          f"({nbytes / 1e6:.2f} MB -> {t_bytes:.5f} ms, "
          f"{nflop / 1e9:.3f} GFLOP -> {t_ops:.5f} ms); f32 kernel "
          f"{ms32:.4f} ms, f32 plain {plain32:.4f} ms, f32 SDPA "
          f"{lib32:.4f} ms, f32 bound "
          f"{bound32:.5f} ms")
    return {"name": "flash_fwd", "route": "cuda",
            "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
            "replaces": "ray_tpu/ops/flash_attention.py:38",
            "launches": None, "max_abs_err": path_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms, "f32_ms": ms32, "f32_bound_ms": bound32,
            "f32_plain_ms": plain32, "f32_library_ms": lib32,
            "bert_shape": bert_forward_times(name, card, rand, bert_err)}


def bert_forward_times(name: str, card: str, rand, err: float) -> dict:
    """The flash forward at BERT-base's training shape, [32, 12, 512, 64]
    bf16 non-causal (what every layer of phase 12's BERT step launches;
    ``err`` is its error against the plain version there): device ms of
    the kernel, its plain version and SDPA, and the bound."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_reference)

    b, h, s, d = BERT_SHAPE
    q, k, v = (rand((b, h, s, d), torch.bfloat16) for _ in range(3))
    ms = device_ms(lambda: flash_attention(q, k, v, causal=False))
    plain_ms = device_ms(lambda: flash_attention_reference(
        q, k, v, causal=False), 3)
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    bw, flops = rates(name)
    nbytes, nflop = attention_work(b, h, s, s, d, False, 2)
    t_bytes, t_ops = nbytes / bw * 1e3, nflop / flops * 1e3
    bound = max(t_bytes, t_ops)
    print(f"[kernel] flash_fwd [{b},{h},{s},{d}] bf16 non-causal (BERT-base "
          f"training) on {card}: kernel {ms:.4f} ms "
          f"({nflop / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, SDPA "
          f"{lib_ms:.4f} ms, bound {bound:.5f} ms ({nbytes / 1e6:.2f} MB -> "
          f"{t_bytes:.5f} ms, {nflop / 1e9:.3f} GFLOP -> {t_ops:.5f} ms), "
          f"max_abs_err {err:.3e}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": err}


def forward_err(label, out, lse, q, k, v, causal) -> float:
    """Max abs error of the forward kernel's out (and lse, when given)
    against the plain version on the same values upcast exactly to f32.
    A row that sees no key must give out 0 and lse -inf where the plain
    version does, never NaN; the lse error is over the other rows."""
    from ray_tpu_torch.ops.flash_attention import flash_attention_reference

    ref, ref_lse = flash_attention_reference(q.float(), k.float(), v.float(),
                                             causal=causal)
    check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
    err = (out.float() - ref).abs().max().item()
    dead = ref_lse == float("-inf")
    if dead.any():
        check(bool((out[dead] == 0).all()), f"{label}: a row without keys "
              f"has non-zero output")
        print(f"[kernel] {label}: {int(dead.sum())} rows without keys give "
              f"output 0" + ("" if lse is None else " and lse -inf"))
    if lse is not None:
        check(not bool(torch.isnan(lse).any()), f"{label}: NaN in lse")
        check(torch.equal(lse == float("-inf"), dead),
              f"{label}: lse is -inf on other rows than the plain version's")
        if (~dead).any():
            err = max(err, (lse - ref_lse)[~dead].abs().max().item())
    return err


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


# the engines of phase 6 by launch path: the slot engine, and the paged
# engine speculating with each drafter (the serve bench's settings)
SPEC_ENGINE = dict(max_slots=8, kv_block_size=16, prefill_chunk=16)
ENGINE_PATHS = {
    "serve_slot": dict(max_slots=4, paged=False),
    "serve_spec_ngram": dict(SPEC_ENGINE, speculate="ngram", speculate_k=8),
    "serve_spec_self": dict(SPEC_ENGINE, speculate="self", speculate_k=4,
                            draft_layers=2),
}


def assert_blocks_returned(engine, label: str):
    """Idle paged engine: every block is free or held by the prefix index
    alone, and evicting the index leaves all free with refcount 0."""
    st = engine.stats()
    check(st["active_slots"] == 0 and st["blocks_free"]
          + st["prefix_cached_blocks"] == st["blocks_total"],
          f"{label}: blocks leaked: {st}")
    engine.trie.evict(st["blocks_total"])
    pool = engine.pool
    check(pool.n_free == pool.n_blocks
          and all(pool.refcount(b) == 0 for b in range(pool.n_blocks + 1)),
          f"{label}: a block is still referenced after evicting the index")


def phase_engines_f32(card: str) -> dict:
    """The slot engine and both speculating engines in f32, TF32 off: the
    token-exact gate.  Returns {path: flash launches in its run}."""
    from ray_tpu_torch.models import gpt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt.GPTConfig.gpt2_124m(dtype=torch.float32)
    params = gpt.init_params(cfg, SEED, device="cuda")
    launches = engines_token_exact(cfg, params, ENGINE_PATHS, card,
                                   gate_drafts=True)
    print("[engines f32] every reply of the three engines token-exact "
          "against generate")
    return launches


def engines_token_exact(cfg, params, paths: dict, card: str, *,
                        gate_drafts: bool) -> dict:
    """Each engine of ``paths`` serves, all at once, the cold long prompt,
    the two shared-head prompts and a repetitive one (16 greedy tokens
    each): every reply must equal the port's ``generate``, the flash
    kernel must launch n_layers times per full-width prefill (once per
    admission on the slot engine), and a paged engine must end with
    every block returned.  With ``gate_drafts`` the n-gram engine must
    accept drafts and the self-drafter must draft.  Returns {path: flash
    launches in its run}."""
    from ray_tpu_torch.inference import EngineConfig, GPTServer
    from ray_tpu_torch.models import gpt

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    prompts = requests(cfg.vocab_size)[:3] + [[1, 2, 3, 4] * 12]
    want = [gpt.generate(params, cfg, torch.tensor([p], device="cuda"), 16,
                         temperature=0.0)[0, len(p):].tolist()
            for p in prompts]
    launches = {}
    for path, kw in paths.items():
        srv = GPTServer(cfg, EngineConfig(**kw), params=params)
        try:
            torch.cuda.synchronize()
            fa.launches = 0              # this path's run starts here
            t0 = time.perf_counter()
            handles = [srv.engine.submit(p, max_new=16) for p in prompts]
            got = [h.result(timeout=300) for h in handles]
            torch.cuda.synchronize()
            launches[path] = fa.launches  # ... and ends here
            wall = time.perf_counter() - t0
            st = srv.engine_stats()
            print(f"[{path} f32] {len(prompts)} requests in {wall:.3f} s on "
                  f"{card}: flash launches {launches[path]}, full-width "
                  f"prefills {st['full_prefills']}, chunk prefills "
                  f"{st['chunk_prefills']}, decode/verify steps "
                  f"{st['decode_iterations']}, tokens per step "
                  f"{st['tokens_per_step']:.4f}, drafted "
                  f"{st['spec_drafted_tokens']}, accepted "
                  f"{st['spec_accepted_tokens']}")
            for p, g, w in zip(prompts, got, want):
                check(g == w, f"{path} f32: the reply to a {len(p)}-token "
                      f"prompt differs from generate: {g} vs {w}")
            check(st["full_prefills"] >= 1, f"{path}: no full-width prefill")
            check(launches[path] == cfg.n_layers * st["full_prefills"],
                  f"{path}: flash kernel launched {launches[path]} times for "
                  f"{st['full_prefills']} full-width prefills of "
                  f"{cfg.n_layers} layers")
            if not kw.get("paged", True):
                check(st["full_prefills"] == len(prompts),
                      f"slot engine: {st['full_prefills']} prefills for "
                      f"{len(prompts)} admissions")
            else:
                assert_blocks_returned(srv.engine, path)
            if gate_drafts and kw.get("speculate") == "ngram":
                check(st["spec_accepted_tokens"] > 0
                      and st["tokens_per_step"] > 1, "the n-gram engine "
                      f"accepted no draft: {st}")
            if gate_drafts and kw.get("speculate") == "self":
                check(st["spec_drafted_tokens"] > 0,
                      f"the self-drafter drafted nothing: {st}")
        finally:
            srv.teardown()
    return launches


# request builders: copies of benchmarks/serve_bench.py's (that module
# imports the JAX package)
def shared_prefix_requests(n, *, seed, vocab, heads, head_len, tail_len,
                           max_new):
    """N requests over K distinct prompt heads, each with a random tail."""
    rng = np.random.default_rng(seed)
    head_toks = [rng.integers(0, vocab, head_len).tolist()
                 for _ in range(heads)]
    return [(head_toks[i % heads] + rng.integers(0, vocab, tail_len).tolist(),
             max_new) for i in range(n)]


def mixed_requests(*, seed, vocab, n_short, n_long, short_len, long_len,
                   short_new, long_new):
    """Short requests interleaved with long prompts."""
    rng = np.random.default_rng(seed)
    out = []
    longs = set(np.linspace(0, n_short + n_long - 1, n_long).astype(int))
    for i in range(n_short + n_long):
        if i in longs:
            pl = int(rng.integers(long_len // 2, long_len + 1))
            out.append((rng.integers(0, vocab, pl).tolist(), long_new))
        else:
            pl = int(rng.integers(short_len // 2, short_len + 1))
            out.append((rng.integers(0, vocab, pl).tolist(), short_new))
    return out


def pct(xs, p):
    """serve_bench's percentile: the nearest rank, on sorted values."""
    xs = sorted(xs)
    i = min(len(xs) - 1, max(0, int(round(p / 100 * (len(xs) - 1)))))
    return xs[i] if xs else 0.0


def run_arm(cfg, params, reqs, engine_cfg):
    """serve_bench's ``run_engine_arm``: warm the engine off the clock on
    a dedicated prompt, submit every request at once, wait for all.
    Returns (numbers over the timed run, replies)."""
    from ray_tpu_torch.inference import GPTServer

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    srv = GPTServer(cfg, engine_cfg, params=params)
    eng = srv.engine
    try:
        wp = [(i % 7) + 1 for i in range(cfg.max_seq * 3 // 4)]
        eng.generate(wp, max_new=2, timeout=600)
        eng.generate(wp, max_new=2, timeout=600)
        if engine_cfg.speculate is not None:
            eng.generate(wp, max_new=engine_cfg.speculate_k + 4, timeout=600)
        st0 = eng.stats()
        torch.cuda.synchronize()
        fa.launches = 0
        t0 = time.perf_counter()
        handles = [eng.submit(p, max_new=m) for p, m in reqs]
        outs = [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t0
        launches = fa.launches
        st = eng.stats()
        if engine_cfg.paged:
            assert_blocks_returned(eng, "arm")
    finally:
        srv.teardown()
    d = {k: st[k] - st0[k] for k in (
        "row_steps", "row_tokens", "spec_drafted_tokens",
        "spec_accepted_tokens", "full_prefills")}
    ttft = [h.first_token_s - h.created_s for h in handles]
    # serve_bench's ITL: (e2e - TTFT) / (n - 1), a stream's token period
    itl = [(h.finished_s - h.first_token_s) / (len(h.tokens) - 1)
           for h in handles if len(h.tokens) > 1]
    for (p, m), out in zip(reqs, outs):
        check(len(out) == m and all(0 <= t < cfg.vocab_size for t in out),
              f"malformed reply of {len(out)} tokens for max_new {m}")
    check(launches == cfg.n_layers * d["full_prefills"],
          f"flash kernel launched {launches} times for "
          f"{d['full_prefills']} full-width prefills")
    return {"wall_s": wall, "req_s": len(reqs) / wall,
            "tokens_s": sum(map(len, outs)) / wall,
            "ttft_p50_s": pct(ttft, 50), "ttft_p99_s": pct(ttft, 99),
            "itl_p50_s": pct(itl, 50), "itl_p99_s": pct(itl, 99),
            "tokens_per_step": d["row_tokens"] / d["row_steps"],
            "spec_accept_rate": (d["spec_accepted_tokens"]
                                 / d["spec_drafted_tokens"]
                                 if d["spec_drafted_tokens"] else 0.0),
            "launches": launches, "full_prefills": d["full_prefills"]}, outs


def phase_engines_bf16(card: str):
    """The serve bench's engine arms 1 and 3 at its quick sizes, in bf16:
    timed on the card, printed, not gated."""
    from ray_tpu_torch.inference import EngineConfig
    from ray_tpu_torch.models import gpt

    cfg = gpt.GPTConfig.gpt2_124m()      # bf16 activations, f32 params
    params = gpt.init_params(cfg, SEED, device="cuda")
    vocab = cfg.vocab_size
    # arm 1: shared prefix, 12 requests over 4 heads of 192 tokens
    reqs1 = shared_prefix_requests(12, seed=11, vocab=vocab, heads=4,
                                   head_len=192, tail_len=8, max_new=4)
    slot, _ = run_arm(cfg, params, reqs1,
                      EngineConfig(max_slots=8, paged=False))
    paged, _ = run_arm(cfg, params, reqs1, EngineConfig(**SPEC_ENGINE))
    print(f"[arm 1 bf16] shared prefix, {len(reqs1)} requests on {card}: "
          f"slot {slot['req_s']:.3f} requests/s ({slot['wall_s']:.3f} s, "
          f"flash launches {slot['launches']} for {slot['full_prefills']} "
          f"admissions), paged {paged['req_s']:.3f} requests/s "
          f"({paged['wall_s']:.3f} s), paged/slot "
          f"{paged['req_s'] / slot['req_s']:.3f}")
    check(slot["full_prefills"] == len(reqs1),
          f"slot arm: {slot['full_prefills']} prefills for {len(reqs1)} "
          f"admissions")
    # arm 3: speculation off / n-gram / self-draft on one request set
    reqs3 = (shared_prefix_requests(12, seed=17, vocab=vocab, heads=4,
                                    head_len=96, tail_len=8, max_new=32)
             + mixed_requests(seed=19, vocab=vocab, n_short=6, n_long=2,
                              short_len=16, long_len=120, short_new=32,
                              long_new=32))
    random.Random(23).shuffle(reqs3)
    arms, outs = {}, {}
    for label, kw in (("off", {}),
                      ("ngram", dict(speculate="ngram", speculate_k=8)),
                      ("self", dict(speculate="self", speculate_k=4,
                                    draft_layers=2))):
        arms[label], outs[label] = run_arm(
            cfg, params, reqs3, EngineConfig(**SPEC_ENGINE, **kw))
    for label, a in arms.items():
        same = np.mean([o == r for o, r in zip(outs[label], outs["off"])])
        print(f"[arm 3 bf16] speculate {label}, {len(reqs3)} requests on "
              f"{card}: TTFT p50/p99 {a['ttft_p50_s'] * 1e3:.2f}/"
              f"{a['ttft_p99_s'] * 1e3:.2f} ms, ITL p50/p99 "
              f"{a['itl_p50_s'] * 1e3:.3f}/{a['itl_p99_s'] * 1e3:.3f} ms, "
              f"tokens per step {a['tokens_per_step']:.4f}, accept rate "
              f"{a['spec_accept_rate']:.4f}, wall {a['wall_s']:.3f} s, "
              f"{a['tokens_s']:.1f} tokens/s, replies equal to the off "
              f"arm's {same:.3f}")


def grad_err(got, ref, dtype):
    """(max abs error, whether it is within the dtype's bound).  f32:
    max |got - ref| <= 1e-4 (1 + max |ref|).  bf16: tests/test_ops.py's
    grad bounds, mean abs error < 1e-3 and |got - ref| <= 0.1 + 0.1 |ref|
    everywhere."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    err = diff.max().item()
    if dtype == torch.float32:
        return err, err <= 1e-4 * (1 + ref.abs().max().item())
    return err, (diff.mean().item() < 1e-3
                 and bool((diff <= 0.1 + 0.1 * ref.abs()).all()))


def phase_backward_kernels(name: str, card: str) -> list:
    from ray_tpu_torch.ops.attention import mha_reference

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    def grads(q, k, v, do, causal):
        """Both kernels and both plain versions on the same inputs: the
        forward kernel's out and lse, and delta from them."""
        s = q.shape[-1] ** -0.5
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
        delta = fa._delta(out, do)
        dk, dv = fa._launch_bwd_kv(q, k, v, do, lse, delta, s, causal)
        dq = fa._launch_bwd_dq(q, k, v, do, lse, delta, s, causal)
        torch.cuda.synchronize()
        rk, rv = fa._bwd_kv_reference(q, k, v, do, lse, delta, s, causal,
                                      512, 512)
        rq = fa._bwd_dq_reference(q, k, v, do, lse, delta, s, causal,
                                  512, 512)
        return (dq, dk, dv), (rq, rk, rv)

    def held(label, dtype, got, ref):
        errs = [grad_err(g, r, dtype) for g, r in zip(got, ref)]
        for kname, pair in (("flash_bwd_dq", errs[:1]),
                            ("flash_bwd_kv", errs[1:])):
            err = max(e for e, _ in pair)
            ok = all(o for _, o in pair)
            print(f"[kernel] {kname} {label} {str(dtype).split('.')[-1]} "
                  f"max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}")
            check(ok, f"{kname} {label} {dtype}: outside its bound "
                      f"(max abs error {err})")
        return max(e for e, _ in errs[1:]), errs[0][0]

    cases = [  # (label, b, h, sq, skv, d, causal)
        ("path", 16, 12, 1024, 1024, 64, True),
        ("non-causal", 1, 12, 1024, 1024, 64, False),
        ("cross q128/kv384", 1, 12, 128, 384, 64, True),
        ("ragged q96/kv200", 1, 12, 96, 200, 64, True),
        ("ragged non-causal", 2, 3, 96, 200, 64, False),
        ("rows without keys q200/kv96", 1, 4, 200, 96, 64, True),
        ("d128", 1, 8, 512, 512, 128, True),
        ("d128 ragged", 1, 8, 130, 300, 128, True),
        ("d256", 1, 4, 256, 256, 256, True),
        ("d256 ragged non-causal", 1, 4, 100, 130, 256, False),
        ("decode-like q1/kv1000", 1, 12, 1, 1000, 64, True),
        ("ragged kv77", 1, 12, 77, 77, 64, True),
        ("ragged kv77 non-causal", 2, 3, 40, 77, 64, False),
        ("BERT-base training shape", 32, 12, 512, 512, 64, False),
    ]
    path_err, bert_err = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, b, h, sq, skv, d, causal in cases:
            q, do = (rand((b, h, sq, d), dtype) for _ in range(2))
            k, v = (rand((b, h, skv, d), dtype) for _ in range(2))
            got, ref = grads(q, k, v, do, causal)
            check(all(bool(torch.isfinite(g).all()) for g in got),
                  f"non-finite backward output, {label} {dtype}")
            e_kv, e_dq = held(f"{label} [{b},{h},{sq}/{skv},{d}] "
                              f"causal={causal}", dtype, got, ref)
            if label == "path" and dtype == torch.bfloat16:
                path_err = {"flash_bwd_kv": e_kv, "flash_bwd_dq": e_dq}
            if label.startswith("BERT") and dtype == torch.bfloat16:
                bert_err = {"flash_bwd_kv": e_kv, "flash_bwd_dq": e_dq}

    # as the model hands them over: q, k, v strided views of one qkv
    # projection; do a transposed view of a [b, s, h, d] gradient, and
    # one whose head dim is not contiguous
    for dtype in (torch.bfloat16, torch.float32):
        qkv = rand((2, 1024, 3 * 768), dtype)
        q, k, v = (t.reshape(2, 1024, 12, 64).transpose(1, 2)
                   for t in qkv.split(768, dim=-1))
        for label, do in (
                ("strided qkv, transposed do",
                 rand((2, 1024, 12, 64), dtype).transpose(1, 2)),
                ("strided qkv, do head dim not contiguous",
                 rand((2, 12, 64, 1024), dtype).transpose(-1, -2))):
            check(not do.is_contiguous(), "do should be non-contiguous")
            held(label, dtype, *grads(q, k, v, do, True))

    # q, k, v and do contiguous at a 1-element offset: not 16-byte
    # aligned, so the bf16 route copies them (the f32 route reads them as
    # they are); each kernel still launches once
    for dtype in (torch.bfloat16, torch.float32):
        shape = (1, 12, 200, 64)
        q, k, v, do = (rand((int(np.prod(shape)) + 1,), dtype)[1:].view(shape)
                       for _ in range(4))
        check(not fa._cp_async_aligned(do), "a 1-element offset view "
              "should not pass the alignment check")
        n0 = (fa.bwd_kv_launches, fa.bwd_dq_launches)
        held("1-element offset views [1,12,200,64] causal=True", dtype,
             *grads(q, k, v, do, True))
        n1 = (fa.bwd_kv_launches - n0[0], fa.bwd_dq_launches - n0[1])
        check(n1 == (1, 1), f"offset views {dtype}: launches {n1}")

    # the op's autograd against autograd through plain attention, f32
    q, k, v, w = (rand((2, 4, 256, 64), torch.float32) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    g_flash = torch.autograd.grad(
        (fa.flash_attention(*leaves, causal=True) * w).sum(), leaves)
    g_plain = torch.autograd.grad(
        (mha_reference(*leaves, causal=True) * w).sum(), leaves)
    for nm, g, r in zip("qkv", g_flash, g_plain):
        err, ok = grad_err(g, r, torch.float32)
        print(f"[kernel] autograd d{nm} through the flash op vs plain "
              f"attention f32 max_abs_err {err:.3e} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"autograd d{nm} differs from plain attention by {err}")

    # times at the training shape, [16, 12, 1024, 64] bf16 causal, and at
    # BERT-base's, [32, 12, 512, 64] bf16 non-causal
    times = backward_times(name, card, rand, 16, 12, 1024, 64, True)
    bert = backward_times(name, card, rand, *BERT_SHAPE, False)
    entries = []
    for kname, line in (("flash_bwd_kv", 192), ("flash_bwd_dq", 238)):
        t = times[kname]
        entries.append({
            "name": kname, "route": "cuda",
            "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": f"ray_tpu/ops/flash_attention.py:{line}",
            "launches": None, "max_abs_err": path_err[kname],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "bert_shape": {**bert[kname], "max_abs_err": bert_err[kname]}})
    return entries


def backward_times(name, card, rand, b, h, s, d, causal) -> dict:
    """Device ms of both backward kernels on one bf16 shape beside their
    bound, their plain versions and SDPA's backward (its forward +
    backward minus its forward), and the forward's against SDPA's:
    {kernel: {"ms", "plain_ms", "library_ms", "bound_ms", "bound_by"}}."""
    import torch.nn.functional as F

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    shape = f"[{b},{h},{s},{d}] bf16 {'causal' if causal else 'non-causal'}"
    q, k, v, do = (rand((b, h, s, d), torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
    delta = fa._delta(out, do)
    fwd_ms = device_ms(lambda: fa.flash_attention(q, k, v, causal=causal))
    fwd_call = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                       reps=5, inner=3)
    fwd_plain_ms = time_ms(lambda: fa.flash_attention_reference(
        q, k, v, causal=causal), reps=3, inner=2)
    calls = {"flash_bwd_kv": lambda: fa._launch_bwd_kv(
                 q, k, v, do, lse, delta, scale, causal),
             "flash_bwd_dq": lambda: fa._launch_bwd_dq(
                 q, k, v, do, lse, delta, scale, causal)}
    ms = {kname: device_ms(fn) for kname, fn in calls.items()}
    call_ms = {kname: time_ms(fn, reps=5, inner=3)
               for kname, fn in calls.items()}
    plain_ms = {
        "flash_bwd_kv": time_ms(lambda: fa._bwd_kv_reference(
            q, k, v, do, lse, delta, scale, causal, 512, 512), reps=3,
            inner=2),
        "flash_bwd_dq": time_ms(lambda: fa._bwd_dq_reference(
            q, k, v, do, lse, delta, scale, causal, 512, 512), reps=3,
            inner=2)}
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def sdpa():
        return F.scaled_dot_product_attention(*leaves, is_causal=causal)

    sdpa_call = time_ms(lambda: sdpa().detach(), reps=5, inner=3)
    sdpa_fwd = device_ms(lambda: sdpa().detach())
    sdpa_both = device_ms(lambda: torch.autograd.grad(sdpa(), leaves, do))
    lib_ms = sdpa_both - sdpa_fwd
    bw, flops = rates(name)
    fb, ff = attention_work(b, h, s, s, d, causal, 2)
    print(f"[kernel] flash_fwd {shape} on {card}: "
          f"kernel {fwd_ms:.4f} ms ({ff / fwd_ms / 1e9:.1f} TFLOP/s; per "
          f"call {fwd_call:.4f} ms), plain {fwd_plain_ms:.4f} ms, SDPA "
          f"{sdpa_fwd:.4f} ms (per call {sdpa_call:.4f}), bound "
          f"{max(fb / bw, ff / flops) * 1e3:.5f} ms"
          f" ({'bytes' if fb / bw >= ff / flops else 'operations'})")
    out = {}
    for kname in calls:
        nbytes, nflop = backward_work(kname, b, h, s, s, d, causal, 2)
        t_bytes, t_ops = nbytes / bw * 1e3, nflop / flops * 1e3
        bound = max(t_bytes, t_ops)
        print(f"[kernel] {kname} {shape} on {card}: "
              f"kernel {ms[kname]:.4f} ms ({nflop / ms[kname] / 1e9:.1f} "
              f"TFLOP/s; per call {call_ms[kname]:.4f} ms), plain "
              f"{plain_ms[kname]:.4f} ms (CUDA events),"
              f" SDPA backward {lib_ms:.4f} ms (device time, fwd+bwd "
              f"{sdpa_both:.4f} - fwd {sdpa_fwd:.4f}), bound {bound:.5f} ms "
              f"({nbytes / 1e6:.2f} MB -> {t_bytes:.5f} ms, "
              f"{nflop / 1e9:.3f} GFLOP -> {t_ops:.5f} ms)")
        out[kname] = {"ms": ms[kname], "plain_ms": plain_ms[kname],
                      "library_ms": lib_ms, "bound_ms": bound,
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations"}
    both = ms["flash_bwd_kv"] + ms["flash_bwd_dq"]
    print(f"[kernel] flash_bwd_kv + flash_bwd_dq {shape} {both:.4f} ms "
          f"against SDPA's backward {lib_ms:.4f} ms: {both / lib_ms:.2f}x")
    return out


def train_run(cfg, params, batch, steps, timed=0, label="train",
              loss_fn=None, tx=None):
    """``steps`` make_train_step steps on one batch from a copy of
    ``params``, then ``timed`` more and one under torch.profiler.  The
    loss is ``loss_fn(params, batch, cfg)`` (the GPT's by default) and the
    optimizer ``tx`` (AdamW(3e-4, weight_decay=0.1) by default).  The
    launch counters are zeroed just before the first step and read after
    each of the ``steps``.  Returns (losses, grad norms, step ms from
    CUDA events over all steps, per-step launches of (flash_fwd,
    flash_bwd_kv, flash_bwd_dq), {kernel: device ms in the profiled step}
    with "all kernels" for the sum over every kernel)."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.train import adamw, make_train_step

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    loss_fn = loss_fn or gpt.loss_fn
    init_fn, step_fn = make_train_step(
        lambda p, b: loss_fn(p, b, cfg), tx or adamw(3e-4, weight_decay=0.1))
    state = init_fn(params)
    n = steps + timed
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    metrics, counts = [], []
    torch.cuda.synchronize()
    fa.launches = fa.bwd_kv_launches = fa.bwd_dq_launches = 0
    seen = (0, 0, 0)
    events[0].record()
    for i in range(n):
        state, m = step_fn(state, batch)
        events[i + 1].record()
        if i < steps:
            now = (fa.launches, fa.bwd_kv_launches, fa.bwd_dq_launches)
            counts.append(tuple(a - b for a, b in zip(now, seen)))
            seen = now
            metrics.append(m)
    torch.cuda.synchronize()
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(n)]
    losses = [m["loss"].item() for m in metrics]
    norms = [m["grad_norm"].item() for m in metrics]
    kernel_ms = {}
    if timed:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step_fn(state, batch)
            torch.cuda.synchronize()
        cuda = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        kernel_ms["all kernels"] = sum(
            e.self_device_time_total for e in cuda) / 1e3
        for kname in ("flash_fwd", "flash_bwd_kv", "flash_bwd_dq"):
            kernel_ms[kname] = sum(e.self_device_time_total for e in cuda
                                   if f"{kname}_kernel<" in e.key) / 1e3
        top = sorted(cuda, key=lambda e: -e.self_device_time_total)[:8]
        print(f"[{label}] profiled step, top kernels by "
              f"device ms: " + "; ".join(
                  f"{e.key[:70]} x{e.count} "
                  f"{e.self_device_time_total / 1e3:.3f}" for e in top))
    del state
    torch.cuda.empty_cache()
    return losses, norms, step_ms, counts, kernel_ms


def phase_training(name: str, card: str):
    from ray_tpu_torch.models import gpt

    base = gpt.GPTConfig.gpt2_124m(remat=True, remat_policy="dots")
    params = gpt.init_params(base, SEED)
    n_params = count_params(params)
    print(f"[train] GPT-2 124M: {n_params} params")
    # bench.py's training flops per token: 6N + the attention term
    return train_policies(name, card, base, params, n_params, "train")


def count_params(params) -> int:
    return sum(t.numel() for t in params["layers"].values()) + sum(
        t.numel() for k, t in params.items() if k != "layers")


def train_policies(name: str, card: str, base, params, n_flop_params: int,
                   label: str, batch_n: int = 16) -> dict:
    """Five make_train_step steps of AdamW(3e-4, weight_decay=0.1) on one
    repeated b16 s1024 batch under remat "dots" and then "dots_flash",
    each followed by 10 timed steps and one profiled one: launches per
    step (2L / L flash forwards, L of each backward kernel), finite and
    falling loss, step 1 against plain attention.  MFU counts
    ``6 * n_flop_params + 12 L d s`` FLOPs per token (bench.py's
    formula) against the card's dense bf16 peak.  Returns ({path: [flash
    forward, bwd_kv, bwd_dq launches over the five steps]}, {policy:
    steady step ms})."""
    L, seq, steps = base.n_layers, 1024, 5
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    batch = {"tokens": torch.randint(0, base.vocab_size, (batch_n, seq + 1),
                                     generator=gen, device="cuda")}
    flops_per_token = 6 * n_flop_params + 12 * L * base.d_model * seq
    peak = rates(name)[1]
    launches, steady_ms = {}, {}
    first = {}
    for policy, fwd_per_step in (("dots", 2 * L), ("dots_flash", L)):
        cfg = dataclasses.replace(base, remat_policy=policy)
        losses, norms, step_ms, counts, kernel_ms = train_run(
            cfg, params, batch, steps, timed=10, label=f"{label} {policy}")
        steady = steady_ms[policy] = statistics.median(step_ms[steps:])
        tps = batch_n * seq / (steady / 1e3)
        print(f"[{label} {policy}] b{batch_n} s{seq} bf16 on {card}: losses "
              f"{[round(x, 5) for x in losses]}, grad norms "
              f"{[round(x, 5) for x in norms]}")
        print(f"[{label} {policy}] step ms {[round(x, 3) for x in step_ms]}; "
              f"steady step (median of the last 10) {steady:.3f} ms, "
              f"{tps:.1f} tokens/s, MFU {flops_per_token * tps / peak:.4f} "
              f"({flops_per_token} FLOPs per token of {peak:.3g} FLOP/s)")
        print(f"[{label} {policy}] one profiled step, device ms per kernel "
              f"and share of the steady step: " + (", ".join(
                  f"{k} {v:.3f} ({v / steady:.3f})"
                  for k, v in kernel_ms.items())
                  if kernel_ms["all kernels"] > 0 else "not measured "
                  "(the profiler saw no device time)"))
        print(f"[{label} {policy}] launches per step (flash_fwd, "
              f"flash_bwd_kv, flash_bwd_dq): {counts}")
        for c in counts:
            check(c == (fwd_per_step, L, L),
                  f"{label} {policy}: a step launched {c}, expected "
                  f"({fwd_per_step}, {L}, {L})")
        check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
              f"{label} {policy}: non-finite loss or grad norm")
        check(losses[-1] < losses[0], f"{label} {policy}: loss did not fall "
              f"over {steps} steps on one batch: {losses}")
        first[policy] = (losses[0], norms[0])
        launches[f"{label}_{policy}"] = [sum(c[i] for c in counts)
                                         for i in range(3)]

    # step 1 on plain attention, the same params and batch.  bf16 bound:
    # activations are bf16 on both sides and round at different points
    # (the plain path rounds probabilities and dP to bf16, the kernels
    # keep them in f32), so loss within 5e-3 relative, grad_norm 5e-2
    ref_cfg = dataclasses.replace(base, attn_impl="reference")
    losses, norms, _, counts, _ = train_run(ref_cfg, params, batch, 1)
    check(counts == [(0, 0, 0)], f"plain attention launched {counts}")
    for policy, (loss, norm) in first.items():
        dl = abs(loss - losses[0]) / abs(losses[0])
        dn = abs(norm - norms[0]) / abs(norms[0])
        ok = dl <= 5e-3 and dn <= 5e-2
        print(f"[{label} {policy}] step 1 vs plain attention: loss "
              f"{loss:.6f} vs {losses[0]:.6f} (rel {dl:.2e}, bound 5e-3), "
              f"grad_norm {norm:.6f} vs {norms[0]:.6f} (rel {dn:.2e}, "
              f"bound 5e-2) {'ok' if ok else 'FAIL'}")
        check(ok, f"{label} {policy}: step 1 disagrees with plain attention")
    return launches, steady_ms


# ------------------------------------------------ mixture of experts

def moe_config(**kw):
    """tiny_moe's routing (4 experts, top-2) at GPT-2 124M widths: d 768,
    12 heads, 12 layers, d_ff 3072, vocab 50304."""
    from ray_tpu_torch.models import gpt

    return gpt.GPTConfig.gpt2_124m(n_experts=4, expert_top_k=2, **kw)


MOE_ENGINE_PATHS = {
    "serve_moe_paged": dict(SPEC_ENGINE),
    "serve_moe_ngram": dict(SPEC_ENGINE, speculate="ngram", speculate_k=8),
    "serve_moe_self": dict(SPEC_ENGINE, speculate="self", speculate_k=4,
                           draft_layers=2),
}


def phase_moe_serving(card: str) -> dict:
    """The MoE config at capacity factor 4.0, where capacity never binds
    (an expert takes at most one slot per token, C = 2s).  In f32 with
    TF32 off the paged engine and both speculating engines must answer
    token-exact (the phase 6 gate, draft counts printed only), and the
    slot engine must refuse the config at construction.  Then the same
    requests in bf16 on the paged engine, beside the dense model's:
    TTFT and decode ms per step, printed.  Returns {path: flash
    launches}."""
    from ray_tpu_torch.inference import (EngineConfig, GPTServer,
                                         MoEDecodeUnsupported)
    from ray_tpu_torch.models import gpt

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = moe_config(capacity_factor=4.0, dtype=torch.float32)
    params = gpt.init_params(cfg, SEED, device="cuda")
    print(f"[serve_moe] GPT-2 124M widths, 4 experts top-2: "
          f"{count_params(params)} params")
    try:
        srv = GPTServer(cfg, EngineConfig(max_slots=4, paged=False),
                        params=params)
    except MoEDecodeUnsupported as e:
        print(f"[serve_moe] slot engine refused at construction: {e}")
    else:
        srv.teardown()
        raise SmokeFailure("the slot engine accepted an MoE config")
    launches = engines_token_exact(cfg, params, MOE_ENGINE_PATHS, card,
                                   gate_drafts=False)
    print("[serve_moe f32] every reply of the three MoE engines "
          "token-exact against generate")
    del params

    prompts = requests(cfg.vocab_size)[:3] + [[1, 2, 3, 4] * 12]
    warm = requests(cfg.vocab_size, seed=SEED + 1)[:3] + [[5, 6, 7, 8] * 12]
    rows = {}
    for path, c in (("serve_moe_bf16", moe_config(capacity_factor=4.0)),
                    ("serve_dense_bf16", gpt.GPTConfig.gpt2_124m())):
        srv = GPTServer(c, EngineConfig(**SPEC_ENGINE), seed=SEED)
        try:
            for h in [srv.engine.submit(p, max_new=16) for p in warm]:
                h.result(timeout=300)
            st0 = srv.engine_stats()
            torch.cuda.synchronize()
            fa.launches = 0              # this path's run starts here
            handles = [srv.engine.submit(p, max_new=16) for p in prompts]
            outs = [h.result(timeout=300) for h in handles]
            torch.cuda.synchronize()
            launches[path] = fa.launches  # ... and ends here
            full = srv.engine_stats()["full_prefills"] - st0["full_prefills"]
        finally:
            srv.teardown()
        for out in outs:
            check(len(out) == 16 and all(0 <= t < c.vocab_size
                                         for t in out),
                  f"{path}: malformed reply {out}")
        check(launches[path] == c.n_layers * full,
              f"{path}: flash kernel launched {launches[path]} times for "
              f"{full} full-width prefills")
        rows[path] = [((h.first_token_s - h.created_s) * 1e3,
                       (h.finished_s - h.first_token_s)
                       / (len(h.tokens) - 1) * 1e3) for h in handles]
    for i, p in enumerate(prompts):
        (mt, md), (dt, dd) = rows["serve_moe_bf16"][i], \
            rows["serve_dense_bf16"][i]
        print(f"[serve_moe bf16] prompt {len(p)} tokens, 4 requests at "
              f"once on {card}: TTFT {mt:.2f} ms (dense {dt:.2f}), decode "
              f"{md:.3f} ms per step (dense {dd:.3f})")
    print(f"[serve_moe bf16] flash launches {launches['serve_moe_bf16']} "
          f"(dense {launches['serve_dense_bf16']}) on {card}")
    return launches


def sync_warnings(cfg, params, batch) -> list:
    """The host syncs ``torch.cuda.set_sync_debug_mode("warn")`` reports
    in one make_train_step step (after a warm-up step), as "file:line:
    message".  The mode's one-time notice that it is a prototype is no
    sync and is left out."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.train import adamw, make_train_step

    init_fn, step_fn = make_train_step(lambda p, b: gpt.loss_fn(p, b, cfg),
                                       adamw(3e-4, weight_decay=0.1))
    state = init_fn(params)
    step_fn(state, batch)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step_fn(state, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    del state
    torch.cuda.empty_cache()
    return [f"{os.path.basename(w.filename)}:{w.lineno}: {w.message}"
            for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def phase_moe_training(name: str, card: str) -> dict:
    """The MoE config at its default capacity factor 1.25 (capacity binds:
    C = 640 of 1024 tokens per expert and row), trained as phase 7 trains
    the dense model; MFU over the ACTIVE parameters (the non-expert ones
    and top-k of the E experts' MLPs).  Then one step of each model under
    sync debug mode: the MoE step must add no host sync."""
    from ray_tpu_torch.models import gpt

    base = moe_config(remat=True, remat_policy="dots")
    params = gpt.init_params(base, SEED)
    n_params = count_params(params)
    E, k, d, f, L = (base.n_experts, base.expert_top_k, base.d_model,
                     base.d_ff, base.n_layers)
    n_active = n_params - L * (E - k) * (2 * d * f + f + d)
    print(f"[train_moe] GPT-2 124M widths, 4 experts top-2, capacity "
          f"factor {base.capacity_factor}: {n_params} params, {n_active} "
          f"active per token; MFU counts 6 * {n_active} + 12 L d s FLOPs "
          f"per token")
    launches, _ = train_policies(name, card, base, params, n_active,
                              "train_moe")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    batch = {"tokens": torch.randint(0, base.vocab_size, (16, 1025),
                                     generator=gen, device="cuda")}
    moe_syncs = sync_warnings(base, params, batch)
    del params
    dense = gpt.GPTConfig.gpt2_124m(remat=True, remat_policy="dots")
    dense_syncs = sync_warnings(dense, gpt.init_params(dense, SEED), batch)
    print(f"[train_moe] host syncs in one step under sync debug mode on "
          f"{card}: MoE {len(moe_syncs)} {moe_syncs}, dense "
          f"{len(dense_syncs)} {dense_syncs}")
    check(len(moe_syncs) <= len(dense_syncs),
          f"the MoE step syncs the host {len(moe_syncs)} times, the dense "
          f"one {len(dense_syncs)}")
    return launches


# ------------------------------------------------- cluster prefix plane

def phase_prefix_plane(card: str) -> dict:
    """Two paged engines at GPT-2 124M width in f32 (cache width 896, so a
    cold 512-token prompt takes the full-width prefill).  The holder
    serves a 512-token prompt; its 32 published blocks go out through
    ``prefix_extract`` and into the adopter through ``prefix_install``;
    the adopter then serves the prompt plus an 8-token tail.  Gates: the
    adopter's reply equals the holder's and ``generate``'s, the adopter
    runs no full-width prefill, 32 blocks are installed, no block leaks,
    and after a pool reset the old generation is refused.  Prints the
    extract and install times and rates, through the engines' op queue.
    Returns {path: flash launches}."""
    from ray_tpu_torch.inference import EngineConfig, GPTServer
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.serve.qos import StalePrefixGeneration

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt.GPTConfig.gpt2_124m(dtype=torch.float32)
    params = gpt.init_params(cfg, SEED, device="cuda")
    rng = np.random.default_rng(SEED + 5)
    prompt = rng.integers(0, cfg.vocab_size, 512).tolist()
    tail = rng.integers(0, cfg.vocab_size, 8).tolist()
    want = gpt.generate(params, cfg, torch.tensor([prompt + tail],
                                                  device="cuda"),
                        16, temperature=0.0)[0, 520:].tolist()
    ec = EngineConfig(max_seq=896)
    holder = GPTServer(cfg, ec, params=params)
    adopter = GPTServer(cfg, ec, params=params)
    launches = {}
    try:
        # the adopter's first request pays its first-call costs, off the
        # measured path
        adopter({"prompt": tail * 3, "max_tokens": 4})
        torch.cuda.synchronize()
        fa.launches = 0                  # the holder's run starts here
        holder({"prompt": prompt, "max_tokens": 8})
        torch.cuda.synchronize()
        launches["prefix_holder"] = fa.launches   # ... and ends here
        check(holder.engine_stats()["full_prefills"] == 1
              and launches["prefix_holder"] == cfg.n_layers,
              f"holder: {launches['prefix_holder']} flash launches, "
              f"expected one full-width prefill of {cfg.n_layers}")
        recs = [r for r in holder.prefix_export() if r["tokens"] == prompt]
        check(len(recs) == 1 and len(recs[0]["blocks"]) == 32,
              f"holder published {recs}")
        gen = recs[0]["generation"]
        extract_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            payload = holder.prefix_extract(None, prompt, gen)
            extract_ms.append((time.perf_counter() - t0) * 1e3)
        nbytes = payload["k"].nbytes + payload["v"].nbytes
        check(payload["k"].shape == payload["v"].shape == (
                  cfg.n_layers, 32, cfg.n_heads, 16, cfg.head_dim),
              f"payload shape {payload['k'].shape}")
        torch.cuda.synchronize()
        fa.launches = 0                  # the adopter's run starts here
        t0 = time.perf_counter()
        got = adopter.prefix_install(None, prompt, payload)
        install_ms = (time.perf_counter() - t0) * 1e3
        check(got == {"installed": 32, "already": False},
              f"install reported {got}")
        reply = adopter({"prompt": prompt + tail, "max_tokens": 16})
        torch.cuda.synchronize()
        launches["prefix_adopter"] = fa.launches  # ... and ends here
        st = adopter.engine_stats()
        check(st["full_prefills"] == 0 and launches["prefix_adopter"] == 0,
              f"adopter ran a full-width prefill: {st['full_prefills']}, "
              f"{launches['prefix_adopter']} flash launches")
        check(st["prefix_hit_tokens"] >= 512,
              f"adopter hit {st['prefix_hit_tokens']} prefix tokens")
        held = holder({"prompt": prompt + tail, "max_tokens": 16})
        check(reply["tokens"] == held["tokens"] == want,
              f"adopted reply {reply['tokens']}, holder's "
              f"{held['tokens']}, generate {want}")
        print(f"[prefix] adopter's reply token-exact against the holder's "
              f"and generate; TTFT on {card}: {reply['ttft_s'] * 1e3:.2f} "
              f"ms adopted vs {held['ttft_s'] * 1e3:.2f} ms on the holder "
              f"(own cache)")
        ext = statistics.median(extract_ms)
        print(f"[prefix] 32 blocks, {nbytes} bytes (k + v) on {card}: "
              f"prefix_extract {ext:.3f} ms median of 5 "
              f"({[round(x, 3) for x in extract_ms]}), "
              f"{nbytes / ext / 1e6:.3f} GB/s; prefix_install "
              f"{install_ms:.3f} ms, {nbytes / install_ms / 1e6:.3f} GB/s")
        hs = holder.engine_stats()
        check(hs["active_slots"] == 0 and hs["blocks_free"]
              + hs["prefix_cached_blocks"] == hs["blocks_total"],
              f"holder: blocks leaked: {hs}")
        # the reset runs on the holder's loop thread, as a failed step's
        # recovery does: the index goes first, then the pool
        eng = holder.engine
        eng._run_op(lambda: (eng.trie.clear(), eng.pool.reset()))
        try:
            holder.prefix_extract(None, prompt, gen)
        except StalePrefixGeneration as e:
            print(f"[prefix] after a pool reset, generation {gen} is "
                  f"refused: {e}")
        else:
            raise SmokeFailure("a reset pool served its old generation")
    finally:
        holder.teardown()
        adopter.teardown()
    assert_blocks_returned(adopter.engine, "prefix adopter")
    print("[prefix] the adopter shut down with every block free (the "
          "holder's blocks were audited before its reset)")
    return launches


# ------------------------------------------------------- replica contract

# the keys of ray_tpu/inference/serving.py GPTServer.fleet_stats, which
# the fleet router and the serve controller read
FLEET_STATS_KEYS = {
    "max_slots", "active_slots", "waiting_requests", "waiting_interactive",
    "blocks_total", "blocks_free", "block_utilization", "mesh_devices",
    "tp_shards", "prefix_hit_tokens", "prefix_lookup_tokens",
    "prefix_hit_rate", "spec_drafted_tokens", "spec_accepted_tokens",
    "spec_accept_rate", "tokens_per_step", "models", "stopped", "draining"}
ADMIT_CTX_KEYS = {"engine", "req", "need", "hit_tokens"}


class ScriptedPlan:
    """A fault plan for the port's gate: ``on_infer`` logs every point
    and its ctx, and runs ``actions[point](ctx, n)`` on the point's n-th
    call, if one is given."""

    def __init__(self, actions=None):
        self.actions = actions or {}
        self.log = []                    # (point, ctx copy)
        self.calls = {}

    def on_infer(self, point, ctx):
        n = self.calls[point] = self.calls.get(point, 0) + 1
        self.log.append((point, dict(ctx)))
        action = self.actions.get(point)
        if action is not None:
            action(ctx, n)


def reference_tokens(cfg, params, prompts, max_new=16) -> list:
    from ray_tpu_torch.models import gpt

    return [gpt.generate(params, cfg, torch.tensor([p], device="cuda"),
                         max_new, temperature=0.0)[0, len(p):].tolist()
            for p in prompts]


def served(srv, prompts, max_new=16):
    """Submit every prompt to the server's one engine at once; returns
    the handles once all are done (their errors kept, not raised)."""
    handles = [srv.engine.submit(p, max_new=max_new) for p in prompts]
    for h in handles:
        try:
            h.result(timeout=300)
        except Exception:
            pass
    return handles


def replica_multiplexing(cfg, card: str, launches: dict):
    """The multiplexed replica at capacity 1: base, alt, base again, each
    a cold 600-token prompt.  Returns the replica, with base resident."""
    from ray_tpu_torch.inference import EngineConfig, build_gpt_deployment
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.serve.context import replica_context

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    rng = np.random.default_rng(SEED + 11)
    cold = [rng.integers(0, cfg.vocab_size, 600).tolist() for _ in range(3)]
    order = [("base", 0, cold[0]), ("alt", 1, cold[1]), ("base", 0, cold[2])]
    want = []
    for _, seed, p in order:
        params = gpt.init_params(cfg, seed, device="cuda")
        want += reference_tokens(cfg, params, [p])
        del params
    gc.collect()
    dep = build_gpt_deployment(cfg=cfg, engine_cfg=EngineConfig(),
                               variants={"base": 0, "alt": 1},
                               multiplex_capacity=1)
    with replica_context("v1", "v1#0"):
        srv = dep.build_replica()
    mux = srv._mux
    load_ms, evict_ms = [], []
    loader, unloader = mux._loader, mux._unloader

    def timed(fn, out):
        def run(*a):
            t0 = time.perf_counter()
            r = fn(*a)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
            return r
        return run

    mux._loader, mux._unloader = timed(loader, load_ms), \
        timed(unloader, evict_ms)
    levels = []
    for i, ((model, _, p), w) in enumerate(zip(order, want)):
        path = f"serve_mux_{model}" + ("_again" if i == 2 else "")
        torch.cuda.synchronize()
        fa.launches = 0                  # this path's run starts here
        reply = srv({"prompt": p, "max_tokens": 16, "model": model})
        torch.cuda.synchronize()
        launches[path] = fa.launches     # ... and ends here
        gc.collect()
        levels.append(torch.cuda.memory_allocated())
        check(reply["tokens"] == w, f"{path}: the reply differs from "
              f"generate on its seed: {reply['tokens']} vs {w}")
        check(launches[path] == cfg.n_layers,
              f"{path}: {launches[path]} flash launches for one cold "
              f"full-width prefill of {cfg.n_layers} layers")
        check(srv.loaded_variants() == [model],
              f"{path}: resident {srv.loaded_variants()}")
    st = srv.multiplex_stats()
    check(st["loads"] == 3 and st["evictions"] == 2,
          f"multiplex_stats {st}: expected 3 loads and 2 evictions")
    # one variant resident after each eviction: the evicted engine's
    # params and pool are freed (equal shapes: equal allocations)
    check(all(abs(m - levels[0]) <= 64 << 20 for m in levels),
          f"device memory {levels} bytes after base, alt, base: an "
          f"evicted variant was not freed")
    names = [e.name for e in srv._engines()]
    check(names == ["v1#0:base"], f"engine names {names}")
    print(f"[replica mux] base, alt, base again token-exact against "
          f"generate on each seed; {cfg.n_layers} flash launches per load; "
          f"multiplex_stats loads {st['loads']}, evictions "
          f"{st['evictions']}; memory_allocated after each request "
          f"{levels} bytes on {card}")
    print(f"[replica mux] variant load ms (params, pool, engine) "
          f"{[round(x, 3) for x in load_ms]}, evict ms (engine "
          f"shutdown) {[round(x, 3) for x in evict_ms]} on {card}")
    return srv


def replica_surface(cfg, srv, card: str):
    """fleet_stats keys, health, drain with a request in flight, then
    teardown: health False and every block returned."""
    from ray_tpu_torch.inference import EngineDrainingError
    from ray_tpu_torch.models import gpt

    st = srv.fleet_stats()
    check(set(st) == FLEET_STATS_KEYS,
          f"fleet_stats keys differ from the JAX package's: "
          f"{sorted(set(st) ^ FLEET_STATS_KEYS)}")
    check(st["models"] == ["base"] and not st["stopped"]
          and not st["draining"], f"fleet_stats {st}")
    check(srv.health() is True, "a live replica reads unhealthy")
    p = requests(cfg.vocab_size)[3]
    want = reference_tokens(cfg, gpt.init_params(cfg, 0, device="cuda"),
                            [p])[0]
    gen = srv({"prompt": p, "max_tokens": 16, "stream": True,
               "model": "base"})
    first = next(gen)                    # admitted and decoding
    srv.drain()
    try:
        srv({"prompt": p, "max_tokens": 4, "model": "base"})
    except EngineDrainingError as e:
        print(f"[replica] draining: a new request raises "
              f"EngineDrainingError ({e})")
    else:
        raise SmokeFailure("a draining replica admitted a request")
    rest = list(gen)
    toks = [first["token"]] + [c["token"] for c in rest if "token" in c]
    check(toks == want and rest[-1].get("done"),
          f"the request in flight during the drain: {toks} vs {want}")
    check(srv.fleet_stats()["draining"], "fleet_stats misses the drain")
    engines = srv._engines()
    srv.teardown()
    check(srv.health() is False and srv.fleet_stats()["stopped"],
          "a torn-down replica reads healthy")
    for eng in engines:
        assert_blocks_returned(eng, f"replica {eng.name} after teardown")
    print(f"[replica] fleet_stats has the JAX package's {len(st)} keys; "
          f"health True; the in-flight request finished token-exact "
          f"through the drain; after teardown health False, no block "
          f"referenced")


def replica_chaos(cfg, card: str, launches: dict):
    """Scripted plans in the port's gate on full-width f32 engines."""
    from ray_tpu_torch.core import fault_injection as fi
    from ray_tpu_torch.inference import EngineConfig, GPTServer
    from ray_tpu_torch.models import gpt

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    params = gpt.init_params(cfg, SEED, device="cuda")
    prompts = requests(cfg.vocab_size)[:3] + [[1, 2, 3, 4] * 12]
    want = reference_tokens(cfg, params, prompts)

    def reject_all(ctx, n):
        ctx["reject_all"] = True

    plan = ScriptedPlan({"infer_speculate": reject_all})
    srv = GPTServer(cfg, EngineConfig(**SPEC_ENGINE, speculate="ngram",
                                      speculate_k=8), params=params)
    try:
        torch.cuda.synchronize()
        fa.launches = 0                  # this path's run starts here
        with fi.injected(plan):
            handles = served(srv, prompts)
        torch.cuda.synchronize()
        launches["chaos_reject_all"] = fa.launches  # ... and ends here
        st = srv.engine_stats()
        for h, w in zip(handles, want):
            check(h.error is None and h.tokens == w,
                  f"reject_all: {h.error} {h.tokens} vs {w}")
        passes = sum(1 for pt, _ in plan.log if pt == "infer_speculate")
        check(passes > 0 and st["spec_drafted_tokens"] > 0
              and st["spec_accepted_tokens"] == 0,
              f"reject_all: {passes} passes, stats {st}")
        check(launches["chaos_reject_all"]
              == cfg.n_layers * st["full_prefills"] > 0,
              f"reject_all: {launches['chaos_reject_all']} flash launches "
              f"for {st['full_prefills']} full-width prefills")
        assert_blocks_returned(srv.engine, "reject_all")
    finally:
        srv.teardown()
    print(f"[chaos] infer_speculate reject_all on {passes} passes: every "
          f"reply token-exact, {st['spec_drafted_tokens']} drafted, 0 "
          f"accepted, no leak")

    def alloc_fails(ctx, n):
        if n == 2:
            raise RuntimeError("injected block-alloc failure")

    plan = ScriptedPlan({"infer_block_alloc": alloc_fails})
    srv = GPTServer(cfg, EngineConfig(**SPEC_ENGINE), params=params)
    try:
        torch.cuda.synchronize()
        fa.launches = 0                  # this path's run starts here
        with fi.injected(plan):
            handles = served(srv, prompts)
            gen0 = srv.engine.pool.generation
            after = served(srv, prompts[:1])
        torch.cuda.synchronize()
        launches["chaos_block_alloc"] = fa.launches  # ... and ends here
        st = srv.engine_stats()
        failed = [str(h.error) for h in handles]
        check(all("injected block-alloc failure" in e for e in failed),
              f"block_alloc: in-flight requests ended with {failed}")
        check(gen0 == 1, f"block_alloc: pool generation {gen0}, expected "
              "one reset")
        check(after[0].error is None and after[0].tokens == want[0],
              f"block_alloc: the next request {after[0].error} "
              f"{after[0].tokens} vs {want[0]}")
        check(launches["chaos_block_alloc"]
              == cfg.n_layers * st["full_prefills"] > 0,
              f"block_alloc: {launches['chaos_block_alloc']} flash "
              f"launches for {st['full_prefills']} full-width prefills")
        assert_blocks_returned(srv.engine, "block_alloc")
        admits = [c for pt, c in plan.log if pt == "infer_admit"]
        check(len(admits) == len(prompts) + 1
              and all(set(c) == ADMIT_CTX_KEYS
                      and c["engine"] == srv.engine.name for c in admits),
              f"infer_admit ctx {admits}")
    finally:
        srv.teardown()
    print(f"[chaos] infer_block_alloc raising on its 2nd call: "
          f"{len(failed)} requests in flight failed with the injected "
          f"error, pool generation 0 -> {gen0}, the next request "
          f"token-exact, no leak; infer_admit ctx {admits[0]}")
    return params, prompts, want


def replica_recorder(cfg, card: str, params, prompts, want,
                     launches: dict):
    """The flight recorder armed on the n-gram engine, then decode ms per
    step on the paged engine with a no-op plan installed and without."""
    from ray_tpu_torch.core import fault_injection as fi
    from ray_tpu_torch.core import flight_recorder as fr
    from ray_tpu_torch.inference import EngineConfig, GPTServer

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    rec = fr.enable()
    srv = GPTServer(cfg, EngineConfig(**SPEC_ENGINE, speculate="ngram",
                                      speculate_k=8), params=params)
    try:
        torch.cuda.synchronize()
        fa.launches = 0                  # this path's run starts here
        handles = served(srv, prompts)
        torch.cuda.synchronize()
        launches["recorder_ngram"] = fa.launches  # ... and ends here
        st = srv.engine_stats()
    finally:
        srv.teardown()
        fr.disable()
    evs = [e for e in rec.export_ingress() if e["kind"] == "engine_request"]
    for h, w in zip(handles, want):
        check(h.error is None and h.tokens == w,
              f"recorder run: {h.error} {h.tokens} vs {w}")
    check(len(evs) == len(prompts)
          and sorted(e["req"] for e in evs) == [h.id for h in handles],
          f"{len(evs)} engine_request events for {len(prompts)} requests")
    check(sum(e["spec_accepted"] for e in evs)
          == st["spec_accepted_tokens"] > 0,
          f"events accepted {[e['spec_accepted'] for e in evs]}, engine "
          f"{st['spec_accepted_tokens']}")
    check(launches["recorder_ngram"] == cfg.n_layers * st["full_prefills"],
          f"recorder run: {launches['recorder_ngram']} flash launches for "
          f"{st['full_prefills']} full-width prefills")
    print(f"[recorder] {len(evs)} engine_request events for {len(prompts)} "
          f"requests; spec_accepted sum {st['spec_accepted_tokens']} equals "
          f"the engine's")

    class NoOpPlan:
        def on_infer(self, point, ctx):
            pass

    per_step = {}
    for label in ("none", "no-op plan", "none again", "no-op plan again"):
        srv = GPTServer(cfg, EngineConfig(**SPEC_ENGINE), params=params)
        try:
            with (fi.injected(NoOpPlan()) if "plan" in label
                  else contextlib.nullcontext()):
                handles = served(srv, prompts)
        finally:
            srv.teardown()
        per_step[label] = statistics.median(
            (h.finished_s - h.first_token_s) / (len(h.tokens) - 1) * 1e3
            for h in handles)
    print(f"[chaos] decode ms per step (median of {len(prompts)} requests "
          f"at once, f32) on {card}: " + ", ".join(
              f"{k} {v:.3f}" for k, v in per_step.items()))


def phase_replica_contract(card: str) -> dict:
    """Multiplexing, the replica surface, chaos and the flight recorder at
    GPT-2 124M width in f32 with TF32 off.  Returns {path: flash
    launches}."""
    from ray_tpu_torch.models import gpt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt.GPTConfig.gpt2_124m(dtype=torch.float32)
    launches = {}
    srv = replica_multiplexing(cfg, card, launches)
    replica_surface(cfg, srv, card)
    del srv
    params, prompts, want = replica_chaos(cfg, card, launches)
    replica_recorder(cfg, card, params, prompts, want, launches)
    return launches


# ------------------------------------------------------------ other models

def f32_err(got, ref):
    """(max abs error, whether it is within 1e-4 (1 + max |ref|)): an f32
    result on the card against the same call on the CPU."""
    err = (got.detach().cpu().float() - ref.float()).abs().max().item()
    return err, err <= 1e-4 * (1 + ref.abs().max().item())


def held_f32(label: str, pairs) -> None:
    """Check every (got on the card, ref on the CPU) pair with f32_err."""
    worst, scale = 0.0, 0.0
    for got, ref in pairs:
        err, ok = f32_err(got, ref)
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
        check(ok, f"{label}: card and CPU differ by {err} (scale "
                  f"{ref.abs().max().item():.3g})")
        worst = max(worst, err)
        scale = max(scale, ref.abs().max().item())
    print(f"[models] {label}: card vs CPU f32 max_abs_err {worst:.3e} "
          f"(bound 1e-4 x (1 + {scale:.3g})) ok")


def flash_launches():
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    return (fa.launches, fa.bwd_kv_launches, fa.bwd_dq_launches)


def to_card(tree):
    from ray_tpu_torch.models.convert import _map

    return _map(lambda t: t.to("cuda"), tree)


def resnet_parity(card: str):
    """ResNet tiny at 16x16 and 15x15 (even and odd SAME padding) and
    ResNet-50 at width 8 with the ImageNet stem at 64x64 (7x7/2 conv, -inf
    max-pool), train=True and then train=False on the stats it returned:
    logits and BN state on the card against the CPU."""
    from ray_tpu_torch.models import resnet
    from ray_tpu_torch.models.convert import _leaves

    gen = torch.Generator().manual_seed(SEED + 6)
    cases = [("tiny 16x16", resnet.ResNetConfig.tiny(num_classes=4), 16),
             ("tiny 15x15", resnet.ResNetConfig.tiny(num_classes=4), 15),
             ("resnet50 width 8 64x64", resnet.ResNetConfig.resnet50(
                 num_filters=8, cifar_stem=False, dtype=torch.float32), 64)]
    for label, cfg, size in cases:
        params, state = resnet.init_params(cfg, SEED, device="cpu")
        x = torch.randn((4, size, size, 3), generator=gen)
        outs = {}
        with torch.no_grad():
            for dev, (p, st, xx) in (
                    ("cpu", (params, state, x)),
                    ("cuda", (to_card(params), to_card(state),
                              x.to("cuda")))):
                logits, st1 = resnet.forward(p, st, xx, cfg, train=True)
                ev, st2 = resnet.forward(p, st1, xx, cfg, train=False)
                check(all(a is b for a, b in zip(_leaves(st1),
                                                  _leaves(st2))),
                      f"resnet {label}: train=False changed the state")
                outs[dev] = [logits, ev, *_leaves(st1)]
        held_f32(f"resnet {label} (logits train/eval, BN state)",
                 zip(outs["cuda"], outs["cpu"]))


def resnet18_training(card: str):
    """ResNet-18 at CIFAR-10 widths, bf16 activations and f32 params, b256
    of seeded random 32x32x3 images and labels: 5 checked hand-written
    steps (value and grad of loss_fn's loss, AdamW(1e-3) over the leaves,
    the BN state carried) and 10 timed."""
    from ray_tpu_torch.models import resnet
    from ray_tpu_torch.models.convert import _leaves, _map
    from ray_tpu_torch.train import adamw

    cfg = resnet.ResNetConfig.resnet18(num_classes=10)
    params, state = resnet.init_params(cfg, SEED)
    params = _map(lambda t: t.requires_grad_(True), params)
    leaves = _leaves(params)
    opt = adamw(1e-3)(leaves)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    batch = {"x": torch.randn((256, 32, 32, 3), generator=gen,
                              device="cuda"),
             "y": torch.randint(0, 10, (256,), generator=gen,
                                device="cuda")}
    state0 = _map(lambda t: t.clone(), state)

    def step(state):
        loss, (state, _) = resnet.loss_fn(params, state, batch, cfg)
        for p, g in zip(leaves, torch.autograd.grad(loss, leaves)):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach(), state

    losses, steps, timed = [], 5, 10
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(steps + timed + 1)]
    events[0].record()
    for i in range(steps + timed):
        loss, state = step(state)
        events[i + 1].record()
        if i < steps:
            losses.append(loss)
    torch.cuda.synchronize()
    losses = [x.item() for x in losses]
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(steps + timed)]
    steady = statistics.median(step_ms[steps:])
    print(f"[models] resnet18 CIFAR-10 widths b256 bf16 on {card}: "
          f"{resnet.num_params(params)} params, losses "
          f"{[round(x, 5) for x in losses]}; steady step (median of 10) "
          f"{steady:.3f} ms, {256 / (steady / 1e3):.1f} images/s; step ms "
          f"{[round(x, 3) for x in step_ms]}")
    check(all(np.isfinite(losses)), f"resnet18: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"resnet18: loss did not fall over "
          f"{steps} steps on one batch: {losses}")
    moved = [not torch.equal(a, b)
             for a, b in zip(_leaves(state), _leaves(state0))]
    check(all(moved), f"resnet18: {moved.count(False)} running stats "
          f"did not move")
    with torch.no_grad():
        _, st = resnet.forward(params, state, batch["x"], cfg, train=False)
    check(all(torch.equal(a, b) for a, b in zip(_leaves(st),
                                                  _leaves(state))),
          "resnet18: train=False changed the running stats")
    print("[models] resnet18: loss falls, every running stat moved, "
          "train=False leaves the state equal")


def bert_batch(cfg, b: int, s: int, seed: int) -> dict:
    """Seeded tokens with 15% of positions labelled, the rest
    ``ignore_index``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                        device="cuda")
    picked = torch.rand((b, s), generator=gen, device="cuda") < 0.15
    return {"input_ids": ids,
            "labels": torch.where(picked, ids, cfg.ignore_index)}


def bert_training(name: str, card: str) -> dict:
    """BERT-base (vocab 30592, 12 layers, d 768, 12 heads, d_ff 3072, bf16
    activations, f32 params, remat on), b32 s512: make_train_step with
    AdamW(1e-4, weight_decay=0.01), 5 checked steps and 10 timed.  Every
    step must launch the flash forward 24 times (12 + 12 recomputed) and
    each backward kernel 12 times; loss and grad_norm finite, the loss
    falling, step 1 within 5e-3 / 5e-2 of plain attention; a padded batch
    launches nothing.  Returns {path: [flash_fwd, flash_bwd_kv,
    flash_bwd_dq launches]}."""
    from ray_tpu_torch.models import bert
    from ray_tpu_torch.train import adamw

    cfg = bert.BERTConfig.bert_base()
    L, d, (b, _, s, _) = cfg.n_layers, cfg.d_model, BERT_SHAPE
    params = bert.init_params(cfg, SEED)
    n_params = bert.num_params(params)
    batch = bert_batch(cfg, b, s, SEED + 8)
    tx = adamw(1e-4, weight_decay=0.01)
    steps = 5
    losses, norms, step_ms, counts, kernel_ms = train_run(
        cfg, params, batch, steps, timed=10, label="train_bert",
        loss_fn=bert.loss_fn, tx=tx)
    steady = statistics.median(step_ms[steps:])
    tps = b * s / (steady / 1e3)
    flops_per_token = 6 * n_params + 12 * L * d * s
    peak = rates(name)[1]
    print(f"[train_bert] BERT-base {n_params} params, b{b} s{s} bf16 remat "
          f"on {card}: losses {[round(x, 5) for x in losses]}, grad norms "
          f"{[round(x, 5) for x in norms]}")
    print(f"[train_bert] step ms {[round(x, 3) for x in step_ms]}; steady "
          f"step (median of the last 10) {steady:.3f} ms, {tps:.1f} "
          f"tokens/s, MFU {flops_per_token * tps / peak:.4f} "
          f"({flops_per_token} FLOPs per token of {peak:.3g} FLOP/s)")
    print(f"[train_bert] one profiled step, device ms per kernel and share "
          f"of the steady step: " + (", ".join(
              f"{k} {v:.3f} ({v / steady:.3f})" for k, v in kernel_ms.items())
              if kernel_ms["all kernels"] > 0 else "not measured (the "
              "profiler saw no device time)"))
    print(f"[train_bert] launches per step (flash_fwd, flash_bwd_kv, "
          f"flash_bwd_dq): {counts}")
    for c in counts:
        check(c == (2 * L, L, L), f"train_bert: a step launched {c}, "
              f"expected ({2 * L}, {L}, {L})")
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          "train_bert: non-finite loss or grad norm")
    check(losses[-1] < losses[0], f"train_bert: loss did not fall over "
          f"{steps} steps on one batch: {losses}")
    launches = {"train_bert": [sum(c[i] for c in counts) for i in range(3)]}

    # step 1 on plain attention, the same params and batch (phase 7's
    # bf16 bound)
    ref_cfg = dataclasses.replace(cfg, attn_impl="reference")
    ref_losses, ref_norms, _, ref_counts, _ = train_run(
        ref_cfg, params, batch, 1, loss_fn=bert.loss_fn, tx=tx)
    check(ref_counts == [(0, 0, 0)], f"plain attention launched {ref_counts}")
    dl = abs(losses[0] - ref_losses[0]) / abs(ref_losses[0])
    dn = abs(norms[0] - ref_norms[0]) / abs(ref_norms[0])
    ok = dl <= 5e-3 and dn <= 5e-2
    print(f"[train_bert] step 1 vs plain attention: loss {losses[0]:.6f} vs "
          f"{ref_losses[0]:.6f} (rel {dl:.2e}, bound 5e-3), grad_norm "
          f"{norms[0]:.6f} vs {ref_norms[0]:.6f} (rel {dn:.2e}, bound 5e-2) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "train_bert: step 1 disagrees with plain attention")

    # a padded batch: the last 64 positions of half the rows masked; it
    # takes plain attention and launches no kernel
    mask = torch.ones((b, s), dtype=torch.long, device="cuda")
    mask[: b // 2, -64:] = 0
    masked = {**batch, "attention_mask": mask}
    m_losses, m_norms, _, m_counts, _ = train_run(
        cfg, params, masked, 1, label="bert_masked", loss_fn=bert.loss_fn,
        tx=tx)
    print(f"[train_bert] padded batch: loss {m_losses[0]:.6f}, grad_norm "
          f"{m_norms[0]:.6f}, launches {m_counts}")
    check(m_counts == [(0, 0, 0)], f"the padded batch launched {m_counts}")
    check(np.isfinite(m_losses[0]) and np.isfinite(m_norms[0]),
          "the padded batch gave a non-finite loss")
    launches["bert_masked"] = list(m_counts[0])
    del params
    torch.cuda.empty_cache()

    # the JAX package's mask check in f32 on a tiny config whose head dim
    # (64) and length (128) take the f32 flash kernel: the loss without a
    # mask (the kernel) equals the loss with an all-ones mask (plain
    # attention)
    tiny = bert.BERTConfig.tiny(d_model=128, n_heads=2)
    tp = bert.init_params(tiny, SEED)
    tb = bert_batch(tiny, 4, 128, SEED + 9)
    with torch.no_grad():
        n0 = flash_launches()
        plain = bert.loss_fn(tp, tb, tiny).item()
        n1 = flash_launches()
        ones = bert.loss_fn(tp, {**tb, "attention_mask": torch.ones_like(
            tb["input_ids"])}, tiny).item()
        n2 = flash_launches()
    rel = abs(plain - ones) / abs(ones)
    print(f"[train_bert] tiny f32 (d 128, 2 heads, s 128): loss without a "
          f"mask {plain:.7f} ({n1[0] - n0[0]} flash launches) vs all-ones "
          f"mask {ones:.7f} ({n2[0] - n1[0]}), rel {rel:.2e} (bound 1e-5)")
    check(n1[0] - n0[0] == tiny.n_layers and n2 == n1,
          f"tiny BERT launches {n0} -> {n1} -> {n2}")
    check(rel <= 1e-5, f"tiny BERT: all-ones mask loss differs by {rel}")
    return launches


def rl_and_mlp_parity(card: str):
    """ActorCritic of each kind and the MLP at their published widths in
    f32 on the card against the CPU: fcnet obs (4,) hiddens (256, 256)
    b256; visionnet 84x84x4 uint8, 6 actions, b64 (Atari PPO's policy);
    lstm cell 256, b32, two windows of T 32 with the carry threaded;
    gtrxl attn_dim 64, 2 layers, b32 T64; MLP 784-128-128-10 b256
    forward and loss.  Prints forward ms per batch (CUDA events per
    call)."""
    from ray_tpu_torch.models import mlp, zoo

    gen = torch.Generator().manual_seed(SEED + 10)
    cases = [("fcnet", dict(kind="fcnet", obs_shape=(4,)), (256, 4)),
             ("visionnet", dict(kind="visionnet", obs_shape=(84, 84, 4),
                                num_actions=6), (64, 84, 84, 4)),
             ("lstm", dict(kind="lstm", obs_shape=(4,), cell_size=256),
              (32, 32, 4)),
             ("gtrxl", dict(kind="gtrxl", obs_shape=(4,), attn_dim=64,
                            attn_layers=2), (32, 64, 4))]
    for label, kw, shape in cases:
        ac = zoo.ActorCritic(zoo.ModelConfig(**kw))
        params = ac.init(SEED, device="cpu")
        if ac.cfg.kind == "visionnet":
            obs = torch.randint(0, 256, shape, generator=gen,
                                dtype=torch.uint8)
        else:
            obs = torch.randn(shape, generator=gen)
        card_params, card_obs = to_card(params), obs.to("cuda")
        with torch.no_grad():
            if ac.is_recurrent:
                second = obs + 0.5
                outs = {}
                for dev, p, o1, o2 in (
                        ("cpu", params, obs, second),
                        ("cuda", card_params, card_obs, second.to("cuda"))):
                    l1, v1, st = ac.apply_seq(p, o1)
                    l2, v2, st = ac.apply_seq(p, o2, st)
                    outs[dev] = [l1, v1, l2, v2] + (list(st) if st else [])

                def fwd():
                    return ac.apply_seq(card_params, card_obs)
            else:
                outs = {dev: list(ac.apply(p, o)) for dev, p, o in (
                    ("cpu", params, obs), ("cuda", card_params, card_obs))}

                def fwd():
                    return ac.apply(card_params, card_obs)
            held_f32(f"ActorCritic {label} {list(shape)}",
                     zip(outs["cuda"], outs["cpu"]))
            print(f"[models] ActorCritic {label} {list(shape)} forward on "
                  f"{card}: {time_ms(fwd, reps=5, inner=3):.4f} ms per batch")

    cfg = mlp.MLPConfig()
    params = mlp.init_params(cfg, SEED, device="cpu")
    batch = {"x": torch.randn((256, cfg.in_dim), generator=gen),
             "y": torch.randint(0, cfg.out_dim, (256,), generator=gen)}
    card_params = to_card(params)
    card_batch = {k: v.to("cuda") for k, v in batch.items()}
    with torch.no_grad():
        held_f32("MLP 784-128-128-10 b256 (logits, loss)", [
            (mlp.forward(card_params, card_batch["x"], cfg),
             mlp.forward(params, batch["x"], cfg)),
            (mlp.loss_fn(card_params, card_batch, cfg),
             mlp.loss_fn(params, batch, cfg))])
        ms = time_ms(lambda: mlp.forward(card_params, card_batch["x"], cfg),
                     reps=5, inner=3)
    print(f"[models] MLP b256 forward on {card}: {ms:.4f} ms per batch")


def phase_other_models(name: str, card: str) -> dict:
    """ResNet, BERT, the RL catalog and the MLP.  The parity parts run in
    f32 with TF32 off (cuDNN's TF32 too) and must launch no flash kernel;
    BERT-base trains on the kernels.  Returns {path: [flash_fwd,
    flash_bwd_kv, flash_bwd_dq launches]}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n0 = flash_launches()
    resnet_parity(card)
    resnet18_training(card)
    check(flash_launches() == n0, f"ResNet launched flash kernels: {n0} -> "
          f"{flash_launches()}")
    launches = bert_training(name, card)
    n0 = flash_launches()
    rl_and_mlp_parity(card)
    check(flash_launches() == n0, f"the RL trunks or the MLP launched flash "
          f"kernels: {n0} -> {flash_launches()}")
    return launches


# ------------------------------------------------------------ the trainer

class HostBatches:
    """``n`` distinct seeded token batches [b, s + 1] int32 over the first
    ``vocab`` ids (so the loss has somewhere to fall), made once on the
    host and given again on every pass; with ``fail_at`` the first pass
    raises instead of giving that step's batch (1-based)."""

    def __init__(self, n, b, s, vocab, seed, fail_at=None):
        rng = np.random.default_rng(seed)
        self.batches = [{"tokens": rng.integers(0, vocab, (b, s + 1),
                                                dtype=np.int32)}
                        for _ in range(n)]
        self.fail_at, self.passes = fail_at, 0

    def __iter__(self):
        self.passes += 1
        first = self.passes == 1
        for i, batch in enumerate(self.batches):
            if first and i + 1 == self.fail_at:
                raise RuntimeError(f"injected data failure at step {i + 1}")
            yield batch


def phase_trainer(name: str, card: str) -> dict:
    """GPT-2 124M at full width and depth, b16 s1024 bf16, remat "dots",
    AdamW(3e-4, weight_decay=0.1), through ``Trainer.fit`` for 12 steps
    (report every 2, checkpoint every 4, keep 2) on distinct host batches
    through ``device_batches``.  The first fit's data fails at step 7, so
    it resumes from the step-4 checkpoint; a second fit runs the same
    batches without a failure.  Gates: the resumed attempt starts at step
    4; its reported losses (steps 6-12) and the first attempt's equal
    the uninterrupted run's within rel 1e-5; every step launches the
    flash kernels 24 / 12 / 12 times; the loss is finite and falls; the
    last checkpoint loads into a fresh state equal, bit for bit, to the
    run's final params and moments; ``TorchPredictor.from_checkpoint``
    gives the model's logits within 1e-6.  Prints the steady step ms from
    the trainer's own throughput, tokens/s and MFU, checkpoint bytes, the
    snapshot's ms and GB/s, the async write, the restore and the feed's
    wait.  Returns {"launches": {path: [fwd, kv, dq]}, "step_ms": ms}."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models.convert import _leaves
    from ray_tpu_torch.train import (Checkpoint, CheckpointManager,
                                     TorchPredictor, Trainer, adamw,
                                     load_state, make_train_step,
                                     state_to_host)
    from ray_tpu_torch.train.step import adam_state

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    cfg = gpt.GPTConfig.gpt2_124m(remat=True, remat_policy="dots")
    L, b, s, steps = cfg.n_layers, 16, 1024, 12
    marks = []       # launch counters at the start of every step

    def loss_fn(p, batch):
        marks.append(flash_launches())
        return gpt.loss_fn(p, batch, cfg)

    def trainer(data, path):
        return Trainer(loss_fn=loss_fn,
                       init_params=lambda seed: gpt.init_params(cfg, seed),
                       optimizer=adamw(3e-4, weight_decay=0.1),
                       train_data=data, num_steps=steps, report_every=2,
                       checkpoint_every=4, seed=SEED, storage_path=path,
                       num_to_keep=2, max_failures=1)

    def per_step(label):
        ends = marks[1:] + [flash_launches()]
        counts = [tuple(e - m for e, m in zip(end, start))
                  for start, end in zip(marks, ends)]
        for c in counts:
            check(c == (2 * L, L, L), f"{label}: a step launched {c}, "
                  f"expected ({2 * L}, {L}, {L})")
        return counts

    root = tempfile.mkdtemp(prefix="_chip_smoke_ckpt_",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        launches = {}
        runs = {}
        for label, fail_at in (("trainer_failover", 7), ("trainer", None)):
            data = HostBatches(steps, b, s, 4096, SEED + 20, fail_at)
            tr = trainer(data, os.path.join(root, label))
            torch.cuda.synchronize()
            marks.clear()
            fa.launches = fa.bwd_kv_launches = fa.bwd_dq_launches = 0
            t0 = time.perf_counter()
            res = tr.fit()
            wall = time.perf_counter() - t0
            counts = per_step(label)
            launches[label] = [sum(c[i] for c in counts) for i in range(3)]
            hist = [(m["step"], m["loss"], m["throughput"])
                    for m in res.metrics_history]
            print(f"[{label}] {data.passes} pass(es) over the data, last "
                  f"attempt from step {tr.start_step}, {len(counts)} steps "
                  f"in {wall:.1f} s on {card}; reported (step, loss): "
                  f"{[(st, round(lo, 6)) for st, lo, _ in hist]}")
            runs[label] = (tr, res, hist, data)

        tr_f, _, hist_f, data_f = runs["trainer_failover"]
        tr, res, hist, _ = runs["trainer"]
        check(data_f.passes == 2 and tr_f.start_step == 4,
              f"the failover run resumed from step {tr_f.start_step} after "
              f"{data_f.passes} passes, expected step 4 after 2")
        check([h[0] for h in hist_f] == [2, 4, 6, 6, 8, 10, 12]
              and [h[0] for h in hist] == [2, 4, 6, 8, 10, 12],
              f"reported steps {[h[0] for h in hist_f]} and "
              f"{[h[0] for h in hist]}")
        want = dict((st, lo) for st, lo, _ in hist)
        rel = [abs(lo - want[st]) / abs(want[st]) for st, lo, _ in hist_f]
        print(f"[trainer] failover run vs uninterrupted run, reported "
              f"losses: largest relative difference {max(rel):.3e} (bound "
              f"1e-5; 0 expected, the kernels use no atomics)")
        check(max(rel) <= 1e-5, f"the resumed losses differ by {max(rel)}")
        losses = [lo for _, lo, _ in hist]
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"loss not finite or not falling: {losses}")
        final, final_f = tr.final_state, tr_f.final_state
        diff = max((a.float() - c.float()).abs().max().item() for a, c in
                   zip(_leaves(final.params), _leaves(final_f.params)))
        print(f"[trainer] final params, failover vs uninterrupted: max abs "
              f"difference {diff:.3e}")
        del final_f, tr_f.final_state

        # the trainer's steady step: its reported throughput gives the
        # time at each report; 6->8 and 10->12 hold no snapshot
        at = {st: st * b * s / thr for st, _, thr in hist}
        spans = [(at[8] - at[6]) / 2 * 1e3, (at[12] - at[10]) / 2 * 1e3]
        step_ms = statistics.median(spans)
        n_params = count_params(final.params)
        flops_per_token = 6 * n_params + 12 * L * cfg.d_model * s
        tps = b * s / (step_ms / 1e3)
        peak = rates(name)[1]
        print(f"[trainer] steady step (steps 6->8, 10->12, from the reported "
              f"throughput) {spans[0]:.3f} / {spans[1]:.3f} ms, median "
              f"{step_ms:.3f} ms, {tps:.1f} tokens/s, MFU "
              f"{flops_per_token * tps / peak:.4f} on {card}")
        waits = [w * 1e3 for w in tr.feed_wait_s]
        print(f"[trainer] feed wait per step (host ms in next()): median "
              f"{statistics.median(waits):.3f}, max {max(waits):.3f}, "
              f"first {waits[0]:.3f}")

        # checkpoint: snapshot, async write, restore
        # the params and Adam's two moments
        nbytes = 3 * sum(t.numel() * t.element_size()
                         for t in _leaves(final.params))
        snap_ms, payload = [], None
        for _ in range(3):
            # the previous snapshot's pinned block goes back to torch's
            # cache first, so each snapshot reuses it, as the trainer's do
            payload = None
            t0 = time.perf_counter()
            payload = state_to_host(final)
            snap_ms.append((time.perf_counter() - t0) * 1e3)
        mgr = CheckpointManager(os.path.join(root, "timing"))
        t0 = time.perf_counter()
        mgr.save(payload)
        queued_ms = (time.perf_counter() - t0) * 1e3
        mgr.flush()
        write_ms = (time.perf_counter() - t0) * 1e3
        del payload
        ck = res.checkpoint
        ck_bytes = os.path.getsize(os.path.join(ck.path, Checkpoint.PAYLOAD))
        print(f"[trainer] checkpoint {ck_bytes} bytes on disk ({nbytes} of "
              f"params and moments); D2H snapshot through pinned memory "
              f"{', '.join(f'{t:.1f}' for t in snap_ms)} ms "
              f"({', '.join(f'{nbytes / t / 1e6:.2f}' for t in snap_ms)} "
              f"GB/s, the pinned block reused); async write: "
              f"save returned in {queued_ms:.1f} ms, on disk after "
              f"{write_ms:.1f} ms")
        init_fn, _ = make_train_step(lambda p, bt: gpt.loss_fn(p, bt, cfg),
                                     adamw(3e-4, weight_decay=0.1))
        fresh = init_fn(gpt.init_params(cfg, SEED + 1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        payload = ck.to_dict()
        t1 = time.perf_counter()
        load_state(fresh, payload)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"[trainer] restore of the step-{payload['step']} checkpoint: "
              f"unpickle {(t1 - t0) * 1e3:.1f} ms, load into the state "
              f"{(t2 - t1) * 1e3:.1f} ms")
        check(payload["step"] == steps and int(fresh.step) == steps,
              f"restored step {int(fresh.step)}")
        got, live = adam_state(fresh.opt_state, fresh.params), \
            adam_state(final.opt_state, final.params)
        check(got["count"] == live["count"] == payload["opt_state"]["count"]
              == steps, f"Adam counts {got['count']} {live['count']}")
        for key in ("mu", "nu"):
            for g, w, h in zip(_leaves(got[key]), _leaves(live[key]),
                               _leaves(payload["opt_state"][key])):
                check(torch.equal(g, w) and np.array_equal(
                    g.cpu().numpy(), h), f"restored {key} differs")
        for g, w in zip(_leaves(fresh.params), _leaves(final.params)):
            check(torch.equal(g, w), "restored params differ")
        print("[trainer] restored params, moments and step equal the run's "
              "final state bit for bit")
        del fresh, payload

        # the predictor on the last checkpoint against the model's forward
        x = data_f.batches[0]["tokens"][:2, :256]
        n0 = flash_launches()
        pred = TorchPredictor.from_checkpoint(
            ck, apply_fn=lambda p, t: gpt.forward(p, t, cfg))
        out = pred.predict({"x": x, "row": np.arange(2)})
        launches["trainer_predictor"] = [
            a - c for a, c in zip(flash_launches(), n0)]
        with torch.no_grad():
            ref = gpt.forward(final.params,
                              torch.from_numpy(x).to("cuda"), cfg)
        err = np.abs(out["predictions"] - ref.cpu().numpy()).max()
        print(f"[trainer] TorchPredictor.from_checkpoint logits "
              f"{list(out['predictions'].shape)} vs forward on the final "
              f"params: max abs {err:.3e} (bound 1e-6); launches "
              f"{launches['trainer_predictor']}")
        check(err <= 1e-6 and list(out["row"]) == [0, 1],
              f"predictor logits differ by {err}")
        check(launches["trainer_predictor"] == [L, 0, 0],
              f"predictor launched {launches['trainer_predictor']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms,
            "history": [(st, lo) for st, lo, _ in hist],
            "grad_norm": {m["step"]: m["grad_norm"]
                          for m in res.metrics_history}}


# ------------------------------------------------------------------- PPO

def phase_ppo(card: str) -> dict:
    """PPO on CartPole at the settings of tests/test_rllib.py's PPO test
    (8 envs x 64 steps, train batch 512, minibatch 128, 6 epochs, lr
    3e-3, entropy 0.01, seed 0) for 18 iterations, learner and policies
    on the card.  Gates: the best mean return is above 60; one update on
    a fixed batch with fixed permutations gives the same params on the
    card as on the CPU within 1e-4 (1 + scale), f32 with TF32 off;
    ``save``/``restore`` round-trips; no flash launch.  Prints env
    steps/s and the learner's and the rollouts' ms per iteration."""
    from ray_tpu_torch.data.feed import to_device
    from ray_tpu_torch.models.convert import (_leaves, _map,
                                              params_from_numpy,
                                              params_to_numpy)
    from ray_tpu_torch.rllib import ppo
    from ray_tpu_torch.rllib import sample_batch as SB
    from ray_tpu_torch.rllib.policy import PolicyConfig, init_policy_params
    from ray_tpu_torch.train import adam

    torch.backends.cuda.matmul.allow_tf32 = False
    n0 = flash_launches()
    settings = dict(env="CartPole-v1", num_rollout_workers=0,
                    num_envs_per_worker=8, rollout_length=64,
                    train_batch_size=512, minibatch_size=128, num_epochs=6,
                    lr=3e-3, entropy_coeff=0.01)

    # one update, card vs CPU, on a fixed batch and fixed permutations
    cfg = ppo.PPOConfig(**settings)
    rng = np.random.default_rng(SEED + 30)
    n = cfg.train_batch_size
    batch = {SB.OBS: rng.standard_normal((n, 4)).astype(np.float32),
             SB.ACTIONS: rng.integers(0, 2, n),
             SB.LOGP: (np.log(0.5) + 0.05 * rng.standard_normal(n))
             .astype(np.float32),
             SB.VF_PREDS: rng.standard_normal(n).astype(np.float32),
             SB.ADVANTAGES: rng.standard_normal(n).astype(np.float32),
             SB.VALUE_TARGETS: rng.standard_normal(n).astype(np.float32)}
    perms = [rng.permutation(n) for _ in range(cfg.num_epochs)]
    p0 = params_to_numpy(init_policy_params(PolicyConfig(4, 2), SEED,
                                            device="cpu"))
    out = {}
    for dev in ("cpu", "cuda"):
        p = _map(lambda t: t.requires_grad_(True),
                 params_from_numpy(p0, device=dev))
        opt = adam(cfg.lr)(_leaves(p))
        p, _, m = ppo.make_ppo_update(cfg)(p, opt, to_device(batch, dev),
                                           perms=perms)
        out[dev] = ([t.detach() for t in _leaves(p)],
                    [v.detach() for v in m.values()])
    worst = 0.0
    for got, ref in zip(out["cuda"][0] + out["cuda"][1],
                        out["cpu"][0] + out["cpu"][1]):
        err, ok = f32_err(got, ref)
        check(ok, f"PPO update: card and CPU differ by {err}")
        worst = max(worst, err)
    print(f"[ppo] one update (6 epochs x 4 minibatches of 128), card vs "
          f"CPU f32: params and metrics max_abs_err {worst:.3e} "
          f"(bound 1e-4 x (1 + scale)) ok")

    # the learning run
    algo = ppo.PPOConfig(seed=SEED, **settings).build()
    sample = algo.workers.sample_sync
    rollout_s = []

    def timed_sample():
        t0 = time.perf_counter()
        got = sample()
        rollout_s.append(time.perf_counter() - t0)
        return got

    algo.workers.sample_sync = timed_sample
    best, rewards, iter_s, sps = 0.0, [], [], []
    for _ in range(18):
        k = len(rollout_s)
        t0 = time.perf_counter()
        r = algo.train()
        iter_s.append((time.perf_counter() - t0, sum(rollout_s[k:])))
        rew = r.get("episode_reward_mean", 0.0)
        rewards.append(round(rew, 2))
        sps.append(r["env_steps_per_sec"])
        best = max(best, rew)
        check(np.isfinite(r["total_loss"]), f"PPO loss {r['total_loss']}")
    learn = [(t - ro) * 1e3 for t, ro in iter_s]
    roll = [ro * 1e3 for _, ro in iter_s]
    print(f"[ppo] CartPole 18 iterations of 512 env steps on {card}: mean "
          f"return per iteration {rewards}, best {best:.2f} (bar 60)")
    print(f"[ppo] env steps/s median {statistics.median(sps):.1f}; per "
          f"iteration: rollout median {statistics.median(roll):.2f} ms, "
          f"learner median {statistics.median(learn):.2f} ms "
          f"(iterations 2-18: rollout {statistics.median(roll[1:]):.2f}, "
          f"learner {statistics.median(learn[1:]):.2f})")
    check(best > 60.0, f"PPO did not learn CartPole: best {best}")

    saved = algo.save()
    other = ppo.PPOConfig(seed=SEED + 1, **settings).build()
    other.restore(saved)
    for a, c in zip(_leaves(algo.params), _leaves(other.params)):
        check(torch.equal(a, c), "PPO restore: params differ")
    back = other.save()["payload"]
    for x, y in zip(_leaves(saved["payload"]["opt_state"]["mu"]),
                    _leaves(back["opt_state"]["mu"])):
        check(np.array_equal(x, y), "PPO restore: moments differ")
    r = other.train()
    check(np.isfinite(r["total_loss"]) and other.iteration == 19,
          f"PPO after restore: {r['total_loss']}, iteration "
          f"{other.iteration}")
    print("[ppo] save/restore round trip: params and moments equal, one "
          "more iteration trains")
    check(flash_launches() == n0, "PPO launched a flash kernel")
    algo.cleanup()
    other.cleanup()
    return {"best": best}


# ------------------------------------------------------------ RLlib tail

def rl_leaves(tree) -> list:
    from ray_tpu_torch.rllib.optim import tree_leaves

    return [t.detach() for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def rl_parity_cases(data: dict) -> list:
    """(label, build(device) -> algorithm, run(algorithm) -> tensors) per
    algorithm of the RLlib tail: one update (or scoring) on a fixed host
    batch with fixed draws; ``run`` returns the metrics and every leaf
    the update wrote."""
    from ray_tpu_torch import rllib as R
    from ray_tpu_torch.data.feed import to_device

    rng = np.random.default_rng(SEED + 40)
    n = 256

    def flat(obs_dim=4, vt=50.0):
        return {"obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
                "actions": rng.integers(0, 2, n),
                "advantages": (2.0 * rng.standard_normal(n) + 0.5)
                .astype(np.float32),
                "value_targets": (vt * rng.standard_normal(n))
                .astype(np.float32)}

    def trans(obs_dim=4, act_dim=None, b=64):
        acts = (rng.uniform(-2, 2, (b, act_dim)).astype(np.float32)
                if act_dim else rng.integers(0, 2, b))
        return {"obs": rng.standard_normal((b, obs_dim)).astype(np.float32),
                "actions": acts,
                "rewards": rng.standard_normal(b).astype(np.float32),
                "dones": (rng.random(b) < 0.1).astype(np.float32),
                "next_obs": rng.standard_normal((b, obs_dim))
                .astype(np.float32)}

    pg_b, a2c_b, lrn_b = flat(), flat(), flat(vt=3.0)
    dqn_b = dict(trans(), weights=rng.uniform(0.3, 1, 64).astype(np.float32))
    sq_b = dict(trans(), weights=np.ones(64, np.float32))
    sac_b, cql_b = trans(), trans()
    td3_b = [trans(obs_dim=3, act_dim=1, b=128) for _ in range(2)]
    td3_noise = [torch.from_numpy(rng.standard_normal((128, 1))
                                  .astype(np.float32)) for _ in range(2)]
    bc_b = {"obs": flat()["obs"], "actions": rng.integers(0, 2, n),
            "value_targets": (5.0 * rng.standard_normal(n))
            .astype(np.float32)}
    A = np.stack([np.eye(8)] * 5).astype(np.float32)
    bvec = np.zeros((5, 8), np.float32)
    for _ in range(40):
        x = rng.standard_normal(8).astype(np.float32)
        k = int(rng.integers(0, 5))
        A[k] += np.outer(x, x)
        bvec[k] += np.float32(rng.standard_normal()) * x
    ctx = rng.standard_normal(8).astype(np.float32)
    z = rng.standard_normal((5, 8)).astype(np.float32)
    cart = dict(env="CartPole-v1", seed=SEED)
    replay = dict(cart, num_envs_per_worker=4, rollout_length=16,
                  learning_starts=32, batch_size=64)
    pend = dict(env="Pendulum-v1", num_envs_per_worker=2, rollout_length=16,
                learning_starts=16, batch_size=128, seed=SEED)
    on = dict(cart, num_envs_per_worker=8, rollout_length=32)
    rollout = R.ImpalaConfig(**on, device="cpu").build().workers \
        .workers[0].sample()

    def dev(algo, batch):
        return to_device(batch, algo.device)

    def metrics(m):
        return [torch.as_tensor(v) for v in m.values()]

    def impala_run(a, times=1):
        out = []
        for _ in range(times):
            out += metrics(a._learn_on(R.SampleBatch(rollout)))
        return out + rl_leaves(a.params)

    def td3_run(a):
        out = []
        for step in range(2):
            out += list(a._update(a.nets, a.opts, dev(a, td3_b[step]), step,
                                  noise=td3_noise[step].to(a.device)))
        return out + rl_leaves(a.nets)

    def es_run(a):
        eps = np.random.default_rng(SEED + 41).standard_normal(
            (a.config.pop_size, a.theta.shape[0])).astype(np.float32)
        r = a.iterate(eps=eps)
        return [torch.tensor(r["pop_return_mean"]), a.theta]

    def learner_run(a):
        out = [torch.tensor(a.update(lrn_b)["loss"]) for _ in range(2)]
        return out + rl_leaves(a._local.params if hasattr(a, "_local")
                               else a.params)

    mod = lambda: R.DiscretePGModule(4, 2)  # noqa: E731
    return [
        ("PG", lambda d: R.PGConfig(**on, device=d).build(),
         lambda a: metrics(a.update(dev(a, pg_b))) + rl_leaves(a.params)),
        ("A2C", lambda d: R.A2CConfig(**on, device=d).build(),
         lambda a: metrics(a.update(dev(a, a2c_b))) + rl_leaves(a.params)),
        ("IMPALA", lambda d: R.ImpalaConfig(**on, device=d).build(),
         impala_run),
        ("APPO", lambda d: R.APPOConfig(**on, target_update_freq=1,
                                        device=d).build(),
         lambda a: impala_run(a, 2) + rl_leaves(a.target_params)),
        ("DQN", lambda d: R.DQNConfig(**replay, device=d).build(),
         lambda a: list(a._update(a.params, a.target_params, a.opt,
                                  dev(a, dqn_b))[2:])
         + rl_leaves(a.params)),
        ("SimpleQ", lambda d: R.SimpleQConfig(**replay, device=d).build(),
         lambda a: list(a._update(a.params, a.target_params, a.opt,
                                  dev(a, sq_b))[2:])
         + rl_leaves(a.params)),
        ("SAC", lambda d: R.SACConfig(**replay, device=d).build(),
         lambda a: metrics(a._update(a.nets, a.opts, dev(a, sac_b)))
         + rl_leaves(a.nets)),
        ("DDPG", lambda d: R.DDPGConfig(**pend, device=d).build(),
         lambda a: list(a._update(a.nets, a.opts, dev(a, td3_b[0]), 0))
         + rl_leaves(a.nets)),
        ("TD3", lambda d: R.TD3Config(**pend, device=d).build(), td3_run),
        ("BC", lambda d: R.BCConfig(input_path=data["expert"], seed=SEED,
                                    device=d).build(),
         lambda a: list(a.update(dev(a, bc_b), 100.0)) + rl_leaves(a.params)),
        ("MARWIL", lambda d: R.MARWILConfig(input_path=data["expert"],
                                            seed=SEED, device=d).build(),
         lambda a: list(a.update(dev(a, bc_b), 4.0)) + rl_leaves(a.params)),
        ("CQL", lambda d: R.CQLConfig(input_path=data["mixed"], seed=SEED,
                                      device=d).build(),
         lambda a: list(a._update(a.params, a.target_params, a.opt,
                                  dev(a, cql_b))[2:]) + rl_leaves(a.params)),
        ("DT", lambda d: R.DTConfig(input_path=data["mixed"], seed=SEED,
                                    device=d).build(),
         lambda a: [a.update(dev(a, data["dt_batch"]))]
         + rl_leaves(a.params)),
        ("LinUCB", lambda d: R.BanditConfig(seed=SEED, device=d).build(),
         lambda a: (a.load_checkpoint({"A": A, "b": bvec}),
                    [a.scores(torch.from_numpy(ctx).to(a.device))])[1]),
        ("LinTS", lambda d: R.BanditConfig(exploration="ts", seed=SEED,
                                           device=d).build(),
         lambda a: (a.load_checkpoint({"A": A, "b": bvec}),
                    [a.scores(torch.from_numpy(ctx).to(a.device),
                              torch.from_numpy(z).to(a.device))])[1]),
        ("ES", lambda d: R.ESConfig(**cart, pop_size=4, max_episode_steps=50,
                                    device=d).build(), es_run),
        ("ARS", lambda d: R.ARSConfig(**cart, pop_size=4, top_directions=2,
                                      max_episode_steps=50,
                                      device=d).build(), es_run),
        ("Learner", lambda d: R.Learner(mod(), lr=0.01, device=d),
         learner_run),
        ("LearnerGroup", lambda d: R.LearnerGroup(mod, 0, lr=0.01, device=d),
         learner_run),
    ]


def rl_parity(data: dict) -> None:
    """Every case of ``rl_parity_cases`` on the CPU and on the card, the
    card's algorithm restored from the CPU one's state first; f32 with
    TF32 off; each result within 1e-4 (1 + scale)."""
    for label, build, run in rl_parity_cases(data):
        cpu, card = build("cpu"), build("cuda")
        if hasattr(cpu, "get_state"):
            card.set_state(cpu.get_state())
        else:
            card.restore(cpu.save())
        held_f32(f"RLlib {label} one update", zip(run(card), run(cpu)))


class LearnClock:
    """Wall seconds in the wrapped learner calls of one algorithm (each
    ends in a device sync); the env steps/s come from ``train()``."""

    def __init__(self, obj, name: str):
        self.s = 0.0
        fn = getattr(obj, name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.s += time.perf_counter() - t0
            return out
        setattr(obj, name, timed)


def best_above(bar: float):
    """A stop rule: the best mean return so far is above ``bar`` (the
    runs stop there; the JAX tests' bars are on the best)."""
    return lambda rs: max(r.get("episode_reward_mean", 0.0)
                          for r in rs) > bar


def rl_learn(label: str, algo, iters: int, card: str, *, learner: str,
             key: str = "episode_reward_mean", stop=None):
    """``iters`` iterations (fewer if ``stop(results)``) -> the results;
    prints the per-iteration metric, env steps/s and learner ms."""
    clock = LearnClock(algo, learner) if learner else None
    results, learn_ms, sps = [], [], []
    t0 = time.perf_counter()
    for _ in range(iters):
        s0 = clock.s if clock else 0.0
        r = algo.train()
        results.append(r)
        sps.append(r["env_steps_per_sec"])
        learn_ms.append(((clock.s if clock else 0.0) - s0) * 1e3)
        if stop is not None and stop(results):
            break
    vals = [round(r.get(key, 0.0), 2) for r in results]
    if len(vals) > 40:          # every 20th, and the last
        vals = vals[::20] + vals[-1:]
        key += " (every 20th iteration and the last)"
    learn = (f"; learner ms per iteration median "
             f"{statistics.median(learn_ms):.2f}" if clock else "")
    print(f"[rllib] {label}: {len(results)} iterations in "
          f"{time.perf_counter() - t0:.1f} s, {key} {vals}; env steps/s "
          f"median {statistics.median(sps):.1f}{learn}; on {card}")
    return results


# CartPole's balancing controller, action 1 iff theta + 0.5 theta_dot > 0
# (the heuristic of tests/test_dt.py), as a policy net of one tanh unit
CONTROLLER = {"fc0": {"w": np.array([[0.0], [0.0], [10.0], [5.0]],
                                    np.float32),
                      "b": np.zeros(1, np.float32)},
              "pi": {"w": np.array([[-1.0, 1.0]], np.float32),
                     "b": np.zeros(2, np.float32)},
              "vf": {"w": np.zeros((1, 1), np.float32),
                     "b": np.zeros(1, np.float32)}}


def card_rollouts(path: str, episodes: int, greedy_every: int,
                  seed: int) -> int:
    """CartPole episodes written with ``JsonWriter`` under ``path``: the
    controller's policy net on the card acts greedily in every
    ``greedy_every``-th episode, the others act uniformly at random.
    Columns obs, actions, rewards, dones, next_obs and value_targets (the
    discounted return to go, gamma 0.99) -> rows written."""
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.rllib import (CartPole, JsonWriter, SampleBatch,
                                     policy_forward)

    pol = params_from_numpy(CONTROLLER, device="cuda")
    rng = np.random.default_rng(seed)
    w = JsonWriter(path)
    rows = 0
    for ep in range(episodes):
        env = CartPole(seed=seed + ep)
        o = env.reset()
        cols = {k: [] for k in ("obs", "actions", "rewards", "dones",
                                "next_obs")}
        done = False
        while not done:
            if ep % greedy_every == 0:
                with torch.no_grad():
                    logits, _ = policy_forward(pol, torch.from_numpy(
                        o[None]).to("cuda"))
                a = int(logits[0].argmax())
            else:
                a = int(rng.integers(0, 2))
            no, r, done, _ = env.step(a)
            for k, v in zip(cols, (o, a, r, float(done), no)):
                cols[k].append(v)
            o = no
        rtg = np.zeros(len(cols["rewards"]), np.float32)
        acc = 0.0
        for t in reversed(range(len(rtg))):
            acc = cols["rewards"][t] + 0.99 * acc
            rtg[t] = acc
        w.write(SampleBatch({
            "obs": np.stack(cols["obs"]).astype(np.float32),
            "actions": np.asarray(cols["actions"], np.int64),
            "rewards": np.asarray(cols["rewards"], np.float32),
            "dones": np.asarray(cols["dones"], np.float32),
            "next_obs": np.stack(cols["next_obs"]).astype(np.float32),
            "value_targets": rtg}))
        rows += len(rtg)
    w.close()
    return rows


def rl_round_trip(label: str, algo, build) -> None:
    """``save`` into a fresh algorithm, ``restore``, and its ``save``
    again equals the first, leaf for leaf; one more iteration trains."""
    from ray_tpu_torch.rllib.optim import tree_leaves

    saved = algo.save()
    other = build()
    other.restore(saved)
    a = [np.asarray(x) for x in tree_leaves(saved["payload"])]
    b = [np.asarray(x) for x in tree_leaves(other.save()["payload"])]
    check(len(a) == len(b) and all(np.array_equal(x, y)
                                   for x, y in zip(a, b)),
          f"{label} save/restore: the restored state differs")
    r = other.train()
    check(other.iteration == algo.iteration + 1
          and r["steps_this_iter"] > 0,
          f"{label} after restore: iteration {other.iteration}")


def phase_rllib_tail(card: str) -> dict:
    """The single-learner RLlib tail on the card (phase 20): every
    algorithm's update card vs CPU, then the learning runs at the
    settings and bars of the JAX package's tests, each algorithm's
    save/restore, and no flash launch.  Returns the phase's seconds by
    part."""
    from ray_tpu_torch import rllib as R

    torch.backends.cuda.matmul.allow_tf32 = False
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    before = flash_launches()
    fa.launches = fa.bwd_kv_launches = fa.bwd_dq_launches = 0
    tmp = tempfile.mkdtemp(prefix="_chip_smoke_rl_",
                           dir=os.path.dirname(os.path.abspath(__file__)))
    parts = {}
    try:
        t0 = time.perf_counter()
        cart = dict(env="CartPole-v1", num_rollout_workers=0)

        pg_cfg = R.PGConfig(**cart, num_envs_per_worker=8, rollout_length=64,
                            train_batch_size=2048, lr=4e-3, seed=0)
        pg = pg_cfg.build()
        res = rl_learn("PG CartPole", pg, 40, card, learner="update",
                       stop=best_above(90))
        best = max(r.get("episode_reward_mean", 0.0) for r in res)
        check(best > 90, f"PG did not learn CartPole: best {best}")
        rl_round_trip("PG", pg, pg_cfg.build)
        pg.cleanup()
        data = {"expert": os.path.join(tmp, "expert"),
                "mixed": os.path.join(tmp, "mixed")}
        rows = (card_rollouts(data["expert"], 8, 1, SEED + 50),
                card_rollouts(data["mixed"], 16, 2, SEED + 60))
        print(f"[rllib] card rollouts of the balancing controller: "
              f"{rows[0]} rows (greedy) and {rows[1]} (half greedy, half "
              f"random) written to a temporary directory")
        parts["pg_and_data"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        dt_host = R.DTConfig(input_path=data["mixed"], seed=SEED,
                             device="cpu").build()
        data["dt_batch"] = dt_host._sample_batch()
        rl_parity(data)
        parts["parity"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        a2c_cfg = R.A2CConfig(**cart, num_envs_per_worker=8,
                              rollout_length=32, lr=2e-3, entropy_coeff=0.01,
                              seed=0)
        a2c = a2c_cfg.build()
        res = rl_learn("A2C CartPole", a2c, 40, card, learner="update",
                       stop=best_above(40))
        best = max(r.get("episode_reward_mean", 0.0) for r in res)
        check(best > 40, f"A2C did not learn CartPole: best {best}")
        rl_round_trip("A2C", a2c, a2c_cfg.build)
        a2c.cleanup()

        imp_cfg = R.ImpalaConfig(**cart, num_envs_per_worker=8,
                                 rollout_length=32, batches_per_step=8,
                                 lr=2e-3, entropy_coeff=0.01, seed=0)
        imp = imp_cfg.build()
        res = rl_learn("IMPALA CartPole", imp, 10, card, learner="_learn_on",
                       stop=best_above(50))
        best = max(r.get("episode_reward_mean", 0.0) for r in res)
        check(best > 50, f"IMPALA did not learn CartPole: best {best}")
        rl_round_trip("IMPALA", imp, imp_cfg.build)
        imp.cleanup()

        appo_cfg = R.APPOConfig(**cart, num_envs_per_worker=4,
                                rollout_length=64, lr=5e-4,
                                batches_per_step=2, seed=1)
        appo = appo_cfg.build()
        res = rl_learn("APPO CartPole", appo, 11, card, learner="_learn_on")
        first, last = (res[0]["episode_reward_mean"],
                       res[-1]["episode_reward_mean"])
        check(last >= first, f"APPO: mean return {first} -> {last}")
        rl_round_trip("APPO", appo, appo_cfg.build)
        appo.cleanup()
        parts["on_policy"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        dqn_cfg = R.DQNConfig(env="CartPole-v1", num_envs_per_worker=8,
                              rollout_length=64, learning_starts=500,
                              buffer_size=20000, batch_size=64,
                              train_intensity=0.25, target_update_freq=500,
                              epsilon_decay_steps=6000, lr=1e-3, seed=0)
        dqn = dqn_cfg.build()
        res = rl_learn("DQN CartPole", dqn, 25, card, learner="_train_once",
                       stop=best_above(50))
        best = max(r.get("episode_reward_mean", 0.0) for r in res)
        check(best > 50, f"DQN did not learn CartPole: best {best}")
        rl_round_trip("DQN", dqn, dqn_cfg.build)

        sq_cfg = R.SimpleQConfig(env="CartPole-v1", num_envs_per_worker=8,
                                 rollout_length=64, learning_starts=500,
                                 seed=0)
        sq = sq_cfg.build()
        res = rl_learn("SimpleQ CartPole", sq, 2, card, learner="_train_once",
                       key="mean_td_loss")
        check(all(np.isfinite(r["mean_td_loss"]) for r in res),
              "SimpleQ: non-finite loss")
        rl_round_trip("SimpleQ", sq, sq_cfg.build)

        sac_cfg = R.SACConfig(env="CartPole-v1", num_envs_per_worker=8,
                              rollout_length=64, learning_starts=500,
                              buffer_size=20000, batch_size=64,
                              target_entropy_scale=0.3, train_intensity=0.25,
                              lr=3e-3, seed=0)
        sac = sac_cfg.build()
        res = rl_learn("SAC CartPole", sac, 20, card, learner="_update",
                       stop=best_above(40))
        best = max(r.get("episode_reward_mean", 0.0) for r in res)
        check(best > 40, f"SAC did not learn CartPole: best {best}")
        rl_round_trip("SAC", sac, sac_cfg.build)
        parts["replay_discrete"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        td3_cfg = R.TD3Config(env="Pendulum-v1", num_envs_per_worker=4,
                              rollout_length=128, learning_starts=500,
                              batch_size=128, train_intensity=1.0,
                              actor_lr=3e-3, critic_lr=3e-3, tau=0.01,
                              exploration_noise=0.15, seed=0)
        td3 = td3_cfg.build()
        rets = []

        def td3_stop(rs):
            if td3._ep_returns:
                rets.append(float(np.mean(td3._ep_returns[-20:])))
            return bool(rets) and rets[-1] > -400
        rl_learn("TD3 Pendulum", td3, 16, card, learner="_update",
                 key="critic_loss", stop=td3_stop)
        print(f"[rllib] TD3 mean of the last 20 returns per iteration "
              f"{[round(r, 1) for r in rets]} (bar -500)")
        check(rets and rets[-1] > -500,
              f"TD3 did not solve Pendulum: {rets[-1:]}")
        rl_round_trip("TD3", td3, td3_cfg.build)
        ddpg_cfg = R.DDPGConfig(env="Pendulum-v1", num_envs_per_worker=2,
                                rollout_length=32, learning_starts=64,
                                batch_size=32, seed=0)
        ddpg = ddpg_cfg.build()
        r = ddpg.train()
        a = ddpg.compute_action(np.zeros(3, np.float32))
        check(r["steps_this_iter"] == 64 and a.shape == (1,)
              and -2.0 <= float(a[0]) <= 2.0, f"DDPG step: {r}, {a}")
        rl_round_trip("DDPG", ddpg, ddpg_cfg.build)
        parts["continuous"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        for mode, seed, frac in (("ucb", 1, 0.6), ("ts", 2, 1.0)):
            cfg = R.BanditConfig(env=lambda s=seed: R.LinearBanditEnv(seed=s),
                                 exploration=mode, steps_per_iter=256,
                                 seed=0)
            algo = cfg.build()
            res = rl_learn(f"Lin{mode.upper()} bandit", algo, 5, card,
                           learner="", key="mean_regret")
            first, last = res[0]["mean_regret"], res[-1]["mean_regret"]
            check(last < first * frac,
                  f"Lin{mode.upper()} regret {first} -> {last}")
            rl_round_trip(f"Lin{mode.upper()}", algo, cfg.build)

        es_cfg = R.ESConfig(env="CartPole-v1", pop_size=12, sigma=0.1,
                            step_size=0.05, max_episode_steps=200, seed=0)
        es = es_cfg.build()
        res = rl_learn("ES CartPole", es, 13, card, learner="",
                       key="pop_return_mean",
                       stop=lambda rs: max(r["pop_return_mean"]
                                           for r in rs[1:]) >
                       rs[0]["pop_return_mean"] + 10 if len(rs) > 1
                       else False)
        first = res[0]["pop_return_mean"]
        best = max(r["pop_return_mean"] for r in res[1:])
        check(best > first + 10, f"ES no improvement: {first} -> {best}")
        rl_round_trip("ES", es, es_cfg.build)
        ars_cfg = R.ARSConfig(env="CartPole-v1", pop_size=8, top_directions=4,
                              max_episode_steps=100, seed=0)
        ars = ars_cfg.build()
        res = rl_learn("ARS CartPole", ars, 1, card, learner="",
                       key="pop_return_mean")
        check(res[0]["steps_this_iter"] > 0 and ars._obs_n > 0,
              "ARS: no env steps or no filter moments")
        rl_round_trip("ARS", ars, ars_cfg.build)
        parts["bandits_es"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        bc_cfg = R.BCConfig(input_path=data["expert"], batch_size=128,
                            lr=1e-2, hiddens=(32,), seed=0)
        bc = bc_cfg.build()
        # the JAX test takes 60 iterations on N(0, 1) observations; the
        # controller's states sit near its boundary and take longer
        rl_learn("BC (card rollouts)", bc, 400, card, learner="update",
                 key="total_loss")
        obs = np.asarray(bc.data["obs"][:100])
        acc = float(np.mean(bc.compute_actions(obs)
                            == np.asarray(bc.data["actions"][:100])))
        print(f"[rllib] BC accuracy on the greedy rollouts {acc:.3f} "
              f"(bar 0.9)")
        check(acc > 0.9, f"BC accuracy {acc}")
        rl_round_trip("BC", bc, bc_cfg.build)
        mw_cfg = R.MARWILConfig(input_path=data["expert"], batch_size=32,
                                beta=1.0, hiddens=(16,), seed=0)
        mw = mw_cfg.build()
        res = rl_learn("MARWIL (card rollouts)", mw, 2, card,
                       learner="update", key="total_loss")
        check(all(np.isfinite(r["total_loss"]) for r in res),
              "MARWIL: non-finite loss")
        rl_round_trip("MARWIL", mw, mw_cfg.build)
        cql_cfg = R.CQLConfig(input_path=data["mixed"], cql_alpha=1.0,
                              batch_size=128, grad_steps_per_iter=50, seed=0)
        cql = cql_cfg.build()
        res = rl_learn("CQL (card rollouts)", cql, 2, card,
                       learner="_update", key="cql_gap")
        check(np.isfinite(res[1]["loss"])
              and res[1]["cql_gap"] < res[0]["cql_gap"] + 1.0
              and cql.compute_action(np.zeros(4, np.float32)) in (0, 1),
              f"CQL: {res}")
        rl_round_trip("CQL", cql, cql_cfg.build)
        dt_cfg = R.DTConfig(input_path=data["mixed"], env="CartPole-v1",
                            context_len=10, grad_steps_per_iter=40,
                            batch_size=32, seed=0)
        dt = dt_cfg.build()
        res = rl_learn("DT (card rollouts)", dt, 2, card, learner="update",
                       key="loss")
        check(np.isfinite(res[1]["loss"]) and res[1]["loss"] < res[0]["loss"],
              f"DT loss did not drop: {res[0]['loss']} -> {res[1]['loss']}")
        ret = dt.evaluate(num_episodes=3, target_return=500.0)
        print(f"[rllib] DT conditioned on return 500: mean return {ret:.1f} "
              f"over 3 episodes (printed, not gated)")
        rl_round_trip("DT", dt, dt_cfg.build)

        learner = R.Learner(R.DiscretePGModule(4, 2, ent_coeff=0.0), lr=0.05)
        b = {"obs": np.random.default_rng(0).normal(size=(64, 4))
             .astype(np.float32),
             "actions": np.random.default_rng(1).integers(0, 2, 64),
             "advantages": np.random.default_rng(2).normal(size=64)
             .astype(np.float32),
             "value_targets": np.random.default_rng(3).normal(size=64)
             .astype(np.float32)}
        first = learner.update(b)["loss"]
        for _ in range(20):
            last = learner.update(b)["loss"]
        group = R.LearnerGroup(lambda: R.DiscretePGModule(4, 2), 0, lr=0.05)
        print(f"[rllib] Learner on the card: loss {first:.4f} -> {last:.4f} "
              f"in 21 updates; LearnerGroup inline loss "
              f"{group.update(b)['loss']:.4f}")
        check(last < first, f"Learner: loss {first} -> {last}")
        parts["offline_learner"] = time.perf_counter() - t0

        after = flash_launches()
        check(after == (0, 0, 0),
              f"the RLlib tail launched flash kernels: {after}")
        print("[rllib] flash launches in phase 20: 0 / 0 / 0")
    finally:
        fa.launches, fa.bwd_kv_launches, fa.bwd_dq_launches = (
            before[0] + fa.launches, before[1] + fa.bwd_kv_launches,
            before[2] + fa.bwd_dq_launches)
        shutil.rmtree(tmp, ignore_errors=True)
    print("[rllib] phase 20 parts (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return parts


# ------------------------------------------------ the rest of RLlib

def rl_rest_parity_cases() -> list:
    """(label, build(device) -> algorithm, run(algorithm) -> tensors) per
    module of the rest of single-learner RLlib: one update on a fixed
    host batch with fixed draws (permutations, bootstrap rows, Gumbel and
    Gaussian noise) at the module's default widths; ``run`` returns the
    losses and every leaf the update wrote."""
    from ray_tpu_torch import rllib as R
    from ray_tpu_torch.data.feed import to_device

    rng = np.random.default_rng(SEED + 70)

    def f32(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def dev(a, batch):
        return to_device(batch, a.device)

    mappo_b = {"obs": f32(256, 4), "actions": rng.integers(0, 2, 256),
               "logp": np.full(256, np.log(0.5), np.float32)
               + f32(256, scale=0.05), "advantages": f32(256, scale=2.0),
               "value_targets": f32(256, scale=3.0),
               "vf_preds": f32(256)}
    perms = [rng.permutation(256) for _ in range(4)]
    dones = (rng.random((16, 16)) < 0.08).astype(np.float32)
    r2d2_b = {"obs": f32(16, 17, 4), "actions": rng.integers(0, 2, (16, 16)),
              "rewards": np.ones((16, 16), np.float32), "dones": dones,
              "h0": f32(16, 64, scale=0.3), "c0": f32(16, 64, scale=0.3)}
    qmix_b = {"obs": f32(64, 2, 2), "actions": rng.integers(0, 2, (64, 2)),
              "rewards": rng.integers(0, 2, 64).astype(np.float32),
              "dones": (rng.random(64) < 0.12).astype(np.float32),
              "next_obs": f32(64, 2, 2), "state": f32(64, 3),
              "next_state": f32(64, 3)}
    maddpg_b = {"obs": f32(128, 2, 3), "actions": rng.uniform(
        -1, 1, (128, 2, 1)).astype(np.float32),
        "rewards": -rng.uniform(0, 2, 128).astype(np.float32),
        "dones": (rng.random(128) < 0.04).astype(np.float32),
        "next_obs": f32(128, 2, 3)}

    def unit(*shape):
        x = f32(*shape)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)
    slate_b = {"user": unit(64, 4), "doc": unit(64, 8, 4),
               "next_user": unit(64, 4), "next_doc": unit(64, 8, 4),
               "actions": np.stack([rng.choice(8, 2, replace=False)
                                    for _ in range(64)]),
               "click": rng.integers(0, 3, 64),
               "rewards": rng.uniform(0, 1, 64).astype(np.float32),
               "dones": (rng.random(64) < 0.05).astype(np.float32)}
    az_b = [f32(128, 17), rng.dirichlet(np.ones(4), 128).astype(np.float32),
            rng.choice([-1.0, 1.0], 128).astype(np.float32)]
    maml_b = R.SinusoidTasks(seed=SEED + 71).sample(25)
    n = 512
    obs = f32(n, 4, scale=0.2)
    mbmpo_d = {"obs": obs, "act1h": np.eye(2, dtype=np.float32)[
        rng.integers(0, 2, n)], "next_obs": obs + f32(n, 4, scale=0.05),
        "rew": np.ones(n, np.float32),
        "done": (rng.random(n) < 0.05).astype(np.float32)}
    mbmpo_idx = rng.integers(0, n, (3, 60, n))
    mbmpo_g = rng.gumbel(size=(6, 3, 2, 32, 64, 2)).astype(np.float32)
    dreamer_b = {"obs": f32(16, 16, 6), "actions": rng.uniform(
        -1, 1, (16, 16, 2)).astype(np.float32),
        "rewards": -rng.uniform(0, 2, (16, 16)).astype(np.float32)}
    dreamer_eps = {"observe": f32(16, 16, 8), "imagine_a": f32(10, 256, 2),
                   "imagine_s": f32(10, 256, 8)}

    def mappo_run(a):
        _, _, m = a._update(a.params["p0"], a.opts["p0"].opt,
                            dev(a, mappo_b), perms=perms)
        return [torch.as_tensor(v) for v in m.values()] + rl_leaves(
            a.params["p0"])

    def mbmpo_run(a):
        d = dev(a, mbmpo_d)
        losses = a._fit_models(a.models, a.model_opt, d, idx=mbmpo_idx)
        _, _, ml, ret = a._meta_update(
            a.params, a.opt, a.models, d["obs"][:64], gumbel=mbmpo_g)
        return [losses, ml, ret] + rl_leaves(a.models) + rl_leaves(
            a.params)

    def dreamer_run(a):
        eps = {k: torch.from_numpy(v).to(a.device)
               for k, v in dreamer_eps.items()}
        m = a._update(a.params, a.opts, dev(a, dreamer_b), eps=eps)
        return list(m.values()) + rl_leaves(a.params)

    mappo = R.MultiAgentPPOConfig(
        env_maker=lambda: R.MultiAgentCartPole(2, seed=SEED)).multi_agent(
        policies=["p0", "p1"],
        policy_mapping_fn=lambda aid: "p0" if aid == "agent_0" else "p1"
    ).training(minibatch_size=128, num_epochs=2, lr=1e-3, seed=SEED)
    return [
        ("multi-agent PPO", lambda d: dataclasses.replace(
            mappo, device=d).build(), mappo_run),
        ("R2D2", lambda d: R.R2D2Config(env="CartPole-v1", seed=SEED,
                                        device=d).build(),
         lambda a: [a._update(a.params, a.target_params, a.opt,
                              dev(a, r2d2_b))[2]] + rl_leaves(a.params)),
        ("QMIX", lambda d: R.QMIXConfig(seed=SEED, device=d).build(),
         lambda a: [a._update(a.params, a.target_params, a.opt,
                              dev(a, qmix_b))[2]] + rl_leaves(a.params)),
        ("MADDPG", lambda d: R.MADDPGConfig(seed=SEED, device=d).build(),
         lambda a: list(a._update(a.state, dev(a, maddpg_b))[1:])
         + rl_leaves(a.state)),
        ("SlateQ", lambda d: R.SlateQConfig(seed=SEED, device=d).build(),
         lambda a: list(a._update(a.params, a.target_params, a.opt,
                                  dev(a, slate_b))[2:])
         + rl_leaves(a.params)),
        ("AlphaZero", lambda d: R.AlphaZeroConfig(seed=SEED,
                                                  device=d).build(),
         lambda a: list(a.update(*(torch.from_numpy(x).to(a.device)
                                   for x in az_b))) + rl_leaves(a.params)),
        ("MAML (second order)", lambda d: R.MAMLConfig(seed=SEED,
                                                       device=d).build(),
         lambda a: [a._update(a.params, a.opt, dev(a, maml_b))[2]]
         + rl_leaves(a.params)),
        ("MB-MPO (fit and meta-update)", lambda d: R.MBMPOConfig(
            env="CartPole-v1", ensemble_size=3, model_epochs=60,
            meta_steps=6, seed=SEED, device=d).build(), mbmpo_run),
        ("Dreamer", lambda d: R.DreamerConfig(seed=SEED, prefill_episodes=1,
                                              device=d).build(),
         dreamer_run),
    ]


def bar_check(label: str, ok: bool, what: str) -> None:
    print(f"[rllib] {label}: {what} -> {'met' if ok else 'NOT met'}")
    check(ok, f"{label} did not meet its bar: {what}")


def phase_rllib_rest(card: str) -> dict:
    """The rest of single-learner RLlib on the card (phase 21): every
    module's update card vs CPU, the learning runs at the settings and
    bars of the JAX package's tests (each stopping once its bar is met;
    QMIX, AlphaZero, SlateQ and Dreamer may run past the test's
    iteration count: the port's generators draw other inits), every
    algorithm's save/restore, and no flash launch.  Returns the phase's
    seconds by part."""
    from ray_tpu_torch import rllib as R

    torch.backends.cuda.matmul.allow_tf32 = False
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    before = flash_launches()
    fa.launches = fa.bwd_kv_launches = fa.bwd_dq_launches = 0
    parts = {}
    try:
        t0 = time.perf_counter()
        for label, build, run in rl_rest_parity_cases():
            cpu, gpu = build("cpu"), build("cuda")
            gpu.restore(cpu.save())
            held_f32(f"RLlib {label} one update", zip(run(gpu), run(cpu)))
        parts["parity"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        mappo_cfg = R.MultiAgentPPOConfig(
            env_maker=lambda: R.MultiAgentCartPole(2, seed=0)).multi_agent(
            policies=["p0", "p1"],
            policy_mapping_fn=lambda aid: "p0" if aid == "agent_0"
            else "p1").training(train_batch_size=512, minibatch_size=128,
                                num_epochs=2, rollout_length=256, lr=1e-3,
                                seed=0)
        mappo = mappo_cfg.build()
        res = rl_learn("multi-agent PPO MultiAgentCartPole", mappo, 6, card,
                       learner="_update",
                       stop=lambda rs: len(rs) > 1 and rs[-1][
                           "episode_reward_mean"]
                       > rs[0]["episode_reward_mean"])
        first, last = (res[0]["episode_reward_mean"],
                       res[-1]["episode_reward_mean"])
        bar_check("multi-agent PPO", last > first and any(
            k.startswith("p1/") for k in res[-1]),
            f"mean reward {first:.2f} -> {last:.2f} (rises)")
        rl_round_trip("multi-agent PPO", mappo, mappo_cfg.build)

        r2_cfg = R.R2D2Config(env="CartPole-v1", num_envs_per_worker=2,
                              rollout_length=64, learning_starts=8,
                              batch_size=8, seq_len=8, burn_in=2, seed=0)
        r2 = r2_cfg.build()
        res = rl_learn("R2D2 CartPole", r2, 3, card, learner="_update",
                       key="mean_td_loss")
        losses = [r["mean_td_loss"] for r in res]
        bar_check("R2D2", all(np.isfinite(losses))
                  and losses[-1] < losses[0],
                  f"TD loss {losses[0]:.4f} -> {losses[-1]:.4f} (falls)")
        rl_round_trip("R2D2", r2, r2_cfg.build)
        parts["mappo_r2d2"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        qmix_cfg = R.QMIXConfig(num_agents=2, rollout_length=256,
                                learning_starts=100, batch_size=32,
                                epsilon_decay_steps=2000, seed=0)
        qmix = qmix_cfg.build()

        def qmix_recent():
            return float(np.mean(qmix._ep_returns[-50:]))
        rl_learn("QMIX TeamSwitch", qmix, 16, card, learner="_update",
                 key="mean_td_loss", stop=lambda rs: qmix_recent() > 6.0)
        bar_check("QMIX", qmix_recent() > 6.0,
                  f"mean of the last 50 returns {qmix_recent():.2f} (> 6.0)")
        rl_round_trip("QMIX", qmix, qmix_cfg.build)

        mad_cfg = R.MADDPGConfig(num_agents=2, rollout_length=200,
                                 learning_starts=200, batch_size=64, seed=0)
        mad = mad_cfg.build()
        rets = []

        def mad_stop(rs):
            if mad._ep_returns:
                rets.append(float(np.mean(mad._ep_returns[-20:])))
            return len(rets) > 1 and rets[-1] > rets[0] + 3.0
        rl_learn("MADDPG SpreadLine", mad, 8, card, learner="_update",
                 key="critic_loss", stop=mad_stop)
        bar_check("MADDPG", len(rets) > 1 and rets[-1] > rets[0] + 3.0,
                  f"mean of the last 20 returns {rets[0]:.2f} -> "
                  f"{rets[-1]:.2f} (first + 3)")
        rl_round_trip("MADDPG", mad, mad_cfg.build)
        parts["qmix_maddpg"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        az_cfg = R.AlphaZeroConfig(num_sims=48, episodes_per_iter=8,
                                   batch_size=64, seed=0)
        az = az_cfg.build()

        def az_recent():
            return float(np.mean(az._ep_returns[-24:]))
        # the JAX test's 12 iterations at its seed; the port's generator
        # draws another init (on the CPU, seeds 0-7 reached 0.375-0.917
        # by iteration 12, seed 0 passed 0.6 at iteration 17)
        rl_learn("AlphaZero GridGoal", az, 24, card, learner="update",
                 stop=lambda rs: len(rs) >= 3 and az_recent() > 0.6)
        bar_check("AlphaZero", az_recent() > 0.6,
                  f"mean of the last 24 returns {az_recent():.3f} (> 0.6)")
        rl_round_trip("AlphaZero", az, az_cfg.build)

        env = R.InterestEvolution(num_candidates=8, slate_size=2, seed=99)
        rng = np.random.default_rng(1)
        rand, ep = [], 0.0
        env.reset()
        for _ in range(20 * 30):
            _, rew, done, _ = env.step(rng.choice(env.C, env.S,
                                                  replace=False))
            ep += rew
            if done:
                rand.append(ep)
                ep = 0.0
                env.reset()
        baseline = float(np.mean(rand))
        sq_cfg = R.SlateQConfig(num_candidates=8, slate_size=2,
                                rollout_length=256, learning_starts=400,
                                batch_size=64, epsilon_decay_steps=2500,
                                seed=0)
        sq = sq_cfg.build()

        def sq_learned():
            return float(np.mean(sq._ep_returns[-30:]))
        rl_learn("SlateQ InterestEvolution", sq, 24, card,
                 learner="_update", key="mean_q_loss",
                 stop=lambda rs: len(sq._ep_returns) >= 30
                 and sq_learned() > 1.15 * baseline)
        bar_check("SlateQ", sq_learned() > 1.15 * baseline,
                  f"mean of the last 30 returns {sq_learned():.3f} vs "
                  f"random slates {baseline:.3f} (x 1.15)")
        rl_round_trip("SlateQ", sq, sq_cfg.build)
        parts["alpha_zero_slateq"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        maml_cfg = R.MAMLConfig(meta_batch_size=25, meta_iters_per_step=200,
                                seed=0)
        maml = maml_cfg.build()
        evals = []

        def maml_stop(rs):
            evals.append(maml.evaluate_adaptation(n_tasks=50))
            ev = evals[-1]
            return (ev["post_adapt_loss"] < 2.0 and ev["post_adapt_loss"]
                    < 0.55 * ev["pre_adapt_loss"])
        rl_learn("MAML sinusoids (200 meta-updates an iteration)", maml, 4,
                 card, learner="_update", key="meta_loss", stop=maml_stop)
        ev = evals[-1]
        bar_check("MAML", np.isfinite(ev["post_adapt_loss"])
                  and ev["post_adapt_loss"] < 2.0
                  and ev["post_adapt_loss"] < 0.55 * ev["pre_adapt_loss"],
                  f"post-adapt {ev['post_adapt_loss']:.3f} vs pre "
                  f"{ev['pre_adapt_loss']:.3f} (< 2.0, < 0.55 x pre)")
        rl_round_trip("MAML", maml, maml_cfg.build)

        dr_cfg = R.DreamerConfig(seed=0, prefill_episodes=6,
                                 episodes_per_step=2,
                                 train_iters_per_step=15, batch_size=8,
                                 seq_len=12, actor_lr=3e-4,
                                 model_warmup_updates=45)
        dr = dr_cfg.build()
        random_ret = float(np.mean(dr._ep_returns))
        evals = []              # (iteration, noise-free eval return)

        def dr_stop(rs):
            if rs[-1]["obs_loss"] >= 0.3 or dr._model_updates <= 45:
                return False
            evals.append((len(rs), dr.evaluate_episodes(4)))
            return evals[-1][1] > random_ret + 10.0
        res = rl_learn("Dreamer LinearLatentEnv", dr, 20, card,
                       learner="_update", key="obs_loss", stop=dr_stop)
        if not evals or evals[-1][0] != len(res):
            evals.append((len(res), dr.evaluate_episodes(4)))
        evals = [e for _, e in evals]
        bar_check("Dreamer", evals[-1] > random_ret + 10.0
                  and res[-1]["obs_loss"] < 0.3,
                  f"eval return {evals[-1]:.2f} vs random {random_ret:.2f} "
                  f"(+ 10), obs_loss {res[-1]['obs_loss']:.4f} (< 0.3)")
        rl_round_trip("Dreamer", dr, dr_cfg.build)
        parts["maml_dreamer"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        mb_cfg = R.MBMPOConfig(env="CartPole-v1", num_rollout_workers=0,
                               num_envs_per_worker=8, rollout_length=64,
                               real_batch_size=1024, ensemble_size=3,
                               model_epochs=60, meta_steps=6, inner_lr=0.1,
                               lr=8e-3, seed=0)
        mb = mb_cfg.build()
        res = rl_learn("MB-MPO CartPole", mb, 20, card,
                       learner="_meta_update", stop=best_above(48))
        best = max(r.get("episode_reward_mean", 0.0) for r in res)
        first, last = res[0]["model_loss_mean"], res[-1]["model_loss_mean"]
        bar_check("MB-MPO", best > 48 and last < first,
                  f"best mean return {best:.1f} (> 48), model loss "
                  f"{first:.4f} -> {last:.4f} (falls)")
        rl_round_trip("MB-MPO", mb, mb_cfg.build)
        parts["mbmpo"] = time.perf_counter() - t0

        after = flash_launches()
        check(after == (0, 0, 0),
              f"the rest of RLlib launched flash kernels: {after}")
        print("[rllib] flash launches in phase 21: 0 / 0 / 0")
    finally:
        fa.launches, fa.bwd_kv_launches, fa.bwd_dq_launches = (
            before[0] + fa.launches, before[1] + fa.bwd_kv_launches,
            before[2] + fa.bwd_dq_launches)
    print(f"[rllib] phase 21 parts (s) on {card}: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return parts


# ------------------------------------------------ sharded training

# [batch, heads, seq, head dim] each rank gives the flash kernels on phase
# 15b's dp2.tp2 mesh: b8 over dp2, GPT-2's 12 heads over tp2
TP_SHAPE = (4, 6, 1024, 64)


def tp_shape_times(name: str, card: str) -> dict:
    """The three kernels at ``TP_SHAPE`` bf16 causal (a dp2.tp2 rank's
    shape in phase 15b): ``rank_shape_times``."""
    return rank_shape_times(name, card, TP_SHAPE, True, "a dp2.tp2 rank's "
                            "shape", "sharded", SEED + 15)


def rank_shape_times(name: str, card: str, shape, causal: bool, what: str,
                     tag: str, seed: int, dtype=torch.bfloat16,
                     forward_only: bool = False) -> dict:
    """The three kernels (the forward alone with ``forward_only``) at one
    ``shape`` in ``dtype`` against their plain versions (max abs error)
    and timed beside their bound, the plain versions and SDPA: {kernel:
    record}."""
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    b, h, s, d = shape
    mode = "causal" if causal else "non-causal"
    dname = str(dtype).split(".")[-1]
    q, k, v, do = (rand(shape, dtype) for _ in range(4))
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    fwd_err = (out.float() - ref.float()).abs().max().item()
    if forward_only:
        ok = fwd_err <= TOL[dtype]
        print(f"[{tag}] flash_fwd [{b},{h},{s},{d}] {dname} {mode} ({what}) "
              f"max_abs_err {fwd_err:.3e} against its plain version (bound "
              f"{TOL[dtype]:g}) {'ok' if ok else 'FAIL'}")
        check(ok, f"flash_fwd at {shape} {dname}: error {fwd_err}")
        return {"flash_fwd": dict(
            forward_times(name, card, tag, q, k, v, causal),
            max_abs_err=fwd_err)}
    delta = fa._delta(out, do)
    scale = d ** -0.5
    dk, dv = fa._launch_bwd_kv(q, k, v, do, lse, delta, scale, causal)
    dq = fa._launch_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    rdk, rdv = fa._bwd_kv_reference(q, k, v, do, lse, delta, scale, causal,
                                    512, 512)
    rdq = fa._bwd_dq_reference(q, k, v, do, lse, delta, scale, causal, 512,
                               512)
    held = {"flash_fwd": [(fwd_err, fwd_err <= TOL[torch.bfloat16])],
            "flash_bwd_kv": [grad_err(dk, rdk, torch.bfloat16),
                             grad_err(dv, rdv, torch.bfloat16)],
            "flash_bwd_dq": [grad_err(dq, rdq, torch.bfloat16)]}
    errs = {}
    for kname, pairs in held.items():
        errs[kname] = max(e for e, _ in pairs)
        ok = all(o for _, o in pairs)
        print(f"[{tag}] {kname} [{b},{h},{s},{d}] bf16 {mode} ({what}) "
              f"max_abs_err {errs[kname]:.3e} against its plain version "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{kname} at {shape}: error {errs[kname]}")
    out = {"flash_fwd": forward_times(name, card, tag, q, k, v, causal)}
    out.update(backward_times(name, card, rand, b, h, s, d, causal))
    for kname, err in errs.items():
        out[kname]["max_abs_err"] = err
    return out


def forward_times(name: str, card: str, tag: str, q, k, v,
                  causal: bool) -> dict:
    """The flash forward on q, k, v timed (device time) beside its bound
    (bytes over the card's rate, or FLOPs over its peak for the dtype:
    tensor cores for bf16, CUDA cores for f32), the plain version and
    SDPA: a kernel record."""
    import torch.nn.functional as F

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    b, h, s, d = q.shape
    ms = device_ms(lambda: fa.flash_attention(q, k, v, causal=causal))
    plain_ms = device_ms(lambda: fa.flash_attention_reference(
        q, k, v, causal=causal), 3)
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal))
    bw, flops = rates(name)
    if q.dtype == torch.float32:
        flops = F32_FLOPS
    nbytes, nflop = attention_work(b, h, s, s, d, causal, q.element_size())
    t_bytes, t_ops = nbytes / bw * 1e3, nflop / flops * 1e3
    print(f"[{tag}] flash_fwd [{b},{h},{s},{d}] "
          f"{str(q.dtype).split('.')[-1]} "
          f"{'causal' if causal else 'non-causal'} on {card}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
          f"bound {max(t_bytes, t_ops):.5f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def sharded_steps(mesh, cfg, params, tokens, steps, *, on_step=None,
                  model=None, tx=None, after_step=None):
    """``steps`` of make_train_step (AdamW(3e-4, weight_decay=0.1) unless
    ``tx``) of ``model`` (the GPT module unless given; it has ``loss_fn``
    and ``param_logical_axes``) on ``mesh`` (None: one device) from a copy
    of ``params`` on one host batch (numpy): ``tokens``, or a dict of
    columns.  Returns [(loss, grad_norm)] and the CUDA-event ms of each
    step.  ``on_step(i)`` runs after step i's metrics are read, then
    ``after_step(i, state)``."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.train import adamw, make_train_step
    from ray_tpu_torch.train.step import device_batch

    model = model or gpt
    logical = model.param_logical_axes(cfg) if mesh is not None else None
    init_fn, step_fn = make_train_step(
        lambda p, b: model.loss_fn(p, b, cfg, mesh=mesh),
        tx or adamw(3e-4, weight_decay=0.1), mesh=mesh,
        params_logical=logical)
    state = init_fn(params)
    batch = device_batch(tokens if isinstance(tokens, dict)
                         else {"tokens": tokens}, "cuda", mesh=mesh)
    out, ms = [], []
    for i in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = step_fn(state, batch)
        z.record()
        out.append((m["loss"].item(), m["grad_norm"].item()))
        ms.append(a.elapsed_time(z))
        if on_step is not None:
            on_step(i)
        if after_step is not None:
            after_step(i, state)
    del state
    return out, ms


def phase_sharded_training(name: str, card: str) -> dict:
    """15a: NCCL at world size 1, the dp mesh of one card, against the
    single-device step; 15b: four ranks as threads on the one card (the
    threaded process group) on dp2.tp2 and dp2.sp2.  Returns {path:
    [flash_fwd, flash_bwd_kv, flash_bwd_dq launches in its run]} and the
    kernels' records at the tp-local shape."""
    import logging

    import torch.distributed as dist

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import create_mesh, run_ranks

    # DTensor warns at every redistribute that sums over two mesh dims
    # (two all-reduces where a flattened dim would take one), thousands
    # of lines here
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    cfg = gpt.GPTConfig.gpt2_124m(remat=True, remat_policy="dots")
    L = cfg.n_layers
    params = gpt.init_params(cfg, SEED)
    rng = np.random.default_rng(SEED + 15)
    launches = {}

    # 15a: NCCL at world size 1, b16 s1024
    tokens = rng.integers(0, cfg.vocab_size, (16, 1025)).astype(np.int64)
    single, single_ms = sharded_steps(None, cfg, params, tokens, 13)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = create_mesh({"dp": 1})
        counts = []

        def count(i):
            if i < 3:
                counts.append((fa.launches, fa.bwd_kv_launches,
                               fa.bwd_dq_launches))
                fa.launches = fa.bwd_kv_launches = fa.bwd_dq_launches = 0

        torch.cuda.synchronize()
        fa.launches = fa.bwd_kv_launches = fa.bwd_dq_launches = 0
        sharded, sharded_ms = sharded_steps(mesh, cfg, params, tokens, 13,
                                            on_step=count)
    finally:
        dist.destroy_process_group()
    launches["sharded_nccl_dp1"] = [sum(c[i] for c in counts)
                                    for i in range(3)]
    for i in range(3):
        (l1, n1), (l2, n2) = single[i], sharded[i]
        rel = abs(l2 - l1) / abs(l1)
        print(f"[sharded 15a] step {i + 1}: loss {l2:.6f} vs one device "
              f"{l1:.6f} (rel {rel:.2e}, bound 1e-5), grad_norm {n2:.5f} "
              f"vs {n1:.5f}, launches {counts[i]}")
        check(rel <= 1e-5, f"15a step {i + 1}: loss {l2} vs {l1}")
        check(counts[i] == (2 * L, L, L), f"15a step {i + 1} launched "
              f"{counts[i]}, expected ({2 * L}, {L}, {L})")
    one = statistics.median(single_ms[3:])
    dt = statistics.median(sharded_ms[3:])
    print(f"[sharded 15a] GPT-2 124M b16 s1024 bf16 \"dots\", NCCL world "
          f"size 1, mesh dp1 on {card}: steady step {dt:.3f} ms vs one "
          f"device {one:.3f} ms (median of 10): DTensor and the mesh arm "
          f"add {dt - one:.3f} ms ({(dt - one) / one:.3%})")

    # 15b: four ranks as threads on the card, b8 s1024
    tokens = rng.integers(0, cfg.vocab_size, (8, 1025)).astype(np.int64)
    ref, _ = sharded_steps(None, cfg, params, tokens, 3)
    for axes, attn in ((("dp", 2), ("tp", 2)), "flash"), \
            ((("dp", 2), ("sp", 2)), "ring"):
        label = ".".join(f"{a}{n}" for a, n in axes)

        def rank(r, axes=axes):
            mesh = create_mesh(dict(axes))
            per_step = []

            def count(i):
                per_step.append(dict(fa.thread_launches()))
                fa.reset_thread_launches()

            fa.reset_thread_launches()
            got, ms = sharded_steps(mesh, cfg, params, tokens, 3,
                                    on_step=count)
            return got, ms, per_step

        torch.cuda.synchronize()
        fa.launches = fa.bwd_kv_launches = fa.bwd_dq_launches = 0
        t = time.perf_counter()
        results = run_ranks(rank, 4, timeout=300)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches[f"sharded_threads_{label}"] = [
            fa.launches, fa.bwd_kv_launches, fa.bwd_dq_launches]
        for r, (got, ms, per_step) in enumerate(results):
            for i, ((l2, n2), (l1, n1)) in enumerate(zip(got, ref)):
                dl, dn = abs(l2 - l1) / abs(l1), abs(n2 - n1) / abs(n1)
                if r == 0:
                    print(f"[sharded 15b {label}] step {i + 1}: loss "
                          f"{l2:.6f} vs one device {l1:.6f} (rel {dl:.2e}, "
                          f"bound 5e-3), grad_norm {n2:.5f} vs {n1:.5f} "
                          f"(rel {dn:.2e}, bound 5e-2)")
                check(dl <= 5e-3 and dn <= 5e-2, f"15b {label} rank {r} "
                      f"step {i + 1}: loss {l2} vs {l1}, norm {n2} vs {n1}")
            for i, seen in enumerate(per_step):
                want = ({("fwd", TP_SHAPE): 2 * L, ("bwd_kv", TP_SHAPE): L,
                         ("bwd_dq", TP_SHAPE): L} if attn == "flash" else {})
                check(seen == want, f"15b {label} rank {r} step {i + 1} "
                      f"launched {seen}, expected {want}")
        print(f"[sharded 15b {label}] 4 ranks as threads sharing {card}: "
              f"per-step launches on each rank "
              f"{'24 / 12 / 12 at ' + str(list(TP_SHAPE)) if attn == 'flash' else '0 (ring attention)'}; "
              f"step ms on rank 0 {[round(x, 1) for x in results[0][1]]}, "
              f"{wall:.1f} s for the 3 steps of all ranks (four ranks share "
              f"one card and one host: not a throughput)")
    return launches, tp_shape_times(name, card)


# ------------------------------------------------ pipelines and experts

# [batch, heads, seq, head dim] each rank gives the flash kernels in phase
# 16: a microbatch of 16a's pp2.dp2 (b16 in 4 microbatches, 2 rows a dp
# rank), of 16b's pp4 (b16 in 8) and of 16c's pp2.ep2 (b8 in 4); a
# dp2.ep2 rank's rows (b8 over dp2); a BERT microbatch of 16d's pp2.dp2
# (b32 in 4, 4 rows a dp rank)
PP_SHAPE = (2, 12, 1024, 64)
EP_SHAPE = (4, 12, 1024, 64)
BERT_PP_SHAPE = (4, 12, 512, 64)


def gpipe_launches(L: int, S: int, M: int) -> tuple:
    """(flash_fwd, flash_bwd_kv, flash_bwd_dq) launches a GPipe step
    makes on each rank: every stage runs its L/S layers at each of the
    T = M + S - 1 ticks (bubbles included), once forward and once more in
    the recompute, and backward once."""
    n = (M + S - 1) * (L // S)
    return (2 * n, n, n)


def one_f_one_b_launches(L: int, S: int, M: int, r: int) -> tuple:
    """The launches of one 1F1B pass on stage ``r``: F runs the stage's
    L/S layers without a graph (not on the last stage); B runs them
    again under remat (forward, recompute, backward), M times each."""
    n = L // S
    f = 0 if r == S - 1 else M * n
    return (f + 2 * M * n, M * n, M * n)


def threaded_run(axes: dict, fn, want, label: str, timeout: float = 600):
    """``fn(mesh, count)`` on four ranks as threads sharing the card, a
    mesh of ``axes`` each; ``count()`` closes a counted step (the
    rank's launches since the last one).  Each rank's counted launches
    must equal ``want(rank)``, ``{(kernel, q shape): n}`` per counted
    step.  Returns the ranks' results, the total launches of the run
    (flash_fwd, flash_bwd_kv, flash_bwd_dq), the wall seconds and the
    peak device memory the run added (bytes, all four ranks)."""
    from ray_tpu_torch.parallel import create_mesh, run_ranks

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    def rank(r):
        mesh = create_mesh(dict(axes))
        per_step = []

        def count():
            per_step.append(dict(fa.thread_launches()))
            fa.reset_thread_launches()

        fa.reset_thread_launches()
        out = fn(mesh, count)
        return out, per_step

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.bwd_kv_launches = fa.bwd_dq_launches = 0
    t = time.perf_counter()
    results = run_ranks(rank, 4, timeout=timeout)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() - base
    total = [fa.launches, fa.bwd_kv_launches, fa.bwd_dq_launches]
    for r, (_, per_step) in enumerate(results):
        check(len(per_step) > 0, f"{label} rank {r} counted no step")
        for i, seen in enumerate(per_step):
            check(seen == want(r), f"{label} rank {r} step {i + 1} "
                  f"launched {seen}, expected {want(r)}")
    return [out for out, _ in results], total, wall, peak


def per_kernel(shape, fwd: int, kv: int, dq: int) -> dict:
    return {("fwd", shape): fwd, ("bwd_kv", shape): kv,
            ("bwd_dq", shape): dq}


def one_device_grads(model, cfg, params, batch, microbatches: int) -> tuple:
    """(loss, grad_norm, gradients in leaf order) of ``model`` on one
    device at ``params`` (whole tensors on the card) and the host
    ``batch``: what a step there would see before its update.  The loss
    is the mean of the loss on each of ``microbatches`` equal row blocks
    of the batch, as a pipeline's MoE aux term is."""
    from ray_tpu_torch.models.convert import _leaves, _map
    from ray_tpu_torch.train.step import device_batch

    p = _map(lambda t: t.detach().requires_grad_(True), params)
    n = len(next(iter(batch.values()))) // microbatches
    loss = sum(model.loss_fn(p, device_batch(
        {k: v[m * n:(m + 1) * n] for k, v in batch.items()}, "cuda"), cfg)
        for m in range(microbatches)) / microbatches
    grads = torch.autograd.grad(loss, _leaves(p), materialize_grads=True)
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))
    return loss.item(), norm.item(), list(grads)


def gathered_state(state) -> dict:
    """A mesh TrainState's params and Adam's count and moments, gathered
    whole (copies on the card).  Collectives: every rank of the mesh
    joins them."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.models.convert import _leaves, _map, _unflatten

    leaves = _leaves(state.params)
    with torch.no_grad():
        local = [p.to_local() for p in leaves]   # the optimizer's tensors
    opt = state.opt_state.state

    def moment(key):
        return _unflatten(state.params, [DTensor.from_local(
            opt[t][key], p.device_mesh, p.placements, run_check=False,
            shape=p.shape, stride=p.stride()).full_tensor().clone()
            for p, t in zip(leaves, local)])

    return {"params": _map(lambda t: t.full_tensor().detach().clone(),
                           state.params),
            "opt": {"count": int(opt[local[0]]["step"]),
                    "mu": moment("exp_avg"), "nu": moment("exp_avg_sq")}}


def mesh_grads(before: dict, after: dict, b1: float) -> list:
    """The gradients a mesh step fed Adam, in leaf order, read back from
    its first moment: ``(mu_after - b1 mu_before) / (1 - b1)`` (no
    ``mu_before`` before the first step)."""
    from ray_tpu_torch.models.convert import _leaves

    mu = _leaves(after["opt"]["mu"])
    was = ([None] * len(mu) if before["opt"] is None
           else _leaves(before["opt"]["mu"]))
    return [(m.cuda() - (0 if w is None else b1 * w.cuda())) / (1 - b1)
            for m, w in zip(mu, was)]


def replayed_update(tx, snap: dict, grads: list) -> list:
    """The params' leaves after one step of ``tx`` on one device from
    ``snap`` (params and Adam's state; none before the first step) fed
    ``grads``."""
    from ray_tpu_torch.models.convert import _leaves, _map
    from ray_tpu_torch.train.step import load_adam_state

    params = _map(lambda t: t.detach().clone(), snap["params"])
    opt = tx(_leaves(params))
    if snap["opt"] is not None:
        load_adam_state(opt, params, snap["opt"])
    for t, g in zip(_leaves(params), grads):
        t.grad = g
    opt.step()
    return _leaves(params)


def rel_errors(got: list, want: list, origin: list = None) -> tuple:
    """L2 distance of ``got`` from ``want`` over the norm of ``want``
    (of ``want - origin`` with ``origin``): over all leaves together,
    the worst leaf's, and its index."""
    diff, size = [], []
    for i, (g, w) in enumerate(zip(got, want)):
        diff.append(torch.linalg.vector_norm(g - w, dtype=torch.float32))
        size.append(torch.linalg.vector_norm(
            w if origin is None else w - origin[i], dtype=torch.float32))
    diff, size = torch.stack(diff), torch.stack(size)
    leaf = diff / size.clamp_min(1e-30)
    return ((diff.norm() / size.norm()).item(), leaf.max().item(),
            int(leaf.argmax()))


def leaf_norm_error(got: list, want: list) -> tuple:
    """The worst leaf's | |got| - |want| | / |want| (L2 norms) and its
    index."""
    g, w = (torch.stack([torch.linalg.vector_norm(t, dtype=torch.float32)
                         for t in ts]) for ts in (got, want))
    leaf = (g - w).abs() / w.clamp_min(1e-30)
    return leaf.max().item(), int(leaf.argmax())


def mesh_steps(axes: dict, model, cfg, params, batch: dict, steps: int,
               want: dict, label: str, traj: list, tx=None,
               microbatches: int = 1):
    """``steps`` of make_train_step (AdamW(3e-4, weight_decay=0.1) unless
    ``tx``) on four threaded ranks on a mesh of ``axes`` from ``params``
    on the host ``batch``, each rank launching ``want`` a step.  After
    each step every rank gathers its state: each rank's params must
    equal rank 0's within 1e-6 (a replica a step left out is about lr
    away), and rank 0 keeps them with Adam's state.  Each mesh step is
    held to one device on the params it started from (its loss the mean
    over ``microbatches`` row blocks, as a pipelined MoE's): loss and
    grad_norm within rel 5e-3 / 5e-2 (15b's bounds), and each leaf of the
    gradients it fed Adam in norm within rel 5e-2 (a leaf given none,
    half or twice its gradient is 0.5 or more away).  Its update must be
    Adam's on one device from the same params and state fed those
    gradients: within rel 1e-3 over all leaves, 1e-2 on each.  A dense
    model's gradients must also lie within rel 5e-2 of one device's over
    all leaves (0.25 on each), and every step's loss and grad_norm within
    15b's bounds of ``traj``, one device's own trajectory from
    ``params``.  An MoE's are printed only: at random init the router's
    top-k is near-tied for many tokens, bf16 rounding flips some between
    the mesh and one device and moves their gradient to other experts,
    and Adam's first steps amplify it.  Returns (launches of the run,
    step ms on rank 0, wall s)."""
    import torch.distributed as dist

    from ray_tpu_torch.models.convert import _leaves, _map
    from ray_tpu_torch.train import adamw

    tx = tx or adamw(3e-4, weight_decay=0.1)
    routed = getattr(cfg, "n_experts", 0) > 0
    snaps = [{"params": params, "opt": None}]     # rank 0's, step by step

    def fn(mesh, count):
        rank, spread = dist.get_rank(), []

        def after_step(i, state):
            got = gathered_state(state)
            if rank == 0:    # load_adam_state reads the moments on the host
                got["opt"].update({k: _map(lambda t: t.cpu(), got["opt"][k])
                                   for k in ("mu", "nu")})
                snaps.append(got)
            dist.all_reduce(torch.zeros(1, device="cuda"))   # rank 0's in
            if rank != 0:
                spread.append(max(
                    (a - b).abs().max().item() for a, b in zip(
                        _leaves(got["params"]),
                        _leaves(snaps[i + 1]["params"]))))

        got, ms = sharded_steps(mesh, cfg, params, batch, steps,
                                on_step=lambda i: count(), model=model,
                                tx=tx, after_step=after_step)
        return got, ms, spread

    out, launches, wall, _ = threaded_run(axes, fn, lambda r: want, label)
    for r, (_, _, spread) in enumerate(out[1:], 1):
        check(max(spread) <= 1e-6, f"{label} rank {r}: params up to "
              f"{max(spread)} from rank 0's after a step")
    def names(tree, pre=""):
        return [n for k, v in tree.items() for n in (
            names(v, f"{pre}{k}.") if isinstance(v, dict) else [pre + k])]

    leaf_names = names(params)
    b1 = tx.keywords["betas"][0]
    for i in range(steps):
        l1, n1, g1 = one_device_grads(model, cfg, snaps[i]["params"], batch,
                                      microbatches)
        g2 = mesh_grads(snaps[i], snaps[i + 1], b1)
        grad, grad_leaf, gi = rel_errors(g2, g1)
        norm_leaf, ni = leaf_norm_error(g2, g1)
        del g1
        before = _leaves(snaps[i]["params"])
        upd, upd_leaf, ui = rel_errors(_leaves(snaps[i + 1]["params"]),
                                       replayed_update(tx, snaps[i], g2),
                                       before)
        del g2
        (lt, nt) = traj[i]
        for r, (got, _, _) in enumerate(out):
            (l2, n2) = got[i]
            dl, dn = abs(l2 - l1) / abs(l1), abs(n2 - n1) / abs(n1)
            tl, tn = abs(l2 - lt) / abs(lt), abs(n2 - nt) / abs(nt)
            if r == 0:
                print(f"[{label}] step {i + 1}: loss {l2:.6f}, grad_norm "
                      f"{n2:.5f}; one device on the same params {l1:.6f} / "
                      f"{n1:.5f} (rel {dl:.2e} / {dn:.2e}, bounds 5e-3 / "
                      f"5e-2), gradients' leaf norms worst rel "
                      f"{norm_leaf:.2e} ({leaf_names[ni]}; bound 5e-2), "
                      f"gradients rel {grad:.2e}, worst leaf "
                      f"{grad_leaf:.2e} ({leaf_names[gi]}; "
                      + ("not gated" if routed else "bounds 5e-2, 0.25")
                      + "), update against Adam's on one device rel "
                      f"{upd:.2e}, worst leaf {upd_leaf:.2e} "
                      f"({leaf_names[ui]}; bounds 1e-3, 1e-2); one device's "
                      f"own step {lt:.6f} / {nt:.5f} (rel {tl:.2e} / "
                      f"{tn:.2e}, " + ("not gated)" if routed
                                       else "bounds 5e-3 / 5e-2)")
                      + "; ranks 1-3's params within "
                      f"{max(o[2][i] for o in out[1:]):.1e} of rank 0's")
            check(dl <= 5e-3 and dn <= 5e-2, f"{label} rank {r} step "
                  f"{i + 1}: loss {l2} vs {l1}, norm {n2} vs {n1} on the "
                  "same params")
            check(routed or (tl <= 5e-3 and tn <= 5e-2),
                  f"{label} rank {r} step {i + 1}: loss {l2} vs {lt}, norm "
                  f"{n2} vs {nt} on one device's trajectory")
        check(norm_leaf <= 5e-2, f"{label} step {i + 1}: the norm of "
              f"{leaf_names[ni]}'s gradient {norm_leaf} from one device's")
        check(routed or (grad <= 5e-2 and grad_leaf <= 0.25), f"{label} "
              f"step {i + 1}: gradients {grad} from one device's, worst "
              f"leaf {grad_leaf}")
        check(upd <= 1e-3 and upd_leaf <= 1e-2, f"{label} step {i + 1}: "
              f"update {upd} from Adam's on one device, worst leaf "
              f"{upd_leaf}")
    return launches, out[0][1], wall


def phase_pipelines(name: str, card: str) -> tuple:
    """16: the pp and ep arms on four threaded ranks sharing the card, at
    GPT-2 124M (and BERT-base) widths, bf16.  16a GPipe on pp2.dp2, b16,
    M 4, three steps; 16b GPipe and 1F1B passes on pp4, b16, M 8 (peak
    memory of each, 1F1B's loss and every leaf's gradient), then
    ``train_step_1f1b``; 16c MoE on dp2.ep2, b8, three steps, and MoE on
    pp2.ep2, b8, M 4, three steps; 16d BERT-base on pp2.dp2, b32 s512,
    M 4, one step.  Returns {path: [flash_fwd, flash_bwd_kv,
    flash_bwd_dq launches]} and the kernels' records at the three
    per-rank shapes."""
    import logging

    from ray_tpu_torch.models import bert, gpt
    from ray_tpu_torch.train import adamw
    from ray_tpu_torch.train.step import (_global_norm, _leaves,
                                          gpt_value_and_grads_1f1b,
                                          shard_batch, train_step_1f1b)

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    cfg = gpt.GPTConfig.gpt2_124m(remat=True, remat_policy="dots")
    L = cfg.n_layers
    params = gpt.init_params(cfg, SEED)
    rng = np.random.default_rng(SEED + 16)
    launches = {}
    tokens16 = rng.integers(0, cfg.vocab_size, (16, 1025)).astype(np.int64)
    batch16 = {"tokens": tokens16}
    ref16, ref_ms = sharded_steps(None, cfg, params, tokens16, 3)

    # 16a: GPipe on pp2.dp2
    want = per_kernel(PP_SHAPE, *gpipe_launches(L, 2, 4))
    launches["pipeline_gpipe_pp2.dp2"], ms, wall = mesh_steps(
        {"pp": 2, "dp": 2}, gpt, cfg, params, batch16, 3, want,
        "pipeline 16a pp2.dp2", ref16)
    print(f"[pipeline 16a] GPipe pp2.dp2, b16, M 4, 4 ranks as threads "
          f"sharing {card}: per-step launches on each rank {want}; step ms "
          f"on rank 0 {[round(x, 1) for x in ms]} (one device "
          f"{[round(x, 1) for x in ref_ms]}), {wall:.1f} s for the 3 steps "
          f"of all ranks (not a throughput)")

    # 16b: GPipe and 1F1B passes at S 4, M 8 on one batch; then
    # train_step_1f1b
    def pipeline_pass(mesh, count, one_f_one_b):
        placed = gpt_params_on(mesh, params, gpt.param_logical_axes(cfg))
        batch = shard_batch({"tokens": tokens16}, mesh)
        t = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        t.record()
        if one_f_one_b:
            loss, grads = gpt_value_and_grads_1f1b(placed, batch["tokens"],
                                                   cfg, mesh)
            leaves = _leaves(grads)
        else:
            leaves = _leaves(placed)
            loss = gpt.loss_fn(placed, batch, cfg, mesh=mesh)
            from ray_tpu_torch.train.step import _sum_grads
            leaves = _sum_grads(list(torch.autograd.grad(loss, leaves)),
                                leaves)
        z.record()
        count()
        norm = _global_norm(leaves).item()
        zero = [i for i, g in enumerate(leaves)
                if _global_norm([g]).item() == 0.0]
        return loss.to_local().item(), norm, t.elapsed_time(z), zero

    peaks = {}
    for kind, want in (("gpipe", lambda r: per_kernel(
            PP_SHAPE, *gpipe_launches(L, 4, 8))),
            ("1f1b", lambda r: per_kernel(
                PP_SHAPE, *one_f_one_b_launches(L, 4, 8, r)))):
        out, launches[f"pipeline_{kind}_pp4"], wall, peak = threaded_run(
            {"pp": 4}, lambda mesh, count, k=kind: pipeline_pass(
                mesh, count, k == "1f1b"), want, f"16b {kind}")
        peaks[kind] = peak
        loss, norm, ms, zero = out[0]
        (l1, n1) = ref16[0]
        bound = 1e-3 + 1e-3 * abs(l1)
        print(f"[pipeline 16b] {kind} pp4, b16, M 8 on {card}: loss "
              f"{loss:.6f} vs one device {l1:.6f} (|diff| "
              f"{abs(loss - l1):.2e}, bound {bound:.2e}), grad_norm "
              f"{norm:.5f} vs {n1:.5f}; peak device memory of the four "
              f"ranks {peak / 2 ** 30:.3f} GiB; pass ms on rank 0 {ms:.1f}, "
              f"{wall:.1f} s for all ranks; launches per rank "
              f"{[want(r) for r in range(4)]}")
        for r, (lr, nr, _, zr) in enumerate(out):
            check(abs(lr - l1) < bound, f"16b {kind} rank {r}: loss {lr} "
                  f"vs one device {l1}")
            check(abs(nr - n1) / n1 <= 5e-2, f"16b {kind} rank {r}: "
                  f"grad_norm {nr} vs one device {n1}")
            check(not zr, f"16b {kind} rank {r}: leaves {zr} got a zero "
                  "gradient")
    print(f"[pipeline 16b] peak device memory a pass added at S 4, M 8 "
          f"(four ranks on one card, params placed in the pass): GPipe "
          f"{peaks['gpipe'] / 2 ** 30:.3f} GiB, 1F1B "
          f"{peaks['1f1b'] / 2 ** 30:.3f} GiB (not gated)")
    # train_step_1f1b also runs the plain loss on one device (its parity
    # check) on each rank: L flash forwards at the whole batch's shape
    b, s = tokens16.shape[0], tokens16.shape[1] - 1
    whole = (b, cfg.n_heads, s, cfg.head_dim)
    out, launches["pipeline_train_step_1f1b_pp4"], wall, _ = threaded_run(
        {"pp": 4}, lambda mesh, count: (train_step_1f1b(
            cfg, mesh, batch_n=b, seq=s), count())[0],
        lambda r: {**per_kernel(PP_SHAPE, *one_f_one_b_launches(L, 4, 8, r)),
                   ("fwd", whole): L},
        "16b train_step_1f1b")
    print(f"[pipeline 16b] train_step_1f1b(gpt2_124m, pp4, batch_n={b}, "
          f"seq={s}): loss {out[0]:.6f} on every rank {out}, its parity "
          f"and grad-norm checks passed, {wall:.1f} s")

    # 16c: MoE on dp2.ep2, then MoE + pp on pp2.ep2
    mcfg = moe_config(remat=True, remat_policy="dots")
    mparams = gpt.init_params(mcfg, SEED)
    tokens8 = rng.integers(0, cfg.vocab_size, (8, 1025)).astype(np.int64)
    mref, mref_ms = sharded_steps(None, mcfg, mparams, tokens8, 3)
    for axes, label, want, mb in (
            ({"dp": 2, "ep": 2}, "dp2.ep2",
             per_kernel(EP_SHAPE, 2 * L, L, L), 1),
            ({"pp": 2, "ep": 2}, "pp2.ep2",
             per_kernel(PP_SHAPE, *gpipe_launches(L, 2, 4)), 4)):
        launches[f"pipeline_moe_{label}"], ms, wall = mesh_steps(
            axes, gpt, mcfg, mparams, {"tokens": tokens8}, 3, want,
            f"pipeline 16c moe {label}", mref, microbatches=mb)
        print(f"[pipeline 16c] MoE (4 experts, top-2, cf 1.25) {label}, "
              f"b8: per-step launches on each rank {want}; step ms on rank "
              f"0 {[round(x, 1) for x in ms]} (one device "
              f"{[round(x, 1) for x in mref_ms]}), {wall:.1f} s for the 3 "
              f"steps of all ranks")

    # 16d: BERT-base on pp2.dp2, one step, no mask
    bcfg = bert.BERTConfig.bert_base()
    bparams = bert.init_params(bcfg, SEED)
    b, _, s, _ = BERT_SHAPE
    bbatch = {k: v.cpu().numpy() for k, v in bert_batch(
        bcfg, b, s, SEED + 16).items()}
    tx = adamw(1e-4, weight_decay=0.01)
    bref, bref_ms = sharded_steps(None, bcfg, bparams, bbatch, 1,
                                  model=bert, tx=tx)
    want = per_kernel(BERT_PP_SHAPE, *gpipe_launches(bcfg.n_layers, 2, 4))
    launches["pipeline_bert_pp2.dp2"], ms, wall = mesh_steps(
        {"pp": 2, "dp": 2}, bert, bcfg, bparams, bbatch, 1, want,
        "pipeline 16d bert pp2.dp2", bref, tx=tx)
    print(f"[pipeline 16d] BERT-base pp2.dp2, b{b} s{s}, M 4, no mask: "
          f"launches on each rank {want}; step ms on rank 0 "
          f"{[round(x, 1) for x in ms]} (one device "
          f"{[round(x, 1) for x in bref_ms]}), {wall:.1f} s")

    records = {
        "pp_shape": rank_shape_times(name, card, PP_SHAPE, True, "a pipeline "
                                     "microbatch on a rank", "pipeline",
                                     SEED + 161),
        "ep_shape": rank_shape_times(name, card, EP_SHAPE, True, "a dp2.ep2 "
                                     "rank's shape", "pipeline", SEED + 162),
        "bert_pp_shape": rank_shape_times(name, card, BERT_PP_SHAPE, False,
                                          "a BERT microbatch on a rank",
                                          "pipeline", SEED + 163)}
    return launches, records


def gpt_params_on(mesh, params, logical):
    """``params`` (whole tensors) as DTensor leaves placed by ``logical``,
    requiring grad."""
    from ray_tpu_torch.models.convert import _map
    from ray_tpu_torch.parallel import spmd
    from ray_tpu_torch.parallel.sharding import DEFAULT_LLM_RULES

    return _map(lambda t: t.detach().requires_grad_(True),
                spmd.place_tree(params, logical, DEFAULT_LLM_RULES, mesh))


# ------------------------------------------------ tensor-parallel serving

# [batch, heads, seq, head dim] each tp rank gives the flash forward in
# phase 17's full-width prefill: GPT-2's 12 heads over tp2 and tp4
SERVE_TP_SHAPES = {2: (1, 6, 1024, 64), 4: (1, 3, 1024, 64)}
# phase 17b/c's engines: phase 6's paged settings, n-gram drafts of 8
TP_ENGINE = dict(SPEC_ENGINE, speculate="ngram", speculate_k=8)


def timed_serve(eng, prompts, max_new: int = 16, together: bool = True):
    """``eng``'s greedy replies to ``prompts``, submitted all at once or
    one after another; with each request's TTFT and ITL (serve_bench's:
    (e2e - TTFT) / (n - 1)) and the wall seconds."""
    t0 = time.perf_counter()
    handles, replies = [], []
    if together:
        handles = [eng.submit(p, max_new=max_new) for p in prompts]
        replies = [h.result(timeout=600) for h in handles]
    else:
        for p in prompts:
            handles.append(eng.submit(p, max_new=max_new))
            replies.append(handles[-1].result(timeout=600))
    wall = time.perf_counter() - t0
    ttft = [h.first_token_s - h.created_s for h in handles]
    itl = [(h.finished_s - h.first_token_s) / (len(h.tokens) - 1)
           for h in handles if len(h.tokens) > 1]
    return replies, ttft, itl, wall


def counted_serve(eng, prompts, together: bool = True, warm=None):
    """``timed_serve`` after a warm-up pass over ``warm``, with every
    flash count set to 0 just before (every tp rank's own too) and read
    just after: (replies, ttft, itl, wall, launches, full-width prefills,
    each rank's launches {(kernel, q shape): n} on a mesh)."""
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    if warm is not None:
        timed_serve(eng, warm, together=together)
    ranks = eng._ranks.executor if eng._ranks is not None else None
    st0 = eng.stats()["full_prefills"]
    torch.cuda.synchronize()
    if ranks is not None:
        ranks.on_ranks(lambda ctx: fa.reset_thread_launches())
    fa.launches = 0                      # the path's run starts here
    out = timed_serve(eng, prompts, together=together)
    torch.cuda.synchronize()
    launches = fa.launches               # ... and ends here
    per_rank = (ranks.on_ranks(lambda ctx: dict(fa.thread_launches()))
                if ranks is not None else None)
    return out + (launches, eng.stats()["full_prefills"] - st0, per_rank)


def fail_next_step(eng) -> None:
    """Arm every tp rank of ``eng``: its next plain or verify step raises
    (once, on every rank alike: a step failure, not a dead rank)."""
    def arm(ctx):
        st = ctx.engines[eng.name]
        real = dict(st.bodies)

        def failing(*args):
            st.bodies.update(real)
            raise RuntimeError("injected tp step failure")

        for body in ("step", "verify"):
            if body in st.bodies:
                st.bodies[body] = failing
    eng._ranks.executor.on_ranks(arm)


def tp_prefill_vs_plain(eng, cfg, prompt) -> list:
    """On every rank of ``eng``: the full-width prefill's last-position
    logits of ``prompt`` with the flash kernel and with plain attention
    (each gathered over tp), [(flash, plain)] of rank 0."""
    from torch.distributed.tensor import DTensor, Replicate

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel.collectives import allgather

    padded = torch.zeros((1, cfg.max_seq), dtype=torch.long, device="cuda")
    padded[0, :len(prompt)] = torch.tensor(prompt)
    n = len(prompt)

    def both(ctx):
        st = ctx.engines[eng.name]
        rows = []
        for c in (cfg, dataclasses.replace(cfg, attn_impl="reference")):
            tok = DTensor.from_local(padded, ctx.mesh, (Replicate(),),
                                     run_check=False)
            with torch.no_grad():
                logits, _ = gpt.forward(st.dparams, tok, c, mesh=ctx.mesh,
                                        return_kv=True)
            rows.append(allgather(logits.to_local()[0, n - 1], "tp",
                                  mesh=ctx.mesh))
        return rows
    return eng._ranks.executor.on_ranks(both)[0]


def phase_tp_serving(name: str, card: str) -> tuple:
    """17a: NCCL at world size 1 on a {tp: 1} DeviceMesh, the paged engine
    in bf16 at phase 5's settings, held token for token to the one-device
    engine (the ITL difference is the executor's host cost).  17b: tp2
    and tp4 as threaded ranks on the card in f32 (TF32 off), phase 6's
    paged engine with n-gram drafts of 8: replies token-exact against
    ``generate``, 12 flash launches a rank per full-width prefill at the
    rank's shape, none elsewhere, no leaked block, and one injected step
    failure recovered on every rank.  17c: the same traffic in bf16,
    timed beside one device; the prefill logits at the rank shape within
    0.125 of plain attention.  Then the forward at both rank shapes in
    bf16 and f32 against its plain version, timed.  Returns ({path: flash
    launches in its run}, {record key: flash_fwd record})."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ray_tpu_torch.inference import EngineConfig, InferenceEngine
    from ray_tpu_torch.models import gpt

    launches = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    cfg = gpt.GPTConfig.gpt2_124m()          # bf16 activations, f32 params
    L, heads = cfg.n_layers, cfg.n_heads
    params = gpt.init_params(cfg, SEED, device="cuda")
    warm = requests(cfg.vocab_size, seed=SEED + 1)
    prompts = requests(cfg.vocab_size)

    # 17a: the executor's process world at one rank against one device
    eng = InferenceEngine(params, cfg, EngineConfig())
    try:
        one, _, one_itl, _, _, _, _ = counted_serve(eng, prompts, False, warm)
    finally:
        eng.shutdown()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("tp",))
        eng = InferenceEngine(params, cfg, EngineConfig(), mesh=mesh)
        try:
            got, _, itl, _, n, full, _ = counted_serve(eng, prompts, False,
                                                       warm)
            st = eng.stats()
        finally:
            eng.shutdown()
    finally:
        dist.destroy_process_group()
    launches["serve_tp1_nccl"] = n
    check(got == one, f"17a: tp1 replies {got} differ from one device's "
          f"{one}")
    check(st["mesh_axes"] == {"tp": 1} and st["tp_shards"] == 1,
          f"17a geometry {st['mesh_axes']}")
    check(full >= 1 and n == L * full, f"17a: {n} flash launches for "
          f"{full} full-width prefills")
    a, b = statistics.median(one_itl), statistics.median(itl)
    print(f"[tp 17a] GPT-2 124M bf16, NCCL world size 1, tp1 DeviceMesh "
          f"on {card}: 4 replies token-exact against one device; ITL "
          f"median {b * 1e3:.3f} ms vs one device {a * 1e3:.3f} ms: the "
          f"executor adds {(b - a) * 1e3:.3f} ms a token ({(b - a) / a:.1%})"
          f"; flash launches {n} for {full} full-width prefills")

    # 17b: threaded tp2 / tp4 in f32, token-exact, launches, recovery
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = gpt.GPTConfig.gpt2_124m(dtype=torch.float32)
    params32 = gpt.init_params(cfg32, SEED, device="cuda")
    # phase 6's traffic: the cold prompt, the two sharing a head, a
    # repetitive one the n-gram drafter speculates on
    traffic = prompts[:3] + [[1, 2, 3, 4] * 12]
    want = [gpt.generate(params32, cfg32, torch.tensor([p], device="cuda"),
                         16, temperature=0.0)[0, len(p):].tolist()
            for p in traffic]
    for tp in (2, 4):
        label, shape = f"tp{tp} f32", SERVE_TP_SHAPES[tp]
        eng = InferenceEngine(params32, cfg32, EngineConfig(**TP_ENGINE),
                              mesh={"tp": tp})
        try:
            got, _, _, wall, n, full, per_rank = counted_serve(eng, traffic)
            st = eng.stats()
            launches[f"serve_tp{tp}_f32"] = n
            for p, g, w in zip(traffic, got, want):
                check(g == w, f"17b {label}: the reply to a {len(p)}-token "
                      f"prompt differs from generate: {g} vs {w}")
            check(full >= 1 and n == tp * L * full, f"17b {label}: {n} "
                  f"launches for {full} full-width prefills")
            check(per_rank == [{("fwd", shape): L * full}] * tp,
                  f"17b {label}: per-rank launches {per_rank}")
            check(st["prefix_hit_tokens"] > 0 and st["chunk_prefills"] > 0
                  and st["spec_accepted_tokens"] > 0, f"17b {label}: {st}")
            assert_blocks_returned(eng, f"17b {label}")
            print(f"[tp 17b] {label} on {card}: {len(traffic)} replies "
                  f"token-exact against generate in {wall:.2f} s; each "
                  f"rank {L * full} flash launches at {list(shape)} for "
                  f"{full} full-width prefills, none in the decode bodies;"
                  f" chunk prefills {st['chunk_prefills']}, prefix hit "
                  f"tokens {st['prefix_hit_tokens']}, tokens per step "
                  f"{st['tokens_per_step']:.3f}, no leaked block")
            fail_next_step(eng)
            bad = eng.submit(traffic[3], max_new=16)
            try:
                bad.result(timeout=300)
                check(False, f"17b {label}: the injected failure did not "
                      f"fail its request")
            except RuntimeError as e:
                check("injected tp step failure" in str(e),
                      f"17b {label}: failed with {e!r}")
            pools = eng._ranks.executor.on_ranks(lambda ctx: (
                tuple(ctx.engines[eng.name].pool.kv.shape),
                ctx.engines[eng.name].pool.kv.abs().sum().item()))
            blocks = eng.pool.n_blocks + 1
            check(pools == [((2, L, blocks, heads // tp,
                              TP_ENGINE["kv_block_size"], cfg.head_dim),
                             0.0)] * tp,
                  f"17b {label}: rank pools after the reset {pools}")
            st = eng.stats()
            check(st["blocks_free"] == st["blocks_total"]
                  and eng.pool.generation == 1, f"17b {label}: {st}")
            again = eng.generate(traffic[3], max_new=16, timeout=300)
            check(again == want[3], f"17b {label}: after the reset "
                  f"{again} vs {want[3]}")
            print(f"[tp 17b] {label}: an injected step failure on every "
                  f"rank failed its request, every rank's pool shard "
                  f"{list(pools[0][0])} was zeroed, and the next reply is "
                  f"token-exact")
        finally:
            eng.shutdown()

    # 17c: bf16, timed beside one device; the prefill logits at the rank
    # shape against plain attention
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32
    for tp in (1, 2, 4):
        eng = InferenceEngine(params, cfg, EngineConfig(**TP_ENGINE),
                              mesh={"tp": tp} if tp > 1 else None)
        try:
            got, ttft, itl, wall, n, full, per_rank = counted_serve(
                eng, traffic, warm=warm)
            check(full >= 1 and n == tp * L * full, f"17c tp{tp}: {n} "
                  f"launches for {full} full-width prefills")
            for g in got:
                check(len(g) == 16 and all(0 <= t < cfg.vocab_size
                                           for t in g), f"17c: reply {g}")
            if tp > 1:
                launches[f"serve_tp{tp}_bf16"] = n
                flash, plain = tp_prefill_vs_plain(eng, cfg, traffic[0])
                err = (flash - plain).abs().max().item()
                check(bool(torch.isfinite(flash).all()) and err
                      <= BF16_LOGIT_TOL, f"17c tp{tp}: prefill logits "
                      f"differ from plain attention by {err}")
                print(f"[tp 17c] tp{tp} bf16 full-width prefill at "
                      f"{list(SERVE_TP_SHAPES[tp])} a rank: last-position "
                      f"logits flash vs plain attention max_abs_err "
                      f"{err:.4e} (bound {BF16_LOGIT_TOL}), argmax "
                      f"{int(flash.argmax())} vs {int(plain.argmax())}")
            tokens = sum(map(len, got))
            print(f"[tp 17c] {'one device' if tp == 1 else f'tp{tp}'} bf16"
                  f" on {card}: {len(traffic)} requests at once, TTFT p50 "
                  f"{pct(ttft, 50) * 1e3:.2f} ms p99 "
                  f"{pct(ttft, 99) * 1e3:.2f} ms, ITL p50 "
                  f"{pct(itl, 50) * 1e3:.3f} ms p99 "
                  f"{pct(itl, 99) * 1e3:.3f} ms, {tokens / wall:.1f} "
                  f"tokens/s, wall {wall:.3f} s"
                  + (" (the ranks share one card and take turns: not a tp "
                     "throughput)" if tp > 1 else ""))
        finally:
            eng.shutdown()

    records = {}
    for tp, shape in SERVE_TP_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            key = f"serve_tp{tp}_shape_{str(dtype).split('.')[-1]}"
            records[key] = rank_shape_times(
                name, card, shape, True, f"a tp{tp} rank's prefill",
                "serve tp", SEED + 17, dtype=dtype,
                forward_only=True)["flash_fwd"]
    return launches, records


# ------------------------------------------------ the trainer on a mesh

def step_launches(marks: list, end) -> list:
    """Per-step launches from ``marks``, the counts taken as each step's
    loss began (and ``end``, after the last): [c_1 - c_0, ...]."""
    ends = marks[1:] + [end]
    if isinstance(end, dict):
        return ends           # per-thread logs, reset at every mark
    return [tuple(e - m for e, m in zip(b, a))
            for a, b in zip(marks, ends)]


def mesh_fit(cfg, data, path, mesh, marks: list, *, logical=True):
    """``Trainer.fit`` of ``cfg`` on ``mesh`` (axes, or None for one
    device): AdamW(3e-4, weight_decay=0.1), report every step, checkpoint
    every 3, one failover; ``marks`` gets this thread's launch counts as
    each step's loss begins (a rank's own log on threaded ranks, the
    global counters else).  Returns (trainer, result)."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.train import Trainer, adamw

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    threaded = mesh is not None and int(np.prod(list(mesh.values()))) > 1

    def loss_fn(p, batch, mesh=None, rules=None):
        if threaded:
            marks.append(dict(fa.thread_launches()))
            fa.reset_thread_launches()
        else:
            marks.append(flash_launches())
        return gpt.loss_fn(p, batch, cfg, mesh=mesh,
                           **({} if rules is None else {"rules": rules}))

    tr = Trainer(loss_fn=loss_fn,
                 init_params=lambda seed: gpt.init_params(cfg, seed),
                 optimizer=adamw(3e-4, weight_decay=0.1), train_data=data,
                 num_steps=len(data.batches), report_every=1,
                 checkpoint_every=3, seed=SEED, storage_path=path,
                 max_failures=1, mesh=mesh,
                 params_logical=(gpt.param_logical_axes(cfg)
                                 if mesh is not None and logical else None))
    if threaded:
        fa.reset_thread_launches()
    return tr, tr.fit()


# phase 18b's GPT-2 124M cut to four layers, and a rank's flash shape on
# dp2.tp2 at b8 s1024 (TP_SHAPE: 4 rows, 6 of the 12 heads)
MESH_FIT_LAYERS = 4
MESH_FIT_BOUND = 1e-3          # 18a: dp1 loss vs one device's, relative


def phase_mesh_trainer(card: str, one_device: list) -> dict:
    """18a: ``Trainer.fit`` on a {dp: 1} mesh at NCCL world size 1, GPT-2
    124M at full width and depth, b16 s1024 bf16 "dots", six steps on
    phase 13's first six batches, a checkpoint every 3 and the data
    failing at step 4: the resume starts at step 3, every step launches
    24 / 12 / 12, the losses at steps 2, 4 and 6 within rel
    ``MESH_FIT_BOUND`` of phase 13's uninterrupted one-device fit
    (``one_device``: its (step, loss) reports).  18b: four ranks as
    threads sharing the card on dp2.tp2, the model cut to
    ``MESH_FIT_LAYERS`` layers, b8 s1024, each rank calling ``fit()`` with
    its own data failing at step 4: every rank resumes at step 3 from
    the checkpoint rank 0 wrote, reports the same losses, launches 8 / 4
    / 4 a step at ``TP_SHAPE``, and each step's loss and grad_norm are
    within rel 5e-3 / 5e-2 of the same fit on one device.  Returns
    {path: [flash_fwd, flash_bwd_kv, flash_bwd_dq] launches in its
    run}."""
    import logging

    import torch.distributed as dist

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import run_ranks

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    logging.getLogger("ray_tpu_torch.train").setLevel(logging.ERROR)
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    launches = {}
    root = tempfile.mkdtemp(prefix="_chip_smoke_ckpt_",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        # 18a: NCCL at world size 1, full depth, beside phase 13
        cfg = gpt.GPTConfig.gpt2_124m(remat=True, remat_policy="dots")
        L = cfg.n_layers
        data = HostBatches(6, 16, 1024, 4096, SEED + 20, fail_at=4)
        dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                                f"{free_port()}", world_size=1, rank=0)
        try:
            marks = []
            torch.cuda.synchronize()
            fa.launches = fa.bwd_kv_launches = fa.bwd_dq_launches = 0
            t0 = time.perf_counter()
            tr, res = mesh_fit(cfg, data, os.path.join(root, "dp1"),
                               {"dp": 1}, marks)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = step_launches(marks, flash_launches())
            launches["trainer_mesh_nccl_dp1"] = [
                fa.launches, fa.bwd_kv_launches, fa.bwd_dq_launches]
            ckpts = sorted(os.listdir(os.path.join(root, "dp1",
                                                   "checkpoints")))
            del tr
        finally:
            dist.destroy_process_group()
        hist = [(m["step"], m["loss"]) for m in res.metrics_history]
        check(data.passes == 2 and [st for st, _ in hist]
              == [1, 2, 3, 4, 5, 6], f"18a: {data.passes} passes, "
              f"reported steps {[st for st, _ in hist]}")
        check(ckpts == ["checkpoint_000000", "checkpoint_000001"],
              f"18a: checkpoints {ckpts}")
        for c in counts:
            check(c == (2 * L, L, L), f"18a: a step launched {c}, "
                  f"expected ({2 * L}, {L}, {L})")
        check(len(counts) == 6, f"18a: {len(counts)} steps counted")
        want = dict(one_device)
        rel = {st: abs(lo - want[st]) / abs(want[st]) for st, lo in hist
               if st in want}
        check(sorted(rel) == [2, 4, 6], f"18a: compared steps {sorted(rel)}")
        print(f"[mesh trainer 18a] GPT-2 124M b16 s1024 bf16 \"dots\", "
              f"Trainer.fit on a dp1 mesh at NCCL world size 1 on {card}: "
              f"data failed at step 4, resumed at step 3 "
              f"({data.passes} passes), 6 steps in {wall:.1f} s, "
              f"launches per step {sorted(set(counts))}; losses "
              f"{[(st, round(lo, 6)) for st, lo in hist]}; vs phase 13's "
              f"one-device fit at steps 2/4/6: rel "
              f"{', '.join(f'{rel[st]:.2e}' for st in sorted(rel))} (bound "
              f"{MESH_FIT_BOUND:g})")
        check(all(np.isfinite(lo) for _, lo in hist)
              and max(rel.values()) <= MESH_FIT_BOUND,
              f"18a: losses {hist} vs one device {one_device}")

        # 18b: four threaded ranks on dp2.tp2 at a cut depth
        cfg = gpt.GPTConfig.gpt2_124m(remat=True, remat_policy="dots",
                                      n_layers=MESH_FIT_LAYERS)
        L = cfg.n_layers
        one = HostBatches(6, 8, 1024, 4096, SEED + 18, fail_at=4)
        _, ref = mesh_fit(cfg, one, os.path.join(root, "one"), None, [])
        ref = [(m["step"], m["loss"], m["grad_norm"])
               for m in ref.metrics_history]

        def rank(r):
            data = HostBatches(6, 8, 1024, 4096, SEED + 18, fail_at=4)
            marks = []
            tr, res = mesh_fit(cfg, data, os.path.join(root, "dp2tp2"),
                               {"dp": 2, "tp": 2}, marks)
            seen = step_launches(marks, dict(fa.thread_launches()))
            return ([(m["step"], m["loss"], m["grad_norm"])
                     for m in res.metrics_history], tr.start_step,
                    data.passes, seen)

        torch.cuda.synchronize()
        fa.launches = fa.bwd_kv_launches = fa.bwd_dq_launches = 0
        t0 = time.perf_counter()
        results = run_ranks(rank, 4, timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["trainer_mesh_threads_dp2_tp2"] = [
            fa.launches, fa.bwd_kv_launches, fa.bwd_dq_launches]
        want_seen = per_kernel(TP_SHAPE, 2 * L, L, L)
        worst = (0.0, 0.0)
        for r, (got, start, passes, seen) in enumerate(results):
            check(start == 3 and passes == 2, f"18b rank {r}: resumed at "
                  f"{start} after {passes} passes")
            check(got == results[0][0], f"18b rank {r} reported {got}, "
                  f"rank 0 {results[0][0]}")
            check(len(seen) == 6 and all(s == want_seen for s in seen),
                  f"18b rank {r} launched {seen}, expected {want_seen} "
                  f"each of 6 steps")
        for (st, l2, n2), (st1, l1, n1) in zip(results[0][0], ref):
            dl, dn = abs(l2 - l1) / abs(l1), abs(n2 - n1) / abs(n1)
            worst = (max(worst[0], dl), max(worst[1], dn))
            check(st == st1 and dl <= 5e-3 and dn <= 5e-2, f"18b step "
                  f"{st}: loss {l2} vs {l1}, grad_norm {n2} vs {n1}")
        print(f"[mesh trainer 18b] GPT-2 124M width, {L} layers, b8 s1024 "
              f"bf16, 4 ranks as threads sharing {card} on dp2.tp2: every "
              f"rank resumed at step 3 from rank 0's checkpoint and "
              f"reported the same; per-step launches on each rank "
              f"{2 * L} / {L} / {L} at {list(TP_SHAPE)}; vs the same fit "
              f"on one device: largest rel loss {worst[0]:.2e} (bound "
              f"5e-3), grad_norm {worst[1]:.2e} (bound 5e-2); losses "
              f"{[(st, round(lo, 5)) for st, lo, _ in results[0][0]]}; "
              f"{wall:.1f} s for the ranks' fits (four ranks share one "
              f"card and one host: not a throughput)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return launches


# ------------------------------------------------ the slot engine on tp

SLOT_TP_ENGINE = dict(paged=False, max_slots=2)


def phase_slot_tp(card: str) -> dict:
    """19a: NCCL at world size 1 on a {tp: 1} ``DeviceMesh``, the slot
    engine in bf16 (phase 5's settings with ``paged=False``) held token
    for token to the one-device slot engine, ITL medians side by side.
    19b: tp2 and tp4 as threaded ranks on the card in f32 (TF32 off), two
    slots for phase 6's four requests (slots are reused): every reply
    token-exact against ``generate``, each rank 12 flash launches per
    admission at [1, 12/tp, 1024, 64] and none elsewhere, every slot
    free after and every rank's cache [2, 12, 2, 12/tp, 1024, 64].  19c:
    the same traffic in bf16 on one device, tp2 and tp4 (ITL beside one
    device's), and the prefill's last-position logits at the rank shape
    within 0.125 of plain attention.  Returns {path: flash launches in
    its run}."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ray_tpu_torch.inference import EngineConfig, InferenceEngine
    from ray_tpu_torch.models import gpt

    launches = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    cfg = gpt.GPTConfig.gpt2_124m()
    L, heads = cfg.n_layers, cfg.n_heads
    params = gpt.init_params(cfg, SEED, device="cuda")
    warm = requests(cfg.vocab_size, seed=SEED + 1)
    prompts = requests(cfg.vocab_size)

    # 19a: the executor's process world at one rank against one device
    eng = InferenceEngine(params, cfg, EngineConfig(paged=False))
    try:
        one, _, one_itl, _, _, _, _ = counted_serve(eng, prompts, False, warm)
    finally:
        eng.shutdown()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("tp",))
        eng = InferenceEngine(params, cfg, EngineConfig(paged=False),
                              mesh=mesh)
        try:
            got, _, itl, _, n, full, _ = counted_serve(eng, prompts, False,
                                                       warm)
            st = eng.stats()
        finally:
            eng.shutdown()
    finally:
        dist.destroy_process_group()
    launches["slot_tp1_nccl"] = n
    check(got == one, f"19a: tp1 slot replies {got} differ from one "
          f"device's {one}")
    check(st["mesh_axes"] == {"tp": 1} and st["tp_shards"] == 1
          and st["free_slots"] == st["max_slots"], f"19a: {st}")
    check(full == len(prompts) and n == L * full, f"19a: {n} flash "
          f"launches for {full} admissions")
    a, b = statistics.median(one_itl), statistics.median(itl)
    print(f"[slot tp 19a] GPT-2 124M bf16 slot engine, NCCL world size 1, "
          f"tp1 DeviceMesh on {card}: {len(prompts)} replies token-exact "
          f"against one device; ITL median {b * 1e3:.3f} ms vs one device "
          f"{a * 1e3:.3f} ms: the executor adds {(b - a) * 1e3:.3f} ms a "
          f"token ({(b - a) / a:.1%}); flash launches {n} for {full} "
          f"admissions")

    # 19b: threaded tp2 / tp4 in f32, two slots for four requests
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = gpt.GPTConfig.gpt2_124m(dtype=torch.float32)
    params32 = gpt.init_params(cfg32, SEED, device="cuda")
    traffic = prompts[:3] + [[1, 2, 3, 4] * 12]
    want = [gpt.generate(params32, cfg32, torch.tensor([p], device="cuda"),
                         16, temperature=0.0)[0, len(p):].tolist()
            for p in traffic]
    for tp in (2, 4):
        label, shape = f"tp{tp} f32", SERVE_TP_SHAPES[tp]
        eng = InferenceEngine(params32, cfg32,
                              EngineConfig(**SLOT_TP_ENGINE),
                              mesh={"tp": tp})
        try:
            got, _, _, wall, n, full, per_rank = counted_serve(eng, traffic)
            st = eng.stats()
            caches = eng._ranks.executor.on_ranks(lambda ctx: tuple(
                ctx.engines[eng.name].pool.kv.shape))
        finally:
            eng.shutdown()
        launches[f"slot_tp{tp}_f32"] = n
        for p, g, w in zip(traffic, got, want):
            check(g == w, f"19b {label}: the reply to a {len(p)}-token "
                  f"prompt differs from generate: {g} vs {w}")
        check(full == len(traffic) and n == tp * L * full, f"19b {label}: "
              f"{n} launches for {full} admissions")
        check(per_rank == [{("fwd", shape): L * full}] * tp,
              f"19b {label}: per-rank launches {per_rank}")
        check(st["free_slots"] == st["max_slots"] == 2
              and st["active_slots"] == 0
              and st["requests_completed"] == len(traffic),
              f"19b {label}: a slot leaked: {st}")
        check(caches == [(2, L, 2, heads // tp, cfg.max_seq,
                          cfg.head_dim)] * tp,
              f"19b {label}: rank caches {caches}")
        print(f"[slot tp 19b] {label} slot engine on {card}: "
              f"{len(traffic)} replies through 2 slots token-exact against "
              f"generate in {wall:.2f} s; each rank {L * full} flash "
              f"launches at {list(shape)} for {full} admissions, none in "
              f"the decode steps; every slot free after, each rank's "
              f"cache {list(caches[0])}")

    # 19c: bf16 on one device, tp2 and tp4; the prefill logits at the
    # rank shape against plain attention
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32
    itl_one = None
    for tp in (1, 2, 4):
        eng = InferenceEngine(params, cfg, EngineConfig(**SLOT_TP_ENGINE),
                              mesh={"tp": tp} if tp > 1 else None)
        try:
            got, ttft, itl, wall, n, full, _ = counted_serve(
                eng, traffic, warm=warm)
            check(full == len(traffic) and n == tp * L * full,
                  f"19c tp{tp}: {n} launches for {full} admissions")
            for g in got:
                check(len(g) == 16 and all(0 <= t < cfg.vocab_size
                                           for t in g), f"19c: reply {g}")
            if tp == 1:
                itl_one = statistics.median(itl)
            else:
                launches[f"slot_tp{tp}_bf16"] = n
                flash, plain = tp_prefill_vs_plain(eng, cfg, traffic[0])
                err = (flash - plain).abs().max().item()
                check(bool(torch.isfinite(flash).all()) and err
                      <= BF16_LOGIT_TOL, f"19c tp{tp}: prefill logits "
                      f"differ from plain attention by {err}")
                print(f"[slot tp 19c] tp{tp} bf16 slot prefill at "
                      f"{list(SERVE_TP_SHAPES[tp])} a rank: last-position "
                      f"logits flash vs plain attention max_abs_err "
                      f"{err:.4e} (bound {BF16_LOGIT_TOL})")
            med = statistics.median(itl)
            print(f"[slot tp 19c] {'one device' if tp == 1 else f'tp{tp}'}"
                  f" bf16 slot engine on {card}: {len(traffic)} requests "
                  f"through 2 slots, TTFT p50 {pct(ttft, 50) * 1e3:.2f} ms, "
                  f"ITL p50 {med * 1e3:.3f} ms (one device's "
                  f"{itl_one * 1e3:.3f} ms, x{med / itl_one:.2f}) p99 "
                  f"{pct(itl, 99) * 1e3:.3f} ms, wall {wall:.3f} s"
                  + (" (the ranks share one card and take turns: not a tp "
                     "throughput)" if tp > 1 else ""))
        finally:
            eng.shutdown()
    return launches


# ------------------------------------------------ the elastic gang

ELASTIC_SHAPE = (8, 12, 1024, 64)      # a world-2 member's rows at b16


class ElasticBatches:
    """``batches`` on every pass, scripted by the gang member reading
    them: ``deaths[(world, step)]`` names the ranks of a world of that
    size that kill themselves (``MemberKilled``) instead of giving that
    step's batch, once each; ``failures[(world, step)]`` counts host-data
    failures there.  The feed raises either at the step it was read
    for."""

    def __init__(self, batches, deaths, failures):
        self.batches = batches
        self.deaths = {k: set(v) for k, v in deaths.items()}
        self.failures = dict(failures)

    def __iter__(self):
        from ray_tpu_torch.parallel.gang import MemberKilled, current_member

        me = current_member()
        for i, b in enumerate(self.batches):
            key = (me.world, i + 1)
            if me.rank in self.deaths.get(key, ()):
                self.deaths[key].discard(me.rank)
                raise MemberKilled(f"rank {me.rank} of {me.world} dies at "
                                   f"step {i + 1}")
            if self.failures.get(key, 0) > 0:
                self.failures[key] -= 1
                raise RuntimeError(f"injected data failure at step {i + 1}")
            yield b


def elastic_trainer(name: str, card: str, one_device: list,
                    one_grad_norm: dict, root: str) -> dict:
    """22a: GPT-2 124M at full width and depth, b16 s1024 bf16 "dots",
    ``Trainer(num_hosts=4)`` on in-process members sharing the card,
    ``{"dp": -1}``, on 18a's six batches, a checkpoint every 3 steps:
    members 1 and 3 kill themselves at step 4, the gang re-forms at 2 and
    resumes at step 3; a data failure at step 5 re-admits two fresh
    members, back to 4, which resume at step 3 and finish.  Returns the
    run's launches."""
    import logging

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel.gang import current_member
    from ray_tpu_torch.train import Trainer, adamw

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    logging.getLogger("ray_tpu_torch.train").setLevel(logging.ERROR)
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    cfg = gpt.GPTConfig.gpt2_124m(remat=True, remat_policy="dots")
    L = cfg.n_layers
    data = ElasticBatches(HostBatches(6, 16, 1024, 4096, SEED + 20).batches,
                          deaths={(4, 4): {1, 3}}, failures={(2, 5): 1})
    # per member and attempt: the thread's launches at each step's start
    # (since the last mark) and at the attempt's end
    marks: dict = {}

    class CountingTrainer(Trainer):
        def train_loop(self, report, get_checkpoint):
            log = marks.setdefault(current_member().member_id, [])
            log.append([])
            fa.reset_thread_launches()
            try:
                super().train_loop(report, get_checkpoint)
            finally:
                log[-1].append(dict(fa.thread_launches()))

    def loss_fn(p, batch, mesh=None, rules=None):
        marks[current_member().member_id][-1].append(
            dict(fa.thread_launches()))
        fa.reset_thread_launches()
        return gpt.loss_fn(p, batch, cfg, mesh=mesh,
                           **({} if rules is None else {"rules": rules}))

    tr = CountingTrainer(
        loss_fn=loss_fn, init_params=lambda seed: gpt.init_params(cfg, seed),
        optimizer=adamw(3e-4, weight_decay=0.1), train_data=data,
        num_steps=6, report_every=1, checkpoint_every=3, seed=SEED,
        storage_path=os.path.join(root, "elastic"), max_failures=2,
        num_hosts=4, mesh={"dp": -1},
        params_logical=gpt.param_logical_axes(cfg))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.bwd_kv_launches = fa.bwd_dq_launches = 0
    t0 = time.perf_counter()
    res = tr.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    total = [fa.launches, fa.bwd_kv_launches, fa.bwd_dq_launches]
    ckpts = sorted(os.listdir(os.path.join(root, "elastic", "checkpoints")))

    worlds = [a["world"] for a in tr.attempts]
    starts = [a["start_step"] for a in tr.attempts]
    recov = [a.get("recovery") for a in tr.attempts]
    check(worlds == [4, 2, 4] and starts == [0, 3, 3]
          and recov == ["shrink", "readmit", None],
          f"22a: attempts at worlds {worlds} from steps {starts}, "
          f"recoveries {recov}")
    ids = [a["member_ids"] for a in tr.attempts]
    check(ids[1] == [ids[0][0], ids[0][2]] and ids[2][:2] == ids[1]
          and not set(ids[2][2:]) & set(ids[0]), f"22a: member ids {ids}")
    check(tr.attempts[0]["error"].rank in (1, 3),
          f"22a: the first attempt failed on rank "
          f"{tr.attempts[0]['error'].rank}")
    want_steps = [[1, 2, 3], [4], [4, 5, 6]]
    for a, steps in zip(tr.attempts, want_steps):
        reps = [[(m["step"], m["loss"], m["grad_norm"]) for m in r]
                for r in a["reports"].values()]
        check(len(reps) == a["world"] and all(r == reps[0] for r in reps)
              and [st for st, _, _ in reps[0]] == steps,
              f"22a: world {a['world']} members reported {reps}")
    hist = [(m["step"], m["loss"], m["grad_norm"])
            for m in res.metrics_history]
    check([st for st, _, _ in hist] == [1, 2, 3, 4, 4, 5, 6],
          f"22a: reported steps {[st for st, _, _ in hist]}")
    check(ckpts == ["checkpoint_000000", "checkpoint_000001"]
          and res.checkpoint.to_dict()["step"] == 6,
          f"22a: checkpoints {ckpts}")
    # launches per member and step: 24 / 12 / 12 at the member's rows
    b, s1 = data.batches[0]["tokens"].shape
    shapes = {w: (b // w, cfg.n_heads, s1 - 1, cfg.d_model // cfg.n_heads)
              for w in (4, 2)}
    check(shapes[2] == ELASTIC_SHAPE, f"22a: a world-2 member's shape "
          f"{shapes[2]}, the kernels timed at {ELASTIC_SHAPE}")
    counted = 0
    for a, steps in zip(tr.attempts, want_steps):
        want = per_kernel(shapes[a["world"]], 2 * L, L, L)
        for mid in a["member_ids"]:
            seen = marks[mid].pop(0)[1:]     # the first is before step 1
            check(len(seen) == len(steps) and all(x == want for x in seen),
                  f"22a: member {mid} in world {a['world']} launched "
                  f"{seen}, expected {want} at each of steps {steps}")
            counted += len(seen)
    check(counted == 4 * 3 + 2 * 1 + 4 * 3,
          f"22a: {counted} member-steps counted, expected 26")
    want = dict(one_device)
    rel = []
    for st, lo, gn in hist:
        if st in (2, 4, 6):
            dl = abs(lo - want[st]) / abs(want[st])
            dn = abs(gn - one_grad_norm[st]) / abs(one_grad_norm[st])
            rel.append((st, dl, dn))
            check(np.isfinite(lo) and dl <= 5e-3 and dn <= 5e-2,
                  f"22a step {st}: loss {lo} vs {want[st]}, grad_norm {gn} "
                  f"vs {one_grad_norm[st]}")
    check(sorted({st for st, _, _ in rel}) == [2, 4, 6],
          f"22a: compared steps {rel}")
    print(f"[elastic 22a] GPT-2 124M b16 s1024 bf16 \"dots\", "
          f"Trainer(num_hosts=4) on in-process members sharing {card}, "
          f"{{\"dp\": -1}}: attempts at worlds {worlds} from steps {starts} "
          f"(recoveries {recov[:2]}); member ids {ids}; every member "
          f"reported the same; per member-step launches {2 * L} / {L} / "
          f"{L} at {list(shapes[4])} (world 4) and {list(ELASTIC_SHAPE)} "
          f"(world 2); reported (step, loss) "
          f"{[(st, round(lo, 5)) for st, lo, _ in hist]}; vs phase 13's "
          f"one-device fit at steps 2/4/6: largest rel loss "
          f"{max(d for _, d, _ in rel):.2e} (bound 5e-3), grad_norm "
          f"{max(d for _, _, d in rel):.2e} (bound 5e-2); {wall:.1f} s wall "
          f"for the fit (three attempts, two checkpoints written, four "
          f"members share one card and one host: not a throughput); peak "
          f"device memory added {peak / 2**30:.2f} GiB")
    return {"trainer_elastic_gang": total}


def ddppo_parity(card: str) -> None:
    """22b's parity: DD-PPO at the lockstep test's settings on the card
    and on the CPU, the card's restored from the CPU's initial params;
    two updates on the same host batches (the CPU workers' rollouts)
    equal within 1e-4 (1 + scale), the card's two ranks bit-equal after
    each."""
    from ray_tpu_torch.rllib import DDPPOConfig
    from ray_tpu_torch.rllib.ddppo import _worker
    from ray_tpu_torch.rllib.optim import tree_leaves

    small = dict(env="CartPole-v1", num_rollout_workers=2,
                 num_envs_per_worker=2, rollout_length=32,
                 train_batch_size=128, minibatch_size=64, num_epochs=1,
                 seed=3)
    cpu = DDPPOConfig(**small, device="cpu").build()
    gpu = DDPPOConfig(**small, device="cuda").build()
    try:
        gpu.load_checkpoint(cpu.save_checkpoint())
        for k in range(2):
            batches = [w.sample() for w in cpu.workers]

            def learn(rank, batches):
                return _worker().learn(batches[rank])

            got, ref = gpu.gang.run(learn, batches), cpu.gang.run(
                learn, batches)
            pairs = [(torch.tensor([g[m] for m in sorted(g)]),
                      torch.tensor([r[m] for m in sorted(r)]))
                     for g, r in zip(got, ref)]
            w_gpu = [w.get_weights() for w in gpu.workers]
            w_cpu = [w.get_weights() for w in cpu.workers]
            pairs += [(torch.from_numpy(a), torch.from_numpy(b))
                      for r in (0, 1) for a, b in zip(
                          tree_leaves(w_gpu[r]), tree_leaves(w_cpu[r]))]
            check(len(pairs) == 2 + 2 * 8, f"22b: {len(pairs)} pairs")
            held_f32(f"DD-PPO update {k + 1} (both ranks' params and "
                     f"metrics)", pairs)
            for a, b in zip(tree_leaves(w_gpu[0]), tree_leaves(w_gpu[1])):
                check(np.array_equal(a, b),
                      "22b: the card's ranks' params differ")
    finally:
        cpu.cleanup()
        gpu.cleanup()


def phase_elastic(name: str, card: str, one_device: list,
                  one_grad_norm: dict) -> tuple:
    """22a (``elastic_trainer``) and 22b, DD-PPO on two members sharing
    the card: the parity of ``ddppo_parity``, then the learning run at
    the JAX test's settings (best mean return above 90 within 25
    iterations), both ranks bit-equal after it, no flash launch.  Also
    the three kernels at ``ELASTIC_SHAPE`` bf16 causal.  Returns
    (launches by path, the kernels' records at that shape)."""
    from ray_tpu_torch.rllib import DDPPOConfig
    from ray_tpu_torch.rllib.optim import tree_leaves

    root = tempfile.mkdtemp(prefix="_chip_smoke_ckpt_",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        launches = elastic_trainer(name, card, one_device, one_grad_norm,
                                   root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    records = rank_shape_times(name, card, ELASTIC_SHAPE, True,
                               "a world-2 member's rows", "elastic",
                               SEED + 22)

    torch.backends.cuda.matmul.allow_tf32 = False
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    fa.launches = fa.bwd_kv_launches = fa.bwd_dq_launches = 0
    ddppo_parity(card)
    algo = DDPPOConfig(env="CartPole-v1", num_rollout_workers=2,
                       num_envs_per_worker=4, rollout_length=64,
                       train_batch_size=512, minibatch_size=128,
                       num_epochs=2, lr=5e-3, seed=0).build()
    try:
        results = rl_learn("DD-PPO, 2 members sharing the card", algo, 25,
                           card, learner="", stop=best_above(90))
        best = max(r.get("episode_reward_mean", 0.0) for r in results)
        bar_check("DD-PPO", best > 90, f"best mean return {best:.2f} above "
                  f"90 within 25 iterations")
        w0, w1 = (tree_leaves(w.get_weights()) for w in algo.workers)
        check(len(w0) == 8, f"22b: {len(w0)} params leaves")
        for a, b in zip(w0, w1):
            check(np.array_equal(a, b), "22b: the ranks' params differ "
                  "after the learning run")
        print(f"[elastic 22b] DD-PPO: the two ranks' params bit-equal after "
              f"{len(results)} iterations; env steps/s "
              f"{[round(r['env_steps_per_sec'], 1) for r in results]}")
    finally:
        algo.cleanup()
    seen = flash_launches()
    print(f"[elastic 22b] flash launches {seen[0]} / {seen[1]} / {seen[2]}")
    check(seen == (0, 0, 0), f"22b: DD-PPO launched {seen}")
    return launches, records


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()

    def run(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"[time] {fn.__name__} {time.perf_counter() - t:.1f} s")
        return out

    name, card = run(phase_environment)
    kernels = [run(phase_kernels, name, card)]
    kernels += run(phase_backward_kernels, name, card)
    run(phase_serving_f32, card)
    serve_launches = run(phase_serving_bf16, card)
    engine_launches = run(phase_engines_f32, card)
    run(phase_engines_bf16, card)
    # the serving phases run before the training phases, which use the
    # profiler
    moe_serve_launches = run(phase_moe_serving, card)
    prefix_launches = run(phase_prefix_plane, card)
    replica_launches = run(phase_replica_contract, card)
    model_launches = run(phase_other_models, name, card)
    trainer = run(phase_trainer, name, card)
    run(phase_ppo, card)
    run(phase_rllib_tail, card)
    run(phase_rllib_rest, card)
    tp_serve_launches, tp_serve_records = run(phase_tp_serving, name, card)
    kernels[0].update(tp_serve_records)
    tp_serve_launches.update(run(phase_slot_tp, card))
    train_launches, steady_ms = run(phase_training, name, card)
    print(f"[trainer] steady step {trainer['step_ms']:.3f} ms (Trainer.fit "
          f"on distinct batches through the feed) vs phase 7's \"dots\" "
          f"step {steady_ms['dots']:.3f} ms (one repeated batch), ratio "
          f"{trainer['step_ms'] / steady_ms['dots']:.3f}, on {card}")
    train_launches.update(run(phase_moe_training, name, card))
    sharded_launches, tp_records = run(phase_sharded_training, name, card)
    train_launches.update(sharded_launches)
    for k in kernels:
        k["tp_shape"] = tp_records[k["name"]]
    pipeline_launches, pipeline_records = run(phase_pipelines, name, card)
    train_launches.update(pipeline_launches)
    for k in kernels:
        for key, rec in pipeline_records.items():
            k[key] = rec[k["name"]]
    train_launches.update(run(phase_mesh_trainer, card,
                              trainer["history"]))
    elastic_launches, elastic_records = run(
        phase_elastic, name, card, trainer["history"], trainer["grad_norm"])
    train_launches.update(elastic_launches)
    for k in kernels:
        k["elastic_shape"] = elastic_records[k["name"]]
    train_launches.update(model_launches)
    train_launches.update(trainer["launches"])
    # launches on each main path's run: the bf16 serving requests, the
    # f32 engines' requests, the MoE engines', the prefix plane's and the
    # replica contract's requests, the five training steps under each
    # remat policy, BERT-base's five steps and its padded batch, the two
    # trainer fits (14 and 12 steps) and the predictor's forward, the
    # sharded steps: 15a's three checked ones, 15b's three per rank, and
    # phase 16's pipelined and expert-parallel steps and passes, the
    # trainer's fits on a mesh (18a's six steps at NCCL world size 1,
    # 18b's six a rank on four threaded ranks), the slot engine's
    # admissions on tp (19a-c) and the elastic gang's 26 member-steps
    # (22a)
    for i, k in enumerate(kernels):
        paths = {p: n[i] for p, n in train_launches.items()}
        if k["name"] == "flash_fwd":
            paths = {"serve_bf16": serve_launches, **engine_launches,
                     **moe_serve_launches, **prefix_launches,
                     **replica_launches, **tp_serve_launches, **paths}
        k["launches"] = sum(paths.values())
        k["launches_by_path"] = paths
    print(f"[done] {time.perf_counter() - t0:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
