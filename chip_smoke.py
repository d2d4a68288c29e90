#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); imports nothing of JAX or
of the JAX package.  Phases, each printing one JSON line:

1. device and toolchain;
2. build: compiles the CUDA kernels of ``src/repro_torch/kernels/csrc``,
   one nvcc per source, all started together;
calibrate. ``repro_torch.launch.calibrate``: the card's float32 GEMM rate
   (TF32 off), bfloat16 GEMM rate and STREAM-scale copy bandwidth, each
   beside the data sheet's figure; it fails on a measurement above 1.05x
   its figure (a timing fault).  Every later bound is printed both ways:
   ``bound_ms`` against the data sheet, ``bound_ms_calibrated`` against
   these ceilings (the exponential rate stays the data sheet's);
3. kernels against their plain PyTorch versions on the card, at the main
   path's shapes (P=64, M=16, K=200), at the SaP-E reduced chain's
   (P=1, M=7 and M=63, K=400), at the sparse run's (P=64, M=33, K=95), at
   edge cases (M=1, K=37, K=256), and bts also at SaP-E's P=8 split
   (M=125) and the P=500 split (M=2), with the cluster size (the route) of
   every btf, fused and bts launch; the four block cyclic reduction
   (BCR) kernels and the whole BCR factor / solve at the P=64 interface
   chain of the d=0.5 band (63 blocks of 2K=400), at the coupled P=500
   chain (499 blocks of 400), at the sparse run's chain (63 blocks of
   2K=190, eliminated in shared memory) -- rhs_reduce and backsub at
   every level of each at R=1, 4 and 8 -- and at edge cases (m=1, m=3,
   K=37 with R=K, the tiled solve kernels), with each reduce level's tile
   size; the two SaP-scan kernels (WKV6, SSD) at the LM path's
   decode (T=1, 8 slots: the step route) and prefill (B=4, T=512, chunk
   64: the split route) shapes, at chunk 16, under strong decay, at a
   ragged chunk (37), at chunk 1 with T > 1, with per-head B and C, and at
   chunk 128 (the one-block kernel), each call's route printed, and a
   chunk that does not tile T (which must be refused); the
   flash-attention kernel in bfloat16 and float32 at Minitron-8B's prefill (32 query heads over 8, T=4096, D=128, causal),
   starcoder2-15b's (48 over 4, T=8192, window 4096), phi3-mini's D=96,
   stablelm's D=64, the reduced D=16, bidirectional, a ragged Tk and a
   window smaller than one tile, deepseek-moe-16b's prefill (16 over 16),
   mixtral-8x22b's (48 over 8, T=8192, window 4096), phi-3-vision's (D=96,
   576 patches + 512 tokens) and whisper-medium's encoder (bidirectional,
   T=1,500, D=64), decoder (T=448, causal) and cross-attention (Tq=448,
   Tk=1,500); the fleet's folded shapes: btf, the fused
   pass and bts (R=1, 4) over S*P = 64 * 16 chains of K = 16 and of
   K' = 2, 4, 8 in one launch each, and BCR over the 64 stacked reduced
   chains of 15 interfaces (2K = 32 and 4), each kernel's cluster size,
   tile or split printed beside one system's;
4. the slices at full size: N=200,000, K=200 banded systems (paper Table
   4.1/4.2 setting), float32 band storage and preconditioner, float64
   iteration, tol=1e-8, through ``factor(plan_banded(...)).solve`` for the
   variants D, C (fused and not), E (P=8, chain), ``solve_many``, E at
   P=64 with BCR (``reduced_solver="auto"``) and with the chain sweep, E
   with BCR and C at P=500 (partitions of two block rows, so the
   interface chain stays coupled); and the sparse front end:
   ``random_sparse(200,000, 20, d=1.0, structured_band=50)`` through
   ``factor(plan(...)).solve`` at P=64 (host DB + CM timed once, in
   phase 3); with every kernel wrapper's launch count, bts's launches by
   cluster size, reduce's by tile size, rhs_reduce's by CTAs a block and
   backsub's by cluster size (an R <= 8 solve on the tiled kernels
   fails);
dtypes (after phase distributed, so that phase trace runs where it
   always did). The preconditioner's and the scans' storage dtypes: every solver
   kernel's bfloat16 and float64 instantiation against its plain version
   in the same dtype on the card (bfloat16 element by element within one
   bfloat16 step plus KERNEL_RTOL of the largest value, float64 within
   DTYPE_F64_RTOL of the largest value) at the main shape (P=64, M=16,
   K=200), K=37 and K=256, the SaP-E interface chains of 63 and 499
   blocks of 2K=400 (btf / bts on the chain, cut to its first 64 blocks at
   499; every BCR kernel at every level of both), the fleet's folded K=16 (1,024 chains; BCR over the 64
   stacked chains of 2K=32), each row with its cluster size, tile, split
   or copy route; WKV6 and SSD with bfloat16 inputs at the LM decode and
   prefill shapes and at chunk 37; then the N=200,000 slices with a
   float64 preconditioner at tol 1e-10 (D, C, E by chain at P=8, E by BCR
   at P=64; true_resnorm <= 1e-9, float32's stall printed beside), a
   bfloat16 one under ``solver="refine"`` at tol 1e-8 (C, E by BCR;
   true_resnorm <= 1e-8, float32's sweeps beside) and under BiCGStab(2)
   (R11's witness, printed), one ``SolverEngine`` fleet step of 64
   systems in each dtype, the launches by (kernel, dtype) of that path
   (each kernel must launch in each dtype); then a float64 matmul rate
   (the calibrated float64 ceiling) and every (kernel, dtype) timed at
   the main shape beside float32, the scans at the prefill shape;
distributed. ``repro_torch.core.distributed`` on 4 ranks of one gloo group
   on the card (``spawn_ranks``; four processes time-sharing cuda:0, so no
   time is a scaling result): ``full()`` through D, C and "auto", and
   ``exact()`` through E at P=64 and P=500 (E's interface chain reduced
   across ranks by parallel cyclic reduction) and "auto", P_total=64 unless
   stated, tol 1e-6; each against the single-process solve of the variant
   that ``factor`` picks, at the same P (x, float64 true residual, sweeps,
   the resolved variant and d), with each rank's setup / factor / solve ms,
   permutations, all-reduces and bytes per factor, solve, preconditioner
   apply and matvec, the solve's share in messages, peak memory and
   launches; btf, the fused pass, bts and the PCR inverse against their
   plain versions at a rank's shapes; C through an NCCL group of one rank
   (x within 1e-6 of the single-process C, no permutation); and
   ``sp_ssd`` / ``sp_wkv6`` at Zamba2-2.7B's (80 heads, N=P=64) and
   RWKV6-1.6B's (32 heads, D=64) head shapes, B=1, T=32,768 split over the
   4 ranks, each shard one split-route launch, against the single-rank
   kernel call at the full T;
trace. ``full()`` C (fused), ``exact()`` E (BCR) at P=64 and the sparse
   ``plan -> factor -> solve`` at P=64 again (the host plan traced once),
   ``TRACE_REPS`` warm ``factor`` / ``solve`` calls, each untraced and
   under a ``repro_torch.obs.Tracer`` (the order alternating): the stage tree (``summary()``)
   and each span's ms, the span tree against ``TRACE_TREES``, the median
   factor and krylov span within 0.9x-1.5x (+2 ms) of the median untraced
   host time, the traced/untraced ratio, the Chrome export's B/E pairs
   balanced;
fleet. ``configs/sap_solver.py:fleet()`` (N=16,384, K=16, d=1.0, C, tol
   1e-6, max_batch 64, fac_cache 256) at P=16 through ``SolverEngine
   .run_until_drained``: 64 distinct matrices, each submitted 4 times with
   a fresh right-hand side, round by round (one step of 64 misses, then
   hits), with systems/s, the cache hit rate, each step's factor and solve
   ms and launches, and 64 single-system factors timed beside the batch;
   it fails if a batch factor launches btf or the fused pass more often
   than one system's factor, or a batched apply launches bts more often
   than one system's apply (a loop over the systems);
cost. A ``SolverEngine(cost_accounting=True)`` at fleet()'s shape, 16
   systems, a miss step then a hit step: ``cost_snapshot()`` and each
   stage's roofline seconds (the calibrated ceilings of
   ``repro_torch.launch.roofline``) against its measured seconds; it fails
   on an achieved fraction above 1.05;
batch_full. ``full()`` (C) and ``exact()`` (E, BCR) at P=64, four systems
   a batch: ``batch_plan`` (exact rounding) -> ``batch_factor`` ->
   ``solve_batch`` and ``solve_batch_many`` (R=4) against four single
   ``factor`` / ``solve`` runs of the same systems -- x within
   ``BATCH_XTOL``, the same sweep counts, every float64 true_resnorm <=
   1e-6, the batch factor's launches one system's -- with the batch's ms
   beside the four single runs';
service. ``configs/sap_solver.py:service()`` at P=16 through
   ``AsyncSolverService``: 4 client threads submit 512 requests (N in
   10,000-16,384, K in 8-16, d 0.5 or 1.1, mixed priorities, a quarter of
   the matrices repeated), with requests/s, the p50 / p99 time in queue,
   the cache hit rate, escalations and deadline misses; it fails on a
   future resolved without a solve (but for a missed deadline), a true
   residual above 10 tol, or a dominance class never routed;
examples. The port's entry points as a user runs them: each module of
   ``repro_torch.examples`` (quickstart, fleet_solve, serve_async,
   traced_solve, distributed_solve on 8 gloo ranks of the card, serve_lm
   for stablelm, rwkv6 and zamba2, train_lm) as ``python -m`` in a
   process of its own at its defaults, each with its seconds, the numbers
   it printed and its kernel launches (read from the child and its ranks);
   it fails on a non-zero exit, a missing "OK" line, a float32 relative
   error above its limit, a training loss that does not fall, a request not
   served, or a kernel of EXAMPLE_KERNELS never launched;
lm. RWKV6-1.6B and Zamba2-2.7B at their published widths and depths,
   random weights from a seeded generator: ``forward`` over 64 tokens
   against 64 ``decode_step`` calls in float32, a bfloat16 prefill
   (B=4, T=512) timed, and a ``ServeEngine`` with 8 slots draining 12
   requests (prompts of 8-24 tokens, 16 new tokens each), with the
   WKV / SSD launches of each path by route (none may take the one-block
   kernel) and a profiler window of decode ticks; then the same model
   with ``scan_dtype="bfloat16"`` against its float32 scans (5 decode
   ticks and a B=4, T=512 prefill, each from an empty state and, for
   RWKV6, from a 64-token prefix's state), each reading beside the plain
   versions' bfloat16 scans (the witness) and within LM_BF16_SCAN_RTOL of
   the largest logit or LM_BF16_SCAN_WITNESS times the witness, its
   bfloat16 scan launches counted;
dense. Minitron-8B at its published width and depth (32 layers, d=4096,
   GQA 32 over 8, vocab 256,000), random float32 weights from a seeded
   generator, after the other models are freed: ``forward`` over 64
   tokens (through the flash kernel) against 64 ``decode_step`` calls
   from an empty cache in float32, bfloat16 prefills at B=4, T=512 and
   B=1, T=4096 (each a forward with one flash launch a layer, profiled
   once), and the same serving run and decode window as above;
moe. deepseek-moe-16b at full size (28 layers, 64 routed experts of which
   6 a token, 2 shared; 67.5 GB of float32 weights) and mixtral-8x22b at
   full width with its depth cut from 56 to MIXTRAL_LAYERS layers
   (``reduced`` in its line), random weights from seed 0, each after the
   previous model is freed: forward (through the flash kernel) against
   decode steps in float32 at capacity_factor = n_experts (no slot
   dropped by either pass; the share the forward drops at the published
   1.25 printed), bfloat16 prefills at B=4, T=512 (mixtral also B=1,
   T=8192 through the window), one flash launch a layer, the first
   prefill once more under the profiler, then the serving run and the
   decode window as above;
vlm. phi-3-vision-4.2b at full size: a bfloat16 prefill of 576 random
   patches prepended to B=4 x 512 tokens, patches of zeros and of ones
   changing the last text logit, a text-only float32 forward against 64
   decode steps, the serving run and the decode window;
encdec. whisper-medium at full size: forward (encode 1,500 random frames,
   decode_train over 64 tokens) against encode -> precompute_cross_kv ->
   64 decode steps in float32 at B=2 (flash launches n_enc_layers + 2
   n_layers); bfloat16 encode at B=4 (n_enc_layers launches; profiled once),
   decode_train at T=448 (2 n_layers launches), 32 greedy decode steps at
   B=4 with the cross cache filled, and the decode window; each of these
   phases prints its peak memory above what earlier phases hold;
train. Training, after every serving phase has freed its model:
   stablelm-1.6b at its published width and depth (24 layers, d=2048, 32
   heads of 64, d_ff 5,632, vocab 100,352; random float32 weights from
   seed 0, bfloat16 compute) through ``TrainLoop`` on the card for 10
   steps of B=8 x T=256 tokens of the affine-bigram stream over 512 tokens
   (lr 5e-4, 5 warmup steps, no checkpoint): every loss finite, step 10's
   at least 1.0 below step 1's, 24 flash launches a step (the forward's;
   the backward differentiates the plain version); the median step ms,
   tokens/s, peak memory, one step under the profiler split by part (the
   flash forward, the attention backward's recompute, the dtype casts and
   their backward, the cross-entropy, AdamW) and the device's busy share;
   then 5 steps with int8 compression (the error state's norm) and two
   microbatches against one on one batch (loss, gradient and update within
   the stated tolerances, which the first microbatch's gradient alone must
   exceed); rwkv6-1.6b and
   zamba2-2.7b at full size, 5 steps on one fixed batch (the loss falls,
   the gradient norm finite and above 0, the scans' launches by route,
   none on the one-block kernel); each autograd Function against autograd
   of its plain version in the same layout on the card (flash at B=8, 32
   heads, T=256, D=64 in bfloat16 and float32, GQA, windowed and
   bidirectional cases; wkv at RWKV6-1.6B's heads; ssd at Zamba2-2.7B's
   with B and C shared): the forward within phase 3's limits of the plain
   version's output, the gradients exactly equal, each backward's ms beside its
   kernel's forward ms; the restart path at stablelm-reduced (a fault at
   step 30 of 50, one restart from the step-20 checkpoint, the restored
   parameters equal to the saved ones bit for bit); every run
   at its published remat ("full"), and stablelm-1.6b at remat "none",
   "full" and "dots" and zamba2-2.7b at "none" and "full" from the same
   weights on one batch: the step ms, the peak memory, the kernel's
   launches a step, the first step's loss and gradient norm equal across
   the modes and the peak at "full" below "none"'s;
sharded. The LM loss on a (2, 2) ("data", "model") mesh of 4 gloo ranks,
   all on the one card, after phase train: first the single-process
   references on the card (stablelm-1.6b at its published width and 1 of
   its 24 layers in bfloat16 with two AdamW steps; rwkv6-1.6b at 2 layers and
   zamba2-2.7b at 6, full width, in float32 and in their published
   bfloat16), each freed before the next: the loss, every leaf's gradient
   norm and an evenly strided sample of rank 0's block of it, the
   updates' norms and samples after each step, and for bfloat16 a witness
   (the same single process with its weights moved by 1e-6 relative: how
   far its own rounding carries each reading); the gloo all-reduce rate
   of two ranks on the card (the link's calibrated figure); then the
   ranks, each with its blocks of the parameters (``shard_model``) and of
   B=8 x T=256 tokens: the loss, every leaf's gradient norm and sample,
   the flash / WKV6 / SSD kernel launched once a layer on the rank's
   local heads (twice under remat); for stablelm two
   ``make_train_step(mesh=...)`` steps with ZeRO-1 (the step losses, the
   gradient norms, every leaf's update norm and sample) and a compressed
   one (also each leaf's int8 scale), then four planted faults (a data
   rank's gradient left out of the average, a step on half the batch,
   ZeRO-1's gather left out, a split leaf's scale its block's own); also
   deepseek-moe-16b ("ep", 2 layers), mixtral-8x22b ("tp", 1
   layer) and whisper-medium (4 + 4 layers) in float32, the MoE jobs with the aux term
   and the route flips against the single process and two planted faults
   (the gates' gradient not summed over "model", a per-rank load
   balance); every fault must fail at least one of the limits the sound
   run passes (SHARD_* below); per rank the times (host clock after a sync),
   peak memory, messages and bytes by kind and axis, and ``analyze``'s
   roofline row against the data sheet's NVLink and the calibrated gloo
   link; rank 0 holds the three kernels at its local-head shapes against
   their plain versions (one token batch an architecture);
5. timing of each kernel beside its plain version (and a library call
   where one computes the same function: for btf and the fused pass a loop
   over the block rows of batched ``torch.linalg.inv`` and ``torch.matmul``,
   for reduce each level's six batched ``torch.matmul`` products, for
   rhs_reduce and backsub each level's ``torch.baddbmm`` / ``bmm`` calls
   on gathered neighbours, with its difference from the plain version),
   with CUDA events; bts at every
   shape the main path gives it, beside the one-block kernel; the BCR
   inverse level by level with each launch's cluster size and route, and
   reduce level by level over the P=64 and the P=500 chain with each
   launch's tile size; the rows whose calls are short (rhs_reduce,
   backsub, WKV6 and SSD at decode and prefill) by the profiler's device
   time, beside the wall time per call (``host_ms``): rhs_reduce and
   backsub over one R=1 solve's levels of the P=64 and the P=500 chain,
   and level by level over both (``queued_ms``: launches queued behind a
   spin kernel, timed by CUDA events; inputs rotated through 3x the L2),
   with each level's share of bound, CTAs a block or cluster size, rows
   and warps a CTA and row copy width; no kernel or library time may read
   under the kernel's (data sheet) bound.  Then each row's share of both
   bounds, a share above 1 of the calibrated bound printed as it is.

Every phase ends with a ``{"phase": "seconds", "of": <phase>}`` line, and
the run with the total and the seconds of every phase.

Then the kernel summary line (a row per kernel, and per (kernel, dtype)
of phase "dtypes": its launches in that phase's slices and fleet steps --
the scans' in phase lm's bfloat16 runs -- its error against the plain
version, its time at the main shape), the card's ``nvidia-smi`` name and
power limit, and as the last line ``{"ok": true, "device": {...}}``.  Any failed
check exits non-zero without that line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

_STARTED = time.perf_counter()  # the phase clock's zero: the process's start
ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
N, K = 200_000, 200
TOL, MAXITER = 1e-8, 200
# Bounds: the least time the card could take, the larger of the bytes over
# the memory rate and the operations over the peak rate of their type.
# Each is printed twice: against the data sheet's H100 peaks
# (repro_torch.launch.roofline.H100_DATASHEET: ``bound_ms``, under which no
# measured time may read) and against the ceilings phase "calibrate"
# measures in this run (``bound_ms_calibrated``).  The exponential rate has
# no calibration: its data sheet figure (H100_DATASHEET_SFU_S) serves both.
# A ceiling measured above CALIBRATE_LIMIT times its data sheet figure is a
# timing fault.
CALIBRATE_LIMIT = 1.05
# The H100's L2 cache: a timed loop whose operands fit in it rotates among
# enough copies of its inputs to exceed it three times, as the LM path's
# layers do (each layer's state is its own).
L2_BYTES = 50e6
# Kernel against plain version, both float32 on the card: the largest
# difference at most this fraction of the largest plain value.  The same
# recurrences in float32 with the sums of every K x K product taken in
# another order; rounding compounds over the M block rows.
KERNEL_RTOL = 1e-4
# The LM path: both models at full width and depth, serving LM_REQUESTS
# requests through LM_SLOTS slots (prompts of LM_PROMPT tokens fed one a
# tick, LM_NEW_TOKENS new tokens each).  Every LM phase's serving run has
# this shape: ~55 ticks, a second wave refilling the slots (the smoke's
# time limit cut it from 16 requests of 16-48 + 32 tokens, ~137 ticks).
LM_ARCHS = ("rwkv6-1.6b", "zamba2-2.7b")
LM_SLOTS, LM_REQUESTS, LM_NEW_TOKENS, LM_PROMPT = 8, 12, 16, (8, 24)
PREFILL_B, PREFILL_T, CONSISTENCY_T = 4, 512, 64
# The dense run: Minitron-8B; its forward (through the flash kernel)
# against DENSE_CONSISTENCY_T decode steps, and a second prefill at the
# kernel's long shape.
DENSE_ARCH = "minitron-8b"
DENSE_CONSISTENCY_T, DENSE_LONG_T = 64, 4096
# The MoE, VLM and encoder-decoder runs (phases "moe", "vlm", "encdec"),
# each model freed before the next: deepseek-moe-16b at full size (67.5 GB
# of float32 weights; forward against MOE_CONSISTENCY_T decode steps at
# B=2), mixtral-8x22b at full width with its depth cut to MIXTRAL_LAYERS
# (its 56 layers need 562.5 GB; forward against MIXTRAL_CONSISTENCY_T steps
# at B=1, a prefill at MIXTRAL_LONG_T through the window), phi-3-vision-4.2b
# and whisper-medium at full size (forward over WHISPER_T decoder tokens
# against as many steps; decode_train at WHISPER_TRAIN_T, WHISPER_STEPS
# greedy steps).  The consistency checks run at capacity_factor =
# n_experts, where every group's capacity is G k and neither pass drops a
# slot; the forward's drops at the published 1.25 are printed.
MOE_ARCH, MIXTRAL_ARCH, VLM_ARCH, ENCDEC_ARCH = (
    "deepseek-moe-16b", "mixtral-8x22b", "phi-3-vision-4.2b", "whisper-medium")
MOE_CONSISTENCY_T, MIXTRAL_LAYERS, MIXTRAL_CONSISTENCY_T, MIXTRAL_LONG_T = 64, 4, 64, 8192
WHISPER_T, WHISPER_TRAIN_T, WHISPER_STEPS = 64, 448, 32
# Phase "train": stablelm-1.6b at full width and depth through TrainLoop
# (TRAIN_STEPS steps of TRAIN_B x TRAIN_T tokens from the affine-bigram
# stream over TRAIN_VOCAB tokens, inside the model's vocabulary; lr
# TRAIN_LR after TRAIN_WARMUP warmup steps), the last step's loss at least
# TRAIN_DROP below the first (30 steps read 11.94 -> 6.23 on the H100, 6.51
# at step 10; the smoke's time limit cut 30 steps to 10); then
# TRAIN_COMPRESS_STEPS steps with int8
# compression, two microbatches against one on one batch from a fresh
# optimizer state (losses within TRAIN_MICRO_LOSS_RTOL, the gradients' and
# the updates' global norms of difference within TRAIN_MICRO_GRAD_RTOL and
# TRAIN_MICRO_UPDATE_RTOL of theirs: bfloat16 compute, where the batch's
# split changes the products' shapes and sums; measured on the H100 7.6e-8,
# 2.2e-3 and 1.3e-2 -- a fresh state's first update is ~lr sign(g), so it
# moves most where a gradient near 0 changes sign), each limit below what
# the planted fault reads (the first microbatch's gradient alone, a step on
# the batch's first half; measured on the H100 3.97e-3, 0.820 and 0.920;
# the run fails if a limit would pass it),
# rwkv6-1.6b and zamba2-2.7b
# for TRAIN_FIXED_STEPS steps on one fixed batch, and the restart path at
# stablelm-reduced (TRAIN_RESTART: a fault at the first step of 50 that
# follows the step-20 checkpoint).
TRAIN_ARCH, TRAIN_OTHERS = "stablelm-1.6b", ("rwkv6-1.6b", "zamba2-2.7b")
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_LR, TRAIN_DROP = 10, 5, 5e-4, 1.0
TRAIN_VOCAB, TRAIN_B, TRAIN_T = 512, 8, 256
TRAIN_COMPRESS_STEPS, TRAIN_FIXED_STEPS = 5, 5
TRAIN_MICRO_LOSS_RTOL, TRAIN_MICRO_GRAD_RTOL, TRAIN_MICRO_UPDATE_RTOL = 1e-5, 5e-2, 1e-1
TRAIN_RESTART = {"steps": 50, "fault_at": 30, "checkpoint_every": 20}
# Every run above takes its configuration's published remat
# ("full"), and phase train adds TRAIN_REMAT: each (arch, modes) trained
# TRAIN_REMAT_STEPS steps on one batch from the same weights and a fresh
# state at each remat mode; the step ms (median of steps 2 on: with two
# steps the host-bound step read 0.87-1.18x "none" at "full" in two
# runs; the smoke's time limit cut six steps to four), the peak memory, the launches a step; the first step's loss and
# gradient norm
# within TRAIN_REMAT_RTOL of remat="none"'s (the replay recomputes the
# same values), and the peak at "full" below "none"'s.
TRAIN_REMAT = (("stablelm-1.6b", ("none", "full", "dots")), ("zamba2-2.7b", ("none", "full")))
TRAIN_REMAT_STEPS, TRAIN_REMAT_RTOL = 4, 1e-6
# flash kernel against its plain version in bfloat16, element by element:
# both compute in float32 and round the output to bfloat16 once, so where
# the float32 values straddle a rounding boundary they differ by one
# bfloat16 step, 2^-8 to 2^-7 of the value.  Limit: FLASH_BF16_STEP of the
# plain value plus FLASH_BF16_ATOL of the largest plain value, for the
# float32 difference before the rounding (the float32 check measures it:
# ~5e-7 of the largest value on the H100).
FLASH_BF16_STEP, FLASH_BF16_ATOL = 2.0**-7, 1e-5
# forward (chunk-64 scans) against CONSISTENCY_T decode steps (chunk-1
# scans), and against a forward at chunk 1, float32 throughout: the
# largest logit difference at most this fraction of the largest logit.
# Measured on the H100: 1.1e-5 (RWKV6, from a warm state) and 1.2e-5
# (Zamba2) -- the same float32 model with the matrix products at another
# batch shape.  RWKV6's first token from a zero state is ill-conditioned
# at random weights (its logits move by 1.3% when the embeddings move by
# 1e-7), so its decode check starts from the state of a 64-token prefix;
# the cold-start difference is printed, not checked.
LM_RTOL = 1e-3
# The solver's serving path (src/repro_torch/configs/sap_solver.py): fleet()
# at FLEET_P partitions, FLEET_S distinct matrices each submitted
# FLEET_ROUNDS times with a fresh right-hand side; full() and exact()
# batched BATCH_S at a time at P=BATCH_P (solve_batch_many at R=BATCH_R);
# service() at SERVICE_P partitions, SERVICE_CLIENTS client threads
# submitting SERVICE_REQUESTS in all.
FLEET_P, FLEET_S, FLEET_ROUNDS = 16, 64, 4
BATCH_S, BATCH_P, BATCH_R = 4, 64, 4
SERVICE_P, SERVICE_CLIENTS, SERVICE_REQUESTS = 16, 4, 512
# Service traffic: N drawn from [10,000, 16,384], K from [8, 16], d from
# SERVICE_D, a quarter of the matrices repeats.  d = 1.0 from random_banded
# reads 0.99999993 in float32 under the d >= 1 rule that routes a request
# to variant C, so 1.1 stands for the dominant class.
SERVICE_N, SERVICE_K, SERVICE_D, SERVICE_REPEAT = (10_000, 16_384), (8, 16), (0.5, 1.1), 0.25
# A batch against single-system solves of the same systems, float32
# preconditioners and float64 iterations on both sides: x within this
# fraction of the single x.  The fold may give a kernel another cluster
# size, tile or split than one system's launch, so sums run in another order.
BATCH_XTOL = 1e-5
# Phase "trace": the span trees (names and nesting) of the traced warm calls,
# as the JAX package opens them for the same calls (tests/test_torch_obs.py
# holds them against it on the CPU).  The median traced factor or krylov
# span of TRACE_REPS warm calls must lie within TRACE_SPAN_RANGE of the
# median untraced host time of as many calls, interleaved with them, plus
# TRACE_SPAN_SLACK_S: a span far under it would be one that did not wait
# for the card.  One call of each is too few: the host's clock on a shared
# machine once read an untraced E krylov call at 15.0 ms where the same call
# reads 12.2-12.6 ms; and five were too few for the sparse solve, whose
# host-synced sweeps read 8-16 ms within a run, in spells several calls
# long (one run's untraced calls 13.9, 14.0, 14.1, 10.8, 9.5 ms, its traced
# ones 14.3, 13.2, 11.3, 9.8, 9.5).  The pairs alternate their order.
_FACTOR_FUSED = ("factor", (("factor.split", ()), ("factor.fused", ()), ("factor.reduced", ())))
TRACE_TREES = {
    "C": (_FACTOR_FUSED, ("krylov", ())),
    "E_bcr": (_FACTOR_FUSED, ("krylov", ())),
    "sparse": (("plan", (("reorder", (("reorder.db", ()), ("reorder.cm", ()),
                                      ("reorder.assemble", ()))),)),
               _FACTOR_FUSED, ("krylov", ())),
}
# The trees leave out the port's own spans, which the JAX package does
# not open (``trace_port_only``): the Krylov loop's ``krylov.*`` sub-spans,
# BCR's ``factor.reduced.level`` spans and the ``plan`` span of
# ``plan_banded`` (attribute ``banded``).
TRACE_SPAN_RANGE, TRACE_SPAN_SLACK_S, TRACE_REPS = (0.9, 1.5), 0.002, 15


def trace_port_only(sp) -> bool:
    """A span of the port's own, left out of the TRACE_TREES comparison."""
    return (sp.name.startswith("krylov.") or sp.name == "factor.reduced.level"
            or (sp.name == "plan" and bool(sp.attrs.get("banded"))))
# Phase "cost": an engine with cost_accounting at fleet()'s shape, COST_S
# systems, a miss step then a hit step; an achieved fraction (roofline
# seconds over measured seconds) above COST_LIMIT fails.
COST_S, COST_LIMIT = 16, 1.05
# Phase "distributed": full() (d=1.0) and exact() (d=0.5) split over
# DIST_RANKS gloo ranks on the one card, DIST_P partitions in all (DIST_P500
# for the coupled E run), tol DIST_TOL, float32 preconditioners and float64
# iterations on both sides; each against the single-process solve of the
# same variant at the same P: x within DIST_XTOL of it (the dots are summed
# across ranks in another order, and E's chain is reduced by PCR where the
# single process runs BCR), within DIST_NCCL_XTOL for the NCCL group of one
# rank (the same kernel calls); every float64 true residual <= 1e-6; the
# sweeps within DIST_SWEEPS (one quarter-exit) of the single process's.
# One preconditioner apply to b alone, gathered from the ranks, against the
# single-process apply: within DIST_ZTOL of its largest value (a converged
# x cannot show a broken cross-rank exchange; the apply does; the largest
# read 1.5e-7, E at P=500, on an H100).  "auto" also
# runs on full()'s band with its diagonal scaled by DIST_DOMINANT, where d is
# above 1 in float32 too (full() reads d = 0.99999964 there and picks E).
# The scans at Zamba2-2.7B's and RWKV6-1.6B's head shapes over
# SHAPES["prefill_32k"] tokens at the scans' default chunk, 64, with decays
# -exp(0.5 normal), then once more with the decays scaled by SCAN_WEAK_DECAY,
# so that a shard of T/DIST_RANKS steps keeps ~0.4 of its state and every
# step of the ranks' carry chain reaches the result.  Every spawn of ranks
# is given DIST_TIMEOUT_S.
DIST_RANKS, DIST_P, DIST_P500, DIST_TOL = 4, 64, 500, 1e-6
# Phase "sharded": the LM loss split over a (data, model) mesh of gloo
# ranks on the card, at B=8, T=256 (phase train's shape); (arch, layers
# or None for the published depth, train steps, compute dtype).
# zamba2-2.7b keeps one whole segment of its published pattern (6 Mamba
# layers, then the shared block).  Limits against the single process: the
# loss (absolute, the JAX package's tests/test_distributed.py:153); each
# leaf's gradient norm (relative) and the relative L2 distance of a
# SHARD_SAMPLE-element strided sample of rank 0's block of it; after each
# step its loss (absolute) and gradient norm, and each leaf's update norm
# and update sample.  A bfloat16 run's per-leaf limit is the larger of the
# fixed one and SHARD_WITNESS_FACTOR times the witness's largest reading
# on the leaves of its kind in any layer (the single process with its
# weights moved by SHARD_WITNESS_SCALE relative),
# because RWKV6's random-init gradients in bfloat16 carry its rounding
# by tens of percent (ROADMAP L1).  The planted faults must each fail one
# limit at least.  stablelm-1.6b runs 1 of its 24 layers at full width,
# the fewest at which each of its four planted faults still fails a limit
# (a fault moves every layer's gradient or update alike).  Its sound and
# faulty readings in bfloat16 (H100 80GB HBM3, 700 W; sound / nearest
# fault) at 1 layer: gradient norm 2.3e-4 / 0.37, gradient sample
# 7.9e-3 / 0.71, step loss 1.2e-4 / 4.9e-3 (half_batch, under the limit:
# its step gradient norm, update norm and sample catch it) and 3.4
# (zero1_stale), step gradient norm 1.5e-4 / 0.41, update norm
# 1.8e-3 / 0.29, update sample 0.10 / 0.72; at the published 24 layers,
# before the cut: 1.5e-3 / 0.38, 5.1e-2 / 0.89, 1.3e-3 / 8.9e-2,
# 1.9e-3 / 0.42, 3.1e-3 / 0.29, 0.20 / 0.75.  The loss limit is the JAX
# package's (a left-out gradient leaves the averaged loss as it was).
#
# Every job runs at its published remat ("full": each layer's
# forward replayed in the backward, its kernels launched twice), and the
# phase adds the MoE and encoder-decoder losses and a compressed ZeRO-1
# step.  deepseek-moe-16b ("ep": 64 experts over model = 2) at 2 of 28
# layers, mixtral-8x22b ("tp", its published setting) at 1 of 56, and
# whisper-medium at 4 of its 24 encoder and 24 decoder layers, all three at
# full width in float32 (the
# route and aux readings below are float32's); each rank's model is made
# whole on the card one rank at a time, cut to its blocks and freed, so
# that four whole mixtral layers are never held at once.  A MoE job also
# reads the aux term alone (relative; under 1% of the loss, so the loss's
# limit cannot see a wrong load balance) and the route flips (routed
# slots whose expert differs from the single process's, over every layer
# and data rank): limits SHARD_AUX_RTOL and SHARD_FLIP_SHARE of the routed
# slots, or SHARD_WITNESS_FACTOR times the witness's reading where that is
# larger (the single process with its weights moved by
# SHARD_WITNESS_SCALE).  stablelm's job adds one compressed ZeRO-1 step
# (grad_compress=True) from the same weights, against the single
# process's compressed step, with the step limits above.  Planted faults
# of each job (SHARD_RUNS' last entry): the three above, and
# router_partial (the gates' gradient not summed over "model"), aux_local
# (the load balance of each rank's own frac and mean_prob), scale_local
# (a split leaf's int8 scale from the rank's block alone, read against
# the compressed step, whose scales are read too: SHARD_SCALE_RTOL).
SHARD_MESH, SHARD_B, SHARD_T, SHARD_LR = (2, 2), 8, 256, 5e-4
SHARD_RUNS = (
    ("stablelm-1.6b", 1, 2, "bfloat16",
     ("grad_left_out", "half_batch", "zero1_stale", "scale_local")),
    ("rwkv6-1.6b", 2, 0, "float32", ()), ("zamba2-2.7b", 6, 0, "float32", ()),
    ("rwkv6-1.6b", 2, 0, "bfloat16", ()), ("zamba2-2.7b", 6, 0, "bfloat16", ()),
    ("deepseek-moe-16b", 2, 0, "float32", ("router_partial", "aux_local")),
    ("mixtral-8x22b", 1, 0, "float32", ()), ("whisper-medium", 4, 0, "float32", ()))
SHARD_FAULT_AGAINST = {"scale_local": "compress"}  # the reference a fault is read against
SHARD_AUX_RTOL, SHARD_FLIP_SHARE = 1e-4, 1e-3
# The compressed step's int8 scale of each JAX leaf (its largest |g| / 127
# over the whole leaf) against the single process's, relative: bfloat16
# moves the largest element by its rounding.  Between the sound run and
# scale_local on the H100 (80GB HBM3, 700 W), stablelm at 1 layer:
# 6.9e-3 sound, 8.5e-2 with the fault (1.14e-2 and 4.84e-2 at 24 layers;
# a rank's block holds most of a leaf's top).
SHARD_SCALE_RTOL = 3e-2
SHARD_LOSS_ATOL, SHARD_NORM_RTOL, SHARD_UPDATE_RTOL, SHARD_TIMEOUT_S = 1e-3, 1e-2, 3e-2, 900
SHARD_STEP_LOSS_ATOL, SHARD_SAMPLE_RTOL, SHARD_UPDATE_SAMPLE_RTOL = 1e-2, 0.2, 0.4
SHARD_SAMPLE, SHARD_WITNESS_SCALE, SHARD_WITNESS_FACTOR = 16384, 1e-6, 3.0
DIST_XTOL, DIST_NCCL_XTOL, DIST_TIMEOUT_S = 1e-5, 1e-6, 300
DIST_SWEEPS, DIST_ZTOL, DIST_DOMINANT, SCAN_WEAK_DECAY = 0.25, 1e-6, 1.25, 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseClock:
    """Each phase's seconds on a line of its own as the phase ends
    (``{"phase": "seconds", "of": name, ...}``), and the run's total."""

    def __init__(self):
        self.start = self.last = _STARTED
        self.by_phase: dict[str, float] = {}

    def end(self, phase: str) -> None:
        now = time.perf_counter()
        self.by_phase[phase] = now - self.last
        emit({"phase": "seconds", "of": phase, "seconds": now - self.last,
              "elapsed_s": now - self.start})
        self.last = now

    def total(self) -> None:
        emit({"phase": "seconds", "of": "total", "seconds": time.perf_counter() - self.start,
              "by_phase": self.by_phase})


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def rel_err(kernel, plain) -> tuple[float, float]:
    """(max abs difference, max abs difference / max abs plain value)."""
    diff = float((kernel.double() - plain.double()).abs().max())
    return diff, diff / max(float(plain.double().abs().max()), 1e-30)


def check_close(what: str, kernel, plain, rtol: float = KERNEL_RTOL) -> float:
    import torch

    if not bool(torch.isfinite(kernel).all()):
        raise AssertionError(f"{what}: kernel output is not finite")
    err, rel = rel_err(kernel, plain)
    if rel > rtol:
        raise AssertionError(f"{what}: max abs err {err:.3e} = {rel:.3e} of max > {rtol}")
    return err


def check_close_bf16(what: str, kernel, plain, atol: float = FLASH_BF16_ATOL
                     ) -> tuple[float, float]:
    """(max abs difference, largest difference over its limit): every
    element within FLASH_BF16_STEP |plain| + atol max |plain| (atol
    FLASH_BF16_ATOL unless given)."""
    import torch

    if not bool(torch.isfinite(kernel).all()):
        raise AssertionError(f"{what}: kernel output is not finite")
    got, want = kernel.double(), plain.double()
    diff = (got - want).abs()
    limit = FLASH_BF16_STEP * want.abs() + atol * float(want.abs().max())
    share = float((diff / limit).max())
    if share > 1.0:
        bad = int((diff > limit).sum())
        raise AssertionError(f"{what}: {bad} elements beyond one bfloat16 step "
                             f"(worst at {share:.3f} of its limit)")
    return float(diff.max()), share


def reduce_library(d, e, f, a):
    """bcr_reduce's function from PyTorch calls: its six K x K products a
    level as batched ``torch.matmul`` (float32, TF32 off), on the clamped
    neighbours max(i-1, 0) and max(2i-1, 0) that the kernel reads, gathered
    by ``index_select`` (E_0 = 0 zeroes the terms they bring in)."""
    import torch

    i = torch.arange(a.shape[0], device=a.device)
    prv = (2 * i - 1).clamp(min=0)
    lo = torch.matmul(e[0::2], a.index_select(0, (i - 1).clamp(min=0)))
    hi = torch.matmul(f[0::2], a)
    dn = d[0::2] - torch.matmul(lo, f.index_select(0, prv)) - torch.matmul(hi, e[1::2])
    return lo, hi, dn, -torch.matmul(lo, e.index_select(0, prv)), -torch.matmul(hi, f[1::2])


def rhs_reduce_library(lo, hi, b):
    """bcr_rhs_reduce's function from PyTorch calls: two ``torch.baddbmm``
    on the neighbours the kernel reads, max(2i-1, 0) gathered by
    ``index_select`` (lo_0 = 0 zeroes the term it brings in)."""
    import torch

    i = torch.arange(lo.shape[0], device=lo.device)
    out = torch.baddbmm(b[0::2], lo, b.index_select(0, (2 * i - 1).clamp(min=0)), alpha=-1)
    return torch.baddbmm(out, hi, b[1::2], alpha=-1)


def backsub_library(a, e, f, b, x):
    """bcr_backsub's function from PyTorch calls: ``torch.baddbmm`` twice
    for t (the neighbour min(i+1, m2-1) gathered by ``index_select``;
    f_{m2-1} = 0 zeroes it), ``torch.bmm`` for a t, then the interleave."""
    import torch

    m2, k, r = x.shape
    nxt = torch.arange(1, m2 + 1, device=x.device).clamp(max=m2 - 1)
    t = torch.baddbmm(b[1::2], e, x, alpha=-1)
    t = torch.baddbmm(t, f, x.index_select(0, nxt), alpha=-1)
    return torch.stack([x, torch.bmm(a, t)], dim=1).reshape(2 * m2, k, r)


def wkv_work(bh: int, t: int, d: int) -> tuple[float, float]:
    """(operations, bytes) of WKV6 over BH rows of T tokens, counted in the
    least-work form of the function, the token-by-token recurrence (the
    chunked form the kernel runs does more): per token, o = r S + (r . (u
    k)) v (2 D^2 + 5 D) and S <- diag(exp(log w)) S + k v^T (3 D^2, the D
    exponentials counted as operations).  Reads r, k, v, log w, u and the
    state; writes o and the state."""
    ops = float(bh) * t * (5 * d * d + 6 * d)
    return ops, 4.0 * bh * (5 * t * d + d + 2 * d * d)


def ssd_work(bh: int, t: int, n: int, p: int, hshare: int) -> tuple[float, float]:
    """(operations, bytes) of SSD over BH rows of T tokens, counted in the
    least-work form, the token-by-token recurrence: per token, S <- exp(log
    a) S + B x^T (3 N P + 1, the exponential counted) and y = C^T S
    (2 N P).  Reads x, log a, the state and B, C once per BH / hshare rows;
    writes y and the state."""
    ops = float(bh) * t * (5 * n * p + 1)
    nbytes = 4.0 * (2 * bh * t * p + 2 * (bh // hshare) * t * n + bh * t + 2 * bh * n * p)
    return ops, nbytes


def flash_work(b: int, hq: int, hk: int, tq: int, tk: int, d: int, causal: bool,
               window, elt_bytes: int) -> tuple[float, float, float]:
    """(tensor-core operations, exponentials, bytes) of attention counted
    in its least-work form: per query head and (query, key) pair the masks
    leave visible, 2 D operations for q.k and 2 D for p.v, both products the
    tensor cores can take at their dense bfloat16 rate, and one
    exponential.  Reads q, k, v once and writes o once."""
    import numpy as np

    t = np.arange(tq)
    hi = np.minimum(t, tk - 1) if causal else np.full(tq, tk - 1)
    lo = np.maximum(t - window + 1, 0) if window else np.zeros(tq, dtype=np.int64)
    pairs = b * hq * float(np.maximum(hi - lo + 1, 0).sum())
    return (pairs * 4 * d, pairs,
            float(elt_bytes * (2 * b * hq * tq * d + 2 * b * hk * tk * d)))


def roofline_bound(flops: float, nbytes: float, bytes_s: float, flop_s: float) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the bytes' time and the
    operations' time at the given rates."""
    t_bytes, t_ops = nbytes / bytes_s * 1e3, flops / flop_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def flash_bound(tc_ops: float, exps: float, nbytes: float, bytes_s: float, bf16_s: float,
                sfu_s: float) -> tuple[float, str]:
    """(ms, what bounds it): the largest of the bytes' time, the tensor
    cores' time and the exponentials' time."""
    t_bytes, t_tc, t_exp = nbytes / bytes_s * 1e3, tc_ops / bf16_s * 1e3, exps / sfu_s * 1e3
    return max(t_bytes, t_tc, t_exp), "bytes" if t_bytes >= max(t_tc, t_exp) else "operations"


def balanced_chrome_trace(path) -> dict:
    """{span name: completed B/E pairs} of a Chrome trace file; an E that
    closes no open B of its name on its thread, or a B left open, raises."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    stacks, pairs = {}, {}
    for ev in sorted((e for e in events if e["ph"] in ("B", "E")), key=lambda e: e["ts"]):
        stack = stacks.setdefault(ev["tid"], [])
        if ev["ph"] == "B":
            stack.append(ev["name"])
        elif ev["name"] in stack:
            stack.reverse()
            stack.remove(ev["name"])
            stack.reverse()
            pairs[ev["name"]] = pairs.get(ev["name"], 0) + 1
        else:
            raise AssertionError(f"trace: E {ev['name']!r} closes no open B")
    if any(stacks.values()):
        raise AssertionError(f"trace: spans left open: {stacks}")
    return pairs


def flash_inputs(dev, b: int, hq: int, hk: int, tq: int, tk: int, d: int, dtype, seed: int):
    """q (B, Hq, Tq, D), k and v (B, Hk, Tk, D), normal, from a seeded
    generator on the card."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, hq, tq, d, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(b, hk, tk, d, generator=g, device=dev).to(dtype) for _ in range(2))
    return q, k, v


def wkv_inputs(dev, bh: int, t: int, d: int, seed: int, strong: bool = False):
    """r, k, v, log w (<= 0; -30 everywhere when ``strong``), u and a state
    for BH rows of T tokens, from a seeded generator on the card."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (torch.randn(bh, t, d, generator=g, device=dev) for _ in range(3))
    if strong:
        logw = torch.full((bh, t, d), -30.0, device=dev)
    else:
        logw = -torch.exp(0.5 * torch.randn(bh, t, d, generator=g, device=dev))
    u = torch.randn(bh, d, generator=g, device=dev)
    s0 = 0.1 * torch.randn(bh, d, d, generator=g, device=dev)
    return r, k, v, logw, u, s0


def ssd_inputs(dev, bh: int, t: int, n: int, p: int, hshare: int, seed: int,
               strong: bool = False):
    """x, B, C (one row per ``hshare`` rows), log a (<= 0; -30 when
    ``strong``) and a state, from a seeded generator on the card."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(bh, t, p, generator=g, device=dev)
    b, c = (torch.randn(bh // hshare, t, n, generator=g, device=dev) for _ in range(2))
    if strong:
        loga = torch.full((bh, t), -30.0, device=dev)
    else:
        loga = -torch.exp(0.5 * torch.randn(bh, t, generator=g, device=dev))
    s0 = 0.1 * torch.randn(bh, n, p, generator=g, device=dev)
    return x, b, c, loga, s0


def chain_coupling(d, e, f) -> dict[str, float]:
    """Largest |D|, |E|, |F| of an interface chain: E, F at float32
    rounding of D mean the chain is decoupled and BCR's coupling terms
    vanish."""
    return {nm: float(t.abs().max()) for nm, t in (("max_abs_d", d), ("max_abs_e", e),
                                                     ("max_abs_f", f))}


def btf_library(d, e, f):
    """btf's function from PyTorch calls: a loop over the M block rows of
    batched ``torch.linalg.inv`` (LU with partial pivoting, no boost) over
    the P partitions and ``torch.matmul`` for L_j and S_j."""
    import torch

    sinv, l = torch.empty_like(d), torch.zeros_like(d)
    sinv[:, 0] = torch.linalg.inv(d[:, 0])
    for j in range(1, d.shape[1]):
        l[:, j] = torch.matmul(e[:, j], sinv[:, j - 1])
        sinv[:, j] = torch.linalg.inv(d[:, j] - torch.matmul(l[:, j], f[:, j - 1]))
    return sinv, l


def fused_library(d, e, f, bq, cq):
    """The fused pass's function from PyTorch calls: btf_library's loop on
    the LU and on the reversed (UL) recurrence, the two spike carries and
    the four corner products; ``(sinv, l, vb, vt, wt, wb)``."""
    import torch

    m = d.shape[1]
    sinv, l = btf_library(d, e, f)
    c_w = cq
    for j in range(1, m):
        c_w = -torch.matmul(l[:, j], c_w)
    c_ul = torch.linalg.inv(d[:, m - 1].flip(-2, -1))
    c_v = bq.flip(-2)
    for j in range(1, m):
        l_ul = torch.matmul(f[:, m - 1 - j].flip(-2, -1), c_ul)
        c_ul = torch.linalg.inv(d[:, m - 1 - j].flip(-2, -1)
                                - torch.matmul(l_ul, e[:, m - j].flip(-2, -1)))
        c_v = -torch.matmul(l_ul, c_v)
    return (sinv, l, torch.matmul(sinv[:, -1], bq), torch.matmul(c_ul, c_v).flip(-2),
            torch.matmul(c_ul, cq.flip(-2)).flip(-2), torch.matmul(sinv[:, -1], c_w))


def host_band_matvec(band, x):
    """A band-storage matrix times a vector on the host, in float64."""
    import numpy as np

    k = (band.shape[1] - 1) // 2
    win = np.lib.stride_tricks.sliding_window_view(np.pad(x, k), band.shape[1])
    return (band.astype(np.float64) * win).sum(axis=1)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card, timed by CUDA events."""
    import torch

    fn()  # warm-up
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn, reps: int) -> float:
    """Mean wall milliseconds per call of ``fn`` over ``reps`` calls in a
    row, ended by a synchronize (the host's cost where calls are short)."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_ms(fn, reps: int, launches=None) -> tuple[float, dict]:
    """Device milliseconds per call of ``fn`` from the profiler's kernel
    time over ``reps`` calls in a row, and by kernel (name: [ms per launch,
    launches per call, launches recorded]).  Unlike CUDA events around the
    loop, it does not count the host's gaps between short launches.
    ``launches``, where given, returns the running count of launches the
    kernel wrappers ``fn`` calls have made.  In a long process the profiler
    loses launches, or sees none: a kernel recorded a number of times that
    is not a multiple of ``reps``, or fewer kernels recorded than the
    wrappers launched, is a window with launches lost, whose per-call sum
    would read low (a time under the card's bound).  Such a window is timed
    by :func:`queued_ms` instead and its by-kernel split is None (the
    caller labels the time "queued")."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    before = launches() if launches else 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    launched = launches() - before if launches else 0
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    lost = [e.key[:72] for e in events if e.count % reps]
    if not events or lost or sum(e.count for e in events) < launched:
        print(f"device_ms: the profiler lost launches ({sum(e.count for e in events)} recorded, "
              f"{launched} launched, {len(lost)} kernels' counts not a multiple of {reps} "
              "calls); timed queued", file=sys.stderr, flush=True)
        return queued_ms(fn, reps), None
    by_kernel = {e.key[:72]: [e.self_device_time_total / 1e3 / e.count, e.count // reps, e.count]
                 for e in events}
    return sum(ms * n for ms, n, _ in by_kernel.values()), by_kernel


def queued_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``: ``reps`` calls queued behind
    a spin kernel (``torch.cuda._sleep``) that outlasts the host's enqueueing
    of them, so the card runs them back to back, timed by CUDA events around
    them.  Unlike events around a loop the host feeds, it does not count the
    host's gaps; unlike the profiler's kernel time, it counts the card's own
    gap from one launch to the next (~1.3 us on the H100).  It needs no
    profiler, which in a long process loses launches.  The card holds a
    bounded queue of pending launches: a window of more launches blocks the
    host until the spin ends, and the calls then run at the host's pace.  A
    window whose enqueueing outlasted its spin is timed again in groups of a
    quarter as many calls, each behind a spin of its own."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / reps  # a call's host and device time
    group = reps
    while True:
        total, done, paced = 0.0, 0, True
        while done < reps:
            n = min(group, reps - done)
            spin, start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            spin.record()
            torch.cuda._sleep(int(4e9 * host_s * n) + 2_000_000)  # cycles: 2x at 2 GHz
            t1 = time.perf_counter()
            start.record()
            for _ in range(n):
                fn()
            stop.record()
            enqueue_ms = (time.perf_counter() - t1) * 1e3
            torch.cuda.synchronize()
            paced = paced and enqueue_ms < spin.elapsed_time(start)
            total += start.elapsed_time(stop)
            done += n
        if paced or group == 1:
            return total / reps
        group = max(1, group // 4)


def rotating(make, nbytes: float):
    """A function returning, call after call, the next of enough input sets
    ``make(seed)`` that their ``nbytes`` each exceed the L2 cache three times."""
    import itertools

    sets = [make(SEED + i) for i in range(max(1, -(-int(3 * L2_BYTES) // int(nbytes))))]
    return itertools.cycle(sets).__next__


def zoo_phases(dev, get_config, get_family, reset, counts, serve, decode_window,
               prompts) -> int:
    """Phases "moe" (deepseek-moe-16b; mixtral-8x22b at MIXTRAL_LAYERS
    layers), "vlm" (phi-3-vision-4.2b) and "encdec" (whisper-medium), each
    model loaded after the previous one is freed, one line each.  ``reset``
    / ``counts`` zero and read the kernel wrappers' launch counts;
    ``serve`` and ``decode_window`` are phase "lm"'s serving run and
    profiled decode window; ``prompts`` give the serving runs' lengths.
    Returns the flash kernel's launches in the prefill, ``encode`` and
    ``decode_train`` passes (each shape's first call)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import moe

    flash_launches = 0

    def load(cfg):
        """(family, parameters from seed SEED, the line's start, the bytes
        the earlier phases hold); the peak statistic starts here."""
        fam = get_family(cfg)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = fam.init(cfg, torch.Generator(dev).manual_seed(SEED), device=dev)
        torch.cuda.synchronize()
        line = {"arch": cfg.name, "params": sum(q.numel() for q in params.parameters()),
                "params_count_formula": cfg.params_count(),
                "weight_bytes": sum(q.numel() * q.element_size() for q in params.parameters()),
                "init_s": time.perf_counter() - t0, "compute_dtype": cfg.compute_dtype}
        return fam, params, line, held

    def against_steps(c32, fam, params, toks, full, cache) -> dict:
        """forward's logits ``full`` against one decode step a token of
        ``toks`` from ``cache``, float32: within LM_RTOL of the largest logit."""
        full = full[..., : c32.vocab]
        diffs = []
        for i in range(toks.shape[1]):
            logits, cache = fam.decode_step(c32, params, cache, toks[:, i:i + 1])
            diffs.append(float((logits - full[:, i]).abs().max()))
        max_logit = float(full.abs().max())
        if not max(diffs) <= LM_RTOL * max_logit:
            raise AssertionError(f"{c32.name}: forward and decode steps differ by "
                                 f"{max(diffs):.3e}, max |logit| {max_logit:.3e}")
        return {"t": toks.shape[1], "batch": toks.shape[0], "rtol": LM_RTOL,
                "max_abs_diff": max(diffs), "first_token_abs_diff": diffs[0],
                "max_abs_logit": max_logit}

    def first_call(what, fn, want_launches, shape):
        """``fn``'s first call with the counts at 0: (output, flash
        launches); the output finite and of ``shape``, the launches as many
        as ``want_launches``."""
        nonlocal flash_launches
        reset()
        out = fn()
        torch.cuda.synchronize()
        n = counts()["flash"]
        out = out[0] if isinstance(out, tuple) else out
        if not (bool(torch.isfinite(out).all()) and tuple(out.shape) == shape):
            raise AssertionError(f"{what}: output bad: {tuple(out.shape)}, want {shape}")
        if n != want_launches:
            raise AssertionError(f"{what} launched the flash kernel {n} times, "
                                 f"not {want_launches}")
        flash_launches += n
        return out, n

    def timed(fn, reps: int = 3) -> list:
        """Wall ms of ``reps`` calls of ``fn``, each ended by a synchronize."""
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    def profiled(fn) -> dict:
        """One call of ``fn`` under the profiler: device busy ms, kernel
        launches, the largest kernels and the flash kernel's share."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in events) / 1e3
        flash_ms = sum(e.self_device_time_total for e in events if "flash_kernel" in e.key) / 1e3
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
        return {"device_busy_ms": busy, "device_kernel_launches": sum(e.count for e in events),
                "top_kernels": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                                for e in top],
                "flash_device_ms": flash_ms, "flash_share": flash_ms / busy if busy else None}

    def drop_share(c, fam, params, toks) -> dict:
        """The routed slots a forward at ``c``'s capacity drops, counted by
        ``moe.slot_counts`` on every layer's input."""
        plain, tally = moe.moe_mlp, []

        def spy(cfg_, p, h, mesh=None):
            tally.append(moe.slot_counts(cfg_, p["router"], h))
            return plain(cfg_, p, h, mesh)

        moe.moe_mlp = spy
        try:
            fam.forward(c, params, toks)
        finally:
            moe.moe_mlp = plain
        dropped, routed = sum(int(d) for d, _ in tally), sum(r for _, r in tally)
        return {"capacity_factor": c.capacity_factor, "group": min(c.moe_group, toks.numel()),
                "layers": len(tally), "dropped": dropped, "routed": routed,
                "share": dropped / routed}

    def decoder_run(phase, cfg, cons_b, cons_t, prefills, extra=None, reduced=None):
        """A decoder-only model: forward (float32, through the flash kernel;
        at a capacity that drops nothing) against decode steps, bfloat16
        prefills (patches prepended where the config has them), ``extra``,
        the serving run and the decode window; one line."""
        fam, params, line, held = load(cfg)
        rng = np.random.default_rng(SEED)
        launches, prefill = {}, {}
        with torch.inference_mode():
            no_drop = {"capacity_factor": float(cfg.n_experts)} if cfg.n_experts else {}
            c32 = dataclasses.replace(cfg, compute_dtype="float32", **no_drop)
            toks = torch.tensor(rng.integers(0, cfg.vocab, size=(cons_b, cons_t)), device=dev)
            reset()
            full, aux = fam.forward(c32, params, toks)
            launches["consistency_f32"] = counts()["flash"]
            consistency = against_steps(c32, fam, params, toks, full,
                                        fam.init_cache(c32, cons_b, cons_t))
            consistency.update(no_drop, aux=float(aux))
            del full
            if cfg.n_experts:
                consistency["published_capacity_drops"] = drop_share(
                    dataclasses.replace(c32, capacity_factor=cfg.capacity_factor), fam,
                    params, toks)
            for b, t in prefills:
                patches = None
                if cfg.n_patches:
                    patches = torch.randn(b, cfg.n_patches, cfg.d_model, device=dev,
                                          generator=torch.Generator(dev).manual_seed(SEED)
                                          ).to(cfg.cdtype)
                ptoks = torch.tensor(rng.integers(0, cfg.vocab, size=(b, t)), device=dev)
                rows = t + (cfg.n_patches if patches is not None else 0)

                def fwd():
                    return fam.forward(cfg, params, ptoks, patches)

                _, launches[f"prefill_b{b}_t{t}"] = first_call(
                    f"{cfg.name} prefill", fwd, cfg.n_layers, (b, rows, cfg.vocab_padded))
                prefill[f"b{b}_t{t}"] = {"shape": [b, t], "rows": rows, "ms": timed(fwd)}
                if (b, t) == prefills[0]:
                    prefill[f"b{b}_t{t}"]["profile"] = profiled(fwd)
                del ptoks, patches
            if extra is not None:
                line.update(extra(cfg, fam, params, rng))
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - held
            serve_line, serve_counts = serve(cfg.name, cfg, params,
                                             [rng.integers(0, cfg.vocab, size=len(pr)).tolist()
                                              for pr in prompts], held)
            launches["serve"] = serve_counts["flash"]  # decode runs no flash kernel
            window_line = decode_window(cfg, fam, params, rng)
        if launches["consistency_f32"] != cfg.n_layers:
            raise AssertionError(f"{cfg.name}: the float32 forward launched the flash kernel "
                                 f"{launches['consistency_f32']} times, not {cfg.n_layers}")
        emit({"phase": phase, **line, **({"reduced": reduced} if reduced else {}),
              "consistency": consistency, "prefill": prefill, "serve": serve_line,
              "decode_window": window_line,
              "peak_mem_bytes": max(peak, serve_line["peak_mem_bytes"]),
              "other_phases_bytes": held, "launches": {"flash": launches}})
        del params

    def patches_change_logits(cfg, fam, params, rng) -> dict:
        """The VLM stub: patches of zeros and of ones must change the last
        text logit (bfloat16, B=1, 16 tokens)."""
        t16 = torch.tensor(rng.integers(0, cfg.vocab, size=(1, 16)), device=dev)
        zeros = torch.zeros(1, cfg.n_patches, cfg.d_model, dtype=cfg.cdtype, device=dev)
        last = [fam.forward(cfg, params, t16, p)[0][:, -1].float()
                for p in (zeros, torch.ones_like(zeros))]
        diff = float((last[0] - last[1]).abs().max())
        if not diff > 0:
            raise AssertionError(f"{cfg.name}: patches of zeros and of ones give the same "
                                 "last text logits")
        return {"patches_zeros_vs_ones_last_logit_max_abs_diff": diff}

    # ---- moe. deepseek-moe-16b at full size; mixtral-8x22b at full width ------
    decoder_run("moe", get_config(MOE_ARCH), 2, MOE_CONSISTENCY_T, [(PREFILL_B, PREFILL_T)])
    torch.cuda.empty_cache()
    mixtral = get_config(MIXTRAL_ARCH)
    decoder_run("moe", dataclasses.replace(mixtral, n_layers=MIXTRAL_LAYERS), 1,
                MIXTRAL_CONSISTENCY_T, [(PREFILL_B, PREFILL_T), (1, MIXTRAL_LONG_T)],
                reduced={"n_layers": [mixtral.n_layers, MIXTRAL_LAYERS]})
    torch.cuda.empty_cache()

    # ---- vlm. phi-3-vision-4.2b at full size ------------------------------------
    decoder_run("vlm", get_config(VLM_ARCH), 2, CONSISTENCY_T, [(PREFILL_B, PREFILL_T)],
                extra=patches_change_logits)
    torch.cuda.empty_cache()

    # ---- encdec. whisper-medium at full size -------------------------------------
    cfg = get_config(ENCDEC_ARCH)
    fam, params, line, held = load(cfg)
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(dev).manual_seed(SEED)
    launches = {}
    with torch.inference_mode():
        # forward (encode 1,500 frames, decode_train over WHISPER_T tokens)
        # against encode -> precompute_cross_kv -> WHISPER_T decode steps
        c32 = dataclasses.replace(cfg, compute_dtype="float32")
        frames = torch.randn(2, cfg.enc_seq, cfg.d_model, generator=gen, device=dev)
        toks = torch.tensor(rng.integers(0, cfg.vocab, size=(2, WHISPER_T)), device=dev)
        reset()
        full, _ = fam.forward(c32, params, {"frames": frames, "tokens": toks})
        launches["consistency_f32"] = counts()["flash"]
        cache = fam.init_cache(c32, 2, WHISPER_T)
        cache["cross_k"], cache["cross_v"] = fam.precompute_cross_kv(
            c32, params, fam.encode(c32, params, frames))
        consistency = against_steps(c32, fam, params, toks, full, cache)
        del full, cache, frames
        # bfloat16: encode at B=4, decode_train at WHISPER_TRAIN_T, greedy steps
        frames = torch.randn(PREFILL_B, cfg.enc_seq, cfg.d_model, generator=gen,
                             device=dev).to(cfg.cdtype)
        enc, launches["encode"] = first_call(
            f"{cfg.name} encode", lambda: fam.encode(cfg, params, frames), cfg.n_enc_layers,
            (PREFILL_B, cfg.enc_seq, cfg.d_model))
        encode_ms = timed(lambda: fam.encode(cfg, params, frames))
        encode_profile = profiled(lambda: fam.encode(cfg, params, frames))
        dtoks = torch.tensor(rng.integers(0, cfg.vocab, size=(PREFILL_B, WHISPER_TRAIN_T)),
                             device=dev)
        _, launches["decode_train"] = first_call(
            f"{cfg.name} decode_train", lambda: fam.decode_train(cfg, params, dtoks, enc),
            2 * cfg.n_layers, (PREFILL_B, WHISPER_TRAIN_T, cfg.vocab_padded))
        train_ms = timed(lambda: fam.decode_train(cfg, params, dtoks, enc))
        cache = fam.init_cache(cfg, PREFILL_B, WHISPER_STEPS + 1)
        cache["cross_k"], cache["cross_v"] = fam.precompute_cross_kv(cfg, params, enc)
        tok = dtoks[:, :1]
        _, cache = fam.decode_step(cfg, params, cache, tok)  # first-call costs
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = []
        for _ in range(WHISPER_STEPS):
            logits, cache = fam.decode_step(cfg, params, cache, tok)
            tok = torch.argmax(logits, dim=-1, keepdim=True)
            out.append(tok)
        torch.cuda.synchronize()
        greedy_s = time.perf_counter() - t0
        launches["greedy_decode"] = counts()["flash"]  # plain decode attention: 0
        out = torch.cat(out, dim=1)
        if not bool(((out >= 0) & (out < cfg.vocab)).all()):
            raise AssertionError(f"{cfg.name}: a greedy token is outside the vocabulary")
        greedy = {"batch": PREFILL_B, "steps": WHISPER_STEPS, "seconds": greedy_s,
                  "ms_per_step": greedy_s * 1e3 / WHISPER_STEPS,
                  "generated_tokens_per_s": PREFILL_B * WHISPER_STEPS / greedy_s}
        del cache, enc, frames, dtoks, out
        window_line = decode_window(cfg, fam, params, rng)
    if launches["consistency_f32"] != cfg.n_enc_layers + 2 * cfg.n_layers:
        raise AssertionError(f"{cfg.name}: the float32 forward launched the flash kernel "
                             f"{launches['consistency_f32']} times, not "
                             f"{cfg.n_enc_layers + 2 * cfg.n_layers}")
    emit({"phase": "encdec", **line, "consistency": consistency,
          "encode_ms": encode_ms, "encode_shape": [PREFILL_B, cfg.enc_seq],
          "encode_profile": encode_profile,
          "decode_train_ms": train_ms, "decode_train_shape": [PREFILL_B, WHISPER_TRAIN_T],
          "greedy_decode": greedy, "decode_window": window_line,
          "peak_mem_bytes": torch.cuda.max_memory_allocated() - held,
          "other_phases_bytes": held, "launches": {"flash": launches}})
    del params
    torch.cuda.empty_cache()
    return flash_launches


def train_phase(dev, get_config, get_family, reset, counts) -> dict:
    """Phase "train", after every serving phase has freed its model; five
    lines ("train" for stablelm-1.6b through TrainLoop, its compression and
    microbatch checks, rwkv6-1.6b / zamba2-2.7b, the autograd Functions
    against autograd of their plain versions, and the restart path).
    ``reset`` / ``counts`` zero and read the kernel wrappers' launch counts.
    Returns the launches of the flash, wkv and ssd kernels in the runs of
    the train path (the Function checks excluded)."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import optim
    from repro_torch.data import DataConfig
    from repro_torch.kernels import autograd as kgrad
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.kernels.ssd import ssd, ssd_plain
    from repro_torch.kernels.wkv import wkv6, wkv6_plain
    from repro_torch.models import layers, transformer
    from repro_torch.train import (CheckpointManager, TrainConfig, TrainLoop, make_train_step,
                                   run_with_restarts)

    launches = {"flash": 0, "wkv": 0, "ssd": 0}

    def add_launches():
        c = counts()
        for nm in launches:
            launches[nm] += c[nm]

    def start_line():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return held

    # ---- 1. stablelm-1.6b at full width and depth through TrainLoop -------------
    cfg = get_config(TRAIN_ARCH)
    held = start_line()
    n_params = cfg.params_count()
    # float32 parameters, gradients, m and v, reckoned before the run (the
    # activations kept for the backward are reckoned in PERF.md)
    reckoned = {"params_grads_m_v_bytes": 4 * 4 * n_params}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    tc = TrainConfig(steps=TRAIN_STEPS, log_every=1, checkpoint_every=TRAIN_STEPS + 1,
                     checkpoint_dir=tmp, seed=SEED)
    oc = optim.AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    dc = DataConfig(vocab=TRAIN_VOCAB, seq_len=TRAIN_T, global_batch=TRAIN_B, noise=0.05,
                    seed=SEED)
    at_step = []

    def note(step):  # the fault hook: the flash launches before each step
        at_step.append(flash_attention.launches)

    t0 = time.perf_counter()
    loop = TrainLoop(cfg, oc, tc, dc, fault_hook=note)  # on the card: no device given
    reset()
    out = loop.run(resume=False)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    add_launches()
    per_step = [b - a for a, b in zip(at_step, at_step[1:] + [flash_attention.launches])]
    log = out["log"]
    losses = [r["loss"] for r in log]
    if len(log) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: {len(log)} logged steps, losses {losses}")
    if not losses[-1] <= losses[0] - TRAIN_DROP:
        raise AssertionError(f"train: step {TRAIN_STEPS}'s loss {losses[-1]:.4f} is not "
                             f"{TRAIN_DROP} below step 1's {losses[0]:.4f}")
    per_layer = _loss_launches(cfg)["flash"]  # twice a layer under remat
    if per_step != [per_layer] * TRAIN_STEPS:
        raise AssertionError(f"train: flash launches a step {per_step}, not {per_layer} each")
    step_ms = [r["step_time_s"] * 1e3 for r in log]
    median_ms = statistics.median(step_ms[1:])
    peak = torch.cuda.max_memory_allocated() - held
    model, opt_state = out["params"], out["opt"]
    params = dict(model.named_parameters())

    # one more step under the profiler, its parts under named ranges
    batch = loop.batch(TRAIN_STEPS)
    fam = get_family(cfg)
    nll_plain, flash_bwd = layers.next_token_nll, kgrad.FlashAttention.backward
    flash_bwd_attr = kgrad.FlashAttention.__dict__["backward"]  # the staticmethod itself

    def nll_ranged(*a):
        with record_function("train.cross_entropy"):
            return nll_plain(*a)

    def flash_bwd_ranged(ctx, grad_o):
        with record_function("train.attention_backward_recompute"):
            return flash_bwd(ctx, grad_o)

    def one_step(marks=None):
        def mark():
            if marks is not None:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()

        for p in params.values():
            p.grad = None
        mark()
        with record_function("train.forward"):
            total, _ = fam.loss(cfg, model, batch)
        mark()
        with record_function("train.backward"):
            total.backward()
        mark()
        with record_function("train.adamw"):
            optim.apply_updates(oc, params, {n: p.grad for n, p in params.items()}, opt_state)
        mark()
        for p in params.values():
            p.grad = None

    transformer.next_token_nll = nll_ranged
    kgrad.FlashAttention.backward = staticmethod(flash_bwd_ranged)
    try:
        one_step()  # warm, and the ranges' first call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            one_step()
            torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
        marks = []
        t0 = time.perf_counter()
        one_step(marks)  # unprofiled: its parts' spans on the card's clock
        torch.cuda.synchronize()
        timed_wall_ms = (time.perf_counter() - t0) * 1e3
        spans = {nm: marks[i].elapsed_time(marks[i + 1])
                 for i, nm in enumerate(("forward", "backward", "adamw"))}
    finally:
        transformer.next_token_nll = nll_plain
        kgrad.FlashAttention.backward = flash_bwd_attr
    events = prof.key_averages()
    # the card's kernels: CUDA events but the ranges' own device-side spans
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("train.")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3

    def inclusive(key):  # device ms of the kernels under a CPU op or range
        return sum(e.device_time_total for e in events
                   if e.key == key and e.device_type == torch.autograd.DeviceType.CPU) / 1e3

    split = {
        "flash_forward": sum(e.self_device_time_total for e in kernels
                             if "flash_kernel" in e.key) / 1e3,
        "attention_backward_recompute": inclusive("train.attention_backward_recompute"),
        "casts_forward_aten_to_copy": inclusive("aten::_to_copy"),
        "casts_backward_ToCopyBackward0": inclusive(
            "autograd::engine::evaluate_function: ToCopyBackward0"),
        "cross_entropy_forward": inclusive("train.cross_entropy"),
        "cross_entropy_backward_logsumexp_gather_mean": sum(inclusive(
            f"autograd::engine::evaluate_function: {n}") for n in (
                "LogsumexpBackward0", "GatherBackward0", "MeanBackward0")),
        "adamw": inclusive("train.adamw"),
        "forward": inclusive("train.forward"),
    }
    if not busy > 0:
        raise AssertionError("train: the profiler saw no kernel on the card")
    for part in ("flash_forward", "attention_backward_recompute", "cross_entropy_forward"):
        if not split[part] > 0:  # a range that no longer wraps its code reads 0
            raise AssertionError(f"train: the profiled step shows no device time in {part}")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    emit({"phase": "train", "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
          "heads": cfg.n_heads, "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab, "params": sum(p.numel() for p in params.values()),
          "compute_dtype": cfg.compute_dtype, "batch": [TRAIN_B, TRAIN_T],
          "data": dataclasses.asdict(dc), "lr": TRAIN_LR, "warmup_steps": TRAIN_WARMUP,
          "steps": TRAIN_STEPS, "losses": losses, "grad_norms": [r["grad_norm"] for r in log],
          "loss_drop": losses[0] - losses[-1], "step_ms": step_ms,
          "median_step_ms_2_on": median_ms,
          "tokens_per_s": TRAIN_B * TRAIN_T / (median_ms / 1e3), "run_s": run_s,
          "stragglers": sum(r["straggler"] for r in log),
          "flash_launches_per_step": per_step, "reckoned": reckoned,
          "peak_mem_bytes": peak, "other_phases_bytes": held,
          "timed_step": {"wall_ms": timed_wall_ms, "event_spans_ms": spans},
          "profiled_step": {"wall_ms": prof_wall_ms, "device_busy_ms": busy,
                            "device_busy_share": busy / prof_wall_ms,
                            # two steps: this step's device time over the
                            # unprofiled step's wall, which lacks the
                            # profiler's host overhead
                            "device_busy_over_timed_step_wall": busy / timed_wall_ms,
                            "device_ms_by_part": split,
                            "top_kernels": [[e.key[:80], e.self_device_time_total / 1e3,
                                             e.count] for e in top]},
          "nvidia_smi": nvidia_smi()})

    # ---- 2. the same model: int8 compression, then two microbatches -------------
    step_c = make_train_step(cfg, oc, dataclasses.replace(tc, grad_compress=True))
    err = optim.compress.init_error_state(params)
    reset()
    closs = []
    for i in range(TRAIN_COMPRESS_STEPS):
        m = step_c(model, opt_state, err, loop.batch(TRAIN_STEPS + 1 + i))
        closs.append(float(m["loss"]))
    add_launches()
    if not all(math.isfinite(x) for x in closs):
        raise AssertionError(f"train: compressed steps' losses {closs}")
    err_norm = float(optim.global_norm(err))
    del err, opt_state
    torch.cuda.empty_cache()
    # one batch, one fresh optimizer state each way, from the same parameters:
    # one microbatch, two, and the planted fault -- the gradient of the first
    # microbatch alone (a step on the batch's first half), what a step that
    # dropped the second would give.  The later runs' gradients and updates
    # are compared with the first's as they come, tensor by tensor, so that
    # only one of each is kept.
    mb_batch = loop.batch(0)
    runs = (("two", 2, mb_batch),
            ("fault_first_half_only", 1, {n: x[:TRAIN_B // 2] for n, x in mb_batch.items()}))
    p0 = {n: p.detach().clone() for n, p in params.items()}
    first = {}
    diff2 = {nm: {"grad": 0.0, "grad_ref": 0.0, "update": 0.0, "update_ref": 0.0}
             for nm, _, _ in runs}
    apply_plain = optim.apply_updates
    current = []

    def spy(cfg_, params_, grads, state):
        if "grads" not in first:
            first["grads"] = {n: g.detach().clone() for n, g in grads.items()}
        else:
            d = diff2[current[-1]]
            for n, g in grads.items():
                d["grad"] += float(torch.sum((g - first["grads"][n]) ** 2))
                d["grad_ref"] += float(torch.sum(first["grads"][n] ** 2))
        return apply_plain(cfg_, params_, grads, state)

    losses_mb = {}
    for name, nmicro, bt in (("one", 1, mb_batch),) + runs:
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(p0[n])
        step_m = make_train_step(cfg, oc, dataclasses.replace(tc, microbatches=nmicro))
        current.append(name)
        optim.apply_updates = spy
        try:
            reset()
            losses_mb[name] = float(step_m(model, optim.init(params), {}, bt)["loss"])
            add_launches()
        finally:
            optim.apply_updates = apply_plain
        if name == "one":
            first["update"] = {n: p.detach() - p0[n] for n, p in params.items()}
        else:
            d = diff2[name]
            for n, p in params.items():
                u2 = p.detach() - p0[n]
                d["update"] += float(torch.sum((u2 - first["update"][n]) ** 2))
                d["update_ref"] += float(torch.sum(first["update"][n] ** 2))
    readings = {nm: {"loss": abs(losses_mb[nm] - losses_mb["one"]) / abs(losses_mb["one"]),
                     "grad": math.sqrt(diff2[nm]["grad"] / diff2[nm]["grad_ref"]),
                     "update": math.sqrt(diff2[nm]["update"] / diff2[nm]["update_ref"])}
                 for nm, _, _ in runs}
    limits = {"loss": TRAIN_MICRO_LOSS_RTOL, "grad": TRAIN_MICRO_GRAD_RTOL,
              "update": TRAIN_MICRO_UPDATE_RTOL}
    del first, p0
    sound, fault = readings["two"], readings["fault_first_half_only"]
    if not all(sound[q] <= limits[q] for q in limits):
        raise AssertionError(f"train: two microbatches against one: {sound}, limits {limits}")
    if not all(fault[q] > limits[q] for q in limits):  # a limit that would pass the fault
        raise AssertionError(f"train: the planted fault (the first microbatch alone) reads "
                             f"{fault}, within limits {limits}")
    emit({"phase": "train", "arch": cfg.name, "check": "compress_and_microbatches",
          "compress": {"steps": TRAIN_COMPRESS_STEPS, "losses": closs,
                       "error_state_norm": err_norm},
          "losses_one_two_fault": losses_mb, "rel_diff_from_one_microbatch": readings,
          "limits": limits,
          "peak_mem_bytes": torch.cuda.max_memory_allocated() - held})
    del model, params, out, loop, batch, mb_batch
    torch.cuda.empty_cache()

    # ---- 3. rwkv6-1.6b and zamba2-2.7b: five steps on one fixed batch ------------
    for arch in TRAIN_OTHERS:
        cfg = get_config(arch)
        fam = get_family(cfg)
        kernel = "wkv" if cfg.family == "rwkv" else "ssd"
        wrapper = wkv6 if kernel == "wkv" else ssd
        recompute_key = "wkv6" if kernel == "wkv" else "ssd"
        held = start_line()
        model = fam.init(cfg, torch.Generator(dev).manual_seed(SEED), device=dev)
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        state = optim.init(params)
        step = make_train_step(cfg, optim.AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                                      total_steps=TRAIN_FIXED_STEPS),
                               TrainConfig(checkpoint_dir=tmp))
        fixed = {"tokens": torch.tensor(np.random.default_rng(SEED + 1).integers(
            0, cfg.vocab, size=(TRAIN_B, TRAIN_T)), device=dev)}
        reset()
        recomputes = kgrad.backward_calls[recompute_key]
        rows = []
        for _ in range(TRAIN_FIXED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(model, state, {}, fixed)
            torch.cuda.synchronize()
            rows.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                         "ms": (time.perf_counter() - t0) * 1e3})
        by_route = dict(wrapper.by_route)
        c = counts()
        add_launches()
        recomputes = kgrad.backward_calls[recompute_key] - recomputes
        gl = [r["loss"] for r in rows]
        if not (all(math.isfinite(x) for x in gl) and gl[-1] < gl[0]):
            raise AssertionError(f"train {arch}: losses {gl} do not fall")
        if not all(math.isfinite(r["grad_norm"]) and r["grad_norm"] > 0 for r in rows):
            raise AssertionError(f"train {arch}: gradient norms {rows}")
        per_step = _loss_launches(cfg)[kernel]
        if by_route["block"] or c[kernel] != TRAIN_FIXED_STEPS * per_step:
            raise AssertionError(f"train {arch}: {c[kernel]} {kernel} launches {by_route}, want "
                                 f"{per_step} a step, none on the one-block kernel")
        emit({"phase": "train", "arch": arch, "check": "fixed_batch", "batch": [TRAIN_B, TRAIN_T],
              "remat": cfg.remat,
              "steps": rows, "median_step_ms": statistics.median(r["ms"] for r in rows[1:]),
              "launches": {kernel: c[kernel], "flash": c["flash"]},
              "launches_by_route": {kernel: by_route}, "backward_recomputes": recomputes,
              "params": sum(p.numel() for p in params.values()),
              "peak_mem_bytes": torch.cuda.max_memory_allocated() - held,
              "other_phases_bytes": held})
        del model, params, state, fixed, step
        torch.cuda.empty_cache()

    # ---- 3b. remat: the same steps at every mode, step ms and peak memory -------
    remat_rows = {}
    for arch, modes in TRAIN_REMAT:
        base = get_config(arch)
        kernel = {"dense": "flash", "rwkv": "wkv", "hybrid": "ssd"}[base.family]
        fixed = {"tokens": torch.tensor(np.random.default_rng(SEED + 2).integers(
            0, base.vocab, size=(TRAIN_B, TRAIN_T)), device=dev)}
        rows = {}
        for mode in modes:
            cfg = dataclasses.replace(base, remat=mode)
            fam = get_family(cfg)
            held = start_line()
            model = fam.init(cfg, torch.Generator(dev).manual_seed(SEED), device=dev)
            model.requires_grad_(True)
            params = dict(model.named_parameters())
            state = optim.init(params)
            step = make_train_step(cfg, optim.AdamWConfig(lr=TRAIN_LR, warmup_steps=0),
                                   TrainConfig(checkpoint_dir=tmp))
            reset()
            steps = []
            for _ in range(TRAIN_REMAT_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = step(model, state, {}, fixed)
                torch.cuda.synchronize()
                steps.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                              "ms": (time.perf_counter() - t0) * 1e3})
            c = counts()
            add_launches()
            rows[mode] = {"steps": steps, "median_step_ms_2_on": statistics.median(
                r["ms"] for r in steps[1:]), "peak_mem_bytes": torch.cuda.max_memory_allocated()
                - held, "other_phases_bytes": held,
                "launches_a_step": c[kernel] / TRAIN_REMAT_STEPS}
            del model, params, state, step, m
            torch.cuda.empty_cache()
        first = rows["none"]["steps"][0]
        for mode, row in rows.items():
            got = row["steps"][0]
            row["first_step_rel_diff"] = {
                q: abs(got[q] - first[q]) / abs(first[q]) for q in ("loss", "grad_norm")}
            row["step_ms_over_none"] = row["median_step_ms_2_on"] / rows["none"][
                "median_step_ms_2_on"]
            row["peak_over_none"] = row["peak_mem_bytes"] / rows["none"]["peak_mem_bytes"]
        remat_rows[arch] = rows
        emit({"phase": "train", "arch": arch, "check": "remat", "batch": [TRAIN_B, TRAIN_T],
              "compute_dtype": base.compute_dtype, "rtol": TRAIN_REMAT_RTOL, "modes": rows,
              "nvidia_smi": nvidia_smi()})
        for mode, row in rows.items():
            if max(row["first_step_rel_diff"].values()) > TRAIN_REMAT_RTOL:
                raise AssertionError(f"train {arch} remat={mode}: the first step's loss and "
                                     f"gradient norm {row['first_step_rel_diff']} differ from "
                                     f"remat='none''s")
            want = _loss_launches(dataclasses.replace(base, remat=mode))[kernel]
            if row["launches_a_step"] != want:
                raise AssertionError(f"train {arch} remat={mode}: {row['launches_a_step']} "
                                     f"{kernel} launches a step, not {want}")
        if "full" in rows and not rows["full"]["peak_mem_bytes"] < rows["none"]["peak_mem_bytes"]:
            raise AssertionError(f"train {arch}: the peak at remat='full' "
                                 f"({rows['full']['peak_mem_bytes']}) is not below 'none''s "
                                 f"({rows['none']['peak_mem_bytes']})")
        del fixed

    # ---- 4. each Function against autograd of its plain version, on the card -----
    def grads_of(fn, inputs, weight):
        """(output, gradients of its sum weighted by ``weight``)."""
        xs = [x.detach().clone().requires_grad_(True) for x in inputs]
        out = fn(*xs)
        out = out[0] if isinstance(out, tuple) else out
        (out.float() * weight).sum().backward()
        return out.detach(), [x.grad for x in xs]

    def timed_pair(fn, inputs, weight):
        """(forward ms with no graph, backward ms of the graph), CUDA events."""
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: fn(*inputs), 5)
        xs = [x.detach().clone().requires_grad_(True) for x in inputs]
        out = fn(*xs)
        out = out[0] if isinstance(out, tuple) else out
        g_out = weight.to(out.dtype).expand_as(out)
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, xs, g_out, retain_graph=True), 5)
        return fwd_ms, bwd_ms

    def check_function(name, via, plain, inputs, weight, must):
        """The Function's forward (the kernel) against the plain version's
        output on the same card tensors, within the kernel's limits (phase
        3's: one bfloat16 step, else KERNEL_RTOL of the largest value); its
        gradients equal to autograd of the plain version's."""
        out, got = grads_of(via, inputs, weight)
        out_plain, want = grads_of(plain, inputs, weight)
        if out.dtype == torch.bfloat16:
            fwd_err, fwd_share = check_close_bf16(f"{name} forward", out, out_plain)
        else:
            fwd_err, fwd_share = check_close(f"{name} forward", out, out_plain), None
        diffs = [float((a.double() - b.double()).abs().max()) for a, b in zip(got, want)]
        if not (all(bool(torch.isfinite(a).all()) for a in got) and max(diffs) == 0.0):
            raise AssertionError(f"{name}: the Function's gradients differ from the plain "
                                 f"version's by {diffs}")
        if must is not None:
            must(got)
        fwd_ms, bwd_ms = timed_pair(via, inputs, weight)
        return {"name": name, "forward_max_abs_err": fwd_err, "forward_bf16_share": fwd_share,
                "grad_max_abs_diff": max(diffs), "dtypes": [str(a.dtype) for a in got],
                "kernel_forward_ms": fwd_ms, "backward_ms": bwd_ms}

    rows = []
    g = torch.Generator(dev).manual_seed(SEED)
    # flash at stablelm-1.6b's training shape in both dtypes, then GQA,
    # windowed and bidirectional cases at small shapes
    for b, hq, hk, t, d, causal, window, dtype in (
            (TRAIN_B, 32, 32, TRAIN_T, 64, True, None, torch.bfloat16),
            (TRAIN_B, 32, 32, TRAIN_T, 64, True, None, torch.float32),
            (2, 8, 2, 200, 32, True, None, torch.bfloat16),
            (2, 4, 4, 192, 16, True, 48, torch.float32),
            (2, 4, 2, 150, 64, False, None, torch.bfloat16)):
        qkv = [torch.randn(b, h, t, d, generator=g, device=dev).to(dtype) for h in (hq, hk, hk)]
        w = torch.randn(b, hq, t, d, generator=g, device=dev)

        def in_dtype(got, dtype=dtype):
            if any(x.dtype != dtype for x in got):
                raise AssertionError(f"flash: gradients in {[x.dtype for x in got]}, not {dtype}")

        rows.append({"shape": [b, hq, hk, t, d, causal, window], **check_function(
            f"flash_{str(dtype)[6:]}",
            lambda q, k, v, c=causal, wd=window: ops.flash_attention(q, k, v, causal=c, window=wd),
            lambda q, k, v, c=causal, wd=window: flash_attention_ref(q, k, v, c, wd), qkv, w,
            in_dtype)})
    # wkv at RWKV6-1.6B's heads (32 x 64, chunk 64): u summed over the batch
    bw, hw, dw = TRAIN_B, 32, 64
    r, k, v = (torch.randn(bw, hw, TRAIN_T, dw, generator=g, device=dev) * 0.5 for _ in range(3))
    logw = -torch.exp(torch.randn(bw, hw, TRAIN_T, dw, generator=g, device=dev) * 0.5 - 2.0)
    u = torch.randn(hw, dw, generator=g, device=dev) * 0.1
    s0 = torch.zeros(bw, hw, dw, dw, device=dev)
    w = torch.randn(bw, hw, TRAIN_T, dw, generator=g, device=dev)

    def u_summed(got):
        if tuple(got[4].shape) != (hw, dw):
            raise AssertionError(f"wkv: u's gradient has shape {tuple(got[4].shape)}")

    def wkv_plain_flat(r, k, v, logw, u):  # ops.wkv6's layout around the plain version
        flat = lambda x: x.reshape(bw * hw, *x.shape[2:]).contiguous()  # noqa: E731
        u_full = u.expand(bw, hw, dw).reshape(bw * hw, dw).contiguous()
        o, _ = wkv6_plain(flat(r), flat(k), flat(v), flat(logw), u_full, flat(s0), 64)
        return o.reshape(bw, hw, TRAIN_T, dw)

    rows.append({"shape": [bw, hw, TRAIN_T, dw, 64], **check_function(
        "wkv6", lambda *a: ops.wkv6(*a, s0, chunk=64), wkv_plain_flat, (r, k, v, logw, u), w,
        u_summed)})
    # ssd at Zamba2-2.7B's (80 heads of 64, N = 64), B and C shared by the heads
    zc = get_config("zamba2-2.7b")
    hs, ns, ps = zc.ssm_expand * zc.d_model // zc.ssm_head_dim, zc.ssm_state, zc.ssm_head_dim
    x = torch.randn(bw, hs, TRAIN_T, ps, generator=g, device=dev) * 0.1
    bm, cm = (torch.randn(bw, TRAIN_T, ns, generator=g, device=dev) * 0.2 for _ in range(2))
    loga = -torch.rand(bw, hs, TRAIN_T, generator=g, device=dev) * 0.2
    s1 = torch.zeros(bw, hs, ns, ps, device=dev)
    w = torch.randn(bw, hs, TRAIN_T, ps, generator=g, device=dev)

    def heads(a):
        return a[:, None].expand(bw, hs, TRAIN_T, ns)

    def bc_summed(got):
        if tuple(got[1].shape) != (bw, TRAIN_T, ns):
            raise AssertionError(f"ssd: B's gradient has shape {tuple(got[1].shape)}")

    def ssd_plain_flat(x, b, c, la):  # ops.ssd's layout (B, C once a row) around the plain version
        flat = lambda a: a.reshape(bw * hs, *a.shape[2:]).contiguous()  # noqa: E731
        y, _ = ssd_plain(flat(x), heads(b)[:, 0].contiguous(), heads(c)[:, 0].contiguous(),
                         flat(la), flat(s1), 64, hs)
        return y.reshape(bw, hs, TRAIN_T, ps)

    rows.append({"shape": [bw, hs, TRAIN_T, ns, ps, 64], **check_function(
        "ssd_shared_bc", lambda x, b, c, la: ops.ssd(x, heads(b), heads(c), la, s1, chunk=64),
        ssd_plain_flat, (x, bm, cm, loga), w, bc_summed)})
    emit({"phase": "train", "check": "functions_vs_plain_autograd", "rows": rows})
    del r, k, v, logw, u, s0, x, bm, cm, loga, s1, w
    torch.cuda.empty_cache()

    # ---- 5. the restart path at stablelm-reduced ---------------------------------
    rcfg = get_config(TRAIN_ARCH, reduced=True)
    rdir = tempfile.mkdtemp(prefix="chip_smoke_restart_")
    rtc = TrainConfig(steps=TRAIN_RESTART["steps"],
                      checkpoint_every=TRAIN_RESTART["checkpoint_every"], checkpoint_dir=rdir,
                      log_every=10)
    roc = optim.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=TRAIN_RESTART["steps"])
    rdc = DataConfig(vocab=rcfg.vocab, seq_len=64, global_batch=8, noise=0.05)
    faults = []

    def fault(step):
        if step == TRAIN_RESTART["fault_at"] and not faults:
            faults.append(step)
            raise RuntimeError("simulated preemption")

    reset()
    rout, restarts = run_with_restarts(lambda: TrainLoop(rcfg, roc, rtc, rdc, fault_hook=fault))
    add_launches()
    resumed_at = rout["log"][0]["step"] - rtc.log_every
    if restarts != 1 or rout["last_step"] != TRAIN_RESTART["steps"] or resumed_at != 20:
        raise AssertionError(f"restart: {restarts} restarts, last step {rout['last_step']}, "
                             f"resumed at {resumed_at}")
    # a loop that ends where the last checkpoint is restores it and takes no step
    latest = CheckpointManager(rdir).latest_step()
    again = TrainLoop(rcfg, roc, dataclasses.replace(rtc, steps=latest), rdc).run()
    with np.load(Path(rdir) / f"step_{latest:08d}.npz") as saved:
        mism = [n for n, p in again["params"].named_parameters()
                if not np.array_equal(p.detach().cpu().numpy(), saved[f"params/{n}"])]
    if again["log"] or mism:
        raise AssertionError(f"restart: restoring step {latest} took steps or changed {mism}")
    emit({"phase": "train", "arch": rcfg.name, "check": "restart",
          "restarts": restarts, "resumed_at": resumed_at, "last_step": rout["last_step"],
          "losses": [r["loss"] for r in rout["log"]], "restored_step": latest,
          "restored_bitwise": True,
          "params_restored": sum(1 for _ in again["params"].parameters())})
    shutil.rmtree(tmp)
    shutil.rmtree(rdir)
    return launches


def _kernel_wrappers() -> dict:
    """The kernel wrappers of the distributed path, by summary name; each
    counts its launches in ``.launches``."""
    from repro_torch.kernels import bcr
    from repro_torch.kernels.btf import btf
    from repro_torch.kernels.bts import bts
    from repro_torch.kernels.fused_spike import fused_factor_spike
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv import wkv6

    return {"btf": btf, "bts": bts, "fused_factor_spike": fused_factor_spike,
            "bcr_inv_odd": bcr.inv_odd, "bcr_reduce": bcr.reduce,
            "bcr_rhs_reduce": bcr.rhs_reduce, "bcr_backsub": bcr.backsub, "wkv": wkv6, "ssd": ssd}


def _reset_launches(wrappers: dict) -> None:
    for w in wrappers.values():
        w.launches = 0
    for nm in ("wkv", "ssd"):
        wrappers[nm].by_route.update(dict.fromkeys(wrappers[nm].by_route, 0))


def _launch_counts(wrappers: dict) -> dict:
    return {nm: w.launches for nm, w in wrappers.items()}


def _dist_rank_checks(parts: dict, tag: str) -> dict:
    """btf, the fused pass, bts (R=1) and the PCR level inverse (inv_odd on
    the blocks interleaved with identity blocks) at one rank's shapes,
    against their plain versions (``check_close``): the rank's partitions
    and 2K x 2K blocks [[I, V^(b)], [W^(t), I]] from its own spike
    corners."""
    import torch

    from repro_torch.core import block_lu as bl
    from repro_torch.core.cyclic_reduction import _vinv
    from repro_torch.kernels.btf import btf
    from repro_torch.kernels.bts import bts
    from repro_torch.kernels.fused_spike import fused_factor_spike

    d, e, f, bn, cp = (parts[nm] for nm in ("d", "e", "f", "b_next", "c_prev"))
    errs = {}
    sinv, l = btf(d, e, f)
    ref = bl.btf_ref(d, e, f)
    errs["btf"] = max(check_close(f"{tag} btf sinv", sinv, ref.sinv),
                      check_close(f"{tag} btf l", l, ref.l))
    out = fused_factor_spike(d, e, f, bn, cp)
    want = bl.fused_factor_spike_padded_ref(d, e, f, bn, cp)
    errs["fused_factor_spike"] = max(check_close(f"{tag} fused {nm}", o, w) for nm, o, w in
                                     zip(("sinv", "l", "vb", "vt", "wt", "wb"), out, want))
    g = torch.Generator(device=d.device).manual_seed(SEED)
    rhs = torch.randn(d.shape[:3] + (1,), generator=g, device=d.device)
    errs["bts"] = check_close(f"{tag} bts", bts(ref.sinv, ref.l, f, rhs), bl.bts_ref(ref, rhs))
    p, k = d.shape[0], d.shape[-1]
    blocks = torch.eye(2 * k, device=d.device).repeat(p, 1, 1)
    blocks[:, :k, k:], blocks[:, k:, :k] = out[2], out[4]
    errs["bcr_inv_odd"] = check_close(f"{tag} inv_odd", _vinv(blocks, 1e-10),
                                      bl.gj_inverse(blocks, 1e-10))
    return {"shape": list(d.shape), "max_abs_err": errs}


def _message_costs(mesh, reps: int = 50) -> dict:
    """Mean microseconds of one neighbour permutation of K float32 values
    (``_shift_from_prev``) and of one 8-byte all-reduce, the ranks in step
    and nothing else running: of host tensors (gloo alone) and of card
    tensors (a host copy each way, the card shared with the other ranks)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import distributed as D

    out = {}
    for where in ("cpu", mesh.device):
        x = torch.zeros(K, device=where)
        s = torch.zeros(1, dtype=torch.float64, device=where)
        for _ in range(5):  # warm-up
            D._shift_from_prev(x, mesh)
            D.all_reduce(s, mesh)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            D._shift_from_prev(x, mesh)
        t1 = time.perf_counter()
        for _ in range(reps):
            D.all_reduce(s, mesh)
        t2 = time.perf_counter()
        out[str(torch.device(where).type)] = {"permutation_us": (t1 - t0) * 1e6 / reps,
                                               "allreduce_us": (t2 - t1) * 1e6 / reps}
    return out


def dist_solver_rank(paths: dict, runs: list, tol: float, maxiter: int) -> dict:
    """One rank of phase "distributed"'s solves, in a gloo group of ranks
    on one card: for each run (name, system, variant, P_total), this
    rank's rows and partitions of the saved band, ``build_dist_sap`` ->
    ``factor`` -> ``solve_factored``, twice (the second is timed: the
    first also loads torch's CUDA code), then one preconditioner apply to b
    and one matvec alone for their messages.  Returns each run's
    diagnostics, this rank's times, traffic, peak memory and kernel
    launches (of the timed factor and solve), the whole x and the whole
    apply on rank 0, rank 0's kernel
    checks at each split's shapes, and the bare cost of a message."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import make_test_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_test_mesh((dist.get_world_size(),), ("data",))
    wrappers = _kernel_wrappers()
    out = {"runs": {}, "checks": {}}
    for name, system, variant, p_total in runs:
        band = np.load(paths[system]["band"], mmap_mode="r")
        b = np.load(paths[system]["b"], mmap_mode="r")
        n, k = band.shape[0], (band.shape[1] - 1) // 2
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches(wrappers)
            D.reset_comm_stats()
            t0 = time.perf_counter()
            dsap = D.build_dist_sap(mesh, n, k, variant=variant,
                                    p_per_device=p_total // mesh.size, band=band)
            band_l, b_l, parts = dsap.shard_band(band, b)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            setup_comm = D.comm_stats()
            D.reset_comm_stats()
            state = dsap.factor(**parts)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            fac_counts, fac_comm = _launch_counts(wrappers), D.comm_stats()
            D.reset_comm_stats()
            res = D.solve_factored(dsap, state, band_l, b_l, parts["b_next"], parts["c_prev"],
                                   tol, maxiter)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            solve_comm = D.comm_stats()
            solve_counts = {nm: c - fac_counts[nm] for nm, c in _launch_counts(wrappers).items()}
            peak = torch.cuda.max_memory_allocated()
            D.reset_comm_stats()
            rb = b_l.reshape(dsap.p_local, dsap.m, k, 1).float().contiguous()
            z = dsap.precond(state, parts["b_next"], parts["c_prev"], rb)
            apply_comm = D.comm_stats()
            D.reset_comm_stats()
            dsap.matvec(band_l, b_l[:, None])
            matvec_comm = D.comm_stats()
        x = D.gather_x(res.x, mesh, n)
        z = D.gather_x(z.reshape(-1), mesh, n)
        line = {
            "variant": dsap.variant, "d_factor": dsap.d_factor, "p_local": dsap.p_local,
            "m": dsap.m, "iterations": float(res.iterations), "resnorm": float(res.resnorm),
            "converged": bool(res.converged), "true_resnorm": float(res.true_resnorm),
            "setup_ms": (t1 - t0) * 1e3, "factor_ms": (t2 - t1) * 1e3, "solve_ms": (t3 - t2) * 1e3,
            "comm": {"setup": setup_comm, "factor": fac_comm, "solve": solve_comm,
                     "apply": apply_comm, "matvec": matvec_comm},
            "peak_mem_bytes": peak, "launches_factor": fac_counts, "launches_solve": solve_counts,
        }
        if mesh.rank == 0:
            line["x"], line["z"] = x.cpu(), z.cpu()
            tag = f"p{p_total}"
            if tag not in out["checks"]:
                out["checks"][tag] = _dist_rank_checks(parts, f"distributed {tag} rank 0")
        out["runs"][name] = line
        del dsap, band_l, b_l, parts, state, res, x, z
        torch.cuda.empty_cache()
    out["message_costs"] = _message_costs(mesh)
    return out


def dist_nccl_rank(paths: dict, p_total: int, tol: float, maxiter: int) -> dict:
    """The C solve of ``paths`` (full()) at ``p_total`` partitions in an
    NCCL group of one rank, with the dominance estimate reduced over the
    group: x, sweeps, true residual, d, ms and the traffic."""
    import numpy as np
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import make_test_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_test_mesh((1,), ("data",))
    band = torch.from_numpy(np.load(paths["band"])).to(mesh.device)
    b = torch.from_numpy(np.load(paths["b"])).to(mesh.device)
    n, k = band.shape[0], (band.shape[1] - 1) // 2
    d = float(D.dist_diag_dominance_factor(mesh, band))
    dsap = D.build_dist_sap(mesh, n, k, "C", p_total)
    band_l, b_l, parts = dsap.shard_band(band, b)
    D.reset_comm_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = D.solve_step_fn(dsap, tol, maxiter)(band_l, b_l, *parts.values())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    comm = D.comm_stats()
    return {"x": D.gather_x(res.x, mesh, n).cpu(), "iterations": float(res.iterations),
            "true_resnorm": float(res.true_resnorm), "d_factor": d, "ms": ms, "comm": comm}


def dist_scan_rank(shapes: dict, seed: int, weak: float) -> dict:
    """One rank of phase "distributed"'s sequence-parallel scans: the
    whole inputs made on the card from ``seed`` (normal; decays
    -exp(0.5 normal)), this rank's slice of T through ``sp_ssd`` /
    ``sp_wkv6`` (twice, the second timed), then the single-rank kernel
    call at the full T on this process as the reference for this rank's
    slice of the output and, on the last rank, the final state; rank 0
    also holds the kernel against its plain version at the rank's shape.
    Then the same inputs with the decays scaled by ``weak`` (a shard's
    total decay O(1), so the whole carry chain reaches the result), once,
    against the single-rank call."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import distributed as D
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd import ssd_plain
    from repro_torch.kernels.wkv import wkv6_plain
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.sequence_parallel import sp_ssd, sp_wkv6

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_test_mesh((dist.get_world_size(),), ("data",))
    dev = mesh.device
    wrappers = _kernel_wrappers()
    out = {}
    for scan, dims in shapes.items():
        g = torch.Generator(device=dev).manual_seed(seed)
        bsz, h, t = dims[:3]

        def rn(*s):
            return torch.randn(*s, generator=g, device=dev)

        if scan == "ssd":
            n, p = dims[3:]
            x, bm, cm = rn(bsz, h, t, p), rn(bsz, h, t, n), rn(bsz, h, t, n)
            la = -torch.exp(0.5 * rn(bsz, h, t))
            seq, extra, fn = (x, bm, cm, la), (), sp_ssd(mesh)
        else:
            d = dims[3]
            r, k, v = rn(bsz, h, t, d), rn(bsz, h, t, d), rn(bsz, h, t, d)
            lw = -torch.exp(0.5 * rn(bsz, h, t, d))
            seq, extra, fn = (r, k, v, lw), (rn(h, d),), sp_wkv6(mesh)
        t_loc = t // mesh.size
        sl = slice(mesh.rank * t_loc, (mesh.rank + 1) * t_loc)
        loc = tuple(a[:, :, sl].contiguous() for a in seq) + extra
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches(wrappers)
            D.reset_comm_stats()
            t0 = time.perf_counter()
            y, s = fn(*loc)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        line = {"ms": ms, "comm": D.comm_stats(), "launches": _launch_counts(wrappers)[scan],
                "by_route": dict(wrappers[scan].by_route), "t_local": t_loc,
                "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        state0 = torch.zeros((bsz, h) + ((dims[3], dims[4]) if scan == "ssd" else (d, d)),
                             device=dev)
        kern = ops.ssd if scan == "ssd" else ops.wkv6
        y_ref, s_ref = kern(*seq, *extra, state0)
        line["max_abs_err_output"] = check_close(f"distributed {scan} rank {mesh.rank} output",
                                                 y, y_ref[:, :, sl])
        if mesh.rank == mesh.size - 1:
            line["max_abs_err_state"] = check_close(f"distributed {scan} final state", s[0], s_ref)
        if mesh.rank == 0:  # the kernel against its plain version at this rank's shape
            flat = [a.reshape(bsz * h, t_loc, -1) for a in loc[:4]]
            zeros = state0.reshape(bsz * h, *state0.shape[2:])
            if scan == "ssd":
                args = (flat[0], flat[1], flat[2], flat[3][..., 0], zeros)
                got, want = wrappers["ssd"](*args), ssd_plain(*args)
            else:
                u_rows = extra[0].expand(bsz, h, -1).reshape(bsz * h, -1).contiguous()
                args = (*flat, u_rows, zeros)
                got, want = wrappers["wkv"](*args), wkv6_plain(*args)
            line["kernel_vs_plain"] = {
                "shape": [bsz * h, t_loc] + list(loc[0].shape[3:]),
                "max_abs_err": max(check_close(f"distributed {scan} kernel {nm}", o, w)
                                   for nm, o, w in zip(("output", "state"), got, want))}
            del got, want, args
        del y, s, y_ref, s_ref
        seq = seq[:3] + (seq[3] * weak,)
        loc = loc[:3] + (loc[3] * weak,) + extra
        line["weak_shard_decay"] = [float(v) for v in torch.aminmax(torch.exp(loc[3].sum(dim=2)))]
        y, s = fn(*loc)
        y_ref, s_ref = kern(*seq, *extra, state0)
        line["weak_max_abs_err_output"] = check_close(
            f"distributed {scan} weak decay rank {mesh.rank} output", y, y_ref[:, :, sl])
        line["weak_err_of_max_output"] = rel_err(y, y_ref[:, :, sl])[1]
        if mesh.rank == mesh.size - 1:
            line["weak_max_abs_err_state"] = check_close(
                f"distributed {scan} weak decay final state", s[0], s_ref)
            line["weak_err_of_max_state"] = rel_err(s[0], s_ref)[1]
        out[scan] = line
        del seq, loc, y, s, y_ref, s_ref
        torch.cuda.empty_cache()
    return out


def distributed_phase(dev, smi, systems, xstar, coupling) -> dict:
    """Phase "distributed": the solver and the SaP-scans split over
    DIST_RANKS ranks of one gloo group on the card (four processes
    time-sharing cuda:0; no time here is a scaling result), and the solver
    in an NCCL group of one rank.  ``systems`` maps "d1.0" / "d0.5" to
    phase 4's (float32 band, float64 b) on the card (full() and exact()),
    ``xstar`` is their solution, ``coupling`` phase 3's largest |D|, |E|,
    |F| of the P=64 and P=500 interface chains of the d=0.5 band.  Returns
    the kernel launches of the ranks' timed runs, by summary name."""
    import os

    import numpy as np
    import torch

    from repro_torch.configs import get_config, sap_solver
    from repro_torch.core import SaPOptions, band_matvec, factor, plan_banded
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models.api import SHAPES

    t_phase = time.perf_counter()
    full, exact = sap_solver.full(), sap_solver.exact()
    assert (full.n, full.k, full.d, exact.n, exact.k, exact.d) == (N, K, 1.0, N, K, 0.5)
    band_dom = systems["d1.0"][0].clone()
    band_dom[:, K] *= DIST_DOMINANT
    sysmap = {"full": systems["d1.0"], "exact": systems["d0.5"],
              "dominant": (band_dom, band_matvec(band_dom.double(), xstar))}
    runs = [("D", "full", "D", DIST_P), ("C", "full", "C", DIST_P),
            ("auto_full", "full", "auto", DIST_P), ("E_p64", "exact", "E", DIST_P),
            ("E_p500", "exact", "E", DIST_P500), ("auto_exact", "exact", "auto", DIST_P),
            ("auto_dominant", "dominant", "auto", DIST_P)]
    note = f"{DIST_RANKS} ranks time-share one card: no time here is a scaling result"

    # single-process solves of the same variants and partition counts
    single = {}
    for name, sysname, variant, p in runs:
        band, b64 = sysmap[sysname]
        opts = SaPOptions(p=p, variant=variant, tol=DIST_TOL, maxiter=MAXITER,
                          precond_dtype="float32")
        fac = factor(plan_banded(band, opts))
        res = fac.solve(b64)
        b_pad = torch.zeros(fac.n_pad, 1, dtype=b64.dtype, device=dev)
        b_pad[:N, 0] = b64
        single[name] = {"variant": fac.variant, "reduced_solver": fac.pc.reduced_solver,
                        "d_factor": float(fac.d_factor), "iterations": float(res.iterations),
                        "true_resnorm": float(res.true_resnorm), "x": res.x,
                        "z": fac.pc.apply(b_pad)[:N, 0]}
        del fac, res, b_pad
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_distributed_")
    launches = dict.fromkeys(_kernel_wrappers(), 0)
    try:
        paths = {}
        for sysname, (band, b64) in sysmap.items():
            paths[sysname] = {"band": os.path.join(tmp, f"{sysname}_band.npy"),
                              "b": os.path.join(tmp, f"{sysname}_b.npy")}
            np.save(paths[sysname]["band"], band.cpu().numpy())
            np.save(paths[sysname]["b"], b64.cpu().numpy())
        build.build_all()  # every library in place: the ranks load, none compiles
        t0 = time.perf_counter()
        ranks = spawn_ranks(dist_solver_rank, DIST_RANKS,
                            args=(paths, runs, DIST_TOL, MAXITER), timeout=DIST_TIMEOUT_S)
        solver_s = time.perf_counter() - t0
        its = {}
        for name, sysname, variant, p in runs:
            band, b64 = sysmap[sysname]
            per = [r["runs"][name] for r in ranks]
            got, ref = per[0], single[name]
            x = got["x"].to(dev)
            resid = float((b64 - band_matvec(band.double(), x)).norm() / b64.norm())
            xdiff = float((x - ref["x"]).norm() / ref["x"].norm())
            zdiff = rel_err(got["z"].to(dev), ref["z"])[1]
            for r in per:
                for nm in launches:
                    launches[nm] += r["launches_factor"][nm] + r["launches_solve"][nm]
            comm = {stage: {key: [r["comm"][stage][key] for r in per]
                            for key in ("permutations", "messages", "bytes", "allreduces",
                                        "allreduce_bytes", "seconds")}
                    for stage in ("setup", "factor", "solve", "apply", "matvec")}
            line = {
                "phase": "distributed", "run": name, "system": sysname, "ranks": DIST_RANKS,
                "backend": "gloo", "device": "cuda:0", "n": N, "k": K,
                "variant_requested": variant, "variant": got["variant"], "p_total": p,
                "p_local": got["p_local"], "m": got["m"], "tol": DIST_TOL,
                "iterations": got["iterations"], "iterations_single": ref["iterations"],
                "converged": got["converged"], "resnorm": got["resnorm"],
                "true_resnorm_f64": resid, "true_resnorm_solver": got["true_resnorm"],
                "true_resnorm_single": ref["true_resnorm"], "x_rel_diff_vs_single": xdiff,
                "apply_diff_of_max_vs_single": zdiff, "forward_error": float((x - xstar).norm() / xstar.norm()),
                "single": {"variant": ref["variant"], "reduced_solver": ref["reduced_solver"]},
                "d_factor": got["d_factor"], "d_factor_single": ref["d_factor"],
                "setup_ms": [r["setup_ms"] for r in per],
                "factor_ms": [r["factor_ms"] for r in per],
                "solve_ms": [r["solve_ms"] for r in per],
                "message_share_of_solve": [r["comm"]["solve"]["seconds"] * 1e3 / r["solve_ms"]
                                           for r in per],
                "comm": comm, "peak_mem_bytes": [r["peak_mem_bytes"] for r in per],
                "launches_factor": [r["launches_factor"] for r in per],
                "launches_solve": [r["launches_solve"] for r in per],
                "note": note, "nvidia_smi": smi,
            }
            if got["variant"] == "E":
                line["chain_coupling"] = coupling["p500" if p == DIST_P500 else "p64"]
            emit(line)
            its[name] = got["iterations"]
            if not bool(torch.isfinite(x).all()) or x.shape != xstar.shape:
                raise AssertionError(f"distributed {name}: bad solution")
            if got["variant"] != ref["variant"]:
                raise AssertionError(f"distributed {name}: variant {got['variant']!r}, the "
                                     f"single-process factor's {ref['variant']!r}")
            if variant == "auto" and abs(got["d_factor"] - ref["d_factor"]) > 1e-6:
                raise AssertionError(f"distributed {name}: d {got['d_factor']} against the "
                                     f"single-process {ref['d_factor']}")
            if resid > 1e-6 or xdiff > DIST_XTOL:
                raise AssertionError(f"distributed {name}: true_resnorm {resid:.3e}, x "
                                     f"{xdiff:.3e} from the single-process solve")
            if abs(got["iterations"] - ref["iterations"]) > DIST_SWEEPS:
                raise AssertionError(f"distributed {name}: {got['iterations']} sweeps, the "
                                     f"single-process solve {ref['iterations']}")
            if zdiff > DIST_ZTOL:
                raise AssertionError(f"distributed {name}: a preconditioner apply {zdiff:.3e} "
                                     f"of its largest value from the single process's")
            must = {"D": ("btf", "bts"), "C": ("fused_factor_spike", "bts", "btf"),
                    "E": ("fused_factor_spike", "bts", "bcr_inv_odd")}[got["variant"]]
            for r in per:
                for nm in must:
                    if r["launches_factor"][nm] + r["launches_solve"][nm] == 0:
                        raise AssertionError(f"distributed {name}: a rank never launched {nm}")
        if its["C"] > its["D"]:
            raise AssertionError(f"distributed: C took {its['C']} sweeps, D {its['D']}")
        if its["E_p500"] > single["E_p500"]["iterations"] + 1:
            raise AssertionError(f"distributed: E at P={DIST_P500} took {its['E_p500']} sweeps")
        if ranks[0]["runs"]["auto_exact"]["variant"] != "E":
            raise AssertionError("distributed: auto on exact() did not pick E")
        if ranks[0]["runs"]["auto_dominant"]["variant"] != "C":
            raise AssertionError(f"distributed: auto at d = {DIST_DOMINANT} did not pick C")
        emit({"phase": "distributed", "check": "kernels_at_rank_shapes",
              "rtol_normwise": KERNEL_RTOL, "rank0": ranks[0]["checks"], "seconds": solver_s,
              # what the couplings change in an apply: the scale of what a
              # broken exchange would leave out, against DIST_ZTOL
              "apply_C_vs_D_of_max": rel_err(single["C"]["z"], single["D"]["z"])[1]})
        emit({"phase": "distributed", "check": "message_costs", "ranks": DIST_RANKS,
              "backend": "gloo", "by_rank": [r["message_costs"] for r in ranks], "note": note,
              "nvidia_smi": smi})

        # the same C solve in an NCCL group of one rank (a child process:
        # this one never joins a group): the dominance all-reduce runs on
        # the card's buffers, and every shift is empty
        nccl = spawn_ranks(dist_nccl_rank, 1, backend="nccl",
                           args=(paths["full"], DIST_P, DIST_TOL, MAXITER),
                           timeout=DIST_TIMEOUT_S)[0]
        x, comm, d_rank = nccl["x"].to(dev), nccl["comm"], nccl["d_factor"]
        xdiff = float((x - single["C"]["x"]).norm() / single["C"]["x"].norm())
        emit({"phase": "distributed", "run": "C_nccl_one_rank", "backend": "nccl", "ranks": 1,
              "p_total": DIST_P, "iterations": nccl["iterations"],
              "iterations_single": single["C"]["iterations"],
              "true_resnorm_solver": nccl["true_resnorm"], "x_rel_diff_vs_single": xdiff,
              "d_factor": d_rank, "d_factor_single": single["C"]["d_factor"],
              "factor_and_solve_ms": nccl["ms"], "comm": comm, "nvidia_smi": smi})
        if xdiff > DIST_NCCL_XTOL or comm["permutations"] or not comm["allreduces"]:
            raise AssertionError(f"distributed NCCL: x {xdiff:.3e} from the single-process C, "
                                 f"traffic {comm}")
        if abs(d_rank - single["C"]["d_factor"]) > 1e-6:
            raise AssertionError(f"distributed NCCL: d {d_rank} against {single['C']['d_factor']}")
        del nccl, x
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del single, band_dom, sysmap
    torch.cuda.empty_cache()

    # the SaP-scans at the published head shapes, T split over the ranks
    zcfg, rcfg = get_config("zamba2-2.7b"), get_config("rwkv6-1.6b")
    t_seq = SHAPES["prefill_32k"].seq_len
    shapes = {"ssd": (1, zcfg.ssm_expand * zcfg.d_model // zcfg.ssm_head_dim, t_seq,
                      zcfg.ssm_state, zcfg.ssm_head_dim),
              "wkv": (1, rcfg.d_model // rcfg.rwkv_head_dim, t_seq, rcfg.rwkv_head_dim)}
    t0 = time.perf_counter()
    scans = spawn_ranks(dist_scan_rank, DIST_RANKS, args=(shapes, SEED, SCAN_WEAK_DECAY),
                        timeout=DIST_TIMEOUT_S)
    for scan, dims in shapes.items():
        per = [r[scan] for r in scans]
        emit({"phase": "distributed", "scan": scan,
              "arch": zcfg.name if scan == "ssd" else rcfg.name, "shape": list(dims),
              "ranks": DIST_RANKS, "backend": "gloo", "chunk": 64,
              "t_local": per[0]["t_local"], "ms": [r["ms"] for r in per],
              "routes": [r["by_route"] for r in per],
              "max_abs_err_output": [r["max_abs_err_output"] for r in per],
              "max_abs_err_state": per[-1]["max_abs_err_state"],
              "weak_decay_scale": SCAN_WEAK_DECAY,
              "weak_shard_decay_min_max": [r["weak_shard_decay"] for r in per],
              "weak_max_abs_err_output": [r["weak_max_abs_err_output"] for r in per],
              "weak_max_abs_err_state": per[-1]["weak_max_abs_err_state"],
              "weak_err_of_max_output": [r["weak_err_of_max_output"] for r in per],
              "weak_err_of_max_state": per[-1]["weak_err_of_max_state"],
              "rtol_normwise": KERNEL_RTOL, "kernel_vs_plain": per[0]["kernel_vs_plain"],
              "messages": [r["comm"]["messages"] for r in per],
              "bytes": [r["comm"]["bytes"] for r in per],
              "message_seconds": [r["comm"]["seconds"] for r in per],
              "peak_mem_bytes": [r["peak_mem_bytes"] for r in per], "note": note,
              "nvidia_smi": smi, "seconds": time.perf_counter() - t0})
        for r in per:
            launches[scan] += r["launches"]
            if r["launches"] != 1 or r["by_route"]["split"] != 1:
                raise AssertionError(f"distributed {scan}: a shard took {r['by_route']}, "
                                     f"not one launch on the split route")
    emit({"phase": "distributed", "seconds": time.perf_counter() - t_phase,
          "launches": launches})
    return launches


def _leaf_norm(t, spec, mesh) -> float:
    """The norm of a whole parameter-shaped tensor from this rank's block:
    squares summed over "model" where the spec splits the leaf there."""
    import torch

    from repro_torch.core.distributed import all_reduce_axis
    from repro_torch.launch.sharding import spec_axes

    sq = t.detach().float().pow(2).sum().reshape(1)
    if "model" in spec_axes(spec):
        sq = all_reduce_axis(sq, mesh, "model")
    return float(torch.sqrt(sq))


def local_head_checks(dev) -> list:
    """flash, WKV6 and SSD at the shapes one rank of phase "sharded" gives
    them (half the heads of B/2 = 4 rows: stablelm-1.6b 16 of 32 heads in
    bfloat16, rwkv6-1.6b 16 of 32, zamba2-2.7b 40 of 80 with B and C
    shared, T=256; the MoE and whisper jobs' heads in float32) against
    their plain versions, phase 3's limits."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.kernels.ssd import ssd_plain
    from repro_torch.kernels.wkv import wkv6_plain

    g = torch.Generator(device=dev).manual_seed(SEED)
    rn = lambda *sh: torch.randn(*sh, generator=g, device=dev)  # noqa: E731
    rows = []
    q, k, v = (rn(SHARD_B // 2, 16, SHARD_T, 64).to(torch.bfloat16) for _ in range(3))
    err, share = check_close_bf16("sharded flash", ops.flash_attention(q, k, v, causal=True),
                                  flash_attention_ref(q, k, v, causal=True))
    rows.append({"kernel": "flash", "shape": [SHARD_B // 2, 16, SHARD_T, 64], "dtype": "bfloat16",
                 "max_abs_err": err, "bf16_step_share": share})
    # float32, the MoE and whisper jobs' local heads: deepseek-moe-16b 8 of
    # 16, mixtral-8x22b 24 of 48 over 4 of 8 KV heads in its window,
    # whisper-medium's encoder (8 of 16, T = 1,500, bidirectional) and its
    # decoder's cross-attention (256 queries to 1,500 keys)
    for job, (hq, hk, tq, tk, d, causal, window) in (
            ("deepseek-moe-16b", (8, 8, SHARD_T, SHARD_T, 128, True, None)),
            ("mixtral-8x22b", (24, 4, SHARD_T, SHARD_T, 128, True, 4096)),
            ("whisper-medium encoder", (8, 8, 1500, 1500, 64, False, None)),
            ("whisper-medium cross", (8, 8, SHARD_T, 1500, 64, False, None))):
        q = rn(SHARD_B // 2, hq, tq, d)
        k, v = rn(SHARD_B // 2, hk, tk, d), rn(SHARD_B // 2, hk, tk, d)
        err = check_close(f"sharded flash {job}",
                          ops.flash_attention(q, k, v, causal=causal, window=window),
                          flash_attention_ref(q, k, v, causal=causal, window=window))
        rows.append({"kernel": "flash", "job": job, "dtype": "float32",
                     "shape": [SHARD_B // 2, hq, hk, tq, tk, d, causal, window],
                     "max_abs_err": err})
    r, kk, vv = (rn(SHARD_B // 2, 16, SHARD_T, 64) for _ in range(3))
    lw = -torch.exp(0.5 * rn(SHARD_B // 2, 16, SHARD_T, 64))
    u, s0 = rn(16, 64), torch.zeros(SHARD_B // 2, 16, 64, 64, device=dev)
    chunk = min(64, SHARD_T)
    got = ops.wkv6(r, kk, vv, lw, u, s0, chunk=chunk)
    flat = lambda t: t.reshape(-1, *t.shape[2:])  # noqa: E731
    want = wkv6_plain(flat(r), flat(kk), flat(vv), flat(lw), u.repeat(SHARD_B // 2, 1), flat(s0),
                      chunk)
    rows.append({"kernel": "wkv", "shape": [SHARD_B // 2, 16, SHARD_T, 64],
                 "max_abs_err": max(check_close("sharded wkv", flat(a), b)
                                    for a, b in zip(got, want))})
    x = rn(SHARD_B // 2, 40, SHARD_T, 64)
    bm, cm = rn(SHARD_B // 2, 1, SHARD_T, 64), rn(SHARD_B // 2, 1, SHARD_T, 64)
    la = -torch.exp(0.5 * rn(SHARD_B // 2, 40, SHARD_T))
    s0 = torch.zeros(SHARD_B // 2, 40, 64, 64, device=dev)
    got = ops.ssd(x, bm.expand(-1, 40, -1, -1), cm.expand(-1, 40, -1, -1), la, s0, chunk=chunk)
    want = ssd_plain(flat(x), flat(bm), flat(cm), flat(la), flat(s0), chunk, hshare=40)
    rows.append({"kernel": "ssd", "shape": [SHARD_B // 2, 40, SHARD_T, 64, 64], "hshare": 40,
                 "max_abs_err": max(check_close("sharded ssd", flat(a), b)
                                    for a, b in zip(got, want))})
    return rows


def _sharded_config(job: dict):
    """A phase "sharded" job's configuration: the published one at the
    job's depth and compute dtype."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(job["arch"])
    if job["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=job["layers"])
    if job["layers"] and cfg.family == "encdec":  # the encoder's depth too
        cfg = dataclasses.replace(cfg, n_enc_layers=job["layers"])
    return dataclasses.replace(cfg, compute_dtype=job["dtype"])


class _RankZero:
    """SHARD_MESH's shape and rank 0's place in it, as ``local_shard`` and
    the families' ``param_pspecs`` read a mesh."""

    shape = dict(zip(("data", "model"), SHARD_MESH))

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes)

    def axis_index(self, axes, rank=None) -> int:
        return 0


def _block_sample(t):
    """SHARD_SAMPLE evenly strided elements of ``t`` (all of a smaller
    one), float32 on the host."""
    flat = t.detach().reshape(-1)
    k = min(flat.numel(), SHARD_SAMPLE)
    stride = flat.numel() // k
    return flat[: stride * k : stride].float().cpu()


def _rel_l2(got, want) -> float:
    """||got - want|| / ||want|| (0 where both are 0)."""
    den = float(want.double().norm())
    num = float((got.double() - want.double()).norm())
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def _zero1_stale(cfg, local, p0: dict, mesh) -> None:
    """Planted fault: every ZeRO-1-sliced leaf's slices of the other data
    ranks set back to their values before the step, as if the gather after
    the update had been left out."""
    import torch

    from repro_torch.train.loop import zero1_dims

    dims = zero1_dims(cfg, local, mesh, True)
    n_data, mine = mesh.shape["data"], mesh.axis_index(("data",))
    with torch.no_grad():
        for name, p in local.named_parameters():
            d = dims[name]
            if d is None:
                continue
            w = p.shape[d] // n_data
            for j in range(n_data):
                if j != mine:
                    p.narrow(d, j * w, w).copy_(p0[name].narrow(d, j * w, w))


class _RoutesRecorded:
    """Each MoE layer's top-k expert indices (a host int tensor (NG, G, k)
    per call of ``moe.route``) while the context is open."""

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.plain, self.routes = moe, moe.route, []

        def route(*args):
            got = self.plain(*args)
            self.routes.append(got[3].detach().to("cpu", copy=True))
            return got

        moe.route = route
        return self.routes

    def __exit__(self, *exc):
        self.moe.route = self.plain


class _ScalesRecorded:
    """Each int8 scale the round trip quantizes with (a float a gradient
    tensor, in ``compress_tree``'s order) while the context is open, by
    the JAX leaf of the tensor (``leaf_key``): the whole leaf's scale."""

    def __init__(self, names):
        from repro_torch.optim import compress

        groups: dict = {}
        for n in names:
            groups.setdefault(compress.leaf_key(n), []).append(n)
        self.order = [k for k, ns in groups.items() for _ in ns]
        self.compress = compress

    def __enter__(self):
        self.plain, self.seen = self.compress._quantize, []

        def quantize(g32, scale):
            self.seen.append(float(scale))
            return self.plain(g32, scale)

        self.compress._quantize = quantize
        self.scales = {}
        return self.scales

    def __exit__(self, *exc):
        self.compress._quantize = self.plain
        self.scales.update(zip(self.order, self.seen))


def _job_batch(cfg, job: dict, dev, mesh=None) -> dict:
    """A job's batch on the card: its tokens and, for whisper, frames drawn
    from SEED + 7 on the card (the same on every process); with ``mesh``
    the rank's block of each (``batch_pspecs``)."""
    import torch

    from repro_torch.launch.sharding import local_shard
    from repro_torch.models import get_family
    from repro_torch.models.api import ShapeSpec

    batch = {"tokens": torch.from_numpy(job["tokens"]).to(dev)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(SHARD_B, cfg.enc_seq, cfg.d_model, device=dev,
                                      generator=torch.Generator(dev).manual_seed(SEED + 7))
    if mesh is None:
        return batch
    spec = get_family(cfg).batch_pspecs(cfg, ShapeSpec("sharded", SHARD_T, SHARD_B, "train"),
                                        mesh)
    return {k: local_shard(v, spec[k], mesh) for k, v in batch.items()}


def _loss_launches(cfg) -> dict:
    """The launches one loss and gradient must make of its family's kernel
    (a rank's, or the single process's): one a layer, twice under
    ``remat`` (the backward replays each layer's forward); whisper's
    encoder layers once, its decoder layers twice (self and cross);
    Zamba2's shared attention outside the replay is not counted."""
    rep = 1 if cfg.remat == "none" else 2
    if cfg.family in ("dense", "moe"):
        return {"flash": rep * cfg.n_layers}
    if cfg.family == "encdec":
        return {"flash": rep * (cfg.n_enc_layers + 2 * cfg.n_layers)}
    return {"wkv" if cfg.family == "rwkv" else "ssd": rep * cfg.n_layers}


def sharded_rank(jobs: list, seed: int) -> dict:
    """One rank of phase "sharded" on a SHARD_MESH ("data", "model") mesh of
    gloo ranks on the card: for each job, the whole model from ``seed``
    on the card, one rank at a time, cut to this rank's blocks
    (``shard_model``) and freed; the sharded loss and gradient of this
    rank's rows (host clock after a sync), the launches of flash / wkv /
    ssd in it, every leaf's gradient norm, the messages and bytes by kind
    and axis, and for a MoE job the aux term (averaged over "data") and
    the routes; with steps, ZeRO-1 train steps (the first under
    ``step_stats``, the second timed), each leaf's update norm after each,
    then a compressed ZeRO-1 step from the same weights; the planted faults
    of the job from the same weights; the peak memory.  Rank 0 also
    returns the samples of its blocks (gradients, updates) and holds the
    kernels at its local-head shapes against their plain versions."""

    import torch
    import torch.distributed as dist

    from repro_torch import optim
    from repro_torch.core import distributed as D
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv import wkv6
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.roofline import step_stats
    from repro_torch.models import get_family, moe, sharded
    from repro_torch.train import loop
    from repro_torch.train.loop import (TrainConfig, init_sharded_error_state,
                                        init_sharded_opt_state, make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_test_mesh(SHARD_MESH, ("data", "model"))
    dev = mesh.device
    wrappers = {"flash": flash_attention, "wkv": wkv6, "ssd": ssd}
    rank0 = mesh.rank == 0

    def timed(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    out = {"coords": mesh.coords()}
    for job in jobs:
        t_job = time.perf_counter()
        cfg = _sharded_config(job)
        fam = get_family(cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        for r in range(mesh.size):  # one whole model on the card at a time
            if mesh.rank == r:
                whole = fam.init(cfg, torch.Generator(dev).manual_seed(seed))
                local = sharded.shard_model(cfg, whole, mesh)
                del whole
                torch.cuda.empty_cache()
            dist.barrier()
        specs = sharded.param_specs(cfg, mesh)
        batch = _job_batch(cfg, job, dev, mesh)
        is_moe = cfg.family == "moe"

        def grad_record(loss, grads, routes=None):
            rec = {"loss": float(loss),
                   "grad_norms": {n: _leaf_norm(g, specs[n], mesh) for n, g in grads.items()},
                   "grad_samples": ({n: _block_sample(g) for n, g in grads.items()}
                                    if rank0 else None)}
            if is_moe:
                with torch.no_grad():
                    aux = fam.loss(cfg, local, batch, mesh=mesh)[1]["aux"].reshape(1)
                rec["aux"] = float(D.all_reduce_axis(aux, mesh, "data") / mesh.shape["data"])
                rec["routes"] = routes
            return rec

        def update_record(p0):
            norms, samples = {}, {}
            for n, p in local.named_parameters():
                d = p.detach() - p0[n].to(dev)
                norms[n] = _leaf_norm(d, specs[n], mesh)
                samples[n] = _block_sample(d)
            return norms, samples if rank0 else None

        def new_step(compress=False):
            state = init_sharded_opt_state(cfg, local, mesh, zero1=True)
            step = make_train_step(cfg, optim.AdamWConfig(lr=SHARD_LR, warmup_steps=0),
                                   TrainConfig(zero1=True, grad_compress=compress), mesh=mesh)
            return state, step

        def restore():
            with torch.no_grad():
                for n, p in local.named_parameters():
                    p.copy_(p0[n])

        def compressed_step():
            """One compressed ZeRO-1 step from p0: metrics, updates and
            each leaf's error norm."""
            restore()
            torch.cuda.empty_cache()
            state, step = new_step(compress=True)
            err = init_sharded_error_state(cfg, local, mesh)
            with _ScalesRecorded(err) as scales:
                m = step(local, state, err, batch)
            un = update_record(p0)
            return {"step_losses": [float(m["loss"])], "step_grad_norms": [float(m["grad_norm"])],
                    "update_norms": [un[0]], "update_samples": [un[1]], "scales": scales,
                    "err_norms": {n: _leaf_norm(e, specs[n], mesh) for n, e in err.items()}}

        for w in wrappers.values():
            w.launches = 0
        D.reset_comm_stats()
        with _RoutesRecorded() as routes:
            (loss, grads), grad_s = timed(lambda: sharded.value_and_grad(cfg, local, batch, mesh))
        rec = {"grad_s": grad_s, "launches": {nm: w.launches for nm, w in wrappers.items()},
               "comm": D.comm_stats()["by_axis"],
               # the forward's routes; a remat replay routes the layers again
               **grad_record(loss, grads, routes[:cfg.n_layers]),
               "local_param_bytes": sum(p.numel() * p.element_size() for p in local.parameters())}
        del grads
        p0 = ({n: p.detach().to("cpu", copy=True) for n, p in local.named_parameters()}
              if job["steps"] or job["faults"] else None)
        rec["faults"] = {}
        if job["steps"]:
            state, step = new_step()
            obytes = sum(t.numel() * 4 for t in [*state.m.values(), *state.v.values()])
            for w in wrappers.values():
                w.launches = 0
            (m1, stats), step1_s = timed(lambda: step_stats(
                lambda: step(local, state, {}, batch), rec["local_param_bytes"], obytes))
            u1 = update_record(p0)
            D.reset_comm_stats()
            m2, step_s = timed(lambda: step(local, state, {}, batch))
            step_comm = D.comm_stats()["by_axis"]
            u2 = update_record(p0)
            metrics = [m1, m2]
            rec.update({
                "step_losses": [float(m["loss"]) for m in metrics],
                "step_grad_norms": [float(m["grad_norm"]) for m in metrics],
                "step1_counted_s": step1_s, "step_s": step_s, "stats": stats,
                "step_comm": step_comm, "opt_state_bytes": obytes,
                "step_launches": {nm: w.launches for nm, w in wrappers.items()},
                "update_norms": [u1[0], u2[0]], "update_samples": [u1[1], u2[1]]})
            del state, step, metrics
            rec["compress"] = compressed_step()
        if "grad_left_out" in job["faults"]:  # a data rank's gradient left out of the average
            restore()
            orig = sharded.reduce_grads

            def left_out(grads_, mesh_, axes):
                if mesh_.axis_index(("data",)) == 1:
                    for g in grads_.values():
                        g.zero_()
                orig(grads_, mesh_, axes)

            sharded.reduce_grads = left_out
            try:
                loss, grads = sharded.value_and_grad(cfg, local, batch, mesh)
            finally:
                sharded.reduce_grads = orig
            rec["faults"]["grad_left_out"] = grad_record(loss, grads)
            del grads
        if "half_batch" in job["faults"]:  # a step on the first half of the rank's rows
            restore()
            state, step = new_step()
            half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            m = step(local, state, {}, half)
            un = update_record(p0)
            rec["faults"]["half_batch"] = {
                "step_losses": [float(m["loss"])], "step_grad_norms": [float(m["grad_norm"])],
                "update_norms": [un[0]], "update_samples": [un[1]]}
            del state, step, m
        if "zero1_stale" in job["faults"]:  # ZeRO-1's gather left out
            restore()
            state, step = new_step()
            m = step(local, state, {}, batch)
            _zero1_stale(cfg, local, p0, mesh)
            un = update_record(p0)
            with torch.no_grad():
                after = sharded.loss(cfg, local, batch, mesh).reshape(1)
            after = D.all_reduce_axis(after, mesh, "data") / mesh.shape["data"]
            rec["faults"]["zero1_stale"] = {
                "step_losses": [float(m["loss"]), float(after)],
                "step_grad_norms": [float(m["grad_norm"])],
                "update_norms": [un[0]], "update_samples": [un[1]]}
            del state, step, m
        if "scale_local" in job["faults"]:  # a split leaf's int8 scale its block's own
            plain = loop.scale_over_model
            loop.scale_over_model = lambda top, mesh_, split_leaf: top
            try:
                rec["faults"]["scale_local"] = compressed_step()
            finally:
                loop.scale_over_model = plain
        for fault, patch in (("router_partial", ("combine_gates", lambda g, mesh_: g)),
                             ("aux_local", ("balance_mean", lambda t, mesh_: t))):
            if fault in job["faults"]:  # the MoE faults: the loss and gradient again
                restore()
                plain = getattr(moe, patch[0])
                setattr(moe, patch[0], patch[1])
                try:
                    loss, grads = sharded.value_and_grad(cfg, local, batch, mesh)
                    rec["faults"][fault] = grad_record(loss, grads)
                finally:
                    setattr(moe, patch[0], plain)
                del grads
        del p0
        rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
        rec["job_s"] = time.perf_counter() - t_job
        out[job["name"]] = rec
        if rank0:
            print(f"sharded: {job['name']} ranks {rec['job_s']:.1f} s", file=sys.stderr, flush=True)
        del local, batch
    torch.cuda.empty_cache()
    if rank0:
        out["kernels"] = local_head_checks(dev)
    return out


def _shard_checks(got: dict, ref: dict, bf16: bool) -> dict:
    """``{check: {"reading", "limit", "leaf", "ok"}}`` of rank 0's record
    ``got`` (the sound run or a fault's) against the single process's
    ``ref``, for every reading ``got`` has: per-leaf readings report the
    leaf furthest past its limit.  In bfloat16 a per-leaf limit is at least
    SHARD_WITNESS_FACTOR times the witness's largest reading among the
    leaves of its kind (the same name in every layer)."""
    import re

    out = {}

    def put(name, readings: dict, limit: float, witness: dict | None = None):
        kind = lambda n: re.sub(r"\.\d+\.", ".*.", n)  # noqa: E731
        top: dict = {}
        for n, w in (witness or {}).items():
            top[kind(n)] = max(top.get(kind(n), 0.0), w)
        lims = {n: max(limit, SHARD_WITNESS_FACTOR * top[kind(n)]) if witness else limit
                for n in readings}
        leaf = max(readings, key=lambda n: readings[n] / lims[n])
        out[name] = {"reading": readings[leaf], "limit": lims[leaf], "leaf": leaf,
                     "ok": readings[leaf] <= lims[leaf]}

    wit = ref.get("witness") if bf16 else None
    if "aux" in got and "aux" in ref:
        rel = lambda a: abs(a - ref["aux"]) / abs(ref["aux"])  # noqa: E731
        put("aux", {"aux": rel(got["aux"])},
            max(SHARD_AUX_RTOL, SHARD_WITNESS_FACTOR * rel(ref["witness_routing"]["aux"])))
    if "scales" in got:
        put("scale", {k: abs(got["scales"][k] - w) / w for k, w in ref["scales"].items()},
            SHARD_SCALE_RTOL)
    if "route_flips" in got:
        put("route_flips", {"routes": got["route_flips"]},
            max(SHARD_FLIP_SHARE * ref["routed_slots"],
                SHARD_WITNESS_FACTOR * ref["witness_routing"]["route_flips"]))
    if "loss" in got:
        put("loss", {"loss": abs(got["loss"] - ref["loss"])}, SHARD_LOSS_ATOL)
        put("grad_norm", {n: abs(got["grad_norms"][n] - w) / max(w, 1e-30)
                          for n, w in ref["grad_norms"].items()}, SHARD_NORM_RTOL,
            wit and wit["grad_norm"])
        put("grad_sample", {n: _rel_l2(got["grad_samples"][n], w)
                            for n, w in ref["grad_samples"].items()}, SHARD_SAMPLE_RTOL,
            wit and wit["grad_sample"])
    if "step_losses" in got:
        put("step_loss", {f"step {i + 1}": abs(a - b) for i, (a, b) in
                          enumerate(zip(got["step_losses"], ref["step_losses"]))},
            SHARD_STEP_LOSS_ATOL)
        put("step_grad_norm", {f"step {i + 1}": abs(a - b) / b for i, (a, b) in
                               enumerate(zip(got["step_grad_norms"], ref["step_grad_norms"]))},
            SHARD_NORM_RTOL)
        put("update_norm", {f"step {i + 1} {n}": abs(u[n] - w) / max(w, 1e-30)
                            for i, (u, r) in enumerate(zip(got["update_norms"],
                                                           ref["update_norms"]))
                            for n, w in r.items()}, SHARD_UPDATE_RTOL)
        put("update_sample", {f"step {i + 1} {n}": _rel_l2(u[n], w)
                              for i, (u, r) in enumerate(zip(got["update_samples"],
                                                             ref["update_samples"]))
                              for n, w in r.items()}, SHARD_UPDATE_SAMPLE_RTOL)
    return out


def _route_flips(want: list, got: list, data_index: int) -> int:
    """Routed slots whose expert differs: a rank's routes (a (NG/data, G,
    k) tensor a layer, its data block's groups) against the single
    process's (NG, G, k) a layer."""
    flips = 0
    for w, g in zip(want, got, strict=True):
        ng = g.shape[0]
        flips += int((w[data_index * ng:(data_index + 1) * ng] != g).sum())
    return flips


def _single_reference(cfg, fam, job: dict, dev) -> dict:
    """The single process on the card: the loss, every leaf's gradient norm
    and the sample of rank 0's block of it (a MoE model also its aux term
    and routes); with steps, each step's loss, gradient norm, and every
    leaf's update norm and sample after it, then one compressed step from
    the same weights (and its error norms); in bfloat16 the witness (the
    same gradient with the weights moved by SHARD_WITNESS_SCALE relative:
    per leaf, how far the norm and the sample move); for a MoE model the
    routing witness (how far the aux term moves and how many routes flip
    with the weights so moved)."""
    import torch

    from repro_torch import optim
    from repro_torch.launch.sharding import local_shard
    from repro_torch.models import sharded
    from repro_torch.train import TrainConfig, make_train_step

    specs = sharded.param_specs(cfg, _RankZero())
    steps = job["steps"]

    def sample(n, t):
        return _block_sample(local_shard(t, specs[n], _RankZero(), sharded.param_segments(cfg, n)))

    def loss_and_grads(model):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _RoutesRecorded() as routes:
            loss, metrics = fam.loss(cfg, model, batch)
        loss.backward()
        torch.cuda.synchronize()
        rec = {"loss": float(loss.detach()), "grad_s": time.perf_counter() - t0,
               "grad_norms": {n: float(p.grad.float().norm()) for n, p in model.named_parameters()},
               "grad_samples": {n: sample(n, p.grad) for n, p in model.named_parameters()}}
        if cfg.family == "moe":
            rec.update({"aux": float(metrics["aux"]), "routes": list(routes),
                        "routed_slots": sum(r.numel() for r in routes)})
        for prm in model.parameters():
            prm.grad = None
        return rec

    def moved_model():
        model = fam.init(cfg, torch.Generator(dev).manual_seed(SEED)).requires_grad_(True)
        g = torch.Generator(dev).manual_seed(SEED + 1)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + SHARD_WITNESS_SCALE * torch.randn(p.shape, generator=g, device=dev))
        return model

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    batch = _job_batch(cfg, job, dev)
    model = fam.init(cfg, torch.Generator(dev).manual_seed(SEED)).requires_grad_(True)
    ref = loss_and_grads(model)
    if steps:
        params = dict(model.named_parameters())
        p0 = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
        state = optim.init(params)
        step = make_train_step(cfg, optim.AdamWConfig(lr=SHARD_LR, warmup_steps=0), TrainConfig())
        ms, ref["update_norms"], ref["update_samples"] = [], [], []

        def updates():
            norms, samples = {}, {}
            for n, p in params.items():
                d = (p.detach() - p0[n].to(dev)).float()
                norms[n], samples[n] = float(d.norm()), sample(n, d)
            return norms, samples

        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ms.append(step(model, state, {}, batch))
            torch.cuda.synchronize()
            ref["step_s"] = time.perf_counter() - t0
            norms, samples = updates()
            ref["update_norms"].append(norms)
            ref["update_samples"].append(samples)
        ref["step_losses"] = [float(m["loss"]) for m in ms]
        ref["step_grad_norms"] = [float(m["grad_norm"]) for m in ms]
        del state, step, ms
        # one compressed step from the same weights and a fresh state
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(p0[n])
        err = optim.compress.init_error_state(params)
        step = make_train_step(cfg, optim.AdamWConfig(lr=SHARD_LR, warmup_steps=0),
                               TrainConfig(grad_compress=True))
        with _ScalesRecorded(err) as scales:
            m = step(model, optim.init(params), err, batch)
        norms, samples = updates()
        ref["compress"] = {"step_losses": [float(m["loss"])],
                           "step_grad_norms": [float(m["grad_norm"])],
                           "update_norms": [norms], "update_samples": [samples],
                           "scales": scales,
                           "err_norms": {n: float(e.norm()) for n, e in err.items()}}
        del params, p0, step, err
    ref["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    del model
    if cfg.compute_dtype == "bfloat16":
        torch.cuda.empty_cache()
        moved = loss_and_grads(moved_model())
    elif cfg.family == "moe":  # the routing witness needs the forward only
        torch.cuda.empty_cache()
        with torch.no_grad(), _RoutesRecorded() as routes:
            aux = fam.loss(cfg, moved_model(), batch)[1]["aux"]
        moved = {"aux": float(aux), "routes": list(routes)}
    if cfg.compute_dtype == "bfloat16" or cfg.family == "moe":
        if cfg.family == "moe":
            ref["witness_routing"] = {
                "aux": moved["aux"],
                "route_flips": _route_flips(ref["routes"], moved["routes"], 0)}
        if cfg.compute_dtype == "bfloat16":
            ref["witness"] = {
                "loss": abs(moved["loss"] - ref["loss"]),
                "grad_norm": {n: abs(moved["grad_norms"][n] - w) / max(w, 1e-30)
                              for n, w in ref["grad_norms"].items()},
                "grad_sample": {n: _rel_l2(moved["grad_samples"][n], w)
                                for n, w in ref["grad_samples"].items()}}
        del moved
    return ref


def sharded_phase(dev, smi, cal) -> dict:
    """Phase "sharded": the LM loss, its gradient and ZeRO-1 train steps
    split over a SHARD_MESH ("data", "model") mesh of gloo ranks, all on
    the one card (four processes time-sharing cuda:0: no time here is a
    scaling result), against the single process: first each single-process
    reference (:func:`_single_reference`), each freed before the next;
    then the gloo all-reduce rate of two ranks on the card (the link's
    calibrated figure); then the ranks, all jobs in one spawn.  Every
    reading of every job and fault is printed before any limit fails the
    phase.  ``cal`` is phase "calibrate"'s spec.  Returns the launches of
    flash / wkv / ssd over the ranks' loss and step runs."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.launch import calibrate
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.launch.roofline import H100_DATASHEET, analyze, model_flops
    from repro_torch.models import get_family
    from repro_torch.models.api import ShapeSpec

    t_phase = time.perf_counter()
    ranks_n = SHARD_MESH[0] * SHARD_MESH[1]
    note = f"{ranks_n} ranks time-share one card: no time here is a scaling result"
    jobs, refs = [], {}
    for arch, layers, steps, dtype, faults in SHARD_RUNS:
        job = {"name": f"{arch}/{dtype}", "arch": arch, "layers": layers, "steps": steps,
               "dtype": dtype, "faults": faults}
        cfg = _sharded_config(job)
        # one batch an architecture, whatever its dtype
        archs = list(dict.fromkeys(a for a, *_ in SHARD_RUNS))
        job["tokens"] = np.random.default_rng(SEED + archs.index(arch)).integers(
            0, cfg.vocab, size=(SHARD_B, SHARD_T)).astype(np.int64)
        jobs.append(job)
        t0 = time.perf_counter()
        refs[job["name"]] = (cfg, _single_reference(cfg, get_family(cfg), job, dev))
        print(f"sharded: {job['name']} single-process reference {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    torch.cuda.empty_cache()
    build.build_all()  # every library in place: the ranks load, none compiles
    link_bw = calibrate.measure_link_bw(device=dev)
    t0 = time.perf_counter()
    ranks = spawn_ranks(sharded_rank, ranks_n, args=(jobs, SEED), timeout=SHARD_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    launches = {"flash": 0, "wkv": 0, "ssd": 0}
    failures = []
    for job in jobs:
        name, arch = job["name"], job["arch"]
        cfg, ref = refs[name]
        per = [r[name] for r in ranks]
        bf16 = cfg.compute_dtype == "bfloat16"
        got0 = dict(per[0])
        if cfg.family == "moe":  # every data rank's routes, once a "model" line
            got0["route_flips"] = sum(
                _route_flips(ref["routes"], r[name]["routes"], r["coords"]["data"])
                for r in ranks if r["coords"]["model"] == 0)
        checks = _shard_checks(got0, ref, bf16)
        line = {"phase": "sharded", "arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
                "mesh": dict(zip(("data", "model"), SHARD_MESH)), "batch": [SHARD_B, SHARD_T],
                "compute_dtype": cfg.compute_dtype, "remat": cfg.remat, "checks": checks,
                "loss": [r["loss"] for r in per], "loss_single": ref["loss"],
                "grad_s": [r["grad_s"] for r in per], "grad_s_single": ref["grad_s"],
                "launches": [r["launches"] for r in per],
                "comm_by_axis": [r["comm"] for r in per],
                "local_param_bytes": [r["local_param_bytes"] for r in per],
                "peak_mem_bytes": [r["peak_mem_bytes"] for r in per],
                "peak_mem_bytes_single": ref["peak_mem_bytes"], "note": note,
                "nvidia_smi": smi}
        if cfg.family == "moe":
            line.update({
                "expert_sharding": cfg.expert_sharding, "n_experts": cfg.n_experts,
                "aux": [r["aux"] for r in per], "aux_single": ref["aux"],
                "route_flips": got0["route_flips"], "routed_slots": ref["routed_slots"],
                "witness_routing": ref["witness_routing"]})
        if cfg.family == "encdec":
            line["enc_layers"] = cfg.n_enc_layers
        if bf16:
            wit = ref["witness"]
            line["witness"] = {"loss": wit["loss"]} | {
                k: {"worst": max(wit[k].values()), "leaf": max(wit[k], key=wit[k].get)}
                for k in ("grad_norm", "grad_sample")}
            f32 = refs.get(f"{arch}/float32")
            if f32 is not None:  # both processes' bfloat16 norms against float32's
                def worst(norms):
                    rel = {n: abs(norms[n] - w) / max(w, 1e-30)
                           for n, w in f32[1]["grad_norms"].items()}
                    return {"worst": max(rel.values()), "leaf": max(rel, key=rel.get)}
                line["grad_norm_against_float32"] = {"single": worst(ref["grad_norms"]),
                                                     "sharded": worst(per[0]["grad_norms"])}
        for r in per:
            for nm in launches:
                launches[nm] += r["launches"][nm] + r.get("step_launches", {}).get(nm, 0)
        if job["steps"]:
            stats = per[0]["stats"]
            mf = model_flops(cfg, ShapeSpec("sharded", SHARD_T, SHARD_B, "train"))
            hw_cal = dataclasses.replace(cal, link_bw=link_bw)
            rows = {tag: analyze(stats, ranks_n, mf, hw=hw).to_dict()
                    for tag, hw in (("sheet", H100_DATASHEET), ("cal", hw_cal))}
            line.update({
                "step_losses": [r["step_losses"] for r in per],
                "step_losses_single": ref["step_losses"],
                "step_grad_norms": [r["step_grad_norms"] for r in per],
                "step_grad_norms_single": ref["step_grad_norms"],
                "step_s": [r["step_s"] for r in per], "step_s_single": ref["step_s"],
                "step1_counted_s": [r["step1_counted_s"] for r in per],
                "step_comm_by_axis": [r["step_comm"] for r in per],
                "opt_state_bytes": [r["opt_state_bytes"] for r in per],
                "roofline": rows, "link_bytes_s": {"sheet": H100_DATASHEET.link_bw,
                                                   "cal": link_bw},
                "saved_activation_bytes": [r["stats"]["saved_bytes"] for r in per]})
        if "compress" in per[0]:
            cchecks = _shard_checks(per[0]["compress"], ref["compress"], bf16)
            checks.update({f"compress_{c}": v for c, v in cchecks.items()})
            errs = {n: abs(per[0]["compress"]["err_norms"][n] - w) / max(w, 1e-30)
                    for n, w in ref["compress"]["err_norms"].items()}
            line["compress"] = {
                "step_loss": per[0]["compress"]["step_losses"][0],
                "step_loss_single": ref["compress"]["step_losses"][0],
                "step_grad_norm": per[0]["compress"]["step_grad_norms"][0],
                "step_grad_norm_single": ref["compress"]["step_grad_norms"][0],
                "err_norm_rel_diff": {"worst": max(errs.values()),
                                      "leaf": max(errs, key=errs.get)}}
        emit(line)
        failures += [f"sharded {name}: {c} {v['reading']:.3e} > {v['limit']:.3e} ({v['leaf']})"
                     for c, v in checks.items() if not v["ok"]]
        if len({r["loss"] for r in per}) != 1:
            failures.append(f"sharded {name}: the ranks' losses {line['loss']} differ")
        must = _loss_launches(cfg)
        failures += [f"sharded {name}: {nm} launched {r['launches'][nm]} times, not {n}"
                     for r in per for nm, n in must.items() if r["launches"][nm] != n]
        for fault, got in per[0].get("faults", {}).items():
            against = ref[SHARD_FAULT_AGAINST[fault]] if fault in SHARD_FAULT_AGAINST else ref
            fchecks = _shard_checks(got, {**against, "witness": ref.get("witness"),
                                          "witness_routing": ref.get("witness_routing")}, bf16)
            caught = [c for c, v in fchecks.items() if not v["ok"]]
            emit({"phase": "sharded", "arch": arch, "fault": fault, "checks": fchecks,
                  "caught_by": caught, "nvidia_smi": smi})
            if not caught:
                failures.append(f"sharded {name}: the planted fault {fault} passes every limit")
        if set(per[0].get("faults", {})) != set(job["faults"]):
            failures.append(f"sharded {name}: faults {sorted(per[0].get('faults', {}))} ran, "
                            f"not {sorted(job['faults'])}")
    emit({"phase": "sharded", "check": "kernels_at_local_head_shapes",
          "rtol_normwise": KERNEL_RTOL, "rows": ranks[0]["kernels"], "nvidia_smi": smi})
    emit({"phase": "sharded", "ranks_s": ranks_s, "seconds": time.perf_counter() - t_phase,
          "launches": launches, "coords": [r["coords"] for r in ranks],
          "link_bytes_s_cal": link_bw, "link_note": "gloo all-reduce of 64 MiB between two "
          "ranks on the card, each buffer through a host copy (measured here, after phase "
          "trace: ranks that end before it shift its host times)", "nvidia_smi": smi})
    if failures:
        raise AssertionError("; ".join(failures))
    return launches



# ---- dtypes: bfloat16 and float64 storage in the solver kernels, bfloat16 scans
#
# Phase "dtypes" holds every solver kernel's bfloat16 and float64
# instantiation, and the scans' bfloat16 one, against the plain versions on
# the card in the same storage (DTYPE_* limits), drives the main slice at
# N=200,000, K=200 with a float64 and a bfloat16 preconditioner and one
# fleet step in each, and times each (kernel, dtype) at the main shape
# beside float32.  Phase "lm" adds the models with scan_dtype="bfloat16"
# (lm_bf16_scan_check).
DTYPE_F64_RTOL = 1e-10  # float64 kernel against plain: normwise, of the largest plain value
DTYPE_F64_TOL, DTYPE_F64_RESNORM = 1e-10, 1e-9  # float64 preconditioner, BiCGStab(2)
DTYPE_BF16_TOL = 1e-8  # bfloat16 preconditioner under solver="refine": true_resnorm <= tol
DTYPE_F32_WITNESS_MAXITER = 60  # P2: float32 at tol 1e-10 runs to its cap
# The H100 SXM's FP64 tensor-core rate on its data sheet; the calibrated
# figure is a float64 torch.matmul measured in this phase.
FP64_DATASHEET_FLOP_S = 67e12
# rwkv6 / zamba2 logits with scan_dtype="bfloat16" against the same model's
# float32-scan logits on the card, the model computing in bfloat16 either
# way: the largest difference at most this share of the largest logit
# (stated before the first run; PERF.md, PR 26 predictions), or
# LM_BF16_SCAN_WITNESS times the plain versions' own bfloat16 reading where
# that is larger: at random weights bfloat16 scan tensors alone move
# RWKV6-1.6B's logits by 4-44% of the largest (PR 26 runs 2, 4), through
# the plain versions as through the kernels (L1).
LM_BF16_SCAN_RTOL, LM_BF16_SCAN_WITNESS = 5e-2, 2.0


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def bcr_plain_factor(d, e, f):
    """The plain BCR factor of the chain (d, e, f), padded to 2^L blocks,
    level by level: ([(d, e, f, a_odd, (lo, hi, d', e', f')) a level], the
    root block), each level's operands beside its plain outputs."""
    from repro_torch.core import cyclic_reduction as cr

    d, e, f = cr.pad_chain(d, e, f)
    levels = []
    while d.shape[0] > 1:
        a = cr.bcr_inv_odd_ref(d)
        out = cr.bcr_reduce_ref(d, e, f, a)
        levels.append((d, e, f, a, out))
        d, e, f = out[2:]
    return levels, d


def bcr_plain_solve(levels, root, b):
    """The plain BCR solve of ``b`` with bcr_plain_factor's levels: ([(lo,
    hi, b, b') a rhs_reduce level], [(a_odd, e_odd, f_odd, b, x, x') a
    backsub level]), each level's operands beside its plain output."""
    from repro_torch.core import cyclic_reduction as cr

    downs = []
    for _, e, f, a, (lo, hi, *_) in levels:
        downs.append((lo, hi, b, cr.bcr_rhs_reduce_ref(lo, hi, b)))
        b = downs[-1][3]
    x = (cr.bcr_inv_odd_ref(root, first=0)[0] @ b[0])[None]
    ups = []
    for (_, e, f, a, _), (_, _, bl, _) in zip(reversed(levels), reversed(downs)):
        ups.append((a, e[1::2].contiguous(), f[1::2].contiguous(), bl, x,
                    cr.bcr_backsub_ref(a, e[1::2], f[1::2], bl, x)))
        x = ups[-1][5]
    return downs, ups


def dtype_phase(dev, smi, band_d1, band_d05, xstar, cal) -> tuple[dict, list]:
    """Phase "dtypes" (see above).  Returns the main path's launches by
    (kernel, dtype) and the summary rows of the new (kernel, dtype) pairs."""
    import numpy as np
    import torch

    from repro_torch.configs import sap_solver
    from repro_torch.core import (SaPOptions, band_matvec, band_to_block_tridiag, factor,
                                  plan_banded, random_banded)
    from repro_torch.core import block_lu as bl
    from repro_torch.core import cyclic_reduction as cr
    from repro_torch.core.spike import _reduced_interface_system
    from repro_torch.kernels import bcr, build, ops
    from repro_torch.kernels._launch import entry
    from repro_torch.kernels.btf import btf
    from repro_torch.kernels.bts import bts
    from repro_torch.kernels.fused_spike import fused_factor_spike
    from repro_torch.kernels.ops import (bcr_work, btf_work, bts_work, fused_work)
    from repro_torch.kernels.ssd import ssd, ssd_plain
    from repro_torch.kernels.wkv import scan_route, wkv6, wkv6_plain
    from repro_torch.launch.roofline import H100_DATASHEET as SHEET
    from repro_torch.serve.solver_engine import SolverEngine

    t_phase = time.perf_counter()
    bf, f64 = torch.bfloat16, torch.float64
    dtypes = (bf, f64)
    wrappers = {"btf": btf, "bts": bts, "fused_factor_spike": fused_factor_spike,
                "bcr_inv_odd": bcr.inv_odd, "bcr_reduce": bcr.reduce,
                "bcr_rhs_reduce": bcr.rhs_reduce, "bcr_backsub": bcr.backsub,
                "wkv": wkv6, "ssd": ssd}
    solver_names = tuple(wrappers)[:7]
    libs = {nm: build.load(nm) for nm in ("btf", "bts", "fused_spike", "bcr")}
    checks, errs = [], {}

    def close(what, kernel, dt, got, want, at, route=None):
        """got against want in dtype dt; one row of the phase's record."""
        if dt == bf:
            err, share = check_close_bf16(f"{what} [{_dtype_name(dt)}]", got, want,
                                          atol=KERNEL_RTOL)
            limit = f"2^-7 |plain| + {KERNEL_RTOL} max |plain|, element by element"
        else:
            err = check_close(f"{what} [{_dtype_name(dt)}]", got, want, rtol=DTYPE_F64_RTOL)
            share = rel_err(got, want)[1] / DTYPE_F64_RTOL
            limit = f"{DTYPE_F64_RTOL} max |plain|, normwise"
        key = (kernel, _dtype_name(dt))
        errs[key] = max(errs.get(key, 0.0), err)
        checks.append({"kernel": kernel, "dtype": _dtype_name(dt), "at": at, "what": what,
                       "route": route, "max_abs_err": err, "of_limit": share, "limit": limit})

    def solver_kernels(at, d, e, f, b_cpl, c_cpl, rs):
        p, k = d.shape[0], d.shape[2]
        for dt in dtypes:
            dd, ee, ff = (x.to(dt) for x in (d, e, f))
            cs = entry(libs["btf"], "btf_cluster_size", dt)(p, k)
            sinv, l = btf(dd, ee, ff)
            ref = bl.btf_ref(dd, ee, ff)
            close("sinv", "btf", dt, sinv, ref.sinv, at, {"cluster": cs})
            close("l", "btf", dt, l, ref.l, at, {"cluster": cs})
            del sinv, l
            g = torch.Generator(device=dev).manual_seed(SEED)
            for r in rs:
                rhs = torch.randn(dd.shape[:3] + (r,), generator=g, device=dev).to(dt)
                cs = entry(libs["bts"], "bts_cluster_size", dt)(p, k, r)
                bulk = entry(libs["bts"], "bts_bulk_route", dt)(
                    ref.sinv.data_ptr(), ref.l.data_ptr(), ff.data_ptr(), k)
                close(f"x r={r}", "bts", dt, bts(ref.sinv, ref.l, ff, rhs), bl.bts_ref(ref, rhs),
                      at, {"cluster": cs, "copies": "tma" if bulk else "element"})
            del ref
            if b_cpl is not None:
                bq, cq = (x.to(dt) for x in bl.pad_couplings(b_cpl, c_cpl, p))
                cs = entry(libs["fused_spike"], "fused_cluster_size", dt)(p, k)
                out = fused_factor_spike(dd, ee, ff, bq, cq)
                want = bl.fused_factor_spike_padded_ref(dd, ee, ff, bq, cq)
                for nm, o, w in zip(("sinv", "l", "vb", "vt", "wt", "wb"), out, want):
                    close(nm, "fused_factor_spike", dt, o, w, at, {"cluster": cs})
                del out, want
            del dd, ee, ff

    def bcr_kernels(at, d, e, f, rs):
        """Each BCR kernel at every level of a factor and a solve of the
        chain, on the plain levels' operands."""
        for dt in dtypes:
            levels, root = bcr_plain_factor(*(x.to(dt) for x in (d, e, f)))
            k = root.shape[1]
            for dd, ee, ff, a, want in levels:
                m = dd.shape[0]
                close(f"m={m}", "bcr_inv_odd", dt, bcr.inv_odd(dd), a, at,
                      {"cluster": entry(libs["bcr"], "bcr_inv_cluster_size", dt)(k)})
                tile = entry(libs["bcr"], "bcr_reduce_tile", dt)(m // 2, k)
                for nm, o, w in zip(("lo", "hi", "d", "e", "f"), bcr.reduce(dd, ee, ff, a), want):
                    close(f"{nm} m={m}", "bcr_reduce", dt, o, w, at, {"tile": tile})
            g = torch.Generator(device=dev).manual_seed(SEED)
            for r in rs:
                b = torch.randn(levels[0][0].shape[0], k, r, generator=g, device=dev).to(dt)
                downs, ups = bcr_plain_solve(levels, root, b)
                for lo, hi, bb, want in downs:
                    m2 = lo.shape[0]
                    close(f"r={r} m2={m2}", "bcr_rhs_reduce", dt, bcr.rhs_reduce(lo, hi, bb), want,
                          at, {"split": entry(libs["bcr"], "bcr_rhs_reduce_split", dt)(m2, k, r)})
                for a, eo, fo, bb, x, want in ups:
                    m2 = a.shape[0]
                    close(f"r={r} m2={m2}", "bcr_backsub", dt, bcr.backsub(a, eo, fo, bb, x), want,
                          at, {"cluster": entry(libs["bcr"], "bcr_backsub_cluster", dt)(m2, k, r)})
                del downs, ups
            del levels, root

    # ---- kernels against their plain versions, in each storage dtype -------
    bt = band_to_block_tridiag(band_d1, K, 64)
    assert (bt.p, bt.m, bt.k) == (64, 16, K)
    solver_kernels(f"main P=64 M=16 K={K}", bt.d, bt.e, bt.f, bt.b_cpl, bt.c_cpl, (1, 4))
    for at, (n, k, p) in {"K=37": (259, 37, 3), "K=256": (1400, 256, 2)}.items():
        small = torch.tensor(random_banded(n, k, 1.0, seed=SEED).astype(np.float32), device=dev)
        sbt = band_to_block_tridiag(small, k, p)
        solver_kernels(at, sbt.d, sbt.e, sbt.f, sbt.b_cpl, sbt.c_cpl, (1, 4, k))
    for p in (64, 500):  # the SaP-E interface chains of the d=0.5 band: 63 and 499 blocks
        sbt = band_to_block_tridiag(band_d05, K, p)
        fs = ops.fused_factor_spike(sbt.d, sbt.e, sbt.f, sbt.b_cpl, sbt.c_cpl)
        rd, re, rf = _reduced_interface_system(fs.v_bot, fs.v_top, fs.w_top, fs.w_bot)
        del sbt, fs
        at = f"E chain {p - 1} blocks of 2K=400"
        # btf / bts on at most the chain's first 64 blocks: the plain btf
        # walks the blocks one by one (seconds a block row at 2K=400)
        cut = min(p - 1, 64)
        solver_kernels(at if cut == p - 1 else f"{at}, first {cut}", rd[None, :cut],
                       re[None, :cut], rf[None, :cut], None, None, (1,))
        bcr_kernels(at, rd, re, rf, (1,))
        del rd, re, rf
    fcfg = sap_solver.fleet()
    fbands = np.stack([random_banded(fcfg.n, fcfg.k, fcfg.d, seed=SEED + 100 + i)
                       .astype(np.float32) for i in range(FLEET_S)])
    fbt = band_to_block_tridiag(torch.tensor(fbands, device=dev), fcfg.k, FLEET_P)
    fold = lambda t: t.flatten(0, 1)  # noqa: E731  (S, P, ...) -> (S*P, ...)
    b_f, c_f = bl.pad_couplings(fbt.b_cpl, fbt.c_cpl, FLEET_P)
    solver_kernels(f"fleet fold {FLEET_S}x{FLEET_P} chains of K={fcfg.k}", fold(fbt.d),
                   fold(fbt.e), fold(fbt.f), None, None, (1, 4))
    for dt in dtypes:  # the fused pass on the folded couplings
        dd, ee, ff, bq, cq = (fold(x).to(dt) for x in (fbt.d, fbt.e, fbt.f, b_f, c_f))
        out = fused_factor_spike(dd, ee, ff, bq, cq)
        for nm, o, w in zip(("sinv", "l", "vb", "vt", "wt", "wb"), out,
                            bl.fused_factor_spike_padded_ref(dd, ee, ff, bq, cq)):
            close(nm, "fused_factor_spike", dt, o, w, "fleet fold",
                  {"cluster": entry(libs["fused_spike"], "fused_cluster_size", dt)(
                      dd.shape[0], fcfg.k)})
    ebt = band_to_block_tridiag(torch.tensor(np.stack(
        [random_banded(fcfg.n, fcfg.k, 0.5, seed=SEED + 100 + i).astype(np.float32)
         for i in range(FLEET_S)]), device=dev), fcfg.k, FLEET_P)
    efs = ops.fused_factor_spike(ebt.d, ebt.e, ebt.f, ebt.b_cpl, ebt.c_cpl)
    rd_f, re_f, rf_f = _reduced_interface_system(efs.v_bot, efs.v_top, efs.w_top, efs.w_bot)
    ends = [cr.pad_chain(*c) for c in zip(rd_f, re_f, rf_f)]
    bcr_kernels(f"fleet {FLEET_S} stacked chains of 2K={2 * fcfg.k}",
                *(torch.cat(t) for t in zip(*ends)), (1, 4))
    del fbt, ebt, efs, rd_f, re_f, rf_f, ends
    # the scans in bfloat16: the LM decode and prefill shapes and a ragged chunk
    scan_shapes = {"wkv": {"decode": (LM_SLOTS * 32, 1, 64, 1),
                           "prefill": (PREFILL_B * 32, PREFILL_T, 64, 64),
                           "chunk37": (6, 74, 64, 37)},
                   "ssd": {"decode": (LM_SLOTS * 80, 1, 64, 64, 80, 1),
                           "prefill": (PREFILL_B * 80, PREFILL_T, 64, 64, 80, 64),
                           "chunk37": (6, 74, 64, 64, 3, 37)}}
    scan_args = {}
    for tag, (bh, t, d, ch) in scan_shapes["wkv"].items():
        r, k, v, logw, u, s0 = wkv_inputs(dev, bh, t, d, SEED)
        args = (r.to(bf), k.to(bf), v.to(bf), logw.to(bf), u, s0)
        scan_args[("wkv", tag)] = (args, ch)
        o, s = wkv6(*args, ch)
        po, ps = wkv6_plain(*args, ch)
        close("o", "wkv", bf, o, po, tag, {"route": scan_route(ch, d)})
        errs[("wkv", "bfloat16")] = max(errs[("wkv", "bfloat16")],
                                        check_close(f"wkv {tag} state", s, ps))
    for tag, (bh, t, n, p, hs, ch) in scan_shapes["ssd"].items():
        x, b, c, la, s0 = ssd_inputs(dev, bh, t, n, p, hs, SEED)
        args = (x.to(bf), b.to(bf), c.to(bf), la, s0)
        scan_args[("ssd", tag)] = (args, ch, hs)
        y, s = ssd(*args, ch, hs)
        py, ps = ssd_plain(*args, ch, hs)
        close("y", "ssd", bf, y, py, tag, {"route": scan_route(ch, n, p)})
        errs[("ssd", "bfloat16")] = max(errs[("ssd", "bfloat16")],
                                        check_close(f"ssd {tag} state", s, ps))
    torch.cuda.synchronize()
    emit({"phase": "dtypes", "check": "kernels_vs_plain", "rows": checks,
          "limits": {"bfloat16": [FLASH_BF16_STEP, KERNEL_RTOL], "float64": DTYPE_F64_RTOL},
          "worst_of_limit": max(c["of_limit"] for c in checks), "nvidia_smi": smi})

    # ---- the main slice at N=200,000, K=200 in each preconditioner dtype -----
    # the launch counts are set to 0 here and read after the fleet step
    for w in wrappers.values():
        w.launches = 0
        w.by_dtype.clear()
    systems = {"d1.0": (band_d1, band_matvec(band_d1.double(), xstar)),
               "d0.5": (band_d05, band_matvec(band_d05.double(), xstar))}
    runs = [("D", "d1.0", dict(p=64, variant="D")), ("C", "d1.0", dict(p=64, variant="C")),
            ("E_chain_p8", "d0.5", dict(p=8, variant="E", reduced_solver="chain")),
            ("E_bcr_p64", "d0.5", dict(p=64, variant="E", reduced_solver="bcr"))]

    def slice_run(band, rhs, **kw):
        opts = SaPOptions(**kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fac = factor(plan_banded(band, opts))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = fac.solve(rhs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        xerr = float((res.x - xstar).norm() / xstar.norm())
        out = {"variant": fac.variant, "p": fac.p, "reduced_solver": fac.pc.reduced_solver,
               "precond_dtype": _dtype_name(fac.pc.lu.sinv.dtype), "solver": fac.solver,
               "tol": opts.tol, "iterations": float(res.iterations),
               "converged": bool(res.converged), "true_resnorm": float(res.true_resnorm),
               "x_rel_err": xerr, "factor_ms": (t1 - t0) * 1e3, "solve_ms": (t2 - t1) * 1e3}
        del fac, res
        return out

    slices = []
    for name, sysname, kw in runs:
        band, rhs = systems[sysname]
        row = {"run": name, "float64": slice_run(band, rhs, tol=DTYPE_F64_TOL, maxiter=MAXITER,
                                                 precond_dtype="float64", **kw)}
        row["float32_same_tol"] = slice_run(band, rhs, tol=DTYPE_F64_TOL,
                                            maxiter=DTYPE_F32_WITNESS_MAXITER,
                                            precond_dtype="float32", **kw)
        slices.append(row)
        emit({"phase": "dtypes", "slice": name, **row, "limit": DTYPE_F64_RESNORM})
    for name, sysname, kw in runs[1::2]:  # C and E with BCR
        band, rhs = systems[sysname]
        row = {"run": name, "bfloat16_refine": slice_run(
                   band, rhs, tol=DTYPE_BF16_TOL, maxiter=MAXITER, precond_dtype="bfloat16",
                   solver="refine", **kw),
               "float32_refine": slice_run(band, rhs, tol=DTYPE_BF16_TOL, maxiter=MAXITER,
                                           precond_dtype="float32", solver="refine", **kw),
               "bfloat16_bicgstab2_r11": slice_run(band, rhs, tol=DTYPE_BF16_TOL, maxiter=MAXITER,
                                                   precond_dtype="bfloat16", **kw)}
        slices.append(row)
        emit({"phase": "dtypes", "slice": name, **row, "limit": DTYPE_BF16_TOL})
    # one fleet step of 64 systems through SolverEngine in each new dtype:
    # float64 under fleet()'s BiCGStab(2), bfloat16 under refinement (R11)
    fleet_x = np.random.default_rng(SEED + 1).normal(size=(FLEET_S, fcfg.n))
    fleet_b = band_matvec(torch.tensor(fbands, device=dev, dtype=torch.float64),
                          torch.tensor(fleet_x, device=dev)).cpu().numpy()
    fleet = {}
    for dt in dtypes:
        fopts = dataclasses.replace(fcfg.to_sap_options(FLEET_P), precond_dtype=_dtype_name(dt),
                                    solver="refine" if dt == bf else "bicgstab2")
        eng = SolverEngine(fopts, max_batch=fcfg.max_batch, cache_size=fcfg.fac_cache,
                           rounding=fcfg.bucket_rounding)
        for i in range(FLEET_S):
            eng.submit_system(fbands[i], fleet_b[i])
        torch.cuda.synchronize()
        before = {nm: w.launches for nm, w in wrappers.items()}
        t0 = time.perf_counter()
        done = eng.step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        step_launches = {nm: w.launches - before[nm] for nm, w in wrappers.items()
                         if w.launches != before[nm]}
        # the S systems fold into each kernel's chain axis: one factor launch
        # for all of them, as one system's C factor (fused + btf once each)
        if step_launches.get("fused_factor_spike", 0) > 1 or step_launches.get("btf", 0) > 1:
            raise AssertionError(f"dtypes: a {dt} fleet step's factor launched per system: "
                                 f"{step_launches}")
        worst = max(float(r.result.true_resnorm) for r in done)
        fleet[_dtype_name(dt)] = {
            "systems": len(done), "solver": fopts.solver, "step_ms": step_ms,
            "launches": step_launches, "worst_true_resnorm": worst,
            "tol": fcfg.tol, "escalated": sum(bool(r.result.escalated) for r in done),
            "misconverged": sum(bool(r.result.misconverged) for r in done),
            "converged": sum(bool(r.result.converged) for r in done)}
        if len(done) != FLEET_S:
            raise AssertionError(f"dtypes: a {dt} fleet step solved {len(done)} of {FLEET_S}")
        del eng, done
    launches = {nm: {_dtype_name(d): c for d, c in w.by_dtype.items()}
                for nm, w in wrappers.items()}
    emit({"phase": "dtypes", "fleet_step": fleet, "launches_by_dtype": launches})
    for row in slices:
        if "float64" in row and not row["float64"]["true_resnorm"] <= DTYPE_F64_RESNORM:
            raise AssertionError(f"dtypes {row['run']}: float64 true_resnorm "
                                 f"{row['float64']['true_resnorm']:.3e} > {DTYPE_F64_RESNORM}")
        if "bfloat16_refine" in row and not (row["bfloat16_refine"]["true_resnorm"]
                                             <= DTYPE_BF16_TOL):
            raise AssertionError(f"dtypes {row['run']}: bfloat16 refine true_resnorm "
                                 f"{row['bfloat16_refine']['true_resnorm']:.3e} > "
                                 f"{DTYPE_BF16_TOL}")
    for nm in solver_names:
        for dt in dtypes:
            if not launches[nm].get(_dtype_name(dt)):
                raise AssertionError(f"dtypes: the main path never launched {nm} in {dt}")

    # ---- timing at the main shape, each dtype beside float32 ---------------
    f64_a = torch.randn(4096, 4096, device=dev, dtype=f64)
    f64_ms = cuda_ms(lambda: f64_a @ f64_a, 10)
    f64_rate = 2 * 4096**3 / (f64_ms * 1e-3)
    del f64_a
    emit({"phase": "calibrate", "float64_flop_s": {"measured": f64_rate,
                                                   "datasheet": FP64_DATASHEET_FLOP_S,
                                                   "measured_over_datasheet":
                                                   f64_rate / FP64_DATASHEET_FLOP_S},
          "how": "torch.matmul of two 4096 x 4096 float64 matrices, 10 calls"})

    def bound(dt, flops, nbytes):
        fl_sheet = FP64_DATASHEET_FLOP_S if dt == f64 else SHEET.peak_flops
        fl_cal = f64_rate if dt == f64 else cal.peak_flops
        ms, by = roofline_bound(flops, nbytes, SHEET.hbm_bw, fl_sheet)
        ms_cal, by_cal = roofline_bound(flops, nbytes, cal.hbm_bw, fl_cal)
        return {"bound_ms": ms, "bound_by": by, "bound_ms_calibrated": ms_cal,
                "bound_by_calibrated": by_cal}

    sbt = band_to_block_tridiag(band_d05, K, 64)
    fs = ops.fused_factor_spike(sbt.d, sbt.e, sbt.f, sbt.b_cpl, sbt.c_cpl)
    chain = _reduced_interface_system(fs.v_bot, fs.v_top, fs.w_top, fs.w_bot)
    del sbt, fs
    p, m = 64, 16
    summary, timing = [], []
    for dt in (torch.float32,) + dtypes:
        isz = torch.tensor([], dtype=dt).element_size()
        d, e, f = (x.to(dt) for x in (bt.d, bt.e, bt.f))
        bq, cq = (x.to(dt) for x in bl.pad_couplings(bt.b_cpl, bt.c_cpl, p))
        fac = bl.btf_ref(d, e, f)
        rhs = torch.randn(p, m, K, 1, device=dev).to(dt)
        levels, root = bcr_plain_factor(*(x.to(dt) for x in chain))
        h = torch.randn(levels[0][0].shape[0], 2 * K, 1, device=dev).to(dt)
        downs, ups = ([op[:-1] for op in ops_] for ops_ in bcr_plain_solve(levels, root, h))
        facts = [lv[:4] for lv in levels]
        work = bcr_work(chain[0].shape[0], 2 * K, 1, isz)
        lib = dt != bf  # torch.linalg.inv takes no bfloat16
        specs = {
            "btf": (lambda: btf(d, e, f), lambda: bl.btf_ref(d, e, f),
                    (lambda: btf_library(d, e, f)) if lib else None, btf_work(p, m, K, isz),
                    "src/repro_torch/kernels/csrc/btf.cu", "src/repro/kernels/btf.py:40", 3),
            "bts": (lambda: bts(fac.sinv, fac.l, f, rhs), lambda: bl.bts_ref(fac, rhs), None,
                    bts_work(p, m, K, 1, isz), "src/repro_torch/kernels/csrc/bts.cu",
                    "src/repro/kernels/bts.py:27", 20),
            "fused_factor_spike": (
                lambda: fused_factor_spike(d, e, f, bq, cq),
                lambda: bl.fused_factor_spike_padded_ref(d, e, f, bq, cq),
                (lambda: fused_library(d, e, f, bq, cq)) if lib else None, fused_work(p, m, K, isz),
                "src/repro_torch/kernels/csrc/fused_spike.cu",
                "src/repro/kernels/fused_spike.py:47", 3),
            "bcr_inv_odd": (lambda: [bcr.inv_odd(fa[0]) for fa in facts],
                            lambda: [cr.bcr_inv_odd_ref(fa[0]) for fa in facts],
                            (lambda: [torch.linalg.inv(fa[0][1::2]) for fa in facts])
                            if lib else None, work["inv_odd"],
                            "src/repro_torch/kernels/csrc/bcr.cu", "src/repro/kernels/bcr.py:43", 3),
            "bcr_reduce": (lambda: [bcr.reduce(*fa) for fa in facts],
                           lambda: [cr.bcr_reduce_ref(*fa) for fa in facts],
                           lambda: [reduce_library(*fa) for fa in facts], work["reduce"],
                           "src/repro_torch/kernels/csrc/bcr.cu", "src/repro/kernels/bcr.py:48", 3),
            "bcr_rhs_reduce": (lambda: [bcr.rhs_reduce(*a) for a in downs],
                               lambda: [cr.bcr_rhs_reduce_ref(*a) for a in downs],
                               lambda: [rhs_reduce_library(*a) for a in downs],
                               work["rhs_reduce"], "src/repro_torch/kernels/csrc/bcr.cu",
                               "src/repro/kernels/bcr.py:79", 20),
            "bcr_backsub": (lambda: [bcr.backsub(*a) for a in ups],
                            lambda: [cr.bcr_backsub_ref(*a) for a in ups],
                            lambda: [backsub_library(*a) for a in ups], work["backsub"],
                            "src/repro_torch/kernels/csrc/bcr.cu", "src/repro/kernels/bcr.py:89",
                            20),
        }
        for nm, (kern, plain, library, (flops, nbytes), source, replaces, reps) in specs.items():
            saved = wrappers[nm].launches, dict(wrappers[nm].by_dtype)
            # the BCR solve's launches are short: queued behind a spin, so
            # the host's gaps do not count (no profiler: a long process's
            # profiler stops seeing kernels), the library loop the same way
            short = nm in ("bcr_rhs_reduce", "bcr_backsub")
            ms = queued_ms(kern, reps) if short else cuda_ms(kern, reps)
            plain_ms = cuda_ms(plain, 1)
            library_ms = (None if not library else queued_ms(library, reps) if short
                          else cuda_ms(library, reps))
            wrappers[nm].launches = saved[0]  # timing launches are not the path's
            wrappers[nm].by_dtype.clear()
            wrappers[nm].by_dtype.update(saved[1])
            ms_is = ("queued, the levels of one R=1 solve of the P=64 chain" if short else
                     "events, one call" + (" (all levels of one factor of the P=64 chain)"
                                           if nm.startswith("bcr") else ""))
            row = {"name": nm if dt == torch.float32 else f"{nm}_{_dtype_name(dt)}",
                   "dtype": _dtype_name(dt), "ms": ms, "ms_is": ms_is, "plain_ms": plain_ms,
                   "library_ms": library_ms, **bound(dt, flops, nbytes),
                   "bytes": nbytes, "flops": flops}
            timing.append(row)
            if dt != torch.float32:
                summary.append({"name": row["name"], "route": "cuda", "source": source,
                                "replaces": replaces,
                                "launches": launches[nm].get(_dtype_name(dt), 0),
                                "max_abs_err": errs[(nm, _dtype_name(dt))], "ms": ms,
                                "plain_ms": plain_ms, **bound(dt, flops, nbytes),
                                "library_ms": library_ms, "dtype": _dtype_name(dt),
                                "ms_is": ms_is})
        del d, e, f, bq, cq, fac, rhs, levels, root, downs, ups, facts
    # the scans at the prefill shape, bfloat16 beside float32
    for nm, (fn, plain_fn) in {"wkv": (wkv6, wkv6_plain), "ssd": (ssd, ssd_plain)}.items():
        spec = scan_args[(nm, "prefill")]
        args, ch = spec[0], spec[1]
        extra = spec[2:]
        f32_args = tuple(a.float() for a in args)
        if nm == "wkv":
            bh, t, dd = args[0].shape
            flops, nbytes = wkv_work(bh, t, dd)
            nbytes_bf = nbytes - 2.0 * bh * 5 * t * dd  # r, k, v, log w, o in 2 bytes
        else:
            bh, t, p_ = args[0].shape
            n_ = args[1].shape[-1]
            flops, nbytes = ssd_work(bh, t, n_, p_, extra[0])
            nbytes_bf = nbytes - 2.0 * (2 * bh * t * p_ + 2 * (bh // extra[0]) * t * n_)
        rows = {}
        for dt, a, nb in ((torch.float32, f32_args, nbytes), (bf, args, nbytes_bf)):
            saved = wrappers[nm].launches, dict(wrappers[nm].by_dtype)
            ms = queued_ms(lambda a=a: fn(*a, ch, *extra), 20)
            plain_ms = cuda_ms(lambda a=a: plain_fn(*a, ch, *extra), 3)
            wrappers[nm].launches = saved[0]
            wrappers[nm].by_dtype.clear()
            wrappers[nm].by_dtype.update(saved[1])
            rows[_dtype_name(dt)] = {"name": nm if dt == torch.float32 else f"{nm}_bfloat16",
                                     "dtype": _dtype_name(dt), "ms": ms, "ms_is": "queued",
                                     "plain_ms": plain_ms, "library_ms": None,
                                     **bound(torch.float32, flops, nb), "bytes": nb,
                                     "flops": flops}
            timing.append(rows[_dtype_name(dt)])
        r = rows["bfloat16"]
        summary.append({"name": r["name"], "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{nm}.cu",
                        "replaces": ("src/repro/kernels/wkv_chunk.py:38" if nm == "wkv"
                                     else "src/repro/kernels/ssd_chunk.py:26"),
                        "launches": None, "max_abs_err": errs[(nm, "bfloat16")],
                        **{k_: r[k_] for k_ in ("ms", "ms_is", "plain_ms", "bound_ms", "bound_by",
                                                "bound_ms_calibrated", "bound_by_calibrated",
                                                "library_ms", "dtype")},
                        "at": f"prefill {PREFILL_B}x{PREFILL_T}"})
    for row in timing:
        for what in ("ms", "library_ms"):
            if row.get(what) is not None and row[what] < row["bound_ms"]:
                raise AssertionError(f"dtypes: {row['name']} {what} {row[what]:.4g} reads under "
                                     f"its bound {row['bound_ms']:.4g} ms")
    emit({"phase": "dtypes", "check": "timing_main_shape", "rows": timing,
          "float64_flop_s": {"datasheet": FP64_DATASHEET_FLOP_S, "calibrated": f64_rate},
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})
    return launches, summary


# ---- examples: the port's entry points as a user runs them ----------------------
#
# Phase "examples" runs each of repro_torch.examples' modules as a user
# would, ``python -m repro_torch.examples.<name>`` with PYTHONPATH=src at
# its defaults on the card (serve_lm also with --arch rwkv6-1.6b and
# zamba2-2.7b; train_lm with --ckpt-dir in the run's own temporary
# directory: its default lies outside it, and an earlier run's step-300
# checkpoint there would leave nothing to train), each in a process group
# of its own with a time limit (EXAMPLE_TIMEOUT_S), one after another.  A
# child reports its kernel launches at exit (kernels/ops.py,
# REPRO_TORCH_REPORT_LAUNCHES; distributed_solve's ranks each report
# theirs).  Limits: exit code 0; the JAX script's "OK" line where it prints
# one (EXAMPLE_OK); every printed relative error of a float32 solve at most
# EXAMPLE_RELERR, but for distributed_solve's SaP-auto on the d=0.5 band:
# that float32 solve exits on its recursive residual at a relative error of
# 1.07e-2 in the JAX package (8 host devices, CPU) and 2.0e-2 in the port
# (8 ranks, CPU), far above cond(A) eps = 746 x 6e-8 (R2), so it is held to
# EXAMPLE_RELERR_D05; train_lm's final loss below its first logged one;
# serve_lm serving every request it was sent; and over the phase, launches
# of every kernel in EXAMPLE_KERNELS.
EXAMPLE_RUNS = (("quickstart",), ("fleet_solve",), ("serve_async",), ("traced_solve",),
                ("distributed_solve",), ("serve_lm",), ("serve_lm", "--arch", "rwkv6-1.6b"),
                ("serve_lm", "--arch", "zamba2-2.7b"), ("train_lm",))
EXAMPLE_OK = {"quickstart": "quickstart OK", "distributed_solve": "distributed solve OK"}
EXAMPLE_RELERR, EXAMPLE_RELERR_D05 = 1e-4, 5e-2
EXAMPLE_TIMEOUT_S = {"distributed_solve": 300, "train_lm": 400}
EXAMPLE_DEFAULT_TIMEOUT_S = 180
EXAMPLE_KERNELS = ("btf", "bts", "fused_factor_spike", "flash", "wkv", "ssd")
_NUMBER = r"[-+]?\d+(?:\.\d*)?(?:[eE][-+]?\d+)?"


def _run_example(argv: tuple, cwd: str, timeout: float) -> tuple:
    """(exit code or None on timeout, stdout, stderr, seconds) of one
    example run; its whole process group is stopped either way."""
    import os
    import signal

    from repro_torch.kernels.ops import REPORT_LAUNCHES_ENV

    env = {**os.environ, "PYTHONPATH": str(SRC), REPORT_LAUNCHES_ENV: "1"}
    cmd = [sys.executable, "-m", f"repro_torch.examples.{argv[0]}", *argv[1:]]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    if rc is None:
        out, err = proc.communicate()
    return rc, out, err, time.perf_counter() - t0


def _example_readings(name: str, out: str) -> dict:
    """The numbers an example printed that its limits read."""
    rd: dict = {"relerr": {}}
    for line in out.splitlines():
        for v in re.findall(rf"relerr=({_NUMBER})", line):
            label = line.split(":")[0] if ":" in line else line.split("relerr=")[0]
            rd["relerr"][label.strip()[:60] or name] = float(v)
    losses = [float(v) for v in re.findall(rf"^step\s+\d+\s+loss ({_NUMBER})", out, re.M)]
    if losses:
        rd["losses"] = losses
    m = re.search(rf"final loss: ({_NUMBER})\s+restarts: (\d+)", out)
    if m:
        rd["final_loss"], rd["restarts"] = float(m.group(1)), int(m.group(2))
    m = re.search(r"served (\d+)/(\d+) requests, (\d+) tokens", out)
    if m:
        rd["served"], rd["sent"], rd["tokens"] = (int(g) for g in m.groups())
    for key, pat in (("tok_s", rf"({_NUMBER}) tok/s"), ("ms", rf"({_NUMBER}) ms"),
                     ("iters", rf"iters=\s*({_NUMBER})"), ("sys_s", rf"({_NUMBER}) sys/s"),
                     ("solves_s", rf"({_NUMBER}) solves/s")):
        found = [float(v) for v in re.findall(pat, out)]
        if found:
            rd[key] = found
    return rd


def examples_phase(smi) -> dict:
    """Phase "examples" (see EXAMPLE_RUNS): one line a run with its seconds,
    the numbers it printed, its launches by kernel (the child and, for
    distributed_solve, its ranks) and its limits; then the phase's total
    launches, which it returns.  Every run's line is printed before a
    failed limit raises."""
    from repro_torch.kernels.ops import LAUNCH_REPORT_PREFIX, launch_counts

    launches = dict.fromkeys(launch_counts(), 0)
    failures, t_phase = [], time.perf_counter()
    for argv in EXAMPLE_RUNS:
        name, run = argv[0], " ".join(argv)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_example_") as tmp:
            extra = ("--ckpt-dir", str(Path(tmp) / "ckpt")) if name == "train_lm" else ()
            timeout = EXAMPLE_TIMEOUT_S.get(name, EXAMPLE_DEFAULT_TIMEOUT_S)
            rc, out, err, secs = _run_example(argv + extra, tmp, timeout)
        reports = [json.JSONDecoder().raw_decode(out, m.end())[0]
                   for m in re.finditer(LAUNCH_REPORT_PREFIX, out)]
        mine = {k: sum(r["launches"].get(k, 0) for r in reports) for k in launches}
        for k, v in mine.items():
            launches[k] += v
        printed = [ln for ln in out.splitlines()
                   if ln.strip() and LAUNCH_REPORT_PREFIX not in ln]
        rd = _example_readings(name, out)
        bad = []
        if rc != 0:
            bad.append(f"exit code {rc} (None: over {timeout} s); stderr: {err[-2000:]}")
        if name in EXAMPLE_OK and not any(ln.startswith(EXAMPLE_OK[name]) for ln in printed):
            bad.append(f"no {EXAMPLE_OK[name]!r} line")
        for label, v in rd["relerr"].items():
            limit = EXAMPLE_RELERR_D05 if "d=0.5" in label else EXAMPLE_RELERR
            if not v <= limit:
                bad.append(f"{label}: relerr {v:.3e} > {limit:.0e}")
        if name == "train_lm" and rc == 0 and not rd.get("final_loss", math.inf) < rd["losses"][0]:
            bad.append(f"final loss {rd.get('final_loss')} is not below the first "
                       f"{rd['losses'][0]}")
        if name == "serve_lm" and rc == 0 and rd.get("served") != rd.get("sent"):
            bad.append(f"served {rd.get('served')} of {rd.get('sent')} requests")
        emit({"phase": "examples", "run": run, "seconds": secs, "rc": rc, "readings": rd,
              "launches": {k: v for k, v in mine.items() if v}, "processes_reporting": len(reports),
              "bcr_reached": [k for k in mine if k.startswith("bcr_") and mine[k]],
              "printed": printed[:60], "failed": bad, "nvidia_smi": smi})
        failures += [f"examples {run}: {b}" for b in bad]
    never = [k for k in EXAMPLE_KERNELS if not launches[k]]
    if never:
        failures.append(f"examples: kernels {never} were never launched")
    emit({"phase": "examples", "seconds": time.perf_counter() - t_phase, "launches": launches,
          "bcr_reached": [k for k in launches if k.startswith("bcr_") and launches[k]],
          "limits": {"relerr": EXAMPLE_RELERR, "relerr_d05": EXAMPLE_RELERR_D05,
                     "timeout_s": {**{a[0]: EXAMPLE_DEFAULT_TIMEOUT_S for a in EXAMPLE_RUNS},
                                   **EXAMPLE_TIMEOUT_S}}})
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


def lm_bf16_scan_check(dev, cfg, fam, params, seed: int) -> dict:
    """One model with scan_dtype="bfloat16" against the same model with
    float32 scans, both computing in the model's bfloat16: five decode
    ticks and a B=4, T=512 prefill, each from an empty state and, for
    RWKV6, from the state of a 64-token prefix (L1: its cold start is
    ill-conditioned).  Each reading is the largest logit difference over
    the largest logit: the kernels' bfloat16 scans against the kernels'
    float32 scans (gated), the plain versions' bfloat16 scans against the
    same float32 run (the witness: what the dtype alone moves), and the
    kernels' bfloat16 scans against the plain versions' (the kernels'
    own share).  Every reading is gated: the kernels' against the float32
    run at most LM_BF16_SCAN_RTOL of the largest logit or
    LM_BF16_SCAN_WITNESS times the witness, whichever is larger.  Also the
    bfloat16 scan launches and the prefill ms of each scan dtype."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd import ssd, ssd_plain
    from repro_torch.kernels.wkv import wkv6, wkv6_plain

    rwkv = cfg.family == "rwkv"
    kernel = wkv6 if rwkv else ssd
    attr, plain = ("_wkv6", wkv6_plain) if rwkv else ("_ssd", ssd_plain)
    bf = torch.bfloat16
    c_bf = dataclasses.replace(cfg, scan_dtype="bfloat16")
    assert cfg.scan_dtype == "float32"
    rng = np.random.default_rng(seed)
    prefix = torch.tensor(rng.integers(0, cfg.vocab, size=(PREFILL_B, CONSISTENCY_T)), device=dev)
    toks = torch.tensor(rng.integers(0, cfg.vocab, size=(PREFILL_B, 5)), device=dev)
    ptoks = torch.tensor(rng.integers(0, cfg.vocab, size=(PREFILL_B, PREFILL_T)), device=dev)
    out = {"scan_dtype": "bfloat16", "against": "float32 scans", "rtol": LM_BF16_SCAN_RTOL,
           "witness_factor": LM_BF16_SCAN_WITNESS, "compute_dtype": cfg.compute_dtype}
    before = kernel.by_dtype.get(bf, 0)

    def runs(state):
        """(decode logits, prefill logits) from ``state`` (None: empty)."""
        def cache():
            if state is None:
                return fam.init_cache(cfg, PREFILL_B, 8)
            return {nm: v.clone() for nm, v in state.items()}
        got = {}
        for tag, c, via_plain in (("f32", cfg, False), ("bf16", c_bf, False),
                                  ("bf16_plain", c_bf, True)):
            real = getattr(ops, attr)
            if via_plain:
                setattr(ops, attr, plain)
            try:
                cc, dec = cache(), []
                for i in range(5):
                    lg, cc = fam.decode_step(c, params, cc, toks[:, i:i + 1])
                    dec.append(lg[..., : cfg.vocab].float())
                pf, _ = fam.forward(c, params, ptoks, None if state is None else cache())
                got[tag] = (torch.stack(dec), pf[..., : cfg.vocab].float())
            finally:
                setattr(ops, attr, real)
        return got

    def reading(a, b, ref):
        return float((a - b).abs().max()) / float(ref.abs().max())

    with torch.inference_mode():
        states = {"cold": None}
        if rwkv:
            states["warm"] = fam.forward(cfg, params, prefix)[1]
        for sname, state in states.items():
            got = runs(state)
            for i, what in enumerate(("decode", "prefill")):
                f32, k_bf, p_bf = (got[t][i] for t in ("f32", "bf16", "bf16_plain"))
                r = {"kernel_bf16_vs_f32": reading(k_bf, f32, f32),
                     "plain_bf16_vs_f32": reading(p_bf, f32, f32),
                     "kernel_bf16_vs_plain_bf16": reading(k_bf, p_bf, p_bf),
                     "max_abs_logit": float(f32.abs().max()),
                     "finite": bool(torch.isfinite(k_bf).all())}
                r["limit"] = max(LM_BF16_SCAN_RTOL, LM_BF16_SCAN_WITNESS * r["plain_bf16_vs_f32"])
                out[f"{what}_{sname}"] = r
            del got
        del states
        for nm, c in (("float32_scan", cfg), ("bfloat16_scan", c_bf)):
            ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fam.forward(c, params, ptoks)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            out[f"prefill_ms_{nm}"] = ms
    out["bfloat16_launches"] = kernel.by_dtype.get(bf, 0) - before
    emit({"phase": "lm", "arch": cfg.name, "check": "bfloat16_scans", **out})
    for key, r in out.items():
        if isinstance(r, dict) and not (r["finite"] and r["kernel_bf16_vs_f32"] <= r["limit"]):
            raise AssertionError(f"{cfg.name} bfloat16 scans: {key} logits "
                                 f"{r['kernel_bf16_vs_f32']:.3e} of the largest off the "
                                 f"float32 scans' (limit {r['limit']:.3e})")
    if not out["bfloat16_launches"]:
        raise AssertionError(f"{cfg.name}: scan_dtype=bfloat16 never launched the bfloat16 kernel")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port package is missing under {SRC}", file=sys.stderr)
        return 2
    clock = PhaseClock()
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np

    from repro_torch.core import (
        CsrOperator,
        SaPOptions,
        band_matvec,
        band_to_block_tridiag,
        factor,
        plan,
        plan_banded,
        random_banded,
        random_sparse,
    )
    from repro_torch.core import block_lu as bl
    from repro_torch.core import cyclic_reduction as cr
    from repro_torch.core.spike import _reduced_interface_system
    from repro_torch.kernels import bcr, build, ops
    from repro_torch.kernels.ops import (
        bcr_work,
        btf_work,
        bts_work,
        fused_work,
        reduce_level_work,
        solve_level_work,
    )
    from repro_torch.configs import get_config, sap_solver
    from repro_torch.core import batched
    from repro_torch.kernels.btf import btf
    from repro_torch.kernels.bts import bts
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.fused_spike import fused_factor_spike
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.kernels.ssd import ssd, ssd_plain
    from repro_torch.kernels.wkv import scan_route, wkv6, wkv6_plain
    from repro_torch.launch import calibrate
    from repro_torch.obs import Tracer, use_tracer
    from repro_torch.launch.roofline import H100_DATASHEET as SHEET
    from repro_torch.launch.roofline import H100_DATASHEET_SFU_S, backend_spec
    from repro_torch.models import get_family
    from repro_torch.serve import Cancelled, Request, ServeEngine

    dev = torch.device("cuda")
    smi = nvidia_smi()

    # ---- 1. device and toolchain -------------------------------------------
    nvcc_v = subprocess.run([build.nvcc(), "--version"], capture_output=True, text=True)
    try:
        import triton

        triton_v = triton.__version__
    except ImportError:
        triton_v = None
    emit({
        "phase": "device",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc_v.stdout.strip().splitlines()[-1],
        "triton": triton_v,
        "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    })

    clock.end("device")
    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    ptxas = build.build_all()
    for name in build.SOURCES:
        build.load(name)
    emit({"phase": "build", "sources": list(build.SOURCES), "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})

    clock.end("build")
    # ---- calibrate: the card's ceilings, measured in this run ------------------
    t0 = time.perf_counter()
    cal = calibrate.calibrate()
    rates = {"float32_flop_s": (cal.peak_flops, SHEET.peak_flops),
             "bfloat16_flop_s": (cal.peak_bf16_flops, SHEET.peak_bf16_flops),
             "copy_bytes_s": (cal.hbm_bw, SHEET.hbm_bw)}
    committed = backend_spec("cuda")
    emit({"phase": "calibrate", "seconds": time.perf_counter() - t0,
          **{nm: {"measured": got, "datasheet": sheet, "measured_over_datasheet": got / sheet}
             for nm, (got, sheet) in rates.items()},
          "exponentials_s": {"datasheet": H100_DATASHEET_SFU_S, "calibrated": None},
          "committed_spec": {"name": committed.name, "float32_flop_s": committed.peak_flops,
                             "bfloat16_flop_s": committed.peak_bf16_flops,
                             "copy_bytes_s": committed.hbm_bw,
                             "link_bytes_s": committed.link_bw},
          "limit_over_datasheet": CALIBRATE_LIMIT, "nvidia_smi": smi})
    for nm, (got, sheet) in rates.items():
        if not 0.0 < got <= CALIBRATE_LIMIT * sheet:
            raise AssertionError(f"calibrate: {nm} {got:.4g} is not within (0, "
                                 f"{CALIBRATE_LIMIT} x the data sheet's {sheet:.4g}]")

    def bound(flops, nbytes) -> dict:
        """The bound against the data sheet's peaks and against this run's
        calibrated ceilings (float32 operations)."""
        ms, by = roofline_bound(flops, nbytes, SHEET.hbm_bw, SHEET.peak_flops)
        ms_cal, by_cal = roofline_bound(flops, nbytes, cal.hbm_bw, cal.peak_flops)
        return {"bound_ms": ms, "bound_by": by, "bound_ms_calibrated": ms_cal,
                "bound_by_calibrated": by_cal}

    def attention_bound(tc_ops, exps, nbytes) -> dict:
        """flash's bound both ways: bfloat16 tensor-core operations, the
        exponentials at the data sheet's rate either way."""
        ms, by = flash_bound(tc_ops, exps, nbytes, SHEET.hbm_bw, SHEET.peak_bf16_flops,
                             H100_DATASHEET_SFU_S)
        ms_cal, by_cal = flash_bound(tc_ops, exps, nbytes, cal.hbm_bw, cal.peak_bf16_flops,
                                     H100_DATASHEET_SFU_S)
        return {"bound_ms": ms, "bound_by": by, "bound_ms_calibrated": ms_cal,
                "bound_by_calibrated": by_cal}

    clock.end("calibrate")
    # ---- 3. kernels against plain versions on the card ----------------------
    band_d1 = torch.tensor(random_banded(N, K, 1.0, seed=SEED).astype(np.float32), device=dev)
    bt = band_to_block_tridiag(band_d1, K, 64)
    assert (bt.p, bt.m, bt.k) == (64, 16, 200)
    errs: dict[str, float] = {}
    routes: dict[str, int] = {}  # cluster size of each btf / fused / bts launch (0: one-block kernel)
    lib_btf, lib_fused = build.load("btf"), build.load("fused_spike")
    lib_bts, lib_bcr = build.load("bts"), build.load("bcr")

    def check_kernels(tag, d, e, f, b_cpl, c_cpl, rs):
        routes[f"btf{tag}"] = lib_btf.btf_cluster_size(d.shape[0], d.shape[2])
        sinv, l = btf(d, e, f)
        ref = bl.btf_ref(d, e, f)
        errs[f"btf{tag}"] = max(check_close(f"btf{tag} sinv", sinv, ref.sinv),
                                check_close(f"btf{tag} l", l, ref.l))
        g = torch.Generator(device=dev).manual_seed(SEED)
        for r in rs:
            rhs = torch.randn(d.shape[:3] + (r,), generator=g, device=dev)
            routes[f"bts{tag}_r{r}"] = lib_bts.bts_cluster_size(d.shape[0], d.shape[2], r)
            errs[f"bts{tag}_r{r}"] = check_close(
                f"bts{tag} r={r}", bts(ref.sinv, ref.l, f, rhs), bl.bts_ref(ref, rhs)
            )
        if b_cpl is not None:
            bq, cq = bl.pad_couplings(b_cpl, c_cpl, d.shape[0])
            routes[f"fused{tag}"] = lib_fused.fused_cluster_size(d.shape[0], d.shape[2])
            out = fused_factor_spike(d, e, f, bq, cq)
            want = bl.fused_factor_spike_padded_ref(d, e, f, bq, cq)
            errs[f"fused{tag}"] = max(
                check_close(f"fused{tag} {nm}", o, w)
                for nm, o, w in zip(("sinv", "l", "vb", "vt", "wt", "wb"), out, want)
            )

    def split_chain(band, k, p):
        """The SaP-E interface chain (P-1 blocks of 2K x 2K) of ``band``
        split into P partitions, as ``factor`` builds it: from the spike
        corners of the fused pass on the card."""
        sbt = band_to_block_tridiag(band, k, p)
        fs = ops.fused_factor_spike(sbt.d, sbt.e, sbt.f, sbt.b_cpl, sbt.c_cpl)
        return _reduced_interface_system(fs.v_bot, fs.v_top, fs.w_top, fs.w_bot)

    check_kernels("", bt.d, bt.e, bt.f, bt.b_cpl, bt.c_cpl, (1, 4, K))
    main_path_errs = dict(errs)
    # the SaP-E reduced chain of an 8-partition split of the same band
    rd, re, rf = split_chain(band_d1, K, 8)
    check_kernels("_chain", rd[None], re[None], rf[None], None, None, (1, 4))
    # edge cases: a single block row with an all-padding last partition; K
    # not a power of two with a partly padded last partition; K = 256, whose
    # block no longer fits one CTA's shared memory (btf and the fused pass
    # then spread it over a cluster of at least two)
    edge = {"_m1": (15, 5, 4), "_k37": (259, 37, 3), "_k256": (1400, 256, 2)}
    for tag, (n, k, p) in edge.items():
        small = torch.tensor(random_banded(n, k, 1.0, seed=SEED).astype(np.float32), device=dev)
        sbt = band_to_block_tridiag(small, k, p)
        check_kernels(tag, sbt.d, sbt.e, sbt.f, sbt.b_cpl, sbt.c_cpl, (1, 4, k))

    # BCR: each kernel on every level of a factor and a solve, and the whole
    # factor / solve, against the plain versions.  Main shapes: the SaP-E
    # interface chain of the d=0.5 band at P=64 (63 blocks of 2K=400).
    band_d05 = torch.tensor(random_banded(N, K, 0.5, seed=SEED).astype(np.float32), device=dev)
    chain = split_chain(band_d05, K, 64)
    assert tuple(chain[0].shape) == (63, 2 * K, 2 * K)
    # bts as SaP-E at P=8 and the P=500 splits run it: factors from the btf
    # kernel (held to its plain version above), kept for the timing phase
    bts_cases = {}
    for tag, p_split in (("_p8", 8), ("_p500", 500)):
        sbt = band_to_block_tridiag(band_d05, K, p_split)
        sinv_k, l_k = btf(sbt.d, sbt.e, sbt.f)
        facs = bl.BTFactors(sinv=sinv_k, l=l_k, f=sbt.f)
        g = torch.Generator(device=dev).manual_seed(SEED)
        rhs = torch.randn(sbt.d.shape[:3] + (1,), generator=g, device=dev)
        routes[f"bts{tag}_r1"] = lib_bts.bts_cluster_size(sbt.p, K, 1)
        errs[f"bts{tag}_r1"] = check_close(f"bts{tag} r=1", bts(sinv_k, l_k, sbt.f, rhs),
                                           bl.bts_ref(facs, rhs))
        bts_cases[tag] = (facs, rhs)
        del sbt

    def bcr_inputs(d, e, f, rs):
        """Per-level kernel inputs of one plain factor and, for each R in
        ``rs``, of one plain solve with a seeded R-column right-hand side:
        [(d, e, f, a_odd)], {R: ([(lo, hi, b)], [(a, e_odd, f_odd, b, x)])}
        and the root block."""
        pd, pe, pf = cr.pad_chain(d, e, f)
        facts, lv = [], []
        while pd.shape[0] > 1:
            a = cr.bcr_inv_odd_ref(pd)
            facts.append((pd, pe, pf, a))
            level, (pd, pe, pf) = cr.bcr_reduce_level_ref(pd, pe, pf)
            lv.append(level)
        root_inv = cr.bcr_inv_odd_ref(pd, first=0)[0]
        solves = {}
        for r in rs:
            g = torch.Generator(device=dev).manual_seed(SEED)
            b = cr.pad_rhs(torch.randn(d.shape[0], d.shape[1], r, generator=g, device=dev), len(lv))
            downs, rhs = [], []
            for level in lv:
                downs.append((level.lo, level.hi, b))
                rhs.append(b)
                b = cr.bcr_rhs_reduce_ref(level.lo, level.hi, b)
            x = (root_inv @ b[0])[None]
            ups = []
            for level, bl_ in zip(reversed(lv), reversed(rhs)):
                ups.append((level.a_odd, level.e_odd.contiguous(), level.f_odd.contiguous(), bl_, x))
                x = cr.bcr_backsub_ref(level.a_odd, level.e_odd, level.f_odd, bl_, x)
            solves[r] = (downs, ups)
        return facts, solves, pd

    reduce_tiles: dict[str, list] = {}  # each reduce level's (m/2, tile size)

    def check_bcr(tag, d, e, f, rs):
        facts, solves, root = bcr_inputs(d, e, f, rs)
        reduce_tiles[tag or "_p64"] = [(pd.shape[0] // 2, lib_bcr.bcr_reduce_tile(
            pd.shape[0] // 2, pd.shape[1])) for pd, _, _, _ in facts]
        err = {nm: 0.0 for nm in ("bcr_inv_odd", "bcr_reduce", "bcr_rhs_reduce", "bcr_backsub")}
        for pd, pe, pf, a in facts:
            err["bcr_inv_odd"] = max(err["bcr_inv_odd"], check_close(
                f"bcr_inv_odd{tag}", bcr.inv_odd(pd), a))
            for o, w in zip(bcr.reduce(pd, pe, pf, a), cr.bcr_reduce_ref(pd, pe, pf, a)):
                err["bcr_reduce"] = max(err["bcr_reduce"], check_close(f"bcr_reduce{tag}", o, w))
        err["bcr_inv_odd"] = max(err["bcr_inv_odd"], check_close(
            f"bcr_inv_odd{tag} root", bcr.inv_odd(root, first=0), cr.bcr_inv_odd_ref(root, first=0)))
        for r, (downs, ups) in solves.items():  # every level at every R
            for lo, hi, b in downs:
                err["bcr_rhs_reduce"] = max(err["bcr_rhs_reduce"], check_close(
                    f"bcr_rhs_reduce{tag} r={r} m2={lo.shape[0]}", bcr.rhs_reduce(lo, hi, b),
                    cr.bcr_rhs_reduce_ref(lo, hi, b)))
            for a, eo, fo, b, x in ups:
                err["bcr_backsub"] = max(err["bcr_backsub"], check_close(
                    f"bcr_backsub{tag} r={r} m2={a.shape[0]}", bcr.backsub(a, eo, fo, b, x),
                    cr.bcr_backsub_ref(a, eo, fo, b, x)))
        for nm, v in err.items():
            errs[f"{nm}{tag}"] = v
        fac, want = ops.bcr_factor(d, e, f), cr.bcr_factor(d, e, f)
        errs[f"bcr_factor{tag}"] = max(
            [check_close(f"bcr_factor{tag} root", fac.root_inv, want.root_inv)]
            + [check_close(f"bcr_factor{tag}", o, w)
               for lo_, lw in zip(fac.levels, want.levels) for o, w in zip(lo_, lw)]
        )
        g = torch.Generator(device=dev).manual_seed(SEED + 1)
        for r in rs:
            h = torch.randn(d.shape[0], d.shape[1], r, generator=g, device=dev)
            errs[f"bcr_solve{tag}_r{r}"] = check_close(
                f"bcr_solve{tag} r={r}", ops.bcr_solve(fac, h), cr.bcr_solve(want, h))

    check_bcr("", *chain, (1, 4, 8))
    bcr_errs = {nm: errs[nm] for nm in ("bcr_inv_odd", "bcr_reduce", "bcr_rhs_reduce", "bcr_backsub")}
    # btf and bts as E_chain_p64 runs them: one partition of 63 block rows
    check_kernels("_chain64", chain[0][None], chain[1][None], chain[2][None], None, None, (1, 4))
    coupling = {"p64": chain_coupling(*chain)}
    # P=500: partitions of two block rows, too short for the far spikes to
    # decay, so E, F and every coupling term of BCR stay active
    chain500 = split_chain(band_d05, K, 500)
    coupling["p500"] = chain_coupling(*chain500)
    check_bcr("_p500", *chain500, (1, 4, 8))  # chain500 is kept for the timing phase

    # the sparse system: float32-exact values, so the float32 operator the
    # plan keeps is the matrix solved; b = A x* in float64
    t0 = time.perf_counter()
    csr = random_sparse(N, 20.0, d=1.0, seed=SEED, structured_band=50)
    csr.data = csr.data.astype(np.float32).astype(np.float64)
    a_sparse = CsrOperator.from_csr(csr, dtype=torch.float64, device=dev)
    sparse_gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sparse_plan = plan(csr, SaPOptions(p=64, variant="auto", tol=TOL, maxiter=MAXITER,
                                       precond_dtype="float32"))
    torch.cuda.synchronize()
    emit({"phase": "sparse_plan", "n": csr.n, "nnz": csr.nnz, "generate_s": sparse_gen_s,
          "plan_s": time.perf_counter() - t0, "k_after_reorder": sparse_plan.k,
          "info": sparse_plan.info})
    # the sparse run's kernels at its shapes: the reordered band split as
    # factor splits it (K=95), and its interface chain (2K=190: inv_odd
    # eliminates in shared memory)
    ks = max(sparse_plan.k, 1)
    sbt = band_to_block_tridiag(sparse_plan.band_pc, ks, 64)
    check_kernels("_sparse", sbt.d, sbt.e, sbt.f, sbt.b_cpl, sbt.c_cpl, (1, 4))
    del sbt
    chain_sp = split_chain(sparse_plan.band_pc, ks, 64)
    coupling["sparse"] = chain_coupling(*chain_sp)
    check_bcr("_sparse", *chain_sp, (1, 4, 8))
    del chain_sp
    # The far spike corners of this band have decayed to nothing, so its
    # chain's couplings E, F are (numerically) zero.  A random chain of the
    # same shape with dense couplings holds the kernels to every term; then
    # edge cases: a one-block chain (root only), m=3 (padded to 4) at
    # 2K=400, and K=37 with R=K.  Random parts are scaled by 1/sqrt(K), so
    # the 4 I shift keeps every block well conditioned.
    edges = {"_dense": (63, 2 * K, 1), "_m1": (1, 400, 1), "_m3": (3, 400, 4), "_k37": (5, 37, 37)}
    for tag, (m, k, r) in edges.items():
        g = torch.Generator(device=dev).manual_seed(SEED)
        sc = k**-0.5
        d = sc * torch.randn(m, k, k, generator=g, device=dev) + 4 * torch.eye(k, device=dev)
        e = 0.3 * sc * torch.randn(m, k, k, generator=g, device=dev)
        f = 0.3 * sc * torch.randn(m, k, k, generator=g, device=dev)
        check_bcr(tag, d, e, f, (r,))
    # the SaP-scan kernels at the LM path's shapes: RWKV6-1.6B's 32 heads of
    # D=64 and Zamba2-2.7B's 80 heads of N=P=64 (B, C shared by the heads),
    # at decode (8 slots, T=1, chunk 1) and prefill (B=4, T=512, chunk 64)
    rw, zb = get_config("rwkv6-1.6b"), get_config("zamba2-2.7b")
    rw_h, rw_d = rw.d_model // rw.rwkv_head_dim, rw.rwkv_head_dim
    zb_h = zb.ssm_expand * zb.d_model // zb.ssm_head_dim
    zb_n, zb_p = zb.ssm_state, zb.ssm_head_dim
    scan_shapes = {
        "decode": (LM_SLOTS, 1, 1), "prefill": (PREFILL_B, PREFILL_T, rw.ssm_chunk),
        "c16": (2, 64, 16), "strong": (2, 64, 64), "strong_c16": (2, 64, 16),
        "ragged_c37": (2, 74, 37), "c1_t16": (2, 16, 1), "c128": (1, 128, 128),
    }
    scan_routes = {}  # the route each call took

    def scan_call(name, wrapper, route, fn):
        """fn() through ``wrapper``, which must take ``route`` for it."""
        before = wrapper.by_route[route]
        out = fn()
        if wrapper.by_route[route] != before + 1:
            raise AssertionError(f"{name} did not take the {route} route: {wrapper.by_route}")
        scan_routes[name] = route
        return out

    for tag, (b, t, c) in scan_shapes.items():
        strong = tag.startswith("strong")
        args = wkv_inputs(dev, b * rw_h, t, rw_d, SEED, strong)
        o, st = scan_call(f"wkv_{tag}", wkv6, scan_route(c, rw_d), lambda: wkv6(*args, c))
        want = wkv6_plain(*args, c)
        errs[f"wkv_{tag}"] = max(check_close(f"wkv {tag} o", o, want[0]),
                                 check_close(f"wkv {tag} state", st, want[1]))
        args = ssd_inputs(dev, b * zb_h, t, zb_n, zb_p, zb_h, SEED, strong)
        y, st = scan_call(f"ssd_{tag}", ssd, scan_route(c, zb_n, zb_p),
                          lambda: ssd(*args, c, zb_h))
        want = ssd_plain(*args, c, zb_h)
        errs[f"ssd_{tag}"] = max(check_close(f"ssd {tag} y", y, want[0]),
                                 check_close(f"ssd {tag} state", st, want[1]))
    # B and C per head (no sharing), and the chunk check: T=96 with chunk 64
    args = ssd_inputs(dev, 2 * 4, 64, zb_n, zb_p, 1, SEED)
    errs["ssd_per_head"] = check_close(
        "ssd per-head B, C",
        scan_call("ssd_per_head", ssd, scan_route(16, zb_n, zb_p), lambda: ssd(*args, 16)[0]),
        ssd_plain(*args, 16)[0])
    # the LM path's shapes take the new routes; only chunk 128 keeps the old kernel
    for name, route in scan_routes.items():
        if (route == "block") != name.endswith("c128"):
            raise AssertionError(f"{name} took the {route} route: {scan_routes}")
    zb_rows = PREFILL_B * zb_h
    ssd_head_group = build.load("ssd").ssd_split_head_group(zb_rows, PREFILL_T, rw.ssm_chunk,
                                                            zb_h)
    refused = []
    for name, fn in (("wkv", lambda: wkv6(*wkv_inputs(dev, rw_h, 96, rw_d, SEED), 64)),
                     ("ssd", lambda: ssd(*ssd_inputs(dev, zb_h, 96, zb_n, zb_p, zb_h, SEED),
                                         64, zb_h))):
        try:
            fn()
        except ValueError as exc:
            refused.append(f"{name}: {exc}")
        else:
            raise AssertionError(f"{name}: T=96 with chunk 64 was not refused")
    # the flash kernel at the dense configurations' attention shapes, in
    # bfloat16 (the prefill) and float32 (the consistency check)
    def attn_shape(name, reduced=False):
        c = get_config(name, reduced)
        return c.n_heads, c.n_kv_heads, c.head_dim, c.window

    mt_hq, mt_hk, mt_d, _ = attn_shape(DENSE_ARCH)
    sc_hq, sc_hk, sc_d, sc_w = attn_shape("starcoder2-15b")
    mx_hq, mx_hk, mx_d, mx_w = attn_shape(MIXTRAL_ARCH)
    wh_hq, wh_hk, wh_d, _ = attn_shape(ENCDEC_ARCH)
    wh_enc = get_config(ENCDEC_ARCH).enc_seq
    vlm_rows = get_config(VLM_ARCH).n_patches + PREFILL_T
    flash_shapes = {
        # tag: (b, hq, hk, tq, tk, d, causal, window)
        "minitron": (1, mt_hq, mt_hk, DENSE_LONG_T, DENSE_LONG_T, mt_d, True, None),
        "starcoder2": (1, sc_hq, sc_hk, 2 * sc_w, 2 * sc_w, sc_d, True, sc_w),
        "phi3_d96": (1, *attn_shape("phi3-mini-3.8b")[:2], 1024, 1024,
                     attn_shape("phi3-mini-3.8b")[2], True, None),
        "stablelm_d64": (1, *attn_shape("stablelm-1.6b")[:2], 1024, 1024,
                         attn_shape("stablelm-1.6b")[2], True, None),
        "reduced_d16": (2, *attn_shape(DENSE_ARCH, True)[:2], 128, 128,
                        attn_shape(DENSE_ARCH, True)[2], True, None),
        "bidirectional": (1, 8, 8, 512, 512, 64, False, None),
        "ragged_tk": (1, mt_hq, mt_hk, 1000, 1000, mt_d, True, None),
        "ragged_tq_tk": (1, 8, 2, 256, 333, mt_d, False, None),
        "window16": (1, mt_hq, mt_hk, 512, 512, mt_d, True, 16),
        # the MoE, VLM and encoder-decoder prompt passes: deepseek-moe-16b's
        # prefill (16 over 16, D=128), mixtral-8x22b's long one (48 over 8,
        # window 4096), phi-3-vision's (D=96 over 576 patches + the text),
        # and whisper-medium's encoder (bidirectional, a ragged 1,500),
        # decoder self-attention and cross-attention (Tq=448, Tk=1,500)
        "deepseek": (PREFILL_B, *attn_shape(MOE_ARCH)[:2], PREFILL_T, PREFILL_T,
                     attn_shape(MOE_ARCH)[2], True, None),
        "mixtral": (1, mx_hq, mx_hk, MIXTRAL_LONG_T, MIXTRAL_LONG_T, mx_d, True, mx_w),
        "phi3v": (PREFILL_B, *attn_shape(VLM_ARCH)[:2], vlm_rows, vlm_rows,
                  attn_shape(VLM_ARCH)[2], True, None),
        "whisper_enc": (PREFILL_B, wh_hq, wh_hk, wh_enc, wh_enc, wh_d, False, None),
        "whisper_self": (PREFILL_B, wh_hq, wh_hk, WHISPER_TRAIN_T, WHISPER_TRAIN_T, wh_d,
                         True, None),
        "whisper_cross": (PREFILL_B, wh_hq, wh_hk, WHISPER_TRAIN_T, wh_enc, wh_d, False, None),
    }
    assert flash_shapes["starcoder2"][1:] == (48, 4, 8192, 8192, 128, True, 4096)
    assert flash_shapes["mixtral"][1:] == (48, 8, 8192, 8192, 128, True, 4096)
    assert flash_shapes["whisper_cross"][1:] == (16, 16, 448, 1500, 64, False, None)
    bf16_share = {}  # each bfloat16 check's worst element over its limit
    for tag, (b, hq, hk, tq, tk, d, causal, window) in flash_shapes.items():
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = flash_inputs(dev, b, hq, hk, tq, tk, d, dtype, SEED)
            got = flash_attention(q, k, v, causal, window)
            want = flash_attention_ref(q, k, v, causal, window)
            if got.dtype != dtype:
                raise AssertionError(f"flash {tag}: output is {got.dtype}, not {dtype}")
            what = f"flash {tag} {dtype}"
            if dtype == torch.bfloat16:
                err, bf16_share[tag] = check_close_bf16(what, got, want)
            else:
                err = check_close(what, got, want)
            errs[f"flash_{tag}_{str(dtype)[6:]}"] = err
            del q, k, v, got, want
    # fleets: S systems folded into each kernel's chain axis.  btf, the fused
    # pass and bts (R = 1, 4) at S*P = 64 * 16 chains of the fleet config's
    # K = 16 and of the K' = 2, 4, 8 that pow2 buckets give at the serving
    # sizes, through kernels/ops.py's fold (one launch each) against the
    # plain versions on the folded operands; BCR over the S = 64 reduced
    # chains of 15 interfaces (2K = 32 and 4) of the d = 0.5 fleets: every
    # level's kernels on the S padded chains laid end to end, as the
    # stacked factor lays them, and the stacked factor / solve against each
    # chain's plain BCR.  Each kernel's cluster size, tile or split at the
    # folded shape beside one system's.
    fcfg = sap_solver.fleet()
    nchains = FLEET_S * FLEET_P
    fleet_routes = {}

    def fleet_split(kf, dd):
        bands = np.stack([random_banded(fcfg.n, kf, dd, seed=SEED + 100 + i).astype(np.float32)
                          for i in range(FLEET_S)])
        return band_to_block_tridiag(torch.tensor(bands, device=dev), kf, FLEET_P)

    def fold(t):
        return t.flatten(0, 1)

    for kf in (fcfg.k, 2, 4, 8):
        tag = f"_fleet_k{kf}"
        fbt = fleet_split(kf, fcfg.d)
        if kf == fcfg.k:
            fleet_bt = fbt  # kept for the timing phase
        routes[f"btf{tag}"] = lib_btf.btf_cluster_size(nchains, kf)
        routes[f"fused{tag}"] = lib_fused.fused_cluster_size(nchains, kf)
        lu = ops.block_tridiag_factor(fbt.d, fbt.e, fbt.f)
        want_lu = bl.btf_ref(fold(fbt.d), fold(fbt.e), fold(fbt.f))
        errs[f"btf{tag}"] = max(check_close(f"btf{tag} sinv", fold(lu.sinv), want_lu.sinv),
                                check_close(f"btf{tag} l", fold(lu.l), want_lu.l))
        fs = ops.fused_factor_spike(fbt.d, fbt.e, fbt.f, fbt.b_cpl, fbt.c_cpl)
        bq_f, cq_f = bl.pad_couplings(fbt.b_cpl, fbt.c_cpl, FLEET_P)
        want = [t.reshape((FLEET_S, FLEET_P) + tuple(t.shape[1:])) for t in
                bl.fused_factor_spike_padded_ref(fold(fbt.d), fold(fbt.e), fold(fbt.f),
                                                 fold(bq_f), fold(cq_f))]
        errs[f"fused{tag}"] = max(
            check_close(f"fused{tag} {nm}", o, w) for nm, o, w in zip(
                ("sinv", "l", "vb", "vt", "wt", "wb"),
                (fs.lu.sinv, fs.lu.l, fs.v_bot, fs.v_top, fs.w_top, fs.w_bot),
                (want[0], want[1], want[2][:, :-1], want[3][:, :-1], want[4][:, 1:],
                 want[5][:, 1:])))
        g = torch.Generator(device=dev).manual_seed(SEED)
        for r in (1, 4):
            rhs = torch.randn(tuple(fbt.d.shape[:4]) + (r,), generator=g, device=dev)
            routes[f"bts{tag}_r{r}"] = lib_bts.bts_cluster_size(nchains, kf, r)
            errs[f"bts{tag}_r{r}"] = check_close(f"bts{tag} r={r}",
                                                 fold(ops.block_tridiag_solve(lu, rhs)),
                                                 bl.bts_ref(want_lu, fold(rhs)))
        fleet_routes[f"k{kf}"] = {
            "chains": nchains, "m": fbt.m,
            "btf_cluster": routes[f"btf{tag}"],
            "btf_cluster_one_system": lib_btf.btf_cluster_size(FLEET_P, kf),
            "fused_cluster": routes[f"fused{tag}"],
            "fused_cluster_one_system": lib_fused.fused_cluster_size(FLEET_P, kf),
            "bts_cluster_r1": routes[f"bts{tag}_r1"],
            "bts_cluster_r1_one_system": lib_bts.bts_cluster_size(FLEET_P, kf, 1),
            "bts_copies": "tma" if lib_bts.bts_bulk_route(
                lu.sinv.data_ptr(), lu.l.data_ptr(), fbt.f.data_ptr(), kf) else "cp.async"}
        del fbt, lu, want_lu, fs, want
        if kf not in (fcfg.k, 2):
            continue
        ebt = fleet_split(kf, 0.5)
        efs = ops.fused_factor_spike(ebt.d, ebt.e, ebt.f, ebt.b_cpl, ebt.c_cpl)
        rd_f, re_f, rf_f = _reduced_interface_system(efs.v_bot, efs.v_top, efs.w_top, efs.w_bot)
        assert tuple(rd_f.shape) == (FLEET_S, FLEET_P - 1, 2 * kf, 2 * kf)
        del ebt, efs
        ends = [cr.pad_chain(*c) for c in zip(rd_f, re_f, rf_f)]
        check_bcr(tag, *(torch.cat(t) for t in zip(*ends)), (1, 4))
        stacked = ops.bcr_factor(rd_f, re_f, rf_f)
        h = torch.randn(FLEET_S, FLEET_P - 1, 2 * kf, 4, generator=g, device=dev)
        y = ops.bcr_solve(stacked, h)
        plain = [cr.bcr_factor(*c) for c in zip(rd_f, re_f, rf_f)]
        errs[f"bcr_stacked{tag}"] = max(
            [check_close(f"bcr_stacked{tag} root", stacked.root_inv[i], w.root_inv)
             for i, w in enumerate(plain)]
            + [check_close(f"bcr_stacked{tag} solve", y[i], cr.bcr_solve(w, h[i]))
               for i, w in enumerate(plain)])
        m2s = [lv.lo.shape[1] for lv in stacked.levels]
        fleet_routes[f"k{kf}"]["bcr_by_level"] = [{
            "m2_one_system": m2, "m2": FLEET_S * m2,
            "reduce_tile": lib_bcr.bcr_reduce_tile(FLEET_S * m2, 2 * kf),
            "reduce_tile_one_system": lib_bcr.bcr_reduce_tile(m2, 2 * kf),
            "rhs_reduce_split": lib_bcr.bcr_rhs_reduce_split(FLEET_S * m2, 2 * kf, 1),
            "rhs_reduce_split_one_system": lib_bcr.bcr_rhs_reduce_split(m2, 2 * kf, 1),
            "backsub_cluster": lib_bcr.bcr_backsub_cluster(FLEET_S * m2, 2 * kf, 1),
            "backsub_cluster_one_system": lib_bcr.bcr_backsub_cluster(m2, 2 * kf, 1)}
            for m2 in m2s]
        del rd_f, re_f, rf_f, ends, stacked, plain, y, h
    torch.cuda.synchronize()
    # btf and the fused pass always on a cluster here; bts on one exactly
    # when R <= 8 (whole spikes, R = K, take the one-block kernel)
    for nm, cs in routes.items():
        wide = nm.startswith("bts") and int(nm.rsplit("_r", 1)[1]) > 8
        if (cs == 0) != wide:
            raise AssertionError(f"{nm} took cluster size {cs}: {routes}")
    emit({"phase": "kernels_vs_plain", "rtol_normwise": KERNEL_RTOL, "routes": routes,
          "reduce_tiles": reduce_tiles, "scan_routes": scan_routes,
          "ssd_prefill_head_group": ssd_head_group,
          "flash_bfloat16_step_atol": [FLASH_BF16_STEP, FLASH_BF16_ATOL],
          "flash_bfloat16_worst_share": bf16_share, "max_abs_err": errs,
          "chain_coupling": coupling, "refused": refused, "flash_shapes": flash_shapes,
          "fleet_routes": fleet_routes})

    clock.end("kernels_vs_plain")
    # ---- 4. the slices at full size ------------------------------------------
    rng = np.random.default_rng(SEED)
    xstar = torch.tensor(rng.normal(size=N), device=dev)
    systems = {}
    for name, band in (("d1.0", band_d1), ("d0.5", band_d05)):
        b64 = band_matvec(band.double(), xstar)
        systems[name] = (band, b64)
    wrappers = {"btf": btf, "bts": bts, "fused_factor_spike": fused_factor_spike,
                "bcr_inv_odd": bcr.inv_odd, "bcr_reduce": bcr.reduce,
                "bcr_rhs_reduce": bcr.rhs_reduce, "bcr_backsub": bcr.backsub,
                "wkv": wkv6, "ssd": ssd, "flash": flash_attention}
    bcr_names = ("bcr_inv_odd", "bcr_reduce", "bcr_rhs_reduce", "bcr_backsub")

    def reset():
        for w in wrappers.values():
            w.launches = 0
        bcr.inv_odd.block_launches = 0
        btf.block_launches = fused_factor_spike.block_launches = bts.block_launches = 0
        bts.by_cluster.clear()
        bcr.reduce.by_tile.clear()
        for w in (bcr.rhs_reduce, bcr.backsub):
            w.block_launches = 0
        bcr.rhs_reduce.by_split.clear()
        bcr.backsub.by_cluster.clear()
        for w in (wkv6, ssd):
            w.by_route.update(dict.fromkeys(w.by_route, 0))

    def counts():
        """Every wrapper's launches, and inv_odd's, btf's, the fused pass's
        and bts's on their one-block routes and rhs_reduce's and backsub's
        on their tiled ones apart."""
        return {**{nm: w.launches for nm, w in wrappers.items()},
                "bcr_inv_odd_block": bcr.inv_odd.block_launches,
                "bcr_rhs_reduce_block": bcr.rhs_reduce.block_launches,
                "bcr_backsub_block": bcr.backsub.block_launches,
                "btf_block": btf.block_launches,
                "fused_factor_spike_block": fused_factor_spike.block_launches,
                "bts_block": bts.block_launches}

    runs = [
        # name, system, options, R, kernels the path must launch
        ("D", "d1.0", dict(p=64, variant="D"), 0, ("btf", "bts")),
        ("C", "d1.0", dict(p=64, variant="C"), 0, ("fused_factor_spike", "bts", "btf")),
        ("C_unfused", "d1.0", dict(p=64, variant="C", fused_factor="off"), 0, ("btf", "bts")),
        ("E", "d0.5", dict(p=8, variant="E"), 0, ("fused_factor_spike", "btf", "bts")),
        ("C_many", "d1.0", dict(p=64, variant="C"), 4, ("fused_factor_spike", "bts", "btf")),
        ("E_bcr", "d0.5", dict(p=64, variant="E", reduced_solver="auto"), 0,
         ("fused_factor_spike", "bts") + bcr_names),
        ("E_chain_p64", "d0.5", dict(p=64, variant="E", reduced_solver="chain"), 0,
         ("fused_factor_spike", "btf", "bts")),
        ("E_bcr_p500", "d0.5", dict(p=500, variant="E", reduced_solver="bcr"), 0,
         ("fused_factor_spike", "bts") + bcr_names),
        ("C_p500", "d0.5", dict(p=500, variant="C"), 0, ("fused_factor_spike", "bts", "btf")),
        ("sparse", "sparse", None, 0, ("fused_factor_spike", "bts") + bcr_names),
    ]
    # runs whose reduced chain must go through BCR, and the chain's coupling
    bcr_runs = {"E_bcr": "p64", "E_bcr_p500": "p500", "sparse": "sparse"}
    iterations = {}
    totals = dict.fromkeys(wrappers, 0)
    for name, sysname, kw, nrhs, must in runs:
        if sysname == "sparse":
            rhs, want_x = a_sparse.matvec(xstar), xstar
            matvec = a_sparse.matvec
        else:
            band, b64 = systems[sysname]
            a64 = band.double()
            matvec = lambda x, a64=a64: band_matvec(a64, x)  # noqa: E731
            if nrhs:
                scale = torch.arange(1, nrhs + 1, device=dev, dtype=torch.float64)
                rhs, want_x = b64[:, None] * scale, xstar[:, None] * scale
            else:
                rhs, want_x = b64, xstar
            opts = SaPOptions(tol=TOL, maxiter=MAXITER, precond_dtype="float32", **kw)
        # Each stage runs twice: the first call also pays one-time costs
        # (lazy loading of torch's CUDA kernels); the second is reported as
        # the stage's time.  Launch counts are those of the first call.
        first = {}
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for attempt in range(2):
            t0 = time.perf_counter()
            fac = factor(sparse_plan if sysname == "sparse" else plan_banded(band, opts))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if attempt == 0:
                factor_counts = counts()
            res = fac.solve_many(rhs) if nrhs else fac.solve(rhs)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if attempt == 0:
                solve_counts = {nm: c - factor_counts[nm] for nm, c in counts().items()}
                run_routes = {"bts_by_cluster": dict(sorted(bts.by_cluster.items())),
                              "reduce_by_tile": dict(sorted(bcr.reduce.by_tile.items())),
                              "rhs_reduce_by_split": dict(sorted(bcr.rhs_reduce.by_split.items())),
                              "backsub_by_cluster": dict(sorted(bcr.backsub.by_cluster.items()))}
                first = {"factor_ms_first_call": (t1 - t0) * 1e3,
                         "solve_ms_first_call": (t2 - t1) * 1e3}
                peak = torch.cuda.max_memory_allocated()
                del fac, res
        x = res.x
        resid = (rhs - matvec(x)).norm(dim=0) / rhs.norm(dim=0)
        fwd = (x - want_x).norm(dim=0) / want_x.norm(dim=0)
        its = res.iterations.flatten().tolist()
        line = {
            "phase": "slice", "run": name, "n": N, "k": fac.k, "system": sysname,
            "variant": fac.variant, "p": fac.p, "fused": fac.pc.fused,
            "reduced_solver": fac.pc.reduced_solver, "nrhs": max(nrhs, 1),
            "iterations": its, "true_resnorm_f64": resid.flatten().tolist(),
            "forward_error": fwd.flatten().tolist(),
            "factor_ms": (t1 - t0) * 1e3, "solve_ms": (t2 - t1) * 1e3, **first,
            "peak_mem_bytes": peak,
            "launches_factor": factor_counts, "launches_solve": solve_counts, **run_routes,
        }
        if name in bcr_runs:
            line["chain_coupling"] = coupling[bcr_runs[name]]
        emit(line)
        iterations[name] = max(its)
        for nm in wrappers:
            totals[nm] += factor_counts[nm] + solve_counts[nm]
        if not bool(torch.isfinite(x).all()) or x.shape != want_x.shape:
            raise AssertionError(f"slice {name}: bad solution")
        if float(resid.max()) > 1e-6:
            raise AssertionError(f"slice {name}: true_resnorm {resid.tolist()} > 1e-6")
        if name in bcr_runs and (fac.variant, fac.pc.reduced_solver) != ("E", "bcr"):
            raise AssertionError(f"slice {name}: variant {fac.variant!r}, reduced_solver "
                                 f"{fac.pc.reduced_solver!r}")
        if name in bcr_runs and min(factor_counts[nm] for nm in bcr_names[:2]) == 0:
            raise AssertionError(f"slice {name}: inv_odd / reduce not launched by the factor")
        if name in bcr_runs and min(solve_counts[nm] for nm in bcr_names[2:]) == 0:
            raise AssertionError(f"slice {name}: rhs_reduce / backsub not launched by the solve")
        for nm in must:
            if factor_counts[nm] + solve_counts[nm] == 0:
                raise AssertionError(f"slice {name}: kernel {nm} was never launched")
        if factor_counts["btf_block"] or factor_counts["fused_factor_spike_block"]:
            raise AssertionError(f"slice {name}: btf / fused took the one-block kernel")
        if factor_counts["bts_block"] + solve_counts["bts_block"]:  # every R here is <= 8
            raise AssertionError(f"slice {name}: bts took the one-block kernel")
        if solve_counts["bcr_rhs_reduce_block"] + solve_counts["bcr_backsub_block"]:
            raise AssertionError(f"slice {name}: rhs_reduce / backsub took the tiled kernels")
        del fac, res, x
    # the exact reduced system solves what truncated SPIKE drops: with the
    # couplings active, E must not need more sweeps than C
    if iterations["E_bcr_p500"] > iterations["C_p500"]:
        raise AssertionError(f"E_bcr_p500 took {iterations['E_bcr_p500']} sweeps, "
                             f"C_p500 {iterations['C_p500']}")

    clock.end("slices")
    # ---- trace: full() C, exact() E (BCR) and the sparse run under a Tracer --
    # Each case's warm calls, untraced and traced in turn (the first call
    # of all warms the plan): the span tree of the first traced call against
    # TRACE_TREES, the median factor / krylov span against the median
    # untraced host time, the Chrome export's B/E pairs.
    def span_tree(tracer):
        def rec(sp):
            kids = sorted((c for c in sp.children if not trace_port_only(c)), key=lambda c: c.t0)
            return (sp.name, tuple(rec(c) for c in kids))

        return tuple(rec(r) for r in tracer.roots() if not trace_port_only(r))

    def span_ms(tracer):
        """Milliseconds of every span by its path (parent/child)."""
        out = {}

        def rec(sp, prefix):
            path = f"{prefix}{sp.name}"
            out[path] = out.get(path, 0.0) + sp.duration_s * 1e3
            for c in sp.children:
                rec(c, path + "/")

        for r in tracer.roots():
            rec(r, "")
        return out

    reset()
    trace_cases = (("C", sap_solver.full(), "d1.0"), ("E_bcr", sap_solver.exact(), "d0.5"),
                   ("sparse", None, "sparse"))
    for name, ccfg, sysname in trace_cases:
        tracer = Tracer()
        if sysname == "sparse":
            with use_tracer(tracer):  # the host plan, traced once
                pl = plan(csr, sparse_plan.opts)
            rhs = a_sparse.matvec(xstar)
            band = None
        else:
            if (ccfg.n, ccfg.k, ccfg.d) != (N, K, float(sysname[1:])):
                raise AssertionError(f"trace {name}: {ccfg} is not the slice's system")
            band, rhs = systems[sysname]
            pl = plan_banded(band, ccfg.to_sap_options(64))

        def untraced_call():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fac = factor(pl)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fac.solve(rhs)
            torch.cuda.synchronize()
            return {"factor": t1 - t0, "krylov": time.perf_counter() - t1}

        untraced_call()  # warms the plan's first factor and solve
        untraced_s = {"factor": [], "krylov": []}
        traced_s = {"factor": [], "krylov": []}
        for rep in range(TRACE_REPS):
            traced_first = rep % 2 == 1  # so a drift in time favours neither
            if not traced_first:
                for st, t in untraced_call().items():
                    untraced_s[st].append(t)
            rep_tracer = tracer if rep == 0 else Tracer()  # the first holds the sparse plan
            with use_tracer(rep_tracer):
                fac = factor(pl)
                res = fac.solve(rhs)
            for st in traced_s:
                traced_s[st].append(rep_tracer.find(st)[0].duration_s)
            if traced_first:
                for st, t in untraced_call().items():
                    untraced_s[st].append(t)
        untraced = {st: statistics.median(ts) for st, ts in untraced_s.items()}
        traced = {st: statistics.median(ts) for st, ts in traced_s.items()}
        x = res.x
        ax = a_sparse.matvec(x) if band is None else band_matvec(band.double(), x)
        resid = float((rhs - ax).norm() / rhs.norm())
        with tempfile.TemporaryDirectory() as tmp:
            pairs = balanced_chrome_trace(tracer.export_chrome(str(Path(tmp) / "trace.json")))
        tree = span_tree(tracer)
        emit({"phase": "trace", "run": name, "variant": fac.variant, "p": fac.p,
              "fused": fac.pc.fused, "reduced_solver": fac.pc.reduced_solver,
              "summary": tracer.summary().splitlines(), "span_ms": span_ms(tracer),
              "untraced_ms": {st: t * 1e3 for st, t in untraced.items()},
              "traced_ms": {st: t * 1e3 for st, t in traced.items()},
              "untraced_ms_each": {st: [t * 1e3 for t in ts] for st, ts in untraced_s.items()},
              "traced_ms_each": {st: [t * 1e3 for t in ts] for st, ts in traced_s.items()},
              "traced_over_untraced": {st: traced[st] / untraced[st] for st in traced},
              "traced_over_untraced_total": sum(traced.values()) / sum(untraced.values()),
              "chrome_pairs": pairs, "true_resnorm_f64": resid,
              "iterations": float(res.iterations)})
        if tree != TRACE_TREES[name]:
            raise AssertionError(f"trace {name}: span tree {tree} is not {TRACE_TREES[name]}")
        lo, hi = TRACE_SPAN_RANGE
        for st, t in traced.items():
            if not lo * untraced[st] <= t <= hi * untraced[st] + TRACE_SPAN_SLACK_S:
                raise AssertionError(f"trace {name}: the median {st} span took {t * 1e3:.3f} ms "
                                     f"against {untraced[st] * 1e3:.3f} ms untraced")
        if resid > 1e-6 or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"trace {name}: true_resnorm {resid}")
        del fac, res, x, pl
    traced_counts = counts()
    for nm in totals:
        totals[nm] += traced_counts[nm]
    for nm in ("fused_factor_spike", "btf", "bts") + bcr_names:
        if not traced_counts[nm]:
            raise AssertionError(f"trace: kernel {nm} was never launched: {traced_counts}")

    clock.end("trace")
    # ---- distributed: the solver and the scans split over ranks ---------------
    # After phase trace: for seconds after the ranks' processes end, this
    # process's host times spread (calls read up to 1.6x their steady
    # time), and phase trace holds host times against each other.
    dist_launches = distributed_phase(dev, smi, systems, xstar, coupling)
    for nm in ("btf", "bts", "fused_factor_spike", "bcr_inv_odd"):
        totals[nm] += dist_launches[nm]

    clock.end("distributed")
    # ---- dtypes: bfloat16 and float64 preconditioners, bfloat16 scans ----------
    # after phase trace, whose host-time ratios it would disturb
    dtype_launches, dtype_summary = dtype_phase(dev, smi, band_d1, band_d05, xstar, cal)
    del systems, band_d05, sparse_plan, a_sparse, csr
    torch.cuda.empty_cache()

    clock.end("dtypes")
    # ---- the solver's serving path: fleet, batch_full, service ----------------
    from torch.profiler import ProfilerActivity, profile

    solver_kernels = ("btf", "bts", "fused_factor_spike") + bcr_names

    def timed(fn):
        """fn()'s result and its wall milliseconds, ended by a sync."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def device_busy(fn):
        """Wall ms of fn() (ended by a sync) and the profiler's device ms
        in it: the card's busy share of the wall time."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall = timed(fn)
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        return {"wall_ms": wall, "device_ms": busy, "busy_share": busy / wall}

    def delta(before):
        now = counts()
        return {nm: now[nm] - before[nm] for nm in solver_kernels if now[nm] != before[nm]}

    def sweeps(iterations) -> int:
        return math.ceil(float(iterations.max()))

    def applies(n_sweeps: int) -> int:
        """Preconditioner applies of a BiCGStab(2) solve: the initial
        residual, the norm of M^-1 b, and four a sweep."""
        return 2 + 4 * n_sweeps

    def add_totals():
        for nm, c in counts().items():
            if nm in totals:
                totals[nm] += c

    def watch_batches(log):
        """Wrap batch_factor and solve_batch (module and class attributes
        the engine reads) so that each call logs the launches it made; the
        previous functions are returned for unwatch()."""
        real = batched.batch_factor, batched.BatchedSaPFactorization.solve_batch

        def factor_logged(bpl):
            before = counts()
            out = real[0](bpl)
            log.append({"call": "factor", "s": bpl.s, **delta(before)})
            return out

        def solve_logged(self, b, record_history=False):
            before = counts()
            res = real[1](self, b, record_history)
            log.append({"call": "solve", "s": self.s, "sweeps": sweeps(res.iterations),
                        **delta(before)})
            return res

        batched.batch_factor = factor_logged
        batched.BatchedSaPFactorization.solve_batch = solve_logged
        return real

    def unwatch(real):
        batched.batch_factor, batched.BatchedSaPFactorization.solve_batch = real

    def must_launch(what, launched, names):
        """Every kernel of a path launched at least once in its run."""
        missing = [nm for nm in names if not launched.get(nm)]
        if missing:
            raise AssertionError(f"{what}: kernels {missing} were never launched: {launched}")

    def check_folds(what, log, one_factor, one_bts_per_apply):
        """No batch factor launches btf or the fused pass more than one
        system's factor does, and no batched solve more bts launches an
        apply than one system's solve: S launches would mean a loop."""
        for entry in log:
            if entry["call"] == "factor":
                for nm in ("btf", "fused_factor_spike"):
                    if entry.get(nm, 0) > one_factor.get(nm, 0):
                        raise AssertionError(f"{what}: a batch factor of {entry['s']} systems "
                                             f"launched {nm} {entry[nm]} times: {entry}")
            elif entry.get("bts", 0) > one_bts_per_apply * applies(entry["sweeps"]):
                raise AssertionError(f"{what}: a batched solve of {entry['s']} systems launched "
                                     f"bts {entry['bts']} times in {entry['sweeps']} sweeps")

    # fleet: 64 distinct matrices of configs/sap_solver.py:fleet(), each
    # submitted FLEET_ROUNDS times with a fresh right-hand side (b = A x*,
    # float64), round by round: one step of 64 misses, then hits
    fleet_bands = [random_banded(fcfg.n, fcfg.k, fcfg.d, seed=SEED + 100 + i).astype(np.float32)
                   for i in range(FLEET_S)]
    frng = np.random.default_rng(SEED + 1)
    fleet_x = frng.normal(size=(FLEET_S, fcfg.n, FLEET_ROUNDS))
    stack64 = torch.tensor(np.stack(fleet_bands), device=dev, dtype=torch.float64)
    fleet_b = band_matvec(stack64, torch.tensor(fleet_x, device=dev)).cpu().numpy()
    del stack64
    fopts = fcfg.to_sap_options(FLEET_P)
    # one system through the lifecycle: its factor's launches and its bts
    # launches an apply are what every batch is held to; first-call costs
    # (torch's lazy loading at these shapes) are paid here too
    reset()
    one = factor(plan_banded(fleet_bands[0], fopts))
    one_factor = counts()
    before = counts()
    one_res = one.solve(fleet_b[0, :, 0])
    one_bts = delta(before).get("bts", 0) / applies(sweeps(one_res.iterations))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for bd in fleet_bands:
        factor(plan_banded(bd, fopts))
    torch.cuda.synchronize()
    singles_factor_ms = (time.perf_counter() - t0) * 1e3
    warm = fcfg.to_engine(FLEET_P)
    for i in range(2):
        warm.submit_system(fleet_bands[i], fleet_b[i, :, 0])
    warm.run_until_drained()
    del warm, one
    eng = fcfg.to_engine(FLEET_P)
    for rnd in range(FLEET_ROUNDS):
        for i in range(FLEET_S):
            eng.submit_system(fleet_bands[i], fleet_b[i, :, rnd])
    log, steps = [], []
    real_step = eng.step

    def timed_step():
        s0, before, t0 = eng.stats_snapshot(), counts(), time.perf_counter()
        done = real_step()
        ms = (time.perf_counter() - t0) * 1e3
        s1 = eng.stats_snapshot()
        steps.append({"requests": len(done), "ms": ms,
                      "factor_ms": (s1["factor_seconds_total"] - s0["factor_seconds_total"]) * 1e3,
                      "solve_ms": (s1["solve_seconds_total"] - s0["solve_seconds_total"]) * 1e3,
                      "cache_hits": s1["cache_hits"] - s0["cache_hits"], "launches": delta(before)})
        return done

    eng.step = timed_step
    real = watch_batches(log)
    try:
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        done = eng.run_until_drained(on_leftover="raise")
        fleet_s = time.perf_counter() - t0
    finally:
        unwatch(real)
    fleet_counts = counts()
    add_totals()
    must_launch("fleet", fleet_counts, ("btf", "bts", "fused_factor_spike"))
    fstats = eng.stats_snapshot()
    # where a step's time goes: the 64 systems through each piece of a miss
    # step, each ended by a sync -- batch_plan (padding and stacking on the
    # host, the copy to the card), batch_factor, 64 index_factorization
    # copies, their stack, the batched solve -- and the card's busy share of
    # a factor, of a batched solve and of one system's factor
    fbpl, plan_ms = timed(lambda: batched.batch_plan(fleet_bands, fopts))
    fbfac, factor_ms = timed(lambda: batched.batch_factor(fbpl))
    facs, index_ms = timed(lambda: [batched.index_factorization(fbfac, i) for i in range(FLEET_S)])
    stacked, stack_ms = timed(lambda: batched.stack_factorizations(facs))
    fb0 = torch.tensor(fleet_b[:, :, 0], device=dev)
    _, solve_ms = timed(lambda: stacked.solve_batch(fb0))
    breakdown = {"batch_plan_ms": plan_ms, "batch_factor_ms": factor_ms,
                 "index_factorization_x64_ms": index_ms, "stack_factorizations_ms": stack_ms,
                 "solve_batch_ms": solve_ms,
                 "batch_factor_profile": device_busy(lambda: batched.batch_factor(fbpl)),
                 "solve_batch_profile": device_busy(lambda: stacked.solve_batch(fb0)),
                 "one_system_factor_profile": device_busy(
                     lambda: factor(plan_banded(fleet_bands[0], fopts)))}
    del fbpl, fbfac, facs, stacked, fb0
    order = sorted(done, key=lambda r: r.rid)
    x_got = np.stack([r.result.x for r in order]).reshape(FLEET_ROUNDS, FLEET_S, fcfg.n)
    fwd = (np.linalg.norm(x_got - fleet_x.transpose(2, 0, 1), axis=-1)
           / np.linalg.norm(fleet_x.transpose(2, 0, 1), axis=-1))
    tres = [r.result.true_resnorm for r in order]
    emit({"phase": "fleet", "config": fcfg.name, "n": fcfg.n, "k": fcfg.k, "d": fcfg.d,
          "p": FLEET_P, "variant": fopts.variant, "tol": fcfg.tol, "max_batch": fcfg.max_batch,
          "fac_cache": fcfg.fac_cache, "systems": FLEET_S, "rounds": FLEET_ROUNDS,
          "requests": len(done), "seconds": fleet_s, "systems_per_s": len(done) / fleet_s,
          "engine_systems_per_s": eng.systems_per_second, "cache_hit_rate": eng.cache_hit_rate,
          "stats": fstats, "steps": steps, "batches": log,
          "launches": {nm: fleet_counts[nm] for nm in solver_kernels if fleet_counts[nm]},
          "one_system": {"factor_launches": {nm: one_factor[nm] for nm in solver_kernels
                                             if one_factor[nm]},
                         "bts_per_apply": one_bts, "iterations": float(one_res.iterations)},
          "factor_ms_64_single_systems": singles_factor_ms, "breakdown": breakdown,
          "iterations": sorted({r.result.iterations for r in order}),
          "true_resnorm_max": max(tres), "forward_error_max": float(fwd.max()),
          "peak_mem_bytes": torch.cuda.max_memory_allocated(), "nvidia_smi": smi})
    if len(done) != FLEET_S * FLEET_ROUNDS or not all(r.result.converged for r in done):
        raise AssertionError("fleet: a request did not converge")
    if max(tres) > 10 * fcfg.tol:
        raise AssertionError(f"fleet: true_resnorm {max(tres)} > {10 * fcfg.tol}")
    if (fstats["cache_misses"], fstats["cache_hits"], fstats["steps"]) != (
            FLEET_S, FLEET_S * (FLEET_ROUNDS - 1), FLEET_ROUNDS):
        raise AssertionError(f"fleet: not one step of misses, then hits: {fstats}")
    check_folds("fleet", log, one_factor, one_bts)
    del eng, done, order, fleet_bands, fleet_b, fleet_x, x_got

    clock.end("fleet")
    # cost: an engine with cost_accounting at fleet()'s shape, COST_S systems,
    # one miss step then one hit step: each stage's roofline seconds (the
    # calibrated ceilings) against the engine's measured seconds
    from repro_torch.serve import SolverEngine

    cost_bands = [random_banded(fcfg.n, fcfg.k, fcfg.d, seed=SEED + 300 + i).astype(np.float32)
                  for i in range(COST_S)]
    crng = np.random.default_rng(SEED + 4)
    ceng = SolverEngine(fopts, max_batch=fcfg.max_batch, cache_size=fcfg.fac_cache,
                        rounding=fcfg.bucket_rounding, cost_accounting=True)
    cost_steps, fractions = [], []
    reset()
    for step_name in ("miss", "hit"):
        for bd in cost_bands:
            ceng.submit_system(bd, host_band_matvec(bd, crng.normal(size=fcfg.n)))
        s0, c0 = ceng.stats_snapshot(), ceng.cost_snapshot()
        done = ceng.step()
        s1, c1 = ceng.stats_snapshot(), ceng.cost_snapshot()
        if len(done) != COST_S or not all(r.result.converged for r in done):
            raise AssertionError(f"cost {step_name}: a request did not converge")
        if max(r.result.true_resnorm for r in done) > 10 * fcfg.tol:
            raise AssertionError(f"cost {step_name}: a true_resnorm above {10 * fcfg.tol}")
        row = {"step": step_name, "requests": len(done),
               "cache_hits": s1["cache_hits"] - s0["cache_hits"],
               "sweeps": max(r.result.iterations for r in done)}
        for stage, key in (("factor", "factor_seconds_total"), ("krylov", "solve_seconds_total")):
            roof = (c1.get(stage, {}).get("roofline_s", 0.0)
                    - c0.get(stage, {}).get("roofline_s", 0.0))
            measured = s1[key] - s0[key]
            frac = roof / measured if roof > 0 else None
            row[stage] = {"roofline_s": roof, "measured_s": measured, "achieved_fraction": frac}
            if frac is not None:
                fractions.append(frac)
        cost_steps.append(row)
    cost_counts = counts()
    add_totals()
    bucket = done[0].result.bucket
    emit({"phase": "cost", "config": fcfg.name, "n": fcfg.n, "k": fcfg.k, "p": FLEET_P,
          "systems": COST_S, "bucket": bucket, "hw": backend_spec("cuda").name,
          "steps": cost_steps, "cost_snapshot": ceng.cost_snapshot(),
          "stage_costs_s1": {nm: c.to_dict() for nm, c in ceng.stage_costs(
              bucket, variant=fopts.variant, dtype=torch.float64).items()},
          "launches": {nm: cost_counts[nm] for nm in solver_kernels if cost_counts[nm]},
          "limit": COST_LIMIT, "nvidia_smi": smi})
    if not fractions or max(fractions) > COST_LIMIT:
        raise AssertionError(f"cost: achieved fractions {fractions} (limit {COST_LIMIT})")
    if cost_steps[1]["cache_hits"] != COST_S:
        raise AssertionError(f"cost: the second step was not all hits: {cost_steps}")
    must_launch("cost", cost_counts, ("btf", "bts", "fused_factor_spike"))
    del ceng, cost_bands, done

    clock.end("cost")
    # batch_full: full() (C) and exact() (E, BCR) at P=64, BATCH_S systems a
    # batch, against BATCH_S single-system factor / solve runs of the same
    # systems.  Exact rounding: the bucket is then each system's own split
    # (N padded to P*M*K = 204,800, K = 200); pow2 would widen K to 256.
    batch_lines = {}
    for cname, ccfg in (("full", sap_solver.full()), ("exact", sap_solver.exact())):
        copts = ccfg.to_sap_options(BATCH_P)
        bands = [torch.tensor(random_banded(ccfg.n, ccfg.k, ccfg.d, seed=SEED + 200 + i)
                              .astype(np.float32), device=dev) for i in range(BATCH_S)]
        xs = torch.tensor(np.random.default_rng(SEED + 2).normal(size=(BATCH_S, ccfg.n)),
                          device=dev)
        bs = torch.stack([band_matvec(bd.double(), x) for bd, x in zip(bands, xs)])
        scale = torch.arange(1, BATCH_R + 1, device=dev, dtype=torch.float64)
        bmany = bs[:, :, None] * scale

        def f64_resnorm(band, x, rhs):
            return ((rhs - band_matvec(band.double(), x)).norm(dim=0) / rhs.norm(dim=0))

        log = []
        real = watch_batches(log)
        try:
            reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for attempt in range(2):  # the second call of each stage is reported
                t0 = time.perf_counter()
                bfac = batched.batch_factor(batched.batch_plan(bands, copts, rounding="exact"))
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                res = bfac.solve_batch(torch.nn.functional.pad(bs, (0, bfac.n - ccfg.n)))
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                resm = bfac.solve_batch_many(
                    torch.nn.functional.pad(bmany, (0, 0, 0, bfac.n - ccfg.n)))
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                if attempt == 0:
                    first_log, batch_counts = list(log), counts()
                    peak = torch.cuda.max_memory_allocated()
                    add_totals()
                    del bfac, res, resm
        finally:
            unwatch(real)
        times = {"factor_ms": (t1 - t0) * 1e3, "solve_batch_ms": (t2 - t1) * 1e3,
                 "solve_batch_many_ms": (t3 - t2) * 1e3}
        variant = (bfac.variant, bfac.fac.pc.reduced_solver)
        bucket = [bfac.n, bfac.k]
        del bfac
        single = {"factor_ms": 0.0, "solve_ms": 0.0, "solve_many_ms": 0.0}
        rows = []
        for i, bd in enumerate(bands):
            for attempt in range(2):
                before = counts()
                t0 = time.perf_counter()
                fac = factor(plan_banded(bd, copts))
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                one_factor = delta(before)
                before = counts()
                one = fac.solve(bs[i])
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                one_bts = delta(before).get("bts", 0) / applies(sweeps(one.iterations))
                onem = fac.solve_many(bmany[i])
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                del fac
            single["factor_ms"] += (t1 - t0) * 1e3
            single["solve_ms"] += (t2 - t1) * 1e3
            single["solve_many_ms"] += (t3 - t2) * 1e3
            xb, xbm = res.x[i, : ccfg.n], resm.x[i, : ccfg.n]
            rows.append({
                "iterations": float(res.iterations[i]), "iterations_single": float(one.iterations),
                "iterations_many": resm.iterations[i].tolist(),
                "iterations_many_single": onem.iterations.tolist(),
                "true_resnorm_f64": float(f64_resnorm(bd, xb, bs[i])),
                "true_resnorm_f64_single": float(f64_resnorm(bd, one.x, bs[i])),
                "true_resnorm_f64_many": f64_resnorm(bd, xbm, bmany[i]).tolist(),
                "x_vs_single": float((xb - one.x).norm() / one.x.norm()),
                "x_vs_single_many": float(((xbm - onem.x).norm(dim=0)
                                           / onem.x.norm(dim=0)).max()),
                "forward_error": float((xb - xs[i]).norm() / xs[i].norm())})
            del one, onem
        emit({"phase": "batch_full", "config": ccfg.name, "n": ccfg.n, "k": ccfg.k, "d": ccfg.d,
              "p": BATCH_P, "s": BATCH_S, "r_many": BATCH_R, "tol": ccfg.tol,
              "variant": variant, "bucket": bucket, "batch": times, "single_x4": single,
              "batch_factor_over_single_x4": times["factor_ms"] / single["factor_ms"],
              "batch_solve_over_single_x4": times["solve_batch_ms"] / single["solve_ms"],
              "systems": rows, "batches_first_call": first_log,
              "launches_batch": {nm: batch_counts[nm] for nm in solver_kernels
                                 if batch_counts[nm]},
              "launches_one_system_factor": one_factor, "one_system_bts_per_apply": one_bts,
              "x_tolerance_vs_single": BATCH_XTOL, "peak_mem_bytes": peak, "nvidia_smi": smi})
        want_variant = ("C", "none") if ccfg.variant == "C" else ("E", "bcr")
        if variant != want_variant:
            raise AssertionError(f"batch_full {cname}: variant {variant}, not {want_variant}")
        for row in rows:
            worst = max([row["true_resnorm_f64"], row["true_resnorm_f64_single"]]
                        + row["true_resnorm_f64_many"])
            if worst > 1e-6:
                raise AssertionError(f"batch_full {cname}: true_resnorm {worst} > 1e-6: {row}")
            if max(row["x_vs_single"], row["x_vs_single_many"]) > BATCH_XTOL:
                raise AssertionError(f"batch_full {cname}: x against the single solve: {row}")
            pairs = [(row["iterations"], row["iterations_single"])] + list(
                zip(row["iterations_many"], row["iterations_many_single"]))
            if any(math.ceil(a) != math.ceil(b) for a, b in pairs):
                raise AssertionError(f"batch_full {cname}: sweep counts differ: {row}")
        factors = [e for e in first_log if e["call"] == "factor"]
        launched = [{nm: c for nm, c in e.items() if nm in solver_kernels} for e in factors]
        if launched != [one_factor]:
            raise AssertionError(f"batch_full {cname}: the batch factor's launches {factors} "
                                 f"are not one system's {one_factor}")
        must_launch(f"batch_full {cname}", batch_counts, ("btf", "bts", "fused_factor_spike")
                    if ccfg.variant == "C" else ("bts", "fused_factor_spike") + bcr_names)
        check_folds(f"batch_full {cname}", first_log, one_factor, one_bts)
        del bands, xs, bs, bmany, res, resm, rows
        torch.cuda.empty_cache()

    clock.end("batch_full")
    # service: configs/sap_solver.py:service() through AsyncSolverService,
    # SERVICE_CLIENTS client threads submitting SERVICE_REQUESTS requests:
    # N, K and d drawn per request (several pow2 buckets, both dominance
    # classes), mixed priorities, a quarter of the matrices repeated; b = A x*
    # in float64.  The requests are made before the clock starts.
    scfg = sap_solver.service()
    srng = np.random.default_rng(SEED + 3)
    pool, reqs = [], []
    for i in range(SERVICE_REQUESTS):
        if pool and srng.random() < SERVICE_REPEAT:
            band = pool[int(srng.integers(len(pool)))]
        else:
            n_i = int(srng.integers(SERVICE_N[0], SERVICE_N[1] + 1))
            k_i = int(srng.integers(SERVICE_K[0], SERVICE_K[1] + 1))
            d_i = SERVICE_D[int(srng.integers(len(SERVICE_D)))]
            band = random_banded(n_i, k_i, d_i, seed=SEED + 1000 + i).astype(np.float32)
            pool.append(band)
        x_i = srng.normal(size=band.shape[0])
        reqs.append((band, host_band_matvec(band, x_i), x_i, int(srng.integers(0, 3))))
    log = []
    real = watch_batches(log)
    futures = [[] for _ in range(SERVICE_CLIENTS)]

    def client(c):
        for band, b, _, prio in reqs[c::SERVICE_CLIENTS]:
            futures[c].append(svc.submit(band, b, priority=prio))

    try:
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        svc = scfg.to_service(SERVICE_P)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVICE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        submit_s = time.perf_counter() - t0
        outs = [[f.outcome(timeout=600) for f in fs] for fs in futures]
        service_s = time.perf_counter() - t0
        svc.close()
    finally:
        unwatch(real)
    service_counts = counts()
    add_totals()
    snap = svc.snapshot()
    by_req = [None] * SERVICE_REQUESTS
    for c, os_ in enumerate(outs):
        for j, out in enumerate(os_):
            by_req[c + j * SERVICE_CLIENTS] = out
    solved = [(o, reqs[i]) for i, o in enumerate(by_req) if not isinstance(o, Cancelled)]
    shed = [o.reason for o in by_req if isinstance(o, Cancelled)]
    wait = svc.metrics.histogram("time_in_queue_s")
    tres = [o.true_resnorm for o, _ in solved]
    fwd = [float(np.linalg.norm(o.x - r[2]) / np.linalg.norm(r[2])) for o, r in solved]
    classes = {}
    for o, _ in solved:
        key = f"{o.variant} {o.bucket[0]}x{o.bucket[1]}"
        classes[key] = classes.get(key, 0) + 1
    emit({"phase": "service", "config": scfg.name, "p": SERVICE_P, "tol": scfg.tol,
          "max_batch": scfg.max_batch, "fac_cache": scfg.fac_cache, "queue_cap": scfg.queue_cap,
          "deadline_s": scfg.deadline_s, "clients": SERVICE_CLIENTS,
          "requests": SERVICE_REQUESTS, "distinct_matrices": len(pool),
          "n_range": SERVICE_N, "k_range": SERVICE_K, "d_values": SERVICE_D,
          "seconds": service_s, "submit_seconds": submit_s,
          "requests_per_s": SERVICE_REQUESTS / service_s,
          "time_in_queue_s": {"p50": wait.quantile(0.5), "p99": wait.quantile(0.99),
                              "max": wait.quantile(1.0), "count": wait.count},
          "solved_by_variant_and_bucket": classes, "shed": shed,
          "cache_hit_rate": snap["derived"]["cache_hit_rate"],
          "escalations": snap["counters"]["escalations"],
          "misconverged": snap["counters"]["misconverged_total"],
          "deadline_misses": snap["counters"]["deadline_misses"],
          "dispatches": snap["histograms"]["batch_occupancy"]["count"],
          "batch_occupancy_mean": snap["histograms"]["batch_occupancy"]["mean"],
          "engine": snap["engine"], "true_resnorm_max": max(tres),
          "forward_error_max": max(fwd), "iterations": sorted({o.iterations for o, _ in solved}),
          "batches": len(log), "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "launches": {nm: service_counts[nm] for nm in solver_kernels if service_counts[nm]},
          "nvidia_smi": smi})
    if any(reason != "deadline" for reason in shed):
        raise AssertionError(f"service: futures resolved without a solve: {shed}")
    if len(solved) + len(shed) != SERVICE_REQUESTS or not solved:
        raise AssertionError("service: a future did not resolve")
    if max(tres) > 10 * scfg.tol or not all(o.converged for o, _ in solved):
        raise AssertionError(f"service: true_resnorm {max(tres)} > {10 * scfg.tol}")
    if {key.split()[0] for key in classes} != {"C", "E"}:
        raise AssertionError(f"service: both dominance classes must be routed: {classes}")
    must_launch("service", service_counts, solver_kernels)
    # one system's counts under both classes: C factors with the fused pass
    # and one btf (the interface inverses), E with the fused pass and BCR;
    # both apply bts twice
    check_folds("service", log, {"btf": 1, "fused_factor_spike": 1}, 2)
    del svc, reqs, pool, by_req, solved, outs, futures
    clock.end("service")

    # ---- examples: the port's entry points, each run as a user runs it ----------
    torch.cuda.empty_cache()
    example_launches = examples_phase(smi)
    for nm in totals:
        totals[nm] += example_launches[nm]
    clock.end("examples")

    # ---- lm. RWKV6-1.6B and Zamba2-2.7B at full width and depth ----------------
    import dataclasses

    def device_profile(prof, top_n: int = 8) -> dict:
        """Device time by kernel from a profiler run: busy ms, launches and
        the largest kernels (name, ms, count)."""
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:top_n]
        return {"device_busy_ms": (sum(e.self_device_time_total for e in events) / 1e3
                                   if events else None),
                "device_kernel_launches": sum(e.count for e in events),
                "top_kernels": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                                for e in top]}

    def serve(arch, cfg, params, prompts, other_bytes):
        """A ServeEngine with LM_SLOTS slots draining ``prompts`` (after a
        warm-up engine that pays first-call costs): the emitted line, and
        every wrapper's launches in the drain."""
        max_len = LM_PROMPT[1] + LM_NEW_TOKENS
        warm = ServeEngine(cfg, params, slots=LM_SLOTS, max_len=max_len)
        warm.submit(Request(rid=-1, prompt=prompts[0][:2], max_new_tokens=1))
        warm.run_until_drained()  # first-call costs (torch's lazy loading)
        del warm
        engine = ServeEngine(cfg, params, slots=LM_SLOTS, max_len=max_len)
        reqs = [Request(rid=i, prompt=pr, max_new_tokens=LM_NEW_TOKENS)
                for i, pr in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        t0 = time.perf_counter()
        ticks = engine.run_until_drained()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        drained = counts()
        # the model's own peak: weights, cache and temporaries
        serve_peak = torch.cuda.max_memory_allocated() - other_bytes
        if not all(r.done and len(r.out) == LM_NEW_TOKENS for r in reqs):
            raise AssertionError(f"{arch}: not every request ended with {LM_NEW_TOKENS} tokens")
        if not all(0 <= tok < cfg.vocab for r in reqs for tok in r.out):
            raise AssertionError(f"{arch}: a generated token is outside the vocabulary")
        generated = LM_REQUESTS * LM_NEW_TOKENS
        return {"slots": LM_SLOTS, "requests": LM_REQUESTS, "new_tokens": LM_NEW_TOKENS,
                "prompt_lengths": [len(p) for p in prompts], "ticks": ticks,
                "seconds": serve_s, "ms_per_tick": serve_s * 1e3 / ticks,
                "generated_tokens_per_s": generated / serve_s,
                "peak_mem_bytes": serve_peak, "other_phases_bytes": other_bytes}, drained

    def decode_window(cfg, fam, params, rng):
        """Five decode ticks at LM_SLOTS slots, timed, then the same five
        under the profiler: device time by kernel (the profiler slows the
        host, not the kernels; the busy share is taken against the
        unprofiled window)."""
        cache = fam.init_cache(cfg, LM_SLOTS, LM_PROMPT[1] + LM_NEW_TOKENS)
        step_toks = torch.tensor(rng.integers(0, cfg.vocab, size=(LM_SLOTS, 1)), device=dev)
        fam.decode_step(cfg, params, cache, step_toks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            _, cache = fam.decode_step(cfg, params, cache, step_toks)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                _, cache = fam.decode_step(cfg, params, cache, step_toks)
            torch.cuda.synchronize()
            profiled_ms = (time.perf_counter() - t0) * 1e3
        del cache
        line = device_profile(prof)
        busy = line["device_busy_ms"]
        return {"ticks": 5, "wall_ms": window_ms, "profiled_wall_ms": profiled_ms, **line,
                "device_busy_share": busy / window_ms if busy is not None else None}

    lm_launches = {}
    for arch in LM_ARCHS:
        cfg = get_config(arch)
        fam = get_family(cfg)
        kernel = "wkv" if cfg.family == "rwkv" else "ssd"
        torch.cuda.synchronize()
        other_bytes = torch.cuda.memory_allocated()  # what the solver phases still hold
        t0 = time.perf_counter()
        params = fam.init(cfg, torch.Generator(dev).manual_seed(SEED), device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(q.numel() for q in params.parameters())
        weight_bytes = sum(q.numel() * q.element_size() for q in params.parameters())
        rng = np.random.default_rng(SEED)
        launches = {}
        with torch.inference_mode():
            # forward (chunk-64 scans) against decode steps (chunk-1 scans), float32
            c32 = dataclasses.replace(cfg, compute_dtype="float32")
            prefix, toks = (torch.tensor(rng.integers(0, cfg.vocab, size=(2, CONSISTENCY_T)),
                                         device=dev) for _ in range(2))

            def against_decode(state):
                """max |forward - decode steps| over toks, both from ``state``
                (None: from zero), and max |logit|."""
                full, _ = fam.forward(c32, params, toks, state)
                full = full[..., : cfg.vocab]
                if state is None:
                    cache = fam.init_cache(c32, 2, CONSISTENCY_T)
                else:
                    cache = {nm: v.clone() for nm, v in state.items()}
                d = []
                for i in range(CONSISTENCY_T):
                    logits, cache = fam.decode_step(c32, params, cache, toks[:, i:i + 1])
                    d.append(float((logits - full[:, i]).abs().max()))
                return max(d), float(full.abs().max()), d[0]

            reset()
            consistency = {"t": CONSISTENCY_T, "batch": 2, "rtol": LM_RTOL}
            (consistency["cold_max_abs_diff"], max_logit,
             consistency["cold_first_token_abs_diff"]) = against_decode(None)
            # the model's own float32 sensitivity: embeddings scaled by 1 + 1e-7 N(0, 1)
            emb = params["embed"].data
            saved = emb.clone()
            emb.mul_(1 + 1e-7 * torch.randn(emb.shape, generator=torch.Generator(dev)
                                            .manual_seed(SEED), device=dev))
            moved, _ = fam.forward(c32, params, toks)
            emb.copy_(saved)
            del saved, emb
            base, _ = fam.forward(c32, params, toks)
            consistency["embed_perturbed_max_abs_diff"] = float(
                (moved - base)[..., : cfg.vocab].abs().max())
            consistency["embed_perturbed_first_token_abs_diff"] = float(
                (moved - base)[:, 0, : cfg.vocab].abs().max())
            # the two kernel paths inside one forward: 64 chunks of 1 token
            # against one chunk of 64, from zero (checked below)
            ones, _ = fam.forward(dataclasses.replace(c32, ssm_chunk=1), params, toks)
            consistency["chunk1_forward_max_abs_diff"] = float(
                (ones - base)[..., : cfg.vocab].abs().max())
            del moved, base, ones
            if cfg.family == "rwkv":
                # witness of RWKV6's cold start (PERF.md, L1): the variance of
                # each head's GroupNorm input over its eps, by position
                gn_ratio, plain_gn = [], fam.group_norm

                def spy(x, w, b, groups, eps=1e-5):
                    heads = x.float().reshape(*x.shape[:-1], groups, -1)
                    gn_ratio.append(heads.var(dim=-1, unbiased=False) / eps)  # (B, T, H)
                    return plain_gn(x, w, b, groups, eps)

                fam.group_norm = spy
                try:
                    fam.forward(c32, params, toks)
                finally:
                    fam.group_norm = plain_gn
                ratio = torch.stack(gn_ratio)  # (layers, B, T, H)
                for where, r in (("t0", ratio[:, :, 0]), ("later", ratio[:, :, 1:])):
                    consistency[f"gn_var_over_eps_{where}"] = {
                        "min": float(r.min()), "median": float(r.median()),
                        "share_below_1": float((r < 1).float().mean())}
                del gn_ratio, ratio
                # RWKV6's first token from a zero state is ill-conditioned (see
                # PERF.md): the check runs from the state of a 64-token prefix
                _, warm = fam.forward(c32, params, prefix)
                consistency["warm_max_abs_diff"], max_logit, _ = against_decode(warm)
                del warm
                diff = consistency["warm_max_abs_diff"]
            else:
                diff = consistency["cold_max_abs_diff"]
            consistency["max_abs_logit"] = max_logit
            launches["consistency_f32"] = counts()[kernel]
            by_route = {"consistency_f32": dict(wrappers[kernel].by_route)}
            for what, d in (("decode steps", diff),
                            ("chunk-1 forward", consistency["chunk1_forward_max_abs_diff"])):
                if not d <= LM_RTOL * max_logit:
                    raise AssertionError(f"{arch}: forward and {what} differ by {d:.3e}, "
                                         f"max |logit| {max_logit:.3e}")
            # prefill at the published bfloat16; launches are the first call's
            ptoks = torch.tensor(rng.integers(0, cfg.vocab, size=(PREFILL_B, PREFILL_T)),
                                 device=dev)
            reset()
            out, _ = fam.forward(cfg, params, ptoks)
            torch.cuda.synchronize()
            launches["prefill"] = counts()[kernel]
            by_route["prefill"] = dict(wrappers[kernel].by_route)
            if not (bool(torch.isfinite(out).all())
                    and out.shape == (PREFILL_B, PREFILL_T, cfg.vocab_padded)):
                raise AssertionError(f"{arch}: prefill logits bad: {tuple(out.shape)}")
            del out
            prefill_ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                fam.forward(cfg, params, ptoks)
                torch.cuda.synchronize()
                prefill_ms.append((time.perf_counter() - t0) * 1e3)
            # serving: LM_REQUESTS requests through LM_SLOTS slots
            prompts = [rng.integers(0, cfg.vocab, size=int(n)).tolist()
                       for n in rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, size=LM_REQUESTS)]
            serve_line, serve_counts = serve(arch, cfg, params, prompts, other_bytes)
            launches["serve"] = serve_counts[kernel]
            by_route["serve"] = dict(wrappers[kernel].by_route)
            window_line = decode_window(cfg, fam, params, rng)
        # the same model with scan_dtype="bfloat16" against its float32 scans
        bf16_line = lm_bf16_scan_check(dev, cfg, fam, params, SEED)
        dtype_launches[kernel]["bfloat16"] = (dtype_launches[kernel].get("bfloat16", 0)
                                              + bf16_line["bfloat16_launches"])
        for nm in ("prefill", "serve"):
            if launches[nm] == 0:
                raise AssertionError(f"{arch}: the {nm} path never launched the {kernel} kernel")
        for nm, taken in by_route.items():
            if taken["block"]:
                raise AssertionError(f"{arch}: the {nm} path took the one-block {kernel} kernel: "
                                     f"{taken}")
        lm_launches[kernel] = launches["serve"] + launches["prefill"] + dist_launches[kernel]
        emit({
            "phase": "lm", "arch": arch, "params": n_params, "weight_bytes": weight_bytes,
            "init_s": init_s, "compute_dtype": cfg.compute_dtype,
            "consistency": consistency,
            "prefill_ms": prefill_ms, "prefill_shape": [PREFILL_B, PREFILL_T],
            "serve": serve_line, "decode_window": window_line,
            "launches": {kernel: launches}, "launches_by_route": {kernel: by_route},
            "bfloat16_scans": bf16_line,
        })
        del params
        torch.cuda.empty_cache()

    clock.end("lm")
    # ---- dense. Minitron-8B at full width and depth ----------------------------
    cfg = get_config(DENSE_ARCH)
    fam = get_family(cfg)
    torch.cuda.synchronize()
    other_bytes = torch.cuda.memory_allocated()  # what the solver phases still hold
    t0 = time.perf_counter()
    params = fam.init(cfg, torch.Generator(dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(q.numel() for q in params.parameters())
    weight_bytes = sum(q.numel() * q.element_size() for q in params.parameters())
    rng = np.random.default_rng(SEED)
    launches = {}
    with torch.inference_mode():
        # forward (through the flash kernel: T = 128) against decode steps
        # (plain decode attention over the KV cache), float32
        c32 = dataclasses.replace(cfg, compute_dtype="float32")
        toks = torch.tensor(rng.integers(0, cfg.vocab, size=(2, DENSE_CONSISTENCY_T)), device=dev)
        reset()
        full, _ = fam.forward(c32, params, toks)
        launches["consistency_f32"] = counts()["flash"]
        full = full[..., : cfg.vocab]
        cache = fam.init_cache(c32, 2, DENSE_CONSISTENCY_T)
        diffs = []
        for i in range(DENSE_CONSISTENCY_T):
            logits, cache = fam.decode_step(c32, params, cache, toks[:, i:i + 1])
            diffs.append(float((logits - full[:, i]).abs().max()))
        max_logit = float(full.abs().max())
        del full, cache, logits
        consistency = {"t": DENSE_CONSISTENCY_T, "batch": 2, "rtol": LM_RTOL,
                       "max_abs_diff": max(diffs), "first_token_abs_diff": diffs[0],
                       "max_abs_logit": max_logit}
        if not max(diffs) <= LM_RTOL * max_logit:
            raise AssertionError(f"{DENSE_ARCH}: forward and decode steps differ by "
                                 f"{max(diffs):.3e}, max |logit| {max_logit:.3e}")
        # bfloat16 prefills: launches are each shape's first call's
        prefill = {}
        for b, t in ((PREFILL_B, PREFILL_T), (1, DENSE_LONG_T)):
            ptoks = torch.tensor(rng.integers(0, cfg.vocab, size=(b, t)), device=dev)
            reset()
            out, _ = fam.forward(cfg, params, ptoks)
            torch.cuda.synchronize()
            launches[f"prefill_b{b}_t{t}"] = counts()["flash"]
            if not (bool(torch.isfinite(out).all()) and out.shape == (b, t, cfg.vocab_padded)):
                raise AssertionError(f"{DENSE_ARCH}: prefill logits bad: {tuple(out.shape)}")
            del out
            ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                fam.forward(cfg, params, ptoks)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            prefill[f"b{b}_t{t}"] = {"shape": [b, t], "ms": ms}
        # the long prefill once more under the profiler: the flash kernel's
        # share of device time
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fam.forward(cfg, params, ptoks)
            torch.cuda.synchronize()
        line = device_profile(prof)
        flash_ms = sum(e.self_device_time_total for e in prof.key_averages()
                       if "flash_kernel" in e.key) / 1e3
        busy = line["device_busy_ms"]
        prefill[f"b1_t{DENSE_LONG_T}"]["profile"] = {
            **line, "flash_device_ms": flash_ms,
            "flash_share": flash_ms / busy if busy else None}
        del ptoks
        # serving: as many requests, of the same prompt lengths, as above
        dense_prompts = [rng.integers(0, cfg.vocab, size=len(pr)).tolist() for pr in prompts]
        serve_line, serve_counts = serve(DENSE_ARCH, cfg, params, dense_prompts, other_bytes)
        launches["serve"] = serve_counts["flash"]  # decode runs no flash kernel
        window_line = decode_window(cfg, fam, params, rng)
    for nm in (f"prefill_b{PREFILL_B}_t{PREFILL_T}", f"prefill_b1_t{DENSE_LONG_T}",
               "consistency_f32"):
        if launches[nm] != cfg.n_layers:
            raise AssertionError(f"{DENSE_ARCH}: {nm} launched the flash kernel "
                                 f"{launches[nm]} times, not once a layer ({cfg.n_layers})")
    lm_launches["flash"] = (launches[f"prefill_b{PREFILL_B}_t{PREFILL_T}"]
                            + launches[f"prefill_b1_t{DENSE_LONG_T}"])
    emit({
        "phase": "dense", "arch": DENSE_ARCH, "params": n_params,
        "params_count_formula": cfg.params_count(), "weight_bytes": weight_bytes,
        "init_s": init_s, "compute_dtype": cfg.compute_dtype, "consistency": consistency,
        "prefill": prefill, "serve": serve_line, "decode_window": window_line,
        "launches": {"flash": launches},
    })
    del params
    torch.cuda.empty_cache()

    clock.end("dense")
    # ---- moe, vlm, encdec: the rest of the LM zoo ---------------------------------
    lm_launches["flash"] += zoo_phases(dev, get_config, get_family, reset, counts, serve,
                                       decode_window, prompts)

    clock.end("moe_vlm_encdec")
    # ---- train: every loss's gradients through the kernels' Functions -------------
    for kernel, n in train_phase(dev, get_config, get_family, reset, counts).items():
        lm_launches[kernel] += n

    clock.end("train")
    # ---- sharded: the LM loss and the ZeRO-1 step over a (data, model) mesh --------
    for kernel, n in sharded_phase(dev, smi, cal).items():
        lm_launches[kernel] += n
    for kernel in ("wkv", "ssd", "flash"):
        lm_launches[kernel] += example_launches[kernel]

    clock.end("sharded")
    # ---- 5. timing at the main path's shapes ---------------------------------
    p, m, k = bt.p, bt.m, bt.k
    ref = bl.btf_ref(bt.d, bt.e, bt.f)
    rhs1 = torch.randn((p, m, k, 1), device=dev)
    bq, cq = bl.pad_couplings(bt.b_cpl, bt.c_cpl, p)
    specs = {
        "btf": dict(
            source="src/repro_torch/kernels/csrc/btf.cu",
            replaces="src/repro/kernels/btf.py:40",
            kernel=lambda: btf(bt.d, bt.e, bt.f),
            plain=lambda: bl.btf_ref(bt.d, bt.e, bt.f),
            library=lambda: btf_library(bt.d, bt.e, bt.f),
            library_vs_plain=lambda: zip(btf_library(bt.d, bt.e, bt.f),
                                         bl.btf_ref(bt.d, bt.e, bt.f)[:2]),
            work=btf_work(p, m, k), reps=10, plain_reps=1, err=main_path_errs["btf"],
        ),
        "bts": dict(
            source="src/repro_torch/kernels/csrc/bts.cu",
            replaces="src/repro/kernels/bts.py:27",
            kernel=lambda: bts(ref.sinv, ref.l, bt.f, rhs1),
            plain=lambda: bl.bts_ref(ref, rhs1),
            work=bts_work(p, m, k, 1), reps=50, plain_reps=5, err=main_path_errs["bts_r1"],
        ),
        "fused_factor_spike": dict(
            source="src/repro_torch/kernels/csrc/fused_spike.cu",
            replaces="src/repro/kernels/fused_spike.py:47",
            kernel=lambda: fused_factor_spike(bt.d, bt.e, bt.f, bq, cq),
            plain=lambda: bl.fused_factor_spike_padded_ref(bt.d, bt.e, bt.f, bq, cq),
            library=lambda: fused_library(bt.d, bt.e, bt.f, bq, cq),
            library_vs_plain=lambda: zip(fused_library(bt.d, bt.e, bt.f, bq, cq),
                                         bl.fused_factor_spike_padded_ref(bt.d, bt.e, bt.f, bq, cq)),
            work=fused_work(p, m, k), reps=5, plain_reps=1, err=main_path_errs["fused"],
        ),
    }
    # BCR at the P=64 interface chain: each kernel over all levels of one
    # factor (inv_odd, reduce) or one solve at R=1 (rhs_reduce, backsub)
    facts, solves, root = bcr_inputs(*chain, (1,))
    downs, ups = solves[1]
    odd_blocks = torch.cat([pd[1::2] for pd, _, _, _ in facts] + [root])
    work = bcr_work(chain[0].shape[0], chain[0].shape[1], 1)

    def each(fn, args):
        return lambda: [fn(*a) for a in args]

    bcr_specs = {
        "bcr_inv_odd": dict(
            kernel=lambda: [bcr.inv_odd(a[0]) for a in facts] + [bcr.inv_odd(root, first=0)],
            plain=lambda: [cr.bcr_inv_odd_ref(a[0]) for a in facts]
            + [cr.bcr_inv_odd_ref(root, first=0)],
            library=lambda: torch.linalg.inv(odd_blocks), replaces="src/repro/kernels/bcr.py:43"),
        "bcr_reduce": dict(kernel=each(bcr.reduce, facts), plain=each(cr.bcr_reduce_ref, facts),
                           library=each(reduce_library, facts),
                           library_vs_plain=lambda: [
                               (o, w) for fa in facts
                               for o, w in zip(reduce_library(*fa), cr.bcr_reduce_ref(*fa))],
                           replaces="src/repro/kernels/bcr.py:48"),
        "bcr_rhs_reduce": dict(kernel=each(bcr.rhs_reduce, downs),
                               plain=each(cr.bcr_rhs_reduce_ref, downs),
                               library=each(rhs_reduce_library, downs),
                               library_vs_plain=lambda: [
                                   (rhs_reduce_library(*a), cr.bcr_rhs_reduce_ref(*a))
                                   for a in downs],
                               replaces="src/repro/kernels/bcr.py:79"),
        "bcr_backsub": dict(kernel=each(bcr.backsub, ups), plain=each(cr.bcr_backsub_ref, ups),
                            library=each(backsub_library, ups),
                            library_vs_plain=lambda: [
                                (backsub_library(*a), cr.bcr_backsub_ref(*a)) for a in ups],
                            replaces="src/repro/kernels/bcr.py:89"),
    }
    for name, s in bcr_specs.items():
        wide = name in ("bcr_inv_odd", "bcr_reduce")
        # rhs_reduce's and backsub's launches are short: their time is the
        # profiler's device time, the loop's wall time per call host_ms
        s.update(source="src/repro_torch/kernels/csrc/bcr.cu", work=work[name[4:]],
                 reps=3 if wide else 100, plain_reps=1 if wide else 5, err=bcr_errs[name],
                 device_time=not wide)
    specs.update(bcr_specs)
    summary = []
    for name, s in specs.items():
        saved = wrappers[name].launches
        if s.get("device_time"):
            ms, by_kernel = device_ms(s["kernel"], s["reps"],
                                      lambda: wrappers[name].launches)
            wall_ms = host_ms(s["kernel"], s["reps"])
        else:
            ms, by_kernel, wall_ms = cuda_ms(s["kernel"], s["reps"]), None, None
        plain_ms = cuda_ms(s["plain"], s["plain_reps"])
        if "library" not in s:
            library_ms = None
        elif s.get("device_time"):  # the library loop by the same clock as the kernel
            library_ms = device_ms(s["library"], s["reps"])[0]
        else:
            library_ms = cuda_ms(s["library"], s["reps"])
        # the library call against the plain version: torch.linalg.inv pivots
        # and does not boost, so they agree only where no pivot needs either
        library_err = (max(float((a - b).abs().max()) for a, b in s["library_vs_plain"]())
                       if "library_vs_plain" in s else None)
        wrappers[name].launches = saved  # timing launches are not the path's
        flops, nbytes = s["work"]
        summary.append({
            "name": name, "route": "cuda", "source": s["source"], "replaces": s["replaces"],
            "launches": totals[name], "max_abs_err": s["err"], "ms": ms, "plain_ms": plain_ms,
            **bound(flops, nbytes), "library_ms": library_ms,
        })
        if wall_ms is not None:
            summary[-1].update(ms_is="device" if by_kernel is not None else "queued",
                               host_ms=wall_ms)
        shape = list(chain[0].shape) if name in bcr_specs else [p, m, k]
        emit({"phase": "timing", "kernel": name, "ms": ms, "host_ms": wall_ms,
              "device_ms_by_kernel": by_kernel, "plain_ms": plain_ms,
              "library_ms": library_ms, "library_max_abs_err_vs_plain": library_err,
              "bytes": nbytes, "flops": flops, "shape": shape})
    # inv_odd level by level (32, 16, ..., 1 odd blocks, then the root), with
    # the cluster size and route of each launch
    lib_bcr = build.load("bcr")
    saved = bcr.inv_odd.launches, bcr.inv_odd.block_launches
    by_level = []
    for blocks, first in [(a[0], 1) for a in facts] + [(root, 0)]:
        kb = blocks.shape[1]
        cs = lib_bcr.bcr_inv_cluster_size(kb)
        by_level.append({
            "blocks": len(range(first, blocks.shape[0], 2)), "k": kb, "cluster": cs,
            "route": "cluster" if cs else "block",
            "max_active_clusters": lib_bcr.bcr_inv_max_clusters(kb, cs) if cs else None,
            "ms": cuda_ms(lambda: bcr.inv_odd(blocks, first=first), 5)})
    bcr.inv_odd.launches, bcr.inv_odd.block_launches = saved
    emit({"phase": "timing", "kernel": "bcr_inv_odd", "by_level": by_level,
          "levels_ms": sum(lv["ms"] for lv in by_level)})

    # bts at every shape the main path gives it, on its cluster route, beside
    # the one-block kernel (the route of R > 8) forced through the C entry
    # point at the same shape
    def bts_block(facs, rhs):
        pp, mm, kk_, rr = rhs.shape
        x = torch.empty_like(rhs)
        ws = torch.empty(pp * kk_ * rr, device=dev)
        build.check(lib_bts, lib_bts.bts_launch(
            facs.sinv.data_ptr(), facs.l.data_ptr(), facs.f.data_ptr(), rhs.data_ptr(),
            x.data_ptr(), ws.data_ptr(), pp, mm, kk_, rr, 0,
            torch.cuda.current_stream().cuda_stream), "bts (one-block kernel)")
        return x

    g = torch.Generator(device=dev).manual_seed(SEED)
    chain_lu = ops.block_tridiag_factor_chain(*chain)
    bts_shapes = {
        "p64_r1": (bl.BTFactors(ref.sinv, ref.l, bt.f), rhs1),
        "p64_r4": (bl.BTFactors(ref.sinv, ref.l, bt.f),
                   torch.randn((p, m, k, 4), generator=g, device=dev)),
        "p8_r1": bts_cases["_p8"],
        "chain63_k400_r1": (chain_lu, torch.randn((1, 63, 2 * K, 1), generator=g, device=dev)),
        "p500_r1": bts_cases["_p500"],
    }
    saved = bts.launches, bts.block_launches, dict(bts.by_cluster)
    bts_rows = []
    for tag, (facs, rhs) in bts_shapes.items():
        pp, mm, kk_, rr = rhs.shape
        cs = lib_bts.bts_cluster_size(pp, kk_, rr)
        got = bts(facs.sinv, facs.l, facs.f, rhs)
        err = check_close(f"bts {tag}", got, bl.bts_ref(facs, rhs))
        bts_rows.append({
            "at": tag, "shape": [pp, mm, kk_, rr], "cluster": cs,
            "ring_stages": lib_bts.bts_ring_stages(kk_, cs, rr),
            "copies": "tma" if lib_bts.bts_bulk_route(facs.sinv.data_ptr(), facs.l.data_ptr(),
                                                      facs.f.data_ptr(), kk_) else "cp.async",
            "ms": cuda_ms(lambda: bts(facs.sinv, facs.l, facs.f, rhs), 20),
            "one_block_ms": cuda_ms(lambda: bts_block(facs, rhs), 10),
            "plain_ms": cuda_ms(lambda: bl.bts_ref(facs, rhs), 3),
            **bound(*bts_work(pp, mm, kk_, rr)),
            "library_ms": None, "max_abs_err": err})
        emit({"phase": "timing", "kernel": "bts", **bts_rows[-1]})
    bts.launches, bts.block_launches = saved[:2]
    bts.by_cluster.clear()
    bts.by_cluster.update(saved[2])
    summary[[e["name"] for e in summary].index("bts")]["shapes"] = bts_rows
    del bts_shapes, bts_cases, chain_lu
    # btf, the fused pass and bts at the fleet's folded shape (S*P = 1,024
    # chains of M = 64 blocks of K = 16, one launch for 64 systems), beside
    # their plain versions and the library loops, with each launch's cluster
    # size (row "fleet" of each kernel)
    fp, fm, fk = nchains, fleet_bt.m, fleet_bt.k
    fd, fe, ff = (fold(t) for t in (fleet_bt.d, fleet_bt.e, fleet_bt.f))
    fbq, fcq = (fold(t) for t in bl.pad_couplings(fleet_bt.b_cpl, fleet_bt.c_cpl, FLEET_P))
    fref = bl.btf_ref(fd, fe, ff)
    frhs = torch.randn((fp, fm, fk, 1), device=dev)
    fleet_specs = {
        "btf": (lambda: btf(fd, fe, ff), lambda: bl.btf_ref(fd, fe, ff),
                lambda: btf_library(fd, fe, ff), btf_work(fp, fm, fk),
                lib_btf.btf_cluster_size(fp, fk), errs[f"btf_fleet_k{fk}"]),
        "bts": (lambda: bts(fref.sinv, fref.l, ff, frhs), lambda: bl.bts_ref(fref, frhs), None,
                bts_work(fp, fm, fk, 1), lib_bts.bts_cluster_size(fp, fk, 1),
                errs[f"bts_fleet_k{fk}_r1"]),
        "fused_factor_spike": (lambda: fused_factor_spike(fd, fe, ff, fbq, fcq),
                               lambda: bl.fused_factor_spike_padded_ref(fd, fe, ff, fbq, fcq),
                               lambda: fused_library(fd, fe, ff, fbq, fcq), fused_work(fp, fm, fk),
                               lib_fused.fused_cluster_size(fp, fk), errs[f"fused_fleet_k{fk}"]),
    }
    for name, (kern, plain, lib_fn, (flops, nbytes), cs, err) in fleet_specs.items():
        w = wrappers[name]
        saved = w.launches, w.block_launches, dict(bts.by_cluster)
        ms = cuda_ms(kern, 20)
        plain_ms = cuda_ms(plain, 1)
        library_ms = cuda_ms(lib_fn, 5) if lib_fn else None
        w.launches, w.block_launches = saved[:2]  # timing launches are not the path's
        bts.by_cluster.clear()
        bts.by_cluster.update(saved[2])
        row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **bound(flops, nbytes),
               "cluster": cs, "max_abs_err": err,
               "shape": [fp, fm, fk] + ([1] if name == "bts" else []), "systems": FLEET_S}
        summary[[e["name"] for e in summary].index(name)]["fleet"] = row
        emit({"phase": "timing", "kernel": name, "at": "fleet", **row, "bytes": nbytes,
              "flops": flops})
    del fleet_bt, fd, fe, ff, fbq, fcq, fref, frhs

    # reduce level by level over the P=64 and the P=500 chain: the kernel at
    # the tile size it takes, the library call (six batched torch.matmul
    # products) and the plain version
    saved = bcr.reduce.launches, dict(bcr.reduce.by_tile)
    reduce_levels = {}
    facts500, solves500, _ = bcr_inputs(*chain500, (1,))
    for tag, lv_facts in (("p64", facts), ("p500", facts500)):
        rows = []
        for fa in lv_facts:
            m2, kb = fa[0].shape[0] // 2, fa[0].shape[1]
            lib_out, plain_out = reduce_library(*fa), cr.bcr_reduce_ref(*fa)
            reps = 3 if m2 >= 64 else 10
            rows.append({
                "m2": m2, "k": kb, "tile": lib_bcr.bcr_reduce_tile(m2, kb),
                "ms": cuda_ms(lambda: bcr.reduce(*fa), reps),
                "library_ms": cuda_ms(lambda: reduce_library(*fa), reps),
                "plain_ms": cuda_ms(lambda: cr.bcr_reduce_ref(*fa), reps),
                "library_max_abs_err_vs_plain": max(
                    float((o - w).abs().max()) for o, w in zip(lib_out, plain_out)),
                **bound(*reduce_level_work(m2, kb))})
            del lib_out, plain_out
        reduce_levels[tag] = rows
        emit({"phase": "timing", "kernel": "bcr_reduce", "at": tag, "by_level": rows,
              "levels_ms": sum(r["ms"] for r in rows),
              "levels_library_ms": sum(r["library_ms"] for r in rows),
              "levels_plain_ms": sum(r["plain_ms"] for r in rows)})
    bcr.reduce.launches = saved[0]
    bcr.reduce.by_tile.clear()
    bcr.reduce.by_tile.update(saved[1])
    summary[[e["name"] for e in summary].index("bcr_reduce")]["by_level"] = reduce_levels
    del facts500
    # rows 6 and 7 over one R=1 solve's levels of the P=500 chain (row
    # "p500"; the summary row is the P=64 chain's): the profiler's device
    # time, whose launches per call count the grids; and level by level over
    # both chains by queued_ms, each level's inputs rotated through 3x the
    # L2 where they fit in it; the library loop (baddbmm on gathered
    # neighbours) by the same clock; each level's route: CTAs a block
    # (rhs_reduce) or cluster size (backsub), rows and warps a CTA, floats a
    # row copy
    solve_fns = {"bcr_rhs_reduce": (bcr.rhs_reduce, rhs_reduce_library, cr.bcr_rhs_reduce_ref),
                 "bcr_backsub": (bcr.backsub, backsub_library, cr.bcr_backsub_ref)}
    work500 = bcr_work(chain500[0].shape[0], chain500[0].shape[1], 1)
    for which, (name, (kern, lib_fn, plain_fn)) in enumerate(solve_fns.items()):
        entry = summary[[e["name"] for e in summary].index(name)]
        routes_of = kern.by_split if which == 0 else kern.by_cluster
        saved = kern.launches, kern.block_launches, dict(routes_of)
        args500 = solves500[1][which]
        ms, by_kernel = device_ms(each(kern, args500), 20, lambda: kern.launches)
        entry["p500"] = {
            "ms": ms, "ms_is": "device" if by_kernel is not None else "queued",
            "host_ms": host_ms(each(kern, args500), 20), "device_ms_by_kernel": by_kernel,
            "plain_ms": cuda_ms(each(plain_fn, args500), 2),
            "library_ms": device_ms(each(lib_fn, args500), 20)[0],
            **bound(*work500[name[4:]]),
            "shape": list(chain500[0].shape)}
        emit({"phase": "timing", "kernel": name, "at": "p500", **entry["p500"]})
        levels = {}
        for tag, args_all in (("p64", solves[1][which]), ("p500", args500)):
            rows = []
            for args in args_all:
                m2, kb, rr = args[0].shape[0], args[0].shape[1], args[-1].shape[-1]
                flops, nbytes = solve_level_work(m2, kb, rr)[name[4:]]
                nxt = rotating(lambda seed, args=args: tuple(t.clone() for t in args), nbytes)
                reps = 20 if nbytes > L2_BYTES else 100
                k_ms = queued_ms(lambda: kern(*nxt()), reps)
                size = (lib_bcr.bcr_rhs_reduce_split(m2, kb, rr) if which == 0
                        else lib_bcr.bcr_backsub_cluster(m2, kb, rr))
                bnd = bound(flops, nbytes)
                rows.append({
                    "m2": m2, "k": kb, "r": rr, "split" if which == 0 else "cluster": size,
                    "rows_per_cta": -(-kb // size), "warps": lib_bcr.bcr_solve_warps(kb, size),
                    "max_active_clusters": (lib_bcr.bcr_backsub_max_clusters(kb, rr, size)
                                            if which else None),
                    "row_copy_floats": lib_bcr.bcr_solve_vec(
                        args[0].data_ptr(), args[1].data_ptr(), args[2 * which].data_ptr(), kb),
                    "ms": k_ms, "ms_is": "queued",
                    "library_ms": queued_ms(lambda: lib_fn(*nxt()), reps),
                    **bnd, "share_of_bound": bnd["bound_ms"] / k_ms,
                    "share_of_calibrated_bound": bnd["bound_ms_calibrated"] / k_ms})
                del nxt
            levels[tag] = rows
            emit({"phase": "timing", "kernel": name, "at": f"{tag}_by_level", "by_level": rows,
                  "levels_ms": sum(r["ms"] for r in rows),
                  "levels_library_ms": sum(r["library_ms"] for r in rows),
                  "levels_bound_ms": sum(r["bound_ms"] for r in rows)})
        kern.launches, kern.block_launches = saved[:2]
        routes_of.clear()
        routes_of.update(saved[2])
        entry["by_level"] = levels
    del chain500, solves500
    # the SaP-scan kernels at the LM path's decode shapes (the summary row:
    # the serving engine's step) and prefill shapes (row "prefill"): ms is
    # the profiler's device time per call (both launches of the split
    # route), host_ms the wall time per call of the loop
    scan_specs = {
        "wkv": dict(source="src/repro_torch/kernels/csrc/wkv.cu",
                    replaces="src/repro/kernels/wkv_chunk.py:38"),
        "ssd": dict(source="src/repro_torch/kernels/csrc/ssd.cu",
                    replaces="src/repro/kernels/ssd_chunk.py:26"),
    }
    for name, s in scan_specs.items():
        entry = {"name": name, "route": "cuda", "source": s["source"],
                 "replaces": s["replaces"], "launches": lm_launches[name], "library_ms": None,
                 "ms_is": "device"}
        for tag in ("decode", "prefill"):
            b, t, c = scan_shapes[tag]
            if name == "wkv":
                make = lambda seed: wkv_inputs(dev, b * rw_h, t, rw_d, seed)  # noqa: E731
                shape = [b * rw_h, t, rw_d, c]
                flops, nbytes = wkv_work(b * rw_h, t, rw_d)
                nxt = rotating(make, nbytes)
                args = make(SEED)
                kern, plain = (lambda: wkv6(*nxt(), c)), (lambda: wkv6_plain(*args, c))
            else:
                make = lambda seed: ssd_inputs(  # noqa: E731
                    dev, b * zb_h, t, zb_n, zb_p, zb_h, seed)
                shape = [b * zb_h, t, zb_n, zb_p, c]
                flops, nbytes = ssd_work(b * zb_h, t, zb_n, zb_p, zb_h)
                nxt = rotating(make, nbytes)
                args = make(SEED)
                kern = lambda: ssd(*nxt(), c, zb_h)  # noqa: E731
                plain = lambda: ssd_plain(*args, c, zb_h)  # noqa: E731
            saved = wrappers[name].launches, dict(wrappers[name].by_route)
            reps = 200 if tag == "decode" else 20
            ms, by_kernel = device_ms(kern, reps, lambda: wrappers[name].launches)
            wall_ms = host_ms(kern, reps)
            plain_ms = cuda_ms(plain, 5 if tag == "decode" else 2)
            wrappers[name].launches = saved[0]  # timing launches are not the path's
            wrappers[name].by_route.update(saved[1])
            row = {"ms": ms, "ms_is": "device" if by_kernel is not None else "queued",
                   "host_ms": wall_ms, "device_ms_by_kernel": by_kernel,
                   "scan_route": scan_routes[f"{name}_{tag}"], "plain_ms": plain_ms,
                   **bound(flops, nbytes), "max_abs_err": errs[f"{name}_{tag}"], "shape": shape}
            emit({"phase": "timing", "kernel": name, "at": tag, **row, "library_ms": None,
                  "bytes": nbytes, "flops": flops})
            if tag == "decode":
                entry.update(row)
            else:
                entry[tag] = row
        summary.append(entry)
    # the flash kernel in bfloat16, as the prefill runs it: at Minitron-8B's
    # prefill (the summary row; the library call is PyTorch's fused causal
    # attention at that shape), at starcoder2-15b's windowed shape (row
    # "windowed"; the library call takes the window as an explicit mask),
    # and at deepseek-moe-16b's prefill and whisper-medium's bidirectional
    # encoder (rows in "shapes")
    entry = {"name": "flash", "route": "cuda", "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
             "replaces": "src/repro/kernels/flash_attn.py:31", "launches": lm_launches["flash"],
             "shapes": []}
    for tag in ("minitron", "starcoder2", "deepseek", "whisper_enc"):
        b, hq, hk, tq, tk, d, causal, window = flash_shapes[tag]
        q, k, v = flash_inputs(dev, b, hq, hk, tq, tk, d, torch.bfloat16, SEED)
        saved = flash_attention.launches
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal, window), 10)
        plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, causal, window), 2)
        flash_attention.launches = saved  # timing launches are not the path's
        if window is None:
            library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), 10)
        else:  # the window as an explicit boolean mask (True: attend)
            pos = torch.arange(tq, device=dev)
            mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
            library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True), 10)
            del mask
        tc_ops, exps, nbytes = flash_work(b, hq, hk, tq, tk, d, causal, window,
                                          q.element_size())
        row = {"ms": ms, "plain_ms": plain_ms, **attention_bound(tc_ops, exps, nbytes),
               "library_ms": library_ms, "max_abs_err": errs[f"flash_{tag}_bfloat16"],
               "shape": [b, hq, hk, tq, tk, d, causal, window]}
        emit({"phase": "timing", "kernel": "flash", "at": tag, **row, "bytes": nbytes,
              "flops_tensor_core": tc_ops, "exponentials": exps})
        if tag == "minitron":
            entry.update(row)
        elif tag == "starcoder2":
            entry["windowed"] = row
        else:
            entry["shapes"].append({"at": tag, **row})
        del q, k, v
    summary.append(entry)
    # host-orchestrated torch code of the path, timed for the record
    x64 = torch.randn(N, device=dev, dtype=torch.float64)
    emit({
        "phase": "timing", "torch_code": True,
        "band_matvec_f32band_f64x_ms": cuda_ms(lambda: band_matvec(band_d1, x64), 20),
        "band_to_block_tridiag_p64_ms": cuda_ms(lambda: band_to_block_tridiag(band_d1, K, 64), 5),
    })

    # no measured time may read under the least time the card could take (the
    # data sheet's bound); each row's share of both bounds, a share of the
    # calibrated bound above 1 printed as it is
    shares, above = [], []
    for entry in summary:
        rows = ([("", entry)] + [(t, entry[t]) for t in ("prefill", "windowed", "p500", "fleet")
                                 if t in entry]
                + [(r.get("at", ""), r) for r in entry.get("shapes", [])]
                + [(f"{tag} m2={r['m2']}", r) for tag, lv in entry.get("by_level", {}).items()
                   for r in lv])
        for at, row in rows:
            for what in ("ms", "library_ms"):
                if row.get(what) is not None and row[what] < row["bound_ms"]:
                    raise AssertionError(f"{entry['name']}: {what} {row[what]:.4g} reads under "
                                         f"its bound {row['bound_ms']:.4g} ms")
            share = {"kernel": entry["name"], "at": at, "ms": row["ms"],
                     "of_datasheet_bound": row["bound_ms"] / row["ms"],
                     "of_calibrated_bound": row["bound_ms_calibrated"] / row["ms"]}
            shares.append(share)
            if share["of_calibrated_bound"] > 1.0:
                above.append(share)
    emit({"phase": "shares", "rows": shares, "above_calibrated_bound": above})
    # the bfloat16 and float64 rows (phase "dtypes"); the scans' launches are
    # phase lm's scan_dtype="bfloat16" runs
    for entry in dtype_summary:
        if entry["launches"] is None:
            entry["launches"] = dtype_launches[entry["name"].split("_")[0]].get("bfloat16", 0)
    clock.end("timing")
    clock.total()
    emit({"kernels": summary + dtype_summary})
    print(smi, flush=True)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
