#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

from the root of a checkout, on a host with one CUDA card, the CUDA toolkit
(nvcc) and PyTorch built for CUDA.  It imports nothing of JAX and nothing of
the JAX package ``repro``.  Phases, each fatal on failure (exit 1, no result
line):

1. Print the python, torch and CUDA versions, the card, and the card's name
   and power limit as nvidia-smi reports them.
2. Build the seven kernel sources (``src/repro_torch/csrc/``: the scorer,
   the assembly tile, flash attention and its backward, the expert GEMM,
   WKV6 and the RG-LRU scan) from the checkout's sources into ``build/``,
   one nvcc each, in parallel, and print the build seconds and ptxas's
   report; fail if ptxas spills registers in any kernel.
3. Hold the scorer's two kernels against their plain torch versions on
   the card.  The full tile: float64 and float32, E in {1, 8, 64}, A, B in
   {1, 13, 16, 128}, random masks, exact equality (``torch.equal``), the
   masked tail (0 / +inf) and NaN propagation.  The fused pair kernel (the
   shortlisted pairs, the work combine and eq. 9's feasibility, (3, P)
   float64 out), bit for bit (NaN as NaN): float64 and float32 (float32
   planes, float64 combine), E in {1, 8, 64}, (A, B) in {(1, 1), (13, 13),
   (5, 128), (128, 128)}, P in {1, 32, A*B} an event, events with an empty
   shortlist inside a batch, pairs in the masked tail, NaN lanes, speeds
   other than 1, ``memory_constraint`` on and off.  The window kernel
   (``ccm_scorer_spec_f64``: a captured lock event a row, flow matrix to
   selection) bit for bit, with its flow matrix in shared memory and in
   global scratch: rows of ``scaling_phase(256)``'s first lock events in
   windows of 1 to 64 rows, mixed edge buckets, a pair count of 0, every
   pair infeasible, a tied maximum (the first wins), ``max_candidates=40``
   (lanes 64: F in shared memory past 48 KB) and ``max_candidates=70``
   (lanes 128: global scratch only); the scatter's adversarial rows
   (``spec_cases.scatter_cases``: one bin, distinct bins, a bin across
   the 32- and 256-edge borders, eb 512, 1024 and 2048, all pads,
   volumes whose order matters); random rows of an odd length (lanes 5 and 8, also
   through the launcher's padded staging stride) and of 64 and 300 pair
   slots.
4. Drive the main path, ``ccm_lb`` with ``n_iter=4, k_rounds=2,
   fanout=4`` on ``device="cuda"``: ``scaling_phase(256)`` (256 ranks, 6400
   tasks, 12,799 comm edges) in float64 solo, float64 with
   ``batch_lock_events=8`` and float32 with ``batch_lock_events=8``, and a
   memory-binding phase (the same shape with a 2.4e8-byte cap) in float64
   solo.  Each run is held against the port's own ``device="cpu"`` run
   (identical assignment, transfer log, transfers and max_work), and its
   pair-kernel launches (counted from zero just before the run, read just
   after) must equal its scorer calls and be more than zero, with no
   full-tile launch.  A 16-rank run is also held against the port's scalar
   reference path (``use_engine=False``), which never calls the scorer.
   The launched (E, A, B) and (E, A, B, P) shapes are recorded, and each
   run's scorer seconds with their split (pack, h2d, launch, d2h,
   combine).  Then the speculative driver on the same phase
   (``spec_window=8`` and 32 scan/disjoint, 8 vmap/greedy), each run
   identical to f64 solo's CPU run, with window-kernel launches equal to
   the windows that scored a row and no pair or full-tile launch; and
   ``ccm_lb_many`` of the JAX package's fleet benchmark (64 instances of a
   16-rank, 400-task phase, window 64, vmap), each instance identical to
   its solo run on the card's host engine.  Wall and stage seconds,
   windows, rollbacks and the window launcher's split are printed.  Then
   ``ccm_lb_pipeline`` over the JAX package's pipeline benchmark (256
   ranks, 6 phases of drifting loads, batch 8) on the CPU and on the card
   with ``reuse_csr``, with ``carry_engine``, and with ``carry_engine``
   and ``spec_window=8``: each card run equal to the CPU's phase by phase,
   CSR reuse, warm starts and engine carry on phases 1 to 5, the pair (or
   window) kernel launched in every phase; per-phase seconds, transfers,
   launches and ``score``/``commit`` seconds are printed.  Last, the
   async balancer ``ccm_lb_async`` on ``scaling_phase(256)`` at latency 0
   (equal to the sync card run), 0.5 and uniform(0.5, 1.5) (equal to the
   CPU's run, event trace included; the last profiled for the device's
   idle share), and the fault benchmark's 64-rank ``crash`` and
   ``crash_then_join`` (equal to the CPU's), each launching the pair
   kernel once a scorer call; walls, transfers, launches and
   ``FaultStats`` are printed.  Then the paper's Fig. 4a
   (``benchmarks/milp_vs_ccmlb.py``: ``random_phase(7, 4 ranks, 14 tasks,
   4 blocks, 16 comms)``, delta 1e-9, 1e-10, 1e-11 and 0): 12 CCM-LB seeds
   a delta on the card, each equal to the CPU's run, and the reduced FWMP
   solved by branch and bound (host numpy, a 100-node limit, a clock limit
   no solve reaches) without and with the card's best W_max as incumbent;
   a solve must end by optimality or the node limit, and a certified
   optimum must not lie above CCM-LB's best (status, objective, LP bound,
   nodes, seconds, CCM-LB's gap and increase are printed).  Last, the
   three planners on the card, each plan equal to the CPU's (the card's
   memory as the HBM budget): expert placement of
   ``benchmarks/expert_placement.py``'s qwen3-moe and llama4-scout at
   published width (zipf(1.4) counts over (4, E), 16 devices), one device
   at half speed, qwen with ``shards_per_expert=2, replicate=True``, a
   4-window drifting sequence synchronously and with ``spec_window=8``
   (window kernel, held to the synchronous plan), stage plans of three
   archs and one stage schedule (contiguous; they make no lock event, so
   no launch), and sequence packing of 256 costs on 8 ranks with and
   without a half-speed rank; pair launches per plan.
5. The paper's assembly application (section VI) on the card.  Hold the
   assembly-tile kernel (``src/repro_torch/csrc/assembly_tile.cu``) against
   its plain torch version: quad orders 4, 16, 64, 192; shapes (1, 1),
   (13, 7), (96, 96), (96, 160), (512, 512); random masks, coincident
   points in the square shapes; the direct distance to ``rtol=1e-5,
   atol=1e-4`` and ``mxu_distance`` to a relative error below 2e-2; block
   shapes (32, 64), (128, 128) and the application's 16 x 16 exactly
   equal; and the application's own launch (``execute.tile_kernel``) on
   real tasks of every quad order to ``rtol=1e-5, atol=1e-4``.  Then run
   the application at 8192 unknowns on 32 ranks: measure every task of the
   training configuration (4096 unknowns, 16 ranks) on the card, train the
   cost model on the card, and run the A/B/C comparison with measured
   durations and the trained model's predictions.  That run's placement
   (CCM-LB on the card) must equal the port's CPU placement from the same
   predictions, and homing is planned on both: both give the same plan, or
   both raise the same one of the reference's homing errors ("homing did
   not converge" is the reference's known fault, ROADMAP queue 3), which
   is then reported beside the A/B/C compute makespans.  Last, the
   analytic run on the card and on the CPU must agree exactly and
   reproduce the reference's counts.  Assembly-kernel launches, counted
   from zero before each measured run, must equal ``repeats * tasks +
   signatures``.
6. Serving ``qwen3-moe-30b-a3b`` on the card.  Hold the flash-attention
   kernel (``csrc/flash_attention.cu``) against its plain torch version in
   float32 (``atol=rtol=2e-5``) and bf16 (``2e-2``) on the cases of
   ``tests/test_kernels.py``, the serve shape (B 4, S 512, 32 / 4 heads,
   hd 128), a length that is no tile multiple, rows that see no key (exactly
   0), head dims 8 and 256, recurrentgemma-9b's local attention as served
   (B 4, S 2560, 16 query heads on one K/V head, hd 256, window 2048) and
   gemma2-27b's (S 4608, 32 query heads on 16, hd 128, window 4096,
   soft-cap 50); in bf16 also against the plain model of its arithmetic,
   p rounded to bf16 before p . v (``atol=4e-3``, ``rtol=2^-8``), and in
   float32 its block shapes against each other (``atol=1e-5``); hold the
   expert-GEMM kernel (``csrc/moe_gemm.cu``) against its plain version
   (``rtol=1e-5, atol=1e-4`` in float32, ``rtol=3e-2, atol=3e-1`` in bf16
   and, tighter, within one bf16 ulp: ``rtol=2^-7, atol=1e-3``) at the
   serve path's four shapes, ragged ones, and C = 1, 13 and 300.  Then
   serve: the model at its published width with its depth cut to 8 of 48
   layers, bf16 weights from the port's init (a seeded
   ``torch.Generator`` on the card), ``serve_batch`` with 4 requests of
   512-token prompts and 32 new tokens.  Launches, counted from zero just
   before the run, must be exactly 8 flash (one per layer, prefill) and
   3 x 8 x 33 = 792 expert GEMM (a prefill and 32 decode steps); prints the
   prefill (and three more prefills of the same batch, uncounted) and
   decode-step seconds, tokens/s, peak memory and, from
   ``torch.profiler`` over one more run, the device's idle share (with
   bounds that count the kernels the profiler left unrecorded).  Last,
   the same weights on the CPU against the card (TF32 off): a 64-token
   prompt and 4 teacher-forced decode steps, each step's logits held to
   the serving contract (normalised log-probs within ``atol=0.07,
   rtol=0.05``, argmax equal), with the count of top-k router selections
   that differ, then again with the card's routing pinned to the CPU's.
   In float32 (the same weight values, widened) the contract must hold.
   In bf16 the discrete router turns the two devices' different last-bit
   rounding into a different expert for near-tied tokens, and the logits
   are bf16-spaced, so the contract is reported, and the run fails only
   on a difference that rounding does not explain: a router flip where
   the CPU's k-th and (k+1)-th logits lie further apart than twice the
   token's logit change, a pinned log-prob beyond the contract's
   tolerance, or a pinned argmax that differs where the CPU's top two
   logits lie further apart than twice the step's largest logit error.
   Then the expert re-placement loop on the served weights (the JAX
   package's ``launch/train.py::rebalance_experts``): one prefill of the
   served prompts through ``run_stack`` gives the router counts (8, 128),
   ``plan_expert_placement`` on 16 devices runs on the card (pair kernel),
   ``apply_expert_permutation`` moves every MoE layer's experts on the
   card, and the same prefill runs again, then once more with its
   routing pinned to the first run's: exactly 8 flash and 24 expert GEMM
   launches each, counts permuted (exactly on the first layer; on the
   others exactly or with every moved top-k selection at a near tie: the
   card's ``index_add_`` sums a token's expert outputs in another order
   once the slots move, so this check cannot catch a wrongly permuted
   later layer), the pinned run's logits within the serving contract
   against the first prefill's (an argmax may differ only at a near tie;
   this is what holds the permuted weights of layers 1 to 7), and the
   unpinned run's too unless selections moved; the unpermuted prefill
   repeated shows the card's own spread; imbalance before and after,
   transfers, the plan's seconds and the launches summed over the four
   prefills are printed.
7. Serving the recurrent LMs on the card.  Hold the WKV6 kernel
   (``csrc/wkv6.cu``) against its plain versions in float32 and bf16 (r,
   k, v; log_w and u float32): y against the sequential oracle and the
   chunked version at chunks 16, 32 and 64, the final state against the
   chunked version's (``atol=2e-4``, ``rtol=1e-5``; bf16 y ``rtol=2^-7``,
   one ulp), on ``tests/test_kernels.py``'s chunk-boundary and fast-decay
   cases (log_w -15 and the clip extreme -exp(8), where only the oracle
   holds y: the chunked form is inexact there), the serve shape (B 4, S
   512, H 64, hd 64) with the test's decay and the model's initial one, a
   ragged S and head dims 8 and 128; hold the RG-LRU kernel
   (``csrc/rglru.cu``) against its plain version (``atol=1e-4``,
   ``rtol=1e-5``; bf16 ``rtol=2^-7``) on ``tests/test_kernels.py``'s
   cases, the serve shape (4, 2560, 4096) and ragged S and W.  Then serve
   ``rwkv6-7b`` and ``recurrentgemma-9b`` at their published widths and
   full depths (7.58 G and 9.40 G parameters, bf16 weights from the port's
   init), each with ``serve_batch`` of 4 requests (512- and 2560-token
   prompts; the latter past the 2048-token local window) and 32 new
   tokens.  Launches, counted from zero just before the run, must be
   exactly 32 wkv6 (bf16), and 26 rglru (float32) and 12 flash (bf16),
   and nothing else; prints the prefill and decode-step seconds,
   tokens/s, peak memory and the device's idle share as for qwen.  Each
   model is freed before the next.  Last, each model's first layers (2 of
   rwkv6's, one period of 3 of recurrentgemma's) on the CPU against the
   card on the same weights, teacher-forced for 4 steps after a 100-token
   (rwkv6) or 2112-token (recurrentgemma, past the window) prompt; in bf16
   recurrentgemma's prompt is 64 tokens (bf16 products are slow on the
   CPU).  The serving contract must hold in float32 and in bf16, where an
   argmax may differ only at a near tie (the CPU's top two logits closer
   than twice the step's largest logit error).
7b. Training ``qwen3-moe-30b-a3b`` on the card.  Hold the flash backward
   kernel (``csrc/flash_attention_bwd.cu``, through ``ops.flash_attention``'s
   autograd function) against autograd through the plain version at every
   ``FLASH_CASES`` shape in float32 and bf16 (dq, dk, dv within 1e-4 and
   2e-2 of their largest |value|), and the expert GEMM's backward (dX and
   dW, two launches of its kernel on transposed copies) against the plain
   autograd at the training shapes and the ragged ones (the forward's
   tolerances).  Then the same float32 weights of qwen cut to 2 layers on
   the card and the CPU: the loss and every gradient leaf of a 2 x 64-token
   batch (rtol 1e-4; gradients within 1e-3 of each leaf's largest
   |value|), and three AdamW steps' losses (rtol 1e-3).  Then ``launch.train.train_loop`` at
   the published width, 4 of 48 layers (3.11 G parameters), 10 steps of 4
   x 512 tokens at lr 3e-4, a CCM-LB expert re-placement every 5 steps on
   16 expert ranks (the pair kernel in the plan; the experts and AdamW's
   moments permuted on the card).  Launches, counted from zero just before the run,
   must be 8 flash forward (forward and remat), 4 flash backward, 24
   expert GEMMs in the forward and 24 in the backward every step, all
   bf16, and some pair launches; the losses finite and the last below the
   first.  One more step runs under ``torch.profiler`` (device idle
   share).  Then the restart pair at 1 of 48 layers (a 4-layer checkpoint
   is 31.1 GB, and the card hosts this script runs on end a run that
   writes more than 45 GiB to their disk): the run uninterrupted, then with a checkpoint every 5 steps into
   a temporary directory, failing at step 7 under ``run_with_restarts``:
   it must restore step 5's checkpoint and its losses from there agree
   with the uninterrupted run's within 1e-3 relative.  Prints the losses, seconds a step (median, min, max),
   tokens/s, peak memory, launches a step, each re-placement's imbalance
   and pair launches; then times both backwards at the training shapes
   against their plain versions' autograd, SDPA's and ``torch.bmm``'s
   backward (timed only) and their bounds.
8. Time the kernels, their plain versions and their bounds at the shapes
   the main paths launched most (the pair kernel also at E = 64, A = B =
   128, P = 32 an event, with the launcher's host time a call and its
   split) (CUDA events, median of repeats; for the
   serve kernels also one PyTorch call of the same function, SDPA and
   ``torch.bmm``, timed only; every kernel also as ``device_ms``,
   launches queued behind a sleep on the card, and flash and the expert
   GEMM as the host's time to queue one call); the assembly tile at the
   most-launched signature of each quad order, with the path's launches
   of each quad order (the mix); and the card's cost of one empty launch,
   the floor under every ``device_ms``.  Flash and the expert GEMM
   are held to their plain versions at every shape the serve paths
   launched, at the tolerances of phase 6, before they are timed.  The
   window kernel at the (W, eb) the spec runs launched most, and at the
   one spec32 and the fleet each launched most, with the launcher's host
   time a call.  Then profile one float64 solo main-path
   run and one ``spec_window=8`` run with ``torch.profiler``: device time
   by kernel and copy, and the device's idle share of the run's wall
   time.
9. Import every module of ``repro_torch``, check that no module of JAX or
   ``repro`` was loaded, then print one JSON line each of serve, recurrent
   serve, per-run, pipeline and async, MILP and planner, and assembly
   numbers, the launch floor, the card line,
   the training numbers,
   one JSON line of per-kernel numbers (the scorer's pair kernel and its
   full-tile kernel, each in float64 and float32, its window kernel, the
   assembly tile,
   flash, the expert GEMM, wkv6, rglru, the flash backward and the expert
   GEMM's backward) and, as the last line,
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Exits non-zero, printing no result, without a CUDA card or when the
``repro_torch`` package is not beside this script.
"""
from __future__ import annotations

import gc
import importlib
import json
import pkgutil
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM, NVIDIA data sheet: HBM3 rate, and the non-tensor-core FP64 and
# FP32 rates (the scorer does adds, subtracts, maxima and compares)
HBM_BYTES_PER_S = 3.35e12
# card clock cycles to sleep while the host queues the launches that
# device_ms times (about 50 ms at the H100's 1.98 GHz boost clock)
QUEUE_SLEEP_CYCLES = 10 ** 8
# seconds of idle host time at each end of a profiled run (profiled_run)
PROFILE_MARGIN_S = 0.1
PEAK_OPS = {"float64": 34e12, "float32": 67e12}
# operations per (ia, ib) lane of the scorer: 106 adds, subtractions and
# maxima plus the two mask compares (csrc/ccm_scorer.cu); selects not counted
OPS_PER_LANE = 108
# float64 operations per pair of the pair kernel's combine: per side four
# products, one quotient and three sums, and the two cap compares
COMBINE_OPS = 18
MAIN_KW = dict(n_iter=4, k_rounds=2, fanout=4)
KERNEL_SOURCE = "src/repro_torch/csrc/ccm_scorer.cu"
REPLACES = "src/repro/kernels/ccm_scorer/kernel.py:35"
# the window kernel replaces the XLA-compiled kind="spec" body (no Pallas)
SPEC_REPLACES = "src/repro/kernels/ccm_scorer/jit.py:253"
# the main path's speculative runs: (label, spec_window, spec_mode,
# spec_fill), each at scaling_phase(256) with MAIN_KW
SPEC_RUNS = (("spec8 scan/disjoint", 8, "scan", "disjoint"),
             ("spec32 scan/disjoint", 32, "scan", "disjoint"),
             ("spec8 vmap/greedy", 8, "vmap", "greedy"))
# the fleet run: the JAX package's benchmarks/ccmlb_fleet.py full
# configuration (64 instances of a 16-rank, 400-task random phase)
FLEET_N = 64
FLEET_PHASE = dict(num_ranks=16, num_tasks=400, num_blocks=24,
                   num_comms=1600, mem_cap=1e12)
FLEET_KW = dict(n_iter=8, k_rounds=2, fanout=8, max_candidates=12)
# per shortlist slot past the scorer tree and the combine: the diff, the
# max of the works, two feasibility compares and the selection compare
SPEC_SLOT_OPS = 5
# the JAX package's benchmarks/ccmlb_pipeline.py full configuration (256
# ranks, 6 phases, loads drifting by a lognormal sigma of 0.08 a phase)
PIPE_PHASE = dict(num_ranks=256, num_tasks=6400, num_blocks=768,
                  num_comms=12800, mem_cap=1e12)
PIPE_N, PIPE_DRIFT = 6, 0.08
PIPE_KW = dict(n_iter=4, k_rounds=2, fanout=4, seed=0, batch_lock_events=8)
# benchmarks/ccmlb_async.py (256 ranks) and ccmlb_fault.py at its largest
# size (64 ranks)
ASYNC_LATENCIES = (0.0, 0.5, ("uniform", 0.5, 1.5))
FAULT_LAT = ("uniform", 0.5, 1.5)
FAULT_RANKS = 64
# the JAX package's benchmarks/milp_vs_ccmlb.py (paper Fig. 4a): the
# instance, the delta sweep, 12 CCM-LB seeds a delta; the MILP's node limit
# lets every solve end well inside the smoke, and its wall-clock limit is
# one no solve reaches (a solve cut by the clock is not reproducible)
MILP_PHASE = dict(num_ranks=4, num_tasks=14, num_blocks=4, num_comms=16,
                  mem_cap=5e8)
MILP_DELTAS = (1e-9, 1e-10, 1e-11, 0.0)
MILP_SEEDS = 12
MILP_KW = dict(n_iter=4, fanout=3)
MILP_NODES = 100
MILP_NO_CLOCK = 3600.0
# the planners: benchmarks/expert_placement.py's router counts drifting by a
# lognormal sigma a window; tests/test_balance.py's stage-plan archs
PLAN_WINDOWS, PLAN_DRIFT = 4, 0.15
STAGE_ARCHS = ("recurrentgemma-9b", "gemma2-27b", "qwen3-moe-30b-a3b")
STAGE_SCHEDULE = (2048, 4096, 8192, 4096)
ASM_SOURCE = "src/repro_torch/csrc/assembly_tile.cu"
ASM_REPLACES = "src/repro/kernels/assembly/kernel.py:25"
# operations per coupled entry and quadrature step, as the JAX package's
# analytic_durations counts them (assembly/execute.py); the kernel skips the
# ladder of an uncoupled entry, so only coupled entries count
ASM_OPS_PER_STEP = 8
ASM_QUADS = (4, 16, 64, 192)
ASM_SHAPES = ((1, 1), (13, 7), (96, 96), (96, 160), (512, 512))
# the reference's A/B/C run at 8192 unknowns, 32 ranks, task_limit_u=96,
# analytic durations, seed 0 (the JAX package on the CPU; the tests hold the
# port's CPU run to it bitwise at 2048 unknowns)
ASM_EXPECT = dict(tasks=5018, transfers=107, off_home=63, waves=2)
# the reference's homing planner's errors (assembly/homing.py)
HOMING_FAULTS = ("homing did not converge",
                 "homing infeasible: no node has headroom")
# the serving path: qwen3-moe-30b-a3b at its published width, depth cut to
# 8 of 48 layers (the card-against-CPU check keeps a copy of the weights in
# host memory); 4 requests of 512-token prompts, 32 new tokens
SERVE_ARCH = "qwen3-moe-30b-a3b"
SERVE_LAYERS = 8
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 512, 32
CHECK_PROMPT, CHECK_STEPS = 64, 4
PEAK_BF16 = 989e12          # dense bf16 tensor-core rate, H100 SXM
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash/kernel.py:28"
GEMM_SOURCE = "src/repro_torch/csrc/moe_gemm.cu"
GEMM_REPLACES = "src/repro/kernels/moe_gemm/kernel.py:22"
# tests/test_kernels.py's tolerances: flash atol = rtol = tol; the expert
# GEMM rtol = tol, atol = 10 tol
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GEMM_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# the bf16 flash kernel against ref.reference_attention_bf16_p, the plain
# model of its arithmetic (p rounded to bf16 before p . v), which returns
# float32: rtol half a bf16 ulp (the kernel's output is rounded once), atol
# for p's rounding, which the kernel applies to exp(s - running max) and
# the model to exp(s - row max) (each p within 2^-9 of its own, relatively;
# 2e-3 seen on the served shapes)
FLASH_P_TOL = dict(atol=4e-3, rtol=2 ** -8)
# the bf16 expert GEMM against its plain version, tightly: both accumulate
# the exact bf16 products in float32 and round once, so they differ only
# where float32 sums taken in another order fall on two sides of a bf16
# rounding boundary: one bf16 ulp, at most 2^-7 of the value; atol for
# results near 0, where the sums' own float32 error (about 1e-6 here)
# outweighs an ulp
GEMM_P_TOL = dict(rtol=2 ** -7, atol=1e-3)
# (B, Sq, Skv, Hq, Hkv, hd, causal, window, softcap): the cases of
# tests/test_kernels.py, then the serve shape, a length that is no multiple
# of the 64-row tile, rows that see no key (a window ending before the
# keys do), head dims 8 and 256, recurrentgemma-9b's local attention as
# served (16 query heads on one K/V head, hd 256, 2560 tokens past the
# 2048-token window, so whole key tiles before the window are skipped) and
# gemma2-27b's as served (hd 128, soft-cap 50, 4608 tokens past the
# 4096-token window)
FLASH_CASES = (
    (2, 128, 128, 4, 2, 64, True, 0, 0.0),
    (1, 256, 256, 4, 4, 64, True, 64, 0.0),
    (2, 128, 128, 8, 2, 32, True, 0, 50.0),
    (1, 192, 192, 2, 1, 64, False, 0, 0.0),
    (1, 96, 160, 2, 2, 64, False, 0, 0.0),
    (4, 512, 512, 32, 4, 128, True, 0, 0.0),
    (1, 100, 100, 4, 2, 128, True, 0, 0.0),
    (1, 128, 64, 2, 1, 64, False, 16, 0.0),
    (1, 37, 37, 2, 2, 8, True, 0, 0.0),
    (1, 70, 70, 2, 1, 256, True, 0, 0.0),
    (4, 2560, 2560, 16, 1, 256, True, 2048, 0.0),
    (1, 4608, 4608, 32, 16, 128, True, 4096, 50.0),
)
# (E, C, d, f): the serve path's prefill gate/up and down, its decode
# gate/up and down, then ragged C, d and f (the wmma kernel: d or f no
# multiple of 8), and C = 1, 13 (no multiple of 8) and 300 (two N tiles of
# the TMA kernel); time_serve_kernels also holds the kernel to its plain
# version at every shape the serve path launched
GEMM_SHAPES = ((128, 168, 2048, 768), (128, 168, 768, 2048),
               (128, 4, 2048, 768), (128, 4, 768, 2048), (3, 37, 100, 70),
               (5, 16, 64, 130), (8, 1, 2048, 768), (8, 13, 2048, 768),
               (8, 300, 2048, 768))

# the training path (phase 7b): qwen3-moe-30b-a3b at its published width,
# depth cut to 4 of 48 layers (3.11 G parameters: 37.4 GB of bf16 weights,
# bf16 gradients and float32 AdamW moments before activations); 10 steps of
# 4 x 512 tokens at lr 3e-4, a re-placement every 5 steps on 16 expert ranks
# (the production mesh's model axis).  The restart check writes a
# checkpoint every 5 steps, and a checkpoint of those 4 layers is 31.1 GB
# (bf16 params, float32 m and v): two of them pass the 45 GiB that the card
# hosts this script runs on let one run write to their disk, deleted files
# included.  So the restart pair (the run
# uninterrupted, then failing at step 7 and restarted from step 5's
# checkpoint) runs at TRAIN_RESTART_LAYERS, whose checkpoint is 12.45 GB,
# and the 4-layer run keeps no checkpoint
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_RESTART_LAYERS = "qwen3-moe-30b-a3b", 4, 1
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 512, 4, 10, 3e-4
TRAIN_REBALANCE, TRAIN_RANKS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 5, 16, 5, 7
# the restarted run's losses against the uninterrupted run's: the card's
# index_add_ sums in no set order, and the restarted run resumes before the
# step-5 re-placement (a function-preserving permutation) that the
# uninterrupted run applied, so its expert sums run in another order
TRAIN_RESTART_RTOL = 1e-3
# card vs cpu: the same float32 weights of qwen cut to 2 layers, a batch of
# 2 x 64 tokens: the loss within rtol 1e-4 and each gradient leaf within
# 1e-3 of its largest |value| (float32 on both sides, TF32 off; sums in
# other orders); the three steps' losses within TRAIN_RESTART_RTOL, for the
# restart check's reason: AdamW moves an element by about lr whatever its
# gradient's size, so where a gradient is near 0 the two sides' rounding
# decides the step (on an H100, 7e-5 after three steps with the first loss
# equal bit for bit)
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 2, 64
TRAIN_CHECK_STEPS = 3
TRAIN_CHECK_RTOL, TRAIN_CHECK_GRAD = 1e-4, 1e-3
# the flash backward against the plain version's autograd (float32) at every
# FLASH_CASES shape: each of dq, dk, dv within this share of its largest
# |value| (float32 inputs: sums in another order; bf16 inputs: the forward's
# output, whose p was rounded to bf16, enters D = rowsum(dO o O), and the
# gradients are rounded once to bf16)
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FLASH_BWD_SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"
FLASH_BWD_REPLACES = "src/repro/models/attention.py:98"
GEMM_BWD_REPLACES = "src/repro/models/moe.py:68"
# the expert GEMM's backward: the training shapes (C = 168; gate/up and
# down), then the ragged ones of GEMM_SHAPES
GEMM_BWD_SHAPES = ((128, 168, 2048, 768), (128, 168, 768, 2048),
                   (3, 37, 100, 70), (5, 16, 64, 130), (8, 1, 2048, 768),
                   (8, 13, 2048, 768), (8, 300, 2048, 768))

# the recurrent serving paths, at their published widths and full depths:
# rwkv6-7b (32 rwkv6 layers: 32 wkv6 launches in prefill) and
# recurrentgemma-9b (12 periods of rglru, rglru, local_attn and 2 rglru:
# 26 rglru and 12 flash launches in prefill, with 2560-token prompts, past
# the 2048-token window); each entry: arch, prompt length, prefill
# launches {kernel: (dtype, count)}, the card-vs-cpu check's depth and its
# prompt length per dtype (recurrentgemma's bf16 check on the CPU at 64
# tokens: bf16 products are slow there; float32 at 2112, past the window)
RWKV_ARCH, RG_ARCH = "rwkv6-7b", "recurrentgemma-9b"
REC_SERVES = (
    (RWKV_ARCH, 512, {"wkv6": ("bfloat16", 32)}, 2,
     {"bfloat16": 100, "float32": 100}),
    (RG_ARCH, 2560, {"rglru": ("float32", 26), "flash": ("bfloat16", 12)}, 3,
     {"bfloat16": 64, "float32": 2112}),
)
WKV_SOURCE = "src/repro_torch/csrc/wkv6.cu"
WKV_REPLACES = "src/repro/kernels/rwkv6/kernel.py:22"
RGLRU_SOURCE = "src/repro_torch/csrc/rglru.cu"
RGLRU_REPLACES = "src/repro/kernels/rglru/kernel.py:25"
# tests/test_kernels.py's tolerances (wkv6 atol 2e-4, rglru 1e-4), with a
# relative term of 1e-5 for the serve shapes' larger values in float32 and
# one bf16 ulp (2^-7) for bf16 outputs
WKV_ATOL, RGLRU_ATOL = 2e-4, 1e-4
WKV_RTOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
# (B, S, H, hd, log_w): tests/test_kernels.py's chunk-boundary cases and
# fast decay (-15, and the model's clip at -exp(8)), the serve shape with
# the test's decay and with the model's initial decay -exp(-6), a ragged
# S, head dims 8 and 128
WKV_CASES = (
    (2, 64, 2, 32, None), (2, 128, 2, 32, None), (1, 64, 1, 16, -15.0),
    (1, 64, 1, 16, -2980.9579870417283), (4, 512, 64, 64, None),
    (4, 512, 64, 64, -0.0024787521766663585), (1, 100, 4, 64, None),
    (1, 37, 2, 8, None), (1, 70, 2, 128, None),
)
# (B, S, W): tests/test_kernels.py's rglru cases, the serve shape, ragged
# S and W
RGLRU_CASES = ((2, 128, 64), (2, 256, 64), (2, 64, 128), (4, 2560, 4096),
               (3, 77, 50), (1, 1, 300), (2, 100, 4100))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def random_tiles(torch, rng, dtype, e_n, a_n, b_n):
    from repro_torch.kernels.ccm_scorer.layout import N_AV, N_PM, N_SC, SC
    av = rng.uniform(-2, 2, (e_n, N_AV, a_n))
    bv = rng.uniform(-2, 2, (e_n, N_AV, b_n))
    pm = rng.uniform(-2, 2, (e_n, N_PM, a_n, b_n))
    sc = rng.uniform(0.1, 3.0, (e_n, N_SC))
    sc[:, SC.na] = rng.integers(0, a_n, e_n)
    sc[:, SC.nb] = rng.integers(0, b_n, e_n)
    return [torch.tensor(x, dtype=dtype, device="cuda")
            for x in (av, bv, pm, sc)]


# ------------------------------------------------------------ 3. the kernel
def check_kernel(torch, kernel, ref, rng) -> dict:
    """The kernel against its plain version on the card, exactly."""
    from repro_torch.kernels.ccm_scorer.layout import AV, OUT, SC
    worst = {}
    n_cases = 0
    for dtype in (torch.float64, torch.float32):
        name = dtype_name(dtype)
        worst[name] = 0.0
        for e_n in (1, 8, 64):
            for a_n in (1, 13, 16, 128):
                for b_n in (1, 13, 16, 128):
                    t = random_tiles(torch, rng, dtype, e_n, a_n, b_n)
                    got = kernel.score_tiles(*t)
                    want = ref.score_tiles(*t)
                    torch.cuda.synchronize()
                    case = f"{name} E={e_n} A={a_n} B={b_n}"
                    if got.shape != want.shape or got.dtype != dtype:
                        fail(f"kernel shape/dtype {tuple(got.shape)} "
                             f"{got.dtype} at {case}")
                    if not torch.equal(got, want):
                        fail(f"kernel != plain version at {case}")
                    sc = t[3]
                    ia = torch.arange(a_n, device="cuda")[None, :, None]
                    ib = torch.arange(b_n, device="cuda")[None, None, :]
                    live = ((ia <= sc[:, SC.na, None, None])
                            & (ib <= sc[:, SC.nb, None, None]))[:, None]
                    tail = ~live
                    flow, mem = got[:, :OUT.mem_a], got[:, OUT.mem_a:]
                    if not (flow.masked_select(tail) == 0).all():
                        fail(f"flow tail not 0 at {case}")
                    if not torch.isposinf(mem.masked_select(tail)).all():
                        fail(f"memory tail not +inf at {case}")
                    if not torch.isfinite(got.masked_select(live)).all():
                        fail(f"non-finite live lane at {case}")
                    both = live.expand_as(got)
                    err = (got[both] - want[both]).abs().max().item()
                    worst[name] = max(worst[name], err)
                    n_cases += 1
        # NaN inputs must come out NaN, as through np.maximum
        t = random_tiles(torch, rng, dtype, 8, 13, 13)
        t[3][:, SC.na] = 12
        t[3][:, SC.nb] = 12
        t[0][:, AV.ovh, 3] = float("nan")         # mem_b's max operand
        t[1][:, AV.out_other, 2] = float("nan")   # off_b through sent_b
        t[3][1, SC.ovh_a] = float("nan")          # mem_a's max operand
        got = kernel.score_tiles(*t)
        want = ref.score_tiles(*t)
        if not torch.isnan(got).any():
            fail(f"NaN inputs gave no NaN output ({name})")
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   equal_nan=True)
        n_cases += 1
    print(f"kernel == plain version on {n_cases} cases (float64 and "
          f"float32, exact, masked tail and NaN checked); max_abs_err "
          f"{worst}", flush=True)
    return worst


def pair_events(rng, e_n, a_n, b_n, counts, tails=False, nans=False):
    """Unpadded per-event features ``(av, bv, pm, sc)`` of an (a_n, b_n)
    tile each, as the engine builds them (sc float64), with speeds other
    than 1 and caps that split the pairs, and ``counts[k]`` random pairs of
    event k, drawn over the whole tile.  ``tails``: each event's na, nb
    random below the tile's, so that pairs in the masked tail are scored
    too.  ``nans``: the last event all live and its flows NaN (a NaN W
    wherever feasible), a NaN memory high in the first event's first
    a-column and a NaN off-rank volume in the last event's first
    b-column."""
    import numpy as np
    from repro_torch.kernels.ccm_scorer.layout import AV, N_AV, N_PM, N_SC, SC
    feats, pairs = [], []
    for n in counts:
        sc = rng.uniform(0.1, 3.0, N_SC)
        sc[SC.na], sc[SC.nb] = ((rng.integers(0, a_n), rng.integers(0, b_n))
                                if tails else (a_n - 1, b_n - 1))
        sc[SC.speed_a], sc[SC.speed_b] = rng.uniform(0.3, 4.0, 2)
        sc[SC.mem_cap_a], sc[SC.mem_cap_b] = rng.uniform(4.0, 12.0, 2)
        feats.append((rng.uniform(-2, 2, (N_AV, a_n)),
                      rng.uniform(-2, 2, (N_AV, b_n)),
                      rng.uniform(-2, 2, (N_PM, a_n, b_n)), sc))
        lanes = rng.choice(a_n * b_n, size=n, replace=False)
        pairs.append(np.stack([lanes // b_n, lanes % b_n], axis=1))
    if nans:
        feats[-1][3][[SC.na, SC.nb]] = a_n - 1, b_n - 1
        feats[-1][3][SC.f_ab] = float("nan")
        feats[0][0][AV.ovh, 0] = float("nan")
        feats[-1][1][AV.out_other, 0] = float("nan")
    return feats, pairs


def pair_inputs(torch, launch, dtype, feats, pairs, params) -> list:
    """The pair kernel's inputs on the card, packed as the launcher packs
    them (``launch.pack``): av, bv, pm, sc, cf, offs, pairs."""
    _, regions, _ = launch.pack(feats, pairs, params, launch.Staging(
        torch.device("cpu"), dtype))
    return [torch.from_numpy(v).to("cuda") for v in regions]


def check_pair_kernel(torch, kernel, launch, ref, rng) -> dict:
    """The fused pair kernel against its plain version on the card, bit
    for bit (NaN as NaN): float64 and float32 (float32 planes, float64
    combine); E in {1, 8, 64}; (A, B) in {(1, 1), (13, 13), (5, 128),
    (128, 128)}; P in {1, 32, A*B} per event (events 1 and 5 empty where
    E >= 8); masked tails; NaN lanes; random coefficients, speeds other
    than 1; memory_constraint on and off."""
    from repro_torch.core import CCMParams
    worst = {}
    n_cases = 0
    split = [0, 0]          # infeasible and feasible pairs, constraint on
    for dtype in (torch.float64, torch.float32):
        name = dtype_name(dtype)
        worst[name] = 0.0
        for e_n in (1, 8, 64):
            for a_n, b_n in ((1, 1), (13, 13), (5, 128), (128, 128)):
                for p_n in sorted({1, min(32, a_n * b_n), a_n * b_n}):
                    for mc in (True, False):
                        nans = (n_cases % 3 == 0)
                        counts = [0 if e_n >= 8 and k in (1, 5) else p_n
                                  for k in range(e_n)]
                        feats, pairs = pair_events(rng, e_n, a_n, b_n,
                                                   counts, True, nans)
                        params = CCMParams(*rng.uniform(0.05, 2.0, 4),
                                           memory_constraint=mc)
                        t = pair_inputs(torch, launch, dtype, feats, pairs,
                                        params)
                        got = kernel.score_pairs(*t, mc)
                        want = ref.score_pairs_packed(*t, mc)
                        torch.cuda.synchronize()
                        case = (f"{name} E={e_n} A={a_n} B={b_n} P={p_n} "
                                f"memory_constraint={mc} nans={nans}")
                        if got.shape != want.shape or \
                                got.dtype != torch.float64:
                            fail(f"pair kernel shape/dtype "
                                 f"{tuple(got.shape)} {got.dtype} at {case}")
                        try:
                            torch.testing.assert_close(
                                got, want, rtol=0, atol=0, equal_nan=True)
                        except AssertionError as err:
                            fail(f"pair kernel != plain version at {case}: "
                                 f"{err}")
                        # without the constraint every pair of the last
                        # event has a NaN W
                        if nans and not mc and not torch.isnan(got).any():
                            fail(f"NaN inputs gave no NaN output at {case}")
                        feas = got[2]
                        if not ((feas == 0) | (feas == 1)).all():
                            fail(f"feasibility not 0/1 at {case}")
                        if not torch.isposinf(got[:2, feas == 0]).all():
                            fail(f"infeasible pair not +inf at {case}")
                        if mc:
                            split[0] += int((feas == 0).sum().item())
                            split[1] += int((feas == 1).sum().item())
                        ok = torch.isfinite(got) & torch.isfinite(want)
                        if ok.any():
                            err = (got[ok] - want[ok]).abs().max().item()
                            worst[name] = max(worst[name], err)
                        n_cases += 1
    if not min(split):
        fail(f"the caps did not split the pairs (infeasible, feasible: "
             f"{split})")
    print(f"pair kernel == plain version on {n_cases} cases (float64 and "
          f"float32, bit for bit, masked tails, NaN lanes, empty "
          f"shortlists; {split[0]} infeasible and {split[1]} feasible pairs "
          f"under the memory constraint); max_abs_err {worst}", flush=True)
    return worst


# --------------------------------------------------------- 4. the main path
def same_run(a, b) -> bool:
    import numpy as np
    return (np.array_equal(a.assignment, b.assignment)
            and a.transfer_log == b.transfer_log
            and a.transfers == b.transfers and a.max_work == b.max_work)


def ranks_over_cap(state) -> int:
    return sum(not state.memory_feasible(r)
               for r in range(state.phase.num_ranks))


def main_path(torch, kernel, launch) -> dict:
    import numpy as np
    from repro_torch.core import (CCMParams, CCMState, ccm_lb,
                                  initial_assignment, random_phase,
                                  scaling_phase)
    launches = {"float64": 0, "float32": 0}
    shapes = {"float64": Counter(), "float32": Counter()}
    pair_shapes = {"float64": Counter(), "float32": Counter()}
    runs = {}

    # 16 ranks against the scalar reference path (never calls the scorer)
    small = scaling_phase(16)
    a_small = initial_assignment(small)
    scalar = ccm_lb(small, a_small, CCMParams(), use_engine=False,
                    device="cpu", **MAIN_KW)
    kernel.reset_launches()
    launch.reset_stats()
    eng = ccm_lb(small, a_small, CCMParams(), device="cuda", **MAIN_KW)
    torch.cuda.synchronize()
    n16 = kernel.PAIR_LAUNCHES["float64"]
    if not same_run(scalar, eng):
        fail("16 ranks: cuda engine run differs from the scalar reference")
    if n16 == 0 or n16 != launch.STATS["calls"] \
            or sum(kernel.LAUNCHES.values()):
        fail(f"16 ranks: {n16} pair launches vs {launch.STATS['calls']} "
             f"calls, full-tile launches {kernel.LAUNCHES}")
    launches["float64"] += n16
    shapes["float64"].update(launch.STATS["shapes"])
    pair_shapes["float64"].update(launch.STATS["pair_shapes"])
    print(f"16 ranks: cuda engine == scalar reference ({eng.transfers} "
          f"transfers, {n16} launches)", flush=True)

    scaling = scaling_phase(256)
    memory = random_phase(1, num_ranks=256, num_tasks=6400, num_blocks=768,
                          num_comms=12800, mem_cap=2.4e8)
    params = CCMParams()
    print(f"main path: scaling_phase(256): {scaling.num_ranks} ranks, "
          f"{scaling.num_tasks} tasks, {scaling.num_comms} comm edges, "
          f"{MAIN_KW}", flush=True)
    f64_assignment = None
    for label, phase, batch, dtype in (
            ("f64 solo", scaling, 1, torch.float64),
            ("f64 batch8", scaling, 8, torch.float64),
            ("f32 batch8", scaling, 8, torch.float32),
            ("f64 solo memory-binding", memory, 1, torch.float64)):
        name = dtype_name(dtype)
        a0 = initial_assignment(phase)
        kw = dict(MAIN_KW, batch_lock_events=batch, dtype=dtype)
        launch.reset_stats()
        t0 = time.perf_counter()
        cpu = ccm_lb(phase, a0, params, device="cpu", profile=True, **kw)
        cpu_s = time.perf_counter() - t0
        cpu_calls = launch.STATS["calls"]

        kernel.reset_launches()
        launch.reset_stats()
        t0 = time.perf_counter()
        gpu = ccm_lb(phase, a0, params, device="cuda", profile=True, **kw)
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        n_launch = dict(kernel.PAIR_LAUNCHES)
        calls = launch.STATS["calls"]

        if not same_run(gpu, cpu):
            fail(f"{label}: cuda run differs from the cpu run")
        if n_launch[name] == 0 or n_launch[name] != calls \
                or calls != cpu_calls:
            fail(f"{label}: pair kernel launches {n_launch} vs scorer calls "
                 f"{calls} (cpu run {cpu_calls})")
        if sum(n_launch.values()) != n_launch[name]:
            fail(f"{label}: launches of the other dtype {n_launch}")
        if sum(kernel.LAUNCHES.values()):
            fail(f"{label}: the full-tile kernel was launched "
                 f"{kernel.LAUNCHES} on the main path")
        mw = np.asarray(gpu.max_work)
        if (not np.isfinite(mw[-1]) or not mw[-1] < mw[0]
                or gpu.assignment.shape != (phase.num_tasks,)
                or gpu.assignment.min() < 0
                or gpu.assignment.max() >= phase.num_ranks):
            fail(f"{label}: implausible result (max_work {gpu.max_work})")
        over = None
        if phase is memory:
            over = (ranks_over_cap(CCMState.build(phase, a0, params)),
                    ranks_over_cap(gpu.state))
            if not np.isinf(mw[0]) or over[0] == 0 or over[1] != 0:
                fail(f"{label}: memory constraint did not bind and clear "
                     f"(ranks over the cap {over}, max_work {mw[[0, -1]]})")
        if phase is scaling and name == "float64" and batch == 1:
            f64_assignment = gpu.assignment
            f64_cpu_run, f64_cuda_run = cpu, gpu
        if name == "float32" and not np.array_equal(gpu.assignment,
                                                    f64_assignment):
            fail(f"{label}: float32 assignment differs from float64")
        launches[name] += n_launch[name]
        shapes[name].update(launch.STATS["shapes"])
        pair_shapes[name].update(launch.STATS["pair_shapes"])
        stages = {k: sum(t[k] for t in gpu.stage_timings)
                  for k in gpu.stage_timings[0]}
        cpu_stages = {k: sum(t[k] for t in cpu.stage_timings)
                      for k in cpu.stage_timings[0]}
        runs[label] = dict(
            ranks=phase.num_ranks, tasks=phase.num_tasks,
            transfers=gpu.transfers, scorer_calls=calls,
            launches=n_launch[name], cuda_s=gpu_s, cpu_s=cpu_s,
            max_work=[float(mw[0]), float(mw[-1])],
            ranks_over_cap=over, cuda_stage_s=stages,
            cpu_stage_s=cpu_stages,
            cuda_score_events_s=launch.STATS["seconds"],
            cuda_score_events_split_s=dict(launch.STATS["split"]),
            cuda_score_call_ms=launch.STATS["seconds"] / calls * 1e3,
            top_shapes=[[list(k), v] for k, v
                        in launch.STATS["shapes"].most_common(5)])
        print(f"{label}: identical to cpu; {gpu.transfers} transfers, "
              f"{calls} scorer calls = {n_launch[name]} pair launches; "
              "max_work "
              f"{float(mw[0])!r} -> {float(mw[-1])!r}"
              + (f"; ranks over the cap {over[0]} -> {over[1]}"
                 if over else "")
              + f"; wall cuda {gpu_s:.3f} s, cpu {cpu_s:.3f} s; scorer "
              f"calls {launch.STATS['seconds']!r} s, split "
              f"{launch.STATS['split']}", flush=True)
    return dict(launches=launches, shapes=shapes, pair_shapes=pair_shapes,
                runs=runs, f64_cpu_run=f64_cpu_run,
                f64_cuda_run=f64_cuda_run)


# -------------------------------------------- 3b / 4b. the speculative window
def spec_capture(phase, params, max_candidates: int, n_events: int):
    """Window rows of the first ``n_events`` lock events of ``phase``'s
    first iteration (``MAIN_KW``'s gossip), captured from its initial state
    as the spec driver captures them (``core.spec._prepare``).  Returns
    (raws, lanes, pair bucket)."""
    from collections import deque

    from repro_torch.core import CCMState, PhaseEngine, initial_assignment
    from repro_torch.core.ccmlb import ProtocolStats
    from repro_torch.core.quiesce import QuiesceTracker
    from repro_torch.core.spec import SpecInstance, _prepare, event_sequence
    from repro_torch.kernels.ccm_scorer.layout import (bucket_lanes,
                                                       bucket_pairs)
    st = CCMState.build(phase, initial_assignment(phase), params)
    eng = PhaseEngine(st, device="cpu")
    tr = QuiesceTracker(st, eng, params, seed=0,
                        k_rounds=MAIN_KW["k_rounds"],
                        fanout=MAIN_KW["fanout"])
    tr.begin_iteration(0)
    clusters, _ = tr.update_summaries()
    seq = event_sequence(phase.num_ranks,
                         tr.update_work_lists(tr.update_gossip()))
    inst = SpecInstance(state=st, engine=eng, clusters=clusters,
                        stats=ProtocolStats(), rebuild=None, queue=deque(),
                        max_candidates=max_candidates)
    lanes = bucket_lanes(max_candidates + 1)
    p_n = bucket_pairs(min(max_candidates * (max_candidates + 2), 32))
    raws = []
    for r, p in seq:
        cap, raw = _prepare(inst, r, p, lanes, lanes, p_n)
        if cap is not None:
            raws.append(raw)
        if len(raws) == n_events:
            break
    return raws, lanes, p_n


def spec_buffer(torch, launch, raws, lanes: int, p_n: int, b_lanes=None):
    """The window of ``raws`` as ``launch.score_spec`` stacks it (padded to
    a power of two of rows), on the card, contiguous; ``b_lanes`` defaults
    to ``lanes``."""
    import numpy as np
    from repro_torch.kernels.ccm_scorer.layout import (bucket_events,
                                                       spec_offsets)
    eb = max(e for _, e in raws)
    offs = spec_offsets(eb, lanes, lanes if b_lanes is None else b_lanes,
                        p_n)
    buf = np.zeros((bucket_events(len(raws)), offs[-1]))
    launch.stack_spec(raws, buf, eb, offs[4])
    return torch.from_numpy(buf).cuda()


def same_bits(torch, a, b) -> bool:
    """Bit for bit, any NaN equal to any NaN."""
    return a.shape == b.shape and bool(
        ((a.view(torch.int64) == b.view(torch.int64))
         | (torch.isnan(a) & torch.isnan(b))).all().item())


def check_spec_kernel(torch, kernel, launch, ref) -> tuple:
    """The window kernel against its plain version on the card, bit for
    bit, with the flow matrix in shared memory and in global scratch: real
    rows of ``scaling_phase(256)``'s first lock events in windows of 1, 8,
    32 and 64 rows; rows of a 16-rank phase mixed in (other edge buckets);
    a row with pair count 0, one with every pair infeasible, one whose
    maximum is tied (the first must win); and ``max_candidates=70`` rows
    (lanes 128, G = 257: F only fits global scratch), and
    ``max_candidates=40`` (lanes 64: F in shared memory past the default
    48 KB, opted in); the fleet's first 64 rows (one window, eb 1024); the
    scatter's adversarial rows (``spec_cases.scatter_cases``, each case a
    window of two rows, and all of them in one); random rows of an odd
    length (lanes 5 and 8: the wrapper copies them to an even stride, and
    the launcher's card route, whose pinned staging pads the stride, is
    held to the plain version too) and of 64 and 300 pair slots (the
    warps' winners meet in shared memory).  The plain version on the card
    is also held to the plain version on the CPU (the tests' oracle), bit
    for bit.  Returns (the worst absolute difference, the captured 256-rank
    rows, the fleet's rows, their lanes and pair bucket)."""
    import numpy as np
    from repro_torch.core import CCMParams, random_phase, scaling_phase
    from repro_torch.kernels.ccm_scorer import spec_cases
    from repro_torch.kernels.ccm_scorer.layout import SC, spec_offsets
    params = CCMParams()
    big, lanes, p_n = spec_capture(scaling_phase(256), params, 12, 96)
    small, _, _ = spec_capture(
        random_phase(11, num_ranks=16, num_tasks=320, num_blocks=48,
                     num_comms=1280, mem_cap=1e12), params, 12, 24)
    mid, m_lanes, m_p = spec_capture(scaling_phase(256), params, 40, 8)
    wide, w_lanes, w_p = spec_capture(scaling_phase(256), params, 70, 24)
    fleet, _, _ = spec_capture(random_phase(1000, **FLEET_PHASE),
                               CCMParams(delta=1e-9), 12, FLEET_N)
    if len(big) < 96 or {e for _, e in small} == {e for _, e in big}:
        fail(f"spec capture: {len(big)} rows, edge buckets "
             f"{sorted({e for _, e in small})} / "
             f"{sorted({e for _, e in big})}")
    # edge rows from real ones
    probe = ref.score_spec_rows(spec_buffer(torch, launch, big, lanes, p_n),
                                lanes, lanes, p_n).cpu()
    k_row = next(i for i in range(len(big)) if probe[i, 0] > 0
                 and np.isfinite(probe[i, 1].item()))
    row, eb = big[k_row]
    k = int(probe[k_row, 0])
    offs = spec_offsets(eb, lanes, lanes, p_n)
    tie = row.copy()
    for o in (offs[5], offs[6]) + tuple(offs[3] + q * p_n for q in range(4)):
        tie[o] = tie[o + k]
    none, infeasible = row.copy(), row.copy()
    none[offs[7] + 5] = 0.0
    infeasible[offs[4] + SC.mem_cap_a] = -1.0
    edge = [(tie, eb), (none, eb), (infeasible, eb), (row, eb)]
    mixed = [x for pair in zip(small, big) for x in pair]
    rng = np.random.default_rng(0)
    scatter = spec_cases.scatter_cases(big[:2], lanes, lanes, p_n)
    cases = [("W=1", big[:1], lanes, lanes, p_n),
             ("W=8", big[:8], lanes, lanes, p_n),
             ("W=32", big[8:40], lanes, lanes, p_n),
             ("W=64", big[32:96], lanes, lanes, p_n),
             ("mixed edge buckets", mixed, lanes, lanes, p_n),
             ("edge rows", edge, lanes, lanes, p_n),
             ("max_candidates=40", mid, m_lanes, m_lanes, m_p),
             ("max_candidates=70", wide[:8], w_lanes, w_lanes, w_p),
             ("max_candidates=70, W=24", wide, w_lanes, w_lanes, w_p),
             ("fleet, W=64", fleet, lanes, lanes, p_n)]
    cases += [(f"scatter: {label}", raws, lanes, lanes, p_n)
              for label, raws in scatter]
    cases += [("scatter: every case", [r for _, rows in scatter
                                       for r in rows], lanes, lanes, p_n),
              ("odd row length", spec_cases.random_rows(rng, 5, 64, 5, 8,
                                                        32), 5, 8, 32),
              ("P=64", spec_cases.random_rows(rng, 4, 96, 16, 16, 64), 16,
               16, 64),
              ("P=300", spec_cases.random_rows(rng, 2, 32, 8, 8, 300), 8, 8,
               300)]
    worst, n_cases = 0.0, 0
    for label, raws, a_n, b_n, p in cases:
        buf = spec_buffer(torch, launch, raws, a_n, p, b_n)
        want = ref.score_spec_rows(buf, a_n, b_n, p)
        if not same_bits(torch, want.cpu(),
                         ref.score_spec_rows(buf.cpu(), a_n, b_n, p)):
            fail(f"spec plain version: card != cpu at {label}")
        if label == "odd row length":
            card = launch.score_spec(raws, a_lanes=a_n, b_lanes=b_n, p_n=p,
                                     device=torch.device("cuda"))
            if buf.shape[1] % 2 == 0 or not same_bits(
                    torch, torch.from_numpy(card), want.cpu()[:len(raws)]):
                fail("window launcher (padded staging stride) != plain "
                     f"version at {label}")
        in_smem = kernel.spec_f_in_smem(a_n, b_n, p)
        for f_global in ((False, True) if in_smem else (True,)):
            got = kernel.score_spec_rows(buf, a_n, b_n, p, f_global=f_global)
            torch.cuda.synchronize()
            if not same_bits(torch, got, want):
                bad = (got != want).any(1).nonzero()[:4].flatten().tolist()
                fail(f"window kernel != plain version at {label} "
                     f"(F in {'global' if f_global else 'shared'} memory), "
                     f"rows {bad}: {got[bad].tolist()} vs "
                     f"{want[bad].tolist()}")
            ok = torch.isfinite(got) & torch.isfinite(want)
            if ok.any():
                worst = max(worst, (got[ok] - want[ok]).abs().max().item())
            n_cases += 1
        if label == "edge rows":
            got = want.cpu()
            if not (got[0, 0] == 0 and got[0, 1] == probe[k_row, 1]
                    and got[1, 0] == 0 and torch.isneginf(got[1, 1])
                    and got[2, 0] == 0 and torch.isneginf(got[2, 1])
                    and got[3, 0] == k):
                fail(f"spec edge rows selected {got.tolist()}")
    if (kernel.spec_f_in_smem(w_lanes, w_lanes, w_p)
            or not kernel.spec_f_in_smem(m_lanes, m_lanes, m_p)
            or kernel.spec_smem_bytes(m_lanes, m_lanes, m_p, True)
            <= 48 * 1024):
        fail("lanes 64 should put F in opted-in shared memory (above 48 KB)"
             ", lanes 128 in global scratch")
    print(f"window kernel == plain version on {n_cases} cases (bit for bit; "
          f"F in shared memory and in global scratch; 256-rank rows, W 1 to "
          f"64, mixed edge buckets, pair count 0, all infeasible, a tie, "
          f"lanes 64 and 128, the fleet's rows, {len(scatter)} adversarial "
          f"scatter cases, an odd row length, 64 and 300 pair slots); "
          f"max_abs_err {worst}", flush=True)
    return worst, big, fleet, lanes, p_n


def spec_path(torch, kernel, launch, want) -> dict:
    """The main path through the speculative driver: ``scaling_phase(256)``
    with ``MAIN_KW`` on the card for each of ``SPEC_RUNS``, each held to
    f64 solo's CPU run (``want``).  Window-kernel launches, counted from
    zero just before each run and read just after, must equal the windows
    that scored a row (``launch.STATS["spec"]["calls"]``), with no pair or
    full-tile launch and no pair scorer call; disjoint fill rolls nothing
    back."""
    from repro_torch.core import CCMParams, ccm_lb, initial_assignment
    from repro_torch.core import scaling_phase
    phase = scaling_phase(256)
    a0 = initial_assignment(phase)
    runs, shapes, launches = {}, Counter(), 0
    for label, window, mode, fill in SPEC_RUNS:
        kernel.reset_launches()
        launch.reset_stats()
        t0 = time.perf_counter()
        gpu = ccm_lb(phase, a0, CCMParams(), device="cuda", profile=True,
                     spec_window=window, spec_mode=mode, spec_fill=fill,
                     **MAIN_KW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = kernel.SPEC_LAUNCHES["float64"]
        rec = launch.STATS["spec"]
        if not same_run(gpu, want):
            fail(f"{label}: cuda spec run differs from f64 solo's cpu run")
        if (n == 0 or n != rec["calls"] or n > gpu.spec_windows
                or sum(kernel.PAIR_LAUNCHES.values())
                or sum(kernel.LAUNCHES.values()) or launch.STATS["calls"]):
            fail(f"{label}: window launches {n}, windows that scored "
                 f"{rec['calls']} of {gpu.spec_windows}, pair launches "
                 f"{kernel.PAIR_LAUNCHES}, full-tile {kernel.LAUNCHES}, pair "
                 f"scorer calls {launch.STATS['calls']}")
        if fill == "disjoint" and gpu.spec_rollbacks:
            fail(f"{label}: {gpu.spec_rollbacks} rollbacks under disjoint "
                 "fill")
        stages = {k: sum(t[k] for t in gpu.stage_timings)
                  for k in gpu.stage_timings[0]}
        shapes.update(rec["shapes"])
        launches += n
        runs[label] = dict(
            window=window, mode=mode, fill=fill, transfers=gpu.transfers,
            windows=gpu.spec_windows, rollbacks=gpu.spec_rollbacks,
            launches=n, rows=rec["rows"], cuda_s=wall, cuda_stage_s=stages,
            score_spec_s=rec["seconds"], score_spec_split_s=dict(
                rec["split"]),
            score_spec_call_ms=rec["seconds"] / n * 1e3,
            top_shapes=[[list(k), v] for k, v
                        in rec["shapes"].most_common(5)])
        print(f"{label}: identical to f64 solo's cpu run; {gpu.transfers} "
              f"transfers, {gpu.spec_windows} windows ({gpu.spec_rollbacks} "
              f"rollbacks), {n} window launches for {rec['rows']} rows; wall "
              f"cuda {wall!r} s; stages {stages}; score_spec "
              f"{rec['seconds']!r} s, split {rec['split']}", flush=True)
    return dict(runs=runs, shapes=shapes, launches=launches)


def fleet_path(torch, kernel, launch) -> dict:
    """``ccm_lb_many`` of the JAX package's fleet benchmark configuration
    (``FLEET_N`` instances of ``random_phase(1000 + i, **FLEET_PHASE)``,
    ``CCMParams(delta=1e-9)``, ``FLEET_KW``, window ``FLEET_N``, mode
    vmap) on the card, every instance held to its solo run on the card's
    host engine (``ccm_lb(seed=i)``, pair kernel).  Window launches,
    counted from zero just before the fleet run, must equal the windows
    that scored a row, with no pair launch."""
    from repro_torch.core import (CCMParams, ccm_lb, ccm_lb_many,
                                  initial_assignment, random_phase)
    phases = [random_phase(1000 + i, **FLEET_PHASE) for i in range(FLEET_N)]
    a0s = [initial_assignment(p) for p in phases]
    params = CCMParams(delta=1e-9)
    kernel.reset_launches()
    launch.reset_stats()
    t0 = time.perf_counter()
    fleet = ccm_lb_many(phases, a0s, params, seed=0, device="cuda",
                        window=FLEET_N, mode="vmap", **FLEET_KW)
    torch.cuda.synchronize()
    fleet_s = time.perf_counter() - t0
    n = kernel.SPEC_LAUNCHES["float64"]
    rec = dict(launch.STATS["spec"])
    if (n == 0 or n != rec["calls"] or sum(kernel.PAIR_LAUNCHES.values())
            or sum(kernel.LAUNCHES.values())):
        fail(f"fleet: window launches {n} vs windows that scored "
             f"{rec['calls']}, pair launches {kernel.PAIR_LAUNCHES}")
    kernel.reset_launches()
    launch.reset_stats()
    t0 = time.perf_counter()
    solos = [ccm_lb(phases[i], a0s[i], params, seed=i, device="cuda",
                    **FLEET_KW) for i in range(FLEET_N)]
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t0
    solo_launches = kernel.PAIR_LAUNCHES["float64"]
    bad = [i for i in range(FLEET_N) if not same_run(fleet[i], solos[i])]
    if bad:
        fail(f"fleet instances {bad[:8]} differ from their solo runs")
    out = dict(instances=FLEET_N, transfers=sum(r.transfers for r in fleet),
               rollbacks=sum(r.spec_rollbacks for r in fleet),
               instance_windows=sum(r.spec_windows for r in fleet),
               launches=n, rows=rec["rows"], fleet_s=fleet_s,
               score_spec_s=rec["seconds"],
               score_spec_split_s=dict(rec["split"]),
               top_shapes=[[list(k), v] for k, v
                           in rec["shapes"].most_common(5)],
               solo_loop_s=solo_s, solo_pair_launches=solo_launches)
    print(f"fleet: {FLEET_N} instances identical to their solo runs; "
          f"{out['transfers']} transfers, {n} window launches for "
          f"{rec['rows']} rows; wall {fleet_s!r} s (solo loop {solo_s!r} s, "
          f"{solo_launches} pair launches); score_spec {rec['seconds']!r} s, "
          f"split {rec['split']}", flush=True)
    return out


# ------------------------------------------ 4c. the multi-phase pipeline
def pipeline_phases():
    """The JAX package's ``benchmarks/ccmlb_pipeline.py`` ``make_phases(1,
    256)``: ``PIPE_N`` phases sharing one topology, task loads drifting by a
    lognormal ``PIPE_DRIFT`` a phase."""
    import dataclasses

    import numpy as np
    from repro_torch.core import random_phase
    phases = [random_phase(1, **PIPE_PHASE)]
    rng = np.random.default_rng(2)
    for _ in range(PIPE_N - 1):
        prev = phases[-1]
        phases.append(dataclasses.replace(
            prev, task_load=prev.task_load
            * rng.lognormal(0.0, PIPE_DRIFT, prev.num_tasks)))
    return phases


def counted_pipeline(counts: dict, **kw) -> tuple:
    """``ccm_lb_pipeline(**kw)`` with the float64 launch count ``counts``
    (``kernel.PAIR_LAUNCHES`` or ``kernel.SPEC_LAUNCHES``) read before and
    after each phase's ``ccm_lb`` call (the pipeline module's own
    reference to it is wrapped for the run and restored after)."""
    from repro_torch.core import pipeline
    per_phase = []
    inner = pipeline.ccm_lb

    def counted(*args, **lb):
        n0 = counts["float64"]
        res = inner(*args, **lb)
        per_phase.append(counts["float64"] - n0)
        return res

    pipeline.ccm_lb = counted
    try:
        res = pipeline.ccm_lb_pipeline(**kw)
    finally:
        pipeline.ccm_lb = inner
    return res, per_phase


def pipeline_path(torch, kernel, launch) -> dict:
    """``ccm_lb_pipeline`` over ``pipeline_phases()`` with
    ``CCMParams(delta=1e-9)`` and ``PIPE_KW``, warm-started: on the CPU,
    then on the card with ``reuse_csr``, again with ``carry_engine``, and
    with ``carry_engine`` and ``spec_window=8`` in place of the batch;
    each card run equals the CPU's phase by phase (assignment, transfer
    log, count, max_work) with the CSR reused, the warm start carried and,
    with carry, the engine carried on phases 1 to 5.  Launches, counted
    from zero just before each card run and read just after, must be more
    than zero in every phase and equal the scorer calls (pair kernel) or
    the windows that scored (window kernel), with no full-tile launch and
    none of the other kernel."""
    from repro_torch.core import CCMParams, ccm_lb_pipeline
    phases = pipeline_phases()
    params = CCMParams(delta=1e-9)
    t0 = time.perf_counter()
    cpu = ccm_lb_pipeline(phases, params, device="cpu", **PIPE_KW)
    cpu_s = time.perf_counter() - t0
    out = dict(phases=PIPE_N, ranks=phases[0].num_ranks,
               tasks=phases[0].num_tasks, cpu_s=cpu_s,
               cpu_phase_s=[r.seconds for r in cpu.runs])
    spec_kw = {k: v for k, v in PIPE_KW.items() if k != "batch_lock_events"}
    for label, carry, kw in (
            ("warm, reuse_csr", False, PIPE_KW),
            ("warm, carry_engine", True, PIPE_KW),
            ("warm, carry_engine, spec_window=8", True,
             dict(spec_kw, spec_window=8))):
        spec = "spec_window" in kw
        counts = kernel.SPEC_LAUNCHES if spec else kernel.PAIR_LAUNCHES
        other = kernel.PAIR_LAUNCHES if spec else kernel.SPEC_LAUNCHES
        kernel.reset_launches()
        launch.reset_stats()
        t0 = time.perf_counter()
        gpu, per_phase = counted_pipeline(
            counts, phases=phases, params=params, device="cuda",
            profile=True, carry_engine=carry, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = counts["float64"]
        calls = (launch.STATS["spec"]["calls"] if spec
                 else launch.STATS["calls"])
        bad = [k for k in range(PIPE_N)
               if not same_run(gpu.runs[k].result, cpu.runs[k].result)]
        if bad:
            fail(f"pipeline {label}: phases {bad} differ from the cpu run")
        want = [False] + [True] * (PIPE_N - 1)
        flags = dict(csr_reused=[r.csr_reused for r in gpu.runs],
                     warm_started=[r.warm_started for r in gpu.runs],
                     engine_carried=[r.engine_carried for r in gpu.runs])
        if (flags["csr_reused"] != want or flags["warm_started"] != want
                or flags["engine_carried"] != (want if carry
                                               else [False] * PIPE_N)):
            fail(f"pipeline {label}: flags {flags}")
        if (n == 0 or n != calls or min(per_phase) == 0
                or sum(kernel.LAUNCHES.values()) or sum(other.values())):
            fail(f"pipeline {label}: launches {n} ({per_phase}) vs calls "
                 f"{calls}, full-tile {kernel.LAUNCHES}, pair "
                 f"{kernel.PAIR_LAUNCHES}, window {kernel.SPEC_LAUNCHES}")
        stages = [{k: sum(t[k] for t in r.result.stage_timings)
                   for k in ("score", "commit")} for r in gpu.runs]
        out[label] = dict(
            cuda_s=wall, kernel="window" if spec else "pair", launches=n,
            calls=calls, scorer_s=(launch.STATS["spec"]["seconds"] if spec
                                   else launch.STATS["seconds"]),
            flags=flags,
            phase_s=[r.seconds for r in gpu.runs],
            phase_transfers=[r.result.transfers for r in gpu.runs],
            phase_launches=per_phase, phase_stage_s=stages,
            max_work=[[float(r.result.max_work[0]),
                       float(r.result.max_work[-1])] for r in gpu.runs])
        print(f"pipeline {label}: {PIPE_N} phases identical to cpu; "
              f"transfers {out[label]['phase_transfers']}, "
              f"{out[label]['kernel']} launches {per_phase} (= {n} calls); "
              f"phase seconds "
              f"{out[label]['phase_s']}; score/commit {stages}; wall cuda "
              f"{wall!r} s, cpu {cpu_s!r} s", flush=True)
    return out


# ----------------------------------------- 4d. the asynchronous balancer
def same_async(a, b) -> bool:
    """``same_run`` plus the event trace, the message and protocol
    counters and everything the fault harness records."""
    import dataclasses
    fs = [None if r.fault_stats is None
          else dataclasses.asdict(r.fault_stats) for r in (a, b)]
    return (same_run(a, b) and a.events == b.events
            and fs[0] == fs[1] and all(
                getattr(a, f) == getattr(b, f)
                for f in ("messages", "sim_time", "lock_conflicts",
                          "yields", "grant_chains", "timeouts",
                          "retries_exhausted", "recovery_log",
                          "dead_ranks", "joined_ranks")))


def async_path(torch, kernel, launch, sync_run) -> dict:
    """``ccm_lb_async`` of the JAX package's ``benchmarks/ccmlb_async.py``
    instance ``scaling_phase(256)`` (``CCMParams(delta=1e-9)``,
    ``MAIN_KW``) on the card at each of ``ASYNC_LATENCIES``: at zero
    latency equal to the sync ``ccm_lb`` card run of the same phase,
    params and knobs (``sync_run``, main_path's f64 solo, whose knobs are
    these), otherwise equal to the CPU's run, event trace and counters
    included; the uniform run is the profiled one.  Then
    ``benchmarks/ccmlb_fault.py``'s ``crash`` and ``crash_then_join`` at
    ``FAULT_RANKS`` ranks under ``FAULT_LAT``, each equal to the CPU's.
    Pair launches, counted from zero just before each card run and read
    just after, must equal its scorer calls and be more than zero, with no
    full-tile or window launch."""
    import dataclasses

    from repro_torch.core import (CCMParams, FaultSpec, RankJoin,
                                  ccm_lb_async, initial_assignment,
                                  scaling_phase)
    params = CCMParams(delta=1e-9)
    if params != sync_run.state.params:
        fail("async_path: main_path's f64 solo run has other params")
    big = scaling_phase(256)
    small = scaling_phase(FAULT_RANKS)
    runs = {}
    cases = [(f"256 ranks, latency {lat!r}", big, dict(latency=lat))
             for lat in ASYNC_LATENCIES]
    cases += [(f"{FAULT_RANKS} ranks, crash", small, dict(
                  latency=FAULT_LAT, fault=FaultSpec(kill=((3, 1, 0.5),),
                                                     seed=19))),
              (f"{FAULT_RANKS} ranks, crash_then_join", small, dict(
                  latency=FAULT_LAT, fault=FaultSpec(kill=((3, 1, 0.5),),
                                                     seed=31),
                  membership=(RankJoin(iteration=2, count=1),)))]
    for label, phase, kw in cases:
        a0 = initial_assignment(phase)
        kw = dict(MAIN_KW, seed=0, collect_trace=True, **kw)
        zero = kw["latency"] == 0.0
        cpu_s = None
        if not zero:
            t0 = time.perf_counter()
            want = ccm_lb_async(phase, a0, params, device="cpu", **kw)
            cpu_s = time.perf_counter() - t0
        got = []

        def run():
            got.append(ccm_lb_async(phase, a0, params, device="cuda", **kw))

        kernel.reset_launches()
        launch.reset_stats()
        prof = None
        if kw["latency"] == ASYNC_LATENCIES[-1] and phase is big:
            prof = profiled_run(torch, run)
            wall = prof["wall_s"]
        else:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        gpu = got[0]
        n = kernel.PAIR_LAUNCHES["float64"]
        n_spec = sum(kernel.SPEC_LAUNCHES.values())
        if zero:
            if not (same_run(gpu, sync_run)
                    and gpu.lock_conflicts == gpu.yields == 0):
                fail(f"async {label}: differs from the sync card run")
        elif not same_async(gpu, want):
            fail(f"async {label}: cuda run differs from the cpu run")
        if (n == 0 or n != launch.STATS["calls"]
                or sum(kernel.LAUNCHES.values()) or n_spec):
            fail(f"async {label}: pair launches {n} vs scorer calls "
                 f"{launch.STATS['calls']}, full-tile {kernel.LAUNCHES}, "
                 f"window {kernel.SPEC_LAUNCHES}")
        fs = (None if gpu.fault_stats is None
              else {k: v for k, v in dataclasses.asdict(
                  gpu.fault_stats).items() if v})
        if "fault" in kw and (gpu.dead_ranks != [3]
                              or (gpu.assignment == 3).any()
                              or not fs.get("recovered_tasks")):
            fail(f"async {label}: dead {gpu.dead_ranks}, fault stats {fs}")
        if "membership" in kw and (gpu.joined_ranks != [FAULT_RANKS] or not
                                   (gpu.assignment == FAULT_RANKS).any()):
            fail(f"async {label}: joined {gpu.joined_ranks}")
        runs[label] = dict(
            ranks=phase.num_ranks, cuda_s=wall, cpu_s=cpu_s,
            profiled=prof is not None, transfers=gpu.transfers,
            launches=n, spec_launches=n_spec,
            score_events_s=launch.STATS["seconds"],
            events=len(gpu.events), messages=gpu.messages,
            sim_time=gpu.sim_time, lock_conflicts=gpu.lock_conflicts,
            yields=gpu.yields, timeouts=gpu.timeouts, fault_stats=fs,
            dead_ranks=gpu.dead_ranks, joined_ranks=gpu.joined_ranks,
            max_work=[float(gpu.max_work[0]), float(gpu.max_work[-1])])
        if prof is not None:
            runs[label].update(
                device_idle_share=prof["device_idle_share"],
                device_idle_share_bounds=prof["device_idle_share_bounds"],
                device_busy_ms=prof["device_busy_ms"])
        print(f"async {label}: identical to "
              f"{'the sync card run' if zero else 'cpu'}; "
              f"{gpu.transfers} transfers, {n} pair launches, "
              f"{len(gpu.events)} events, {gpu.lock_conflicts} conflicts; "
              f"wall cuda {wall!r} s{' (profiled)' if prof else ''}, cpu "
              f"{cpu_s!r} s; fault stats {fs}"
              + (f"; device idle {prof['device_idle_share']!r} "
                 f"(bounds {prof['device_idle_share_bounds']})"
                 if prof else ""), flush=True)
    return runs


# ------------------------------------- 4e. the MILP certification (Fig. 4a)
def milp_path(torch, kernel, launch) -> dict:
    """The paper's Fig. 4a on the card, as the JAX package's
    ``benchmarks/milp_vs_ccmlb.py`` runs it: ``random_phase(7, 4 ranks,
    14 tasks, 4 blocks, 16 comms, mem_cap=5e8)`` from ``initial_assignment``
    at each delta of ``MILP_DELTAS``.  ``MILP_SEEDS`` CCM-LB runs
    (``MILP_KW``) on the card, each equal to the port's CPU run
    (assignment, transfer log and count, max-work trace), their pair
    launches counted from zero just before the card runs and read just
    after (more than zero, equal to the scorer calls, no full-tile or
    window launch).  Then ``solve_milp(build_fwmp_reduced(...))`` (host
    numpy) with ``max_nodes=MILP_NODES`` and a wall-clock limit no solve
    reaches, without and with the card runs' best W_max as
    ``incumbent_obj``; each solve must end by optimality or at the node
    limit, and a certified optimum must not lie above CCM-LB's best."""
    import numpy as np

    from repro_torch.core import (CCMParams, ccm_lb, initial_assignment,
                                  random_phase)
    from repro_torch.core.milp import build_fwmp_reduced, solve_milp
    phase = random_phase(7, **MILP_PHASE)
    a0 = initial_assignment(phase)
    out = {}
    for delta in MILP_DELTAS:
        params = CCMParams(alpha=1.0, beta=1e-9, gamma=1e-11, delta=delta)
        t0 = time.perf_counter()
        cpu = [ccm_lb(phase, a0, params, device="cpu", seed=s, **MILP_KW)
               for s in range(MILP_SEEDS)]
        cpu_s = time.perf_counter() - t0
        kernel.reset_launches()
        launch.reset_stats()
        t0 = time.perf_counter()
        gpu = [ccm_lb(phase, a0, params, device="cuda", seed=s, **MILP_KW)
               for s in range(MILP_SEEDS)]
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        n = kernel.PAIR_LAUNCHES["float64"]
        bad = [s for s in range(MILP_SEEDS) if not same_run(gpu[s], cpu[s])]
        if bad:
            fail(f"milp delta {delta!r}: card runs of seeds {bad} differ "
                 "from the cpu runs")
        if (n == 0 or n != launch.STATS["calls"]
                or sum(kernel.LAUNCHES.values())
                or sum(kernel.SPEC_LAUNCHES.values())):
            fail(f"milp delta {delta!r}: pair launches {n} vs scorer calls "
                 f"{launch.STATS['calls']}, full-tile {kernel.LAUNCHES}, "
                 f"window {kernel.SPEC_LAUNCHES}")
        works = [float(r.max_work[-1]) for r in gpu]
        best = min(works)
        milp = build_fwmp_reduced(phase, params)
        solves = {}
        for label, inc in (("no incumbent", np.inf),
                           ("ccm-lb incumbent", best)):
            t0 = time.perf_counter()
            res = solve_milp(milp, incumbent_obj=inc, max_nodes=MILP_NODES,
                             time_limit_s=MILP_NO_CLOCK)
            solve_s = time.perf_counter() - t0
            if res.status != "optimal" and res.nodes < MILP_NODES:
                fail(f"milp delta {delta!r}, {label}: ended {res.status} "
                     f"after {res.nodes} of {MILP_NODES} nodes")
            if res.status == "optimal" and \
                    res.objective > best * (1 + 1e-9):
                fail(f"milp delta {delta!r}, {label}: certified optimum "
                     f"{res.objective!r} above CCM-LB's best {best!r}")
            solves[label] = dict(
                status=res.status, objective=float(res.objective),
                lp_bound=float(res.lp_bound),
                best_bound=float(res.best_bound), nodes=res.nodes,
                seconds=solve_s)
        opt = [s["objective"] for s in solves.values()
               if s["status"] == "optimal"]
        if len(set(opt)) > 1:
            fail(f"milp delta {delta!r}: the two solves' optima differ "
                 f"{opt}")
        lp = solves["no incumbent"]["lp_bound"]
        gaps = [(w - lp) / lp for w in works]
        incr = [(w - opt[0]) / opt[0] for w in works] if opt else None
        out[f"{delta:g}"] = dict(
            ccmlb_runs=MILP_SEEDS, cuda_s=gpu_s, cpu_s=cpu_s,
            pair_launches=n, transfers=[r.transfers for r in gpu],
            ccmlb_best=best, ccmlb_worst=max(works),
            ccmlb_gap_to_lp=[min(gaps), max(gaps)],
            ccmlb_increase_over_optimum=(None if incr is None
                                         else [min(incr), max(incr)]),
            milp=solves)
        print(f"milp delta {delta:g}: {MILP_SEEDS} card CCM-LB runs "
              f"identical to cpu ({n} pair launches; wall cuda {gpu_s!r} s, "
              f"cpu {cpu_s!r} s), W_max {best!r}..{max(works)!r}, gap to "
              f"the LP bound {min(gaps):.3e}..{max(gaps):.3e}, increase over "
              f"the MILP optimum "
              + ("not certified" if incr is None
                 else f"{100 * min(incr):.2f}%..{100 * max(incr):.2f}%")
              + "; MILP "
              + "; ".join(f"{k}: {v['status']} W={v['objective']!r} "
                          f"LP bound {v['lp_bound']!r} nodes {v['nodes']} "
                          f"{v['seconds']:.2f} s host"
                          for k, v in solves.items()), flush=True)
    return out


# ---------------------------------------------- 4f. the three planners
def zipf_counts(rng, e_n, l_n=4, tokens=32768):
    """Router counts as the JAX package's ``benchmarks/expert_placement.py``
    draws them: zipf(1.4) over (l_n, e_n), each layer scaled to ``tokens``."""
    import numpy as np
    counts = rng.zipf(1.4, (l_n, e_n)).astype(np.float64)
    return counts / counts.sum(1, keepdims=True) * tokens


def same_expert_plan(a, b) -> bool:
    """Two placement plans: assignment, permutations, imbalances, max work,
    the transfer log and every ``ServingPlan`` array."""
    import numpy as np
    sa, sb = a.serving, b.serving
    return (np.array_equal(a.assignment, b.assignment)
            and np.array_equal(a.permutations, b.permutations)
            and a.imbalance_before == b.imbalance_before
            and a.imbalance_after == b.imbalance_after
            and a.max_work_before == b.max_work_before
            and a.max_work_after == b.max_work_after
            and a.replicated_blocks == b.replicated_blocks
            and a.lb_result.transfer_log == b.lb_result.transfer_log
            and np.array_equal(sa.replicas, sb.replicas)
            and np.array_equal(sa.routing_shares, sb.routing_shares)
            and np.array_equal(sa.hbm_bytes, sb.hbm_bytes)
            and sa.replicated_experts == sb.replicated_experts)


def same_stage_plan(a, b) -> bool:
    import numpy as np
    return (np.array_equal(a.assignment, b.assignment)
            and np.array_equal(a.stage_flops, b.stage_flops)
            and a.imbalance == b.imbalance and a.cut_bytes == b.cut_bytes
            and a.contiguous == b.contiguous)


def same_pack(a, b) -> bool:
    import numpy as np
    return (np.array_equal(a.assignment, b.assignment)
            and a.makespan_before == b.makespan_before
            and a.makespan_after == b.makespan_after
            and a.imbalance_after == b.imbalance_after)


def planner_path(torch, kernel, launch) -> dict:
    """The three planners on the card, each plan equal to the port's CPU
    plan, with the card's own memory as the HBM budget: expert placement
    of ``benchmarks/expert_placement.py``'s configurations (qwen3-moe and
    llama4-scout at published width, zipf(1.4) counts over (4, E), 16
    devices; one device at half speed), qwen with ``shards_per_expert=2,
    replicate=True``, ``plan_expert_placement_sequence`` over
    ``PLAN_WINDOWS`` drifting windows synchronously and with
    ``spec_window=8`` (held to the synchronous plan; the window kernel),
    stage plans of ``STAGE_ARCHS`` on 4 stages (each contiguous) and one
    stage schedule, and ``rebalance_sequences`` of 256 lognormal(0, 1.2)
    costs over 8 ranks, with and without a half-speed rank.  Each card
    plan's launches are counted from zero just before it and read just
    after: pair launches (window launches on the spec run) equal to the
    scorer calls and, but for the stage plans (whose stage 1 finds no move
    worth a lock), more than zero; no full-tile launch, none of the other
    kernel."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.balance import (plan_expert_placement,
                                     plan_expert_placement_sequence,
                                     plan_pipeline_stages,
                                     plan_pipeline_stages_schedule,
                                     rebalance_sequences)
    hbm = float(torch.cuda.get_device_properties(0).total_memory)
    rng = np.random.default_rng(0)
    qwen = configs.get_config(SERVE_ARCH)
    scout = configs.get_config("llama4-scout-17b-a16e")
    qwen_counts = zipf_counts(rng, qwen.num_experts)
    scout_counts = zipf_counts(rng, scout.num_experts)
    straggler_counts = zipf_counts(rng, qwen.num_experts)
    speed = np.ones(16)
    speed[0] = 0.5
    seq = [qwen_counts]
    for _ in range(PLAN_WINDOWS - 1):
        nxt = seq[-1] * rng.lognormal(0.0, PLAN_DRIFT, qwen_counts.shape)
        seq.append(nxt / nxt.sum(1, keepdims=True)
                   * qwen_counts.sum(1)[:, None])
    costs = np.random.default_rng(0).lognormal(0, 1.2, 256)
    seq_speed = np.ones(8)
    seq_speed[0] = 0.5
    expert_kw = dict(hbm_budget_bytes=hbm, seed=0)
    cases = [
        ("experts qwen3-moe-30b-a3b", "placement", lambda **d:
         plan_expert_placement(qwen_counts, qwen, 16, **expert_kw, **d)),
        ("experts llama4-scout-17b-a16e", "placement", lambda **d:
         plan_expert_placement(scout_counts, scout, 16, **expert_kw, **d)),
        ("experts straggler", "placement", lambda **d:
         plan_expert_placement(straggler_counts, qwen, 16, rank_speed=speed,
                               **expert_kw, **d)),
        ("experts qwen replicated", "placement", lambda **d:
         plan_expert_placement(qwen_counts, qwen, 16, shards_per_expert=2,
                               replicate=True, **expert_kw, **d)),
        (f"experts sequence x{PLAN_WINDOWS}", "sequence", lambda **d:
         plan_expert_placement_sequence(seq, qwen, 16, **expert_kw, **d)),
        (f"experts sequence x{PLAN_WINDOWS}, spec_window=8", "sequence",
         lambda **d: plan_expert_placement_sequence(
             seq, qwen, 16, spec_window=8, **expert_kw, **d)),
    ]
    for arch in STAGE_ARCHS:
        cfg = configs.get_config(arch)
        cases.append((f"stages {arch}", "stages", lambda cfg=cfg, **d:
                      plan_pipeline_stages(cfg, 4, hbm_budget_bytes=hbm,
                                           **d)))
    cases += [
        (f"stage schedule {SERVE_ARCH} {STAGE_SCHEDULE}", "schedule",
         lambda **d: plan_pipeline_stages_schedule(
             qwen, 4, STAGE_SCHEDULE, hbm_budget_bytes=hbm, **d)),
        ("seqpack 256 on 8", "seqpack", lambda **d:
         rebalance_sequences(costs, 8, seed=0, **d)),
        ("seqpack 256 on 8, rank 0 at half speed", "seqpack", lambda **d:
         rebalance_sequences(costs, 8, rank_speed=seq_speed, seed=0, **d)),
    ]
    same = {"placement": same_expert_plan, "stages": same_stage_plan,
            "seqpack": same_pack,
            "sequence": lambda a, b: len(a) == len(b) and all(
                map(same_expert_plan, a, b)),
            "schedule": lambda a, b: len(a) == len(b) and all(
                map(same_stage_plan, a, b))}
    out, cpu_plans = {}, {}
    for label, kind, plan in cases:
        spec = "spec_window" in label
        t0 = time.perf_counter()
        # the spec run is held to the synchronous sequence's cpu plan
        want = (cpu_plans[label.split(",")[0]] if spec
                else plan(device="cpu"))
        cpu_s = None if spec else time.perf_counter() - t0
        cpu_plans[label] = want
        kernel.reset_launches()
        launch.reset_stats()
        t0 = time.perf_counter()
        got = plan(device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, other = ((kernel.SPEC_LAUNCHES, kernel.PAIR_LAUNCHES) if spec
                         else (kernel.PAIR_LAUNCHES, kernel.SPEC_LAUNCHES))
        n = counts["float64"]
        calls = (launch.STATS["spec"]["calls"] if spec
                 else launch.STATS["calls"])
        if not same[kind](got, want):
            fail(f"planner {label}: card plan differs from the cpu plan")
        # a stage plan makes no lock event: its stage 1 finds no move
        # worth a lock (the reference's too; ROADMAP queue 3)
        if ((n == 0 and kind not in ("stages", "schedule")) or n != calls
                or sum(kernel.LAUNCHES.values()) or sum(other.values())):
            fail(f"planner {label}: launches {n} vs calls {calls}, "
                 f"full-tile {kernel.LAUNCHES}, pair {kernel.PAIR_LAUNCHES},"
                 f" window {kernel.SPEC_LAUNCHES}")
        plans = got if isinstance(got, list) else [got]
        if kind in ("stages", "schedule") and not all(p.contiguous
                                                      for p in plans):
            fail(f"planner {label}: a stage plan is not contiguous "
                 f"{[p.assignment.tolist() for p in plans]}")
        if kind in ("placement", "sequence") and any(
                sorted(perm.tolist()) != list(range(perm.shape[0]))
                for p in plans for perm in p.permutations):
            fail(f"planner {label}: a slot permutation is not one")
        rec = dict(cuda_s=wall, cpu_s=cpu_s,
                   kernel="window" if spec else "pair", launches=n,
                   transfers=[p.lb_result.transfers for p in plans]
                   if kind in ("placement", "sequence") else None)
        if kind in ("placement", "sequence"):
            rec.update(
                imbalance=[[p.imbalance_before, p.imbalance_after]
                           for p in plans],
                max_work=[[p.max_work_before, p.max_work_after]
                          for p in plans],
                replicated_blocks=[p.replicated_blocks for p in plans],
                hbm_within_budget=all(p.serving.within_budget()
                                      for p in plans))
        elif kind == "seqpack":
            rec.update(makespan=[got.makespan_before, got.makespan_after],
                       imbalance=[got.imbalance_before, got.imbalance_after])
        else:
            rec.update(assignment=[p.assignment.tolist() for p in plans],
                       imbalance=[p.imbalance for p in plans],
                       cut_bytes=[p.cut_bytes for p in plans])
        out[label] = rec
        print(f"planner {label}: card plan identical to cpu; "
              f"{rec['kernel']} launches {n}; imbalance {rec['imbalance']}"
              f"; wall cuda {wall!r} s, cpu {cpu_s!r} s", flush=True)
    if not sum(r["launches"] for r in out.values()):
        fail("planner_path: no plan launched the pair kernel")
    out["hbm_budget_bytes"] = hbm
    return out


# ----------------------------------------------------------- 5. assembly
def tile_inputs(torch, rng, nr, nc, coincident=False):
    pr = rng.uniform(0.0, 2.0, (nr, 3))
    pc = rng.uniform(0.0, 2.0, (nc, 3))
    if coincident:
        pc[:nc // 2] = pr[:nc // 2]
    couple = rng.random((nr, nc)) < 0.7
    return (torch.tensor(pr, dtype=torch.float32, device="cuda"),
            torch.tensor(pc, dtype=torch.float32, device="cuda"),
            torch.tensor(couple, device="cuda"))


def check_assembly_kernel(torch, asm_ops, asm_ref, rng) -> float:
    """The assembly kernel against its plain version on the card; returns
    the largest absolute error of the direct mode."""
    from repro_torch.assembly.execute import TILE_BLOCK
    worst = 0.0
    n_cases = 0
    for nr, nc in ASM_SHAPES:
        for q in ASM_QUADS:
            t = tile_inputs(torch, rng, nr, nc, coincident=nr == nc)
            for mxu in (False, True):
                case = f"({nr}, {nc}) Q={q} mxu_distance={mxu}"
                got = asm_ops.assembly_tile(*t, quad_order=q,
                                            mxu_distance=mxu)
                others = [asm_ops.assembly_tile(
                    *t, quad_order=q, block_r=br, block_c=bc,
                    mxu_distance=mxu)
                    for br, bc in ((32, 64), (TILE_BLOCK, TILE_BLOCK))]
                want = asm_ref.reference_tile(*t, q, mxu_distance=mxu)
                torch.cuda.synchronize()
                if got.shape != (nr, nc) or got.dtype != torch.float32:
                    fail(f"assembly kernel shape/dtype {tuple(got.shape)} "
                         f"{got.dtype} at {case}")
                if not all(torch.equal(got, o) for o in others):
                    fail(f"assembly kernel: blocks (128, 128), (32, 64) and "
                         f"({TILE_BLOCK}, {TILE_BLOCK}) differ at {case}")
                if not (got.masked_select(~t[2]) == 0).all():
                    fail(f"assembly kernel: uncoupled entry not 0 at {case}")
                if mxu:
                    rel = ((got - want).abs()
                           / (want.abs() + 1e-3)).max().item()
                    if not rel < 2e-2:
                        fail(f"assembly kernel: relative error {rel} at "
                             f"{case}")
                else:
                    try:
                        torch.testing.assert_close(got, want, rtol=1e-5,
                                                   atol=1e-4)
                    except AssertionError as err:
                        fail(f"assembly kernel != plain version at {case}: "
                             f"{err}")
                    worst = max(worst, (got - want).abs().max().item())
                n_cases += 1
    print(f"assembly kernel == plain version on {n_cases} cases (direct: "
          f"rtol=1e-5, atol=1e-4; mxu_distance: relative error < 2e-2; "
          f"block shapes exactly equal); max_abs_err {worst!r}", flush=True)
    return worst


def check_real_tasks(torch, asm_ref, problem, per_quad: int = 3) -> float:
    """The application's own launch (``execute.tile_kernel``, 16 x 16
    tiles) against the plain version on real tasks of ``problem``: the
    first ``per_quad`` of each quad order and its largest; returns the
    largest absolute error."""
    from repro_torch.assembly.execute import _task_inputs, tile_kernel
    worst, n_cases = 0.0, 0
    for q in ASM_QUADS:
        tasks = [t for t in problem.tasks if t.quad_order == q]
        if not tasks:
            fail(f"real tasks: no task of quad order {q}")
        biggest = max(tasks, key=lambda t: len(t.rows) * len(t.cols))
        for t in tasks[:per_quad] + [biggest]:
            pr, pc, couple = _task_inputs(problem, t, torch.device("cuda"))
            got = tile_kernel(pr, pc, couple, q)
            want = asm_ref.reference_tile(pr, pc, couple, q)
            case = f"task ({len(t.rows)}, {len(t.cols)}) Q={q}"
            try:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
            except AssertionError as err:
                fail(f"assembly kernel != plain version on {case}: {err}")
            worst = max(worst, (got - want).abs().max().item())
            n_cases += 1
    print(f"assembly kernel (the application's launch) == plain version on "
          f"{n_cases} real tasks (rtol=1e-5, atol=1e-4); max_abs_err "
          f"{worst!r}", flush=True)
    return worst


def signatures(problem) -> Counter:
    return Counter((len(t.rows), len(t.cols), t.quad_order)
                   for t in problem.tasks)


def spread(d) -> dict:
    import numpy as np
    med = float(np.median(d))
    return dict(min=float(d.min()), median=med, max=float(d.max()),
                max_over_median=float(d.max()) / med)


def count_launches(asm_kernel, problem, label: str) -> int:
    n = asm_kernel.LAUNCHES["float32"]
    want = 2 * problem.num_tasks + len(signatures(problem))
    if n == 0 or n != want:
        fail(f"{label}: {n} assembly-kernel launches, expected 2 x "
             f"{problem.num_tasks} tasks + {len(signatures(problem))} "
             f"signatures = {want}")
    return n


def same_plan(ha, hb) -> bool:
    return (ha is None) == (hb is None) and (
        ha is None or (ha.waves == hb.waves and ha.detours == hb.detours
                       and ha.total_bytes == hb.total_bytes))


def same_placement(a, b) -> bool:
    """Two runs balanced from the same predictions: the same predictions,
    CCM-LB placement and off-home copies, and the same baseline A."""
    import numpy as np
    return (np.array_equal(a.durations_pred, b.durations_pred)
            and np.array_equal(a.lb_result.assignment, b.lb_result.assignment)
            and a.lb_result.transfer_log == b.lb_result.transfer_log
            and a.lb_result.transfers == b.lb_result.transfers
            and a.lb_result.max_work == b.lb_result.max_work
            and a.n_off_home_ranks == b.n_off_home_ranks
            and a.makespan_baseline == b.makespan_baseline)


def home(run):
    """``plan_assembly_homing(run)`` and ``None``, or ``run`` and the
    reference's homing error."""
    from repro_torch.assembly import plan_assembly_homing
    try:
        return plan_assembly_homing(run), None
    except RuntimeError as err:
        if str(err) not in HOMING_FAULTS:
            raise
        return run, str(err)


def same_assembly_run(a, b) -> bool:
    import numpy as np
    return (np.array_equal(a.lb_result.assignment, b.lb_result.assignment)
            and a.lb_result.transfer_log == b.lb_result.transfer_log
            and a.lb_result.transfers == b.lb_result.transfers
            and a.makespan_baseline == b.makespan_baseline
            and a.makespan_overdecomposed == b.makespan_overdecomposed
            and a.makespan_ccmlb == b.makespan_ccmlb
            and a.imbalance_before == b.imbalance_before
            and a.imbalance_after == b.imbalance_after
            and a.n_off_home_ranks == b.n_off_home_ranks
            and same_plan(a.homing, b.homing))


def run_summary(run, fault=None) -> dict:
    """A/B/C of a run; where homing raised ``fault``, C's homing time, its
    speedup and the waves are ``None`` and only C's compute is known."""
    homed = fault is None
    return dict(
        tasks=run.problem.num_tasks, transfers=run.lb_result.transfers,
        makespan_s=dict(A=run.makespan_baseline,
                        B=run.makespan_overdecomposed, C=run.makespan_ccmlb,
                        C_homing=(run.homing.est_time_s if run.homing
                                  else 0.0) if homed else None),
        speedup=dict(B=run.speedup_overdecomposed,
                     C=float(run.speedup_ccmlb) if homed else None,
                     C_compute=run.makespan_baseline / run.makespan_ccmlb),
        imbalance=[run.imbalance_before, run.imbalance_after],
        off_home_copies=run.n_off_home_ranks,
        homing_waves=(len(run.homing.waves) if run.homing else 0)
        if homed else None,
        homing_fault=fault, stage_s=run.stage_seconds)


def assembly_path(torch, asm_kernel, asm_ref, kernel, launch) -> dict:
    """The application at 8192 unknowns on 32 ranks, on the card."""
    import numpy as np
    from repro_torch.assembly import (balance_assembly, build_problem,
                                      run_assembly_comparison)
    from repro_torch.assembly.execute import measure_durations
    from repro_torch.costmodel import train_cost_model
    from repro_torch.costmodel.train import evaluate_cost_model
    out, runs, stage_s = {}, {}, {}
    scorer = 0

    # training data: every task of the 4096-unknown configuration, measured
    t0 = time.perf_counter()
    train_p = build_problem(4096, 16, task_limit_u=96, seed=1)
    feats = train_p.features()
    stage_s["train_build"] = time.perf_counter() - t0
    real_worst = check_real_tasks(torch, asm_ref, train_p)
    asm_kernel.reset_launches()
    t0 = time.perf_counter()
    durs = measure_durations(train_p, device="cuda")
    torch.cuda.synchronize()
    stage_s["train_measure"] = time.perf_counter() - t0
    n_train = count_launches(asm_kernel, train_p, "training data")
    if durs.shape != (train_p.num_tasks,) or not (np.isfinite(durs).all()
                                                  and (durs > 0).all()):
        fail("training data: durations not finite and positive")
    out["train_durations_s"] = spread(durs)

    # the cost model, trained on the card
    t0 = time.perf_counter()
    model, hist = train_cost_model(feats, durs, epochs=120, batch_size=128,
                                   alpha=0.3, reduce_to=int(0.7 * len(durs)),
                                   seed=0, device="cuda")
    torch.cuda.synchronize()
    stage_s["train_cost_model"] = time.perf_counter() - t0
    if model.net.out_w.device.type != "cuda":
        fail("cost model: not on the card")
    metrics = evaluate_cost_model(model, feats, durs)
    if not (np.isfinite(hist["loss"]).all() and hist["loss"][-1]
            < hist["loss"][0] and all(np.isfinite(v)
                                      for v in metrics.values())):
        fail(f"cost model: loss {hist['loss'][::30]} metrics {metrics}")
    out["cost_model"] = dict(metrics, loss_first=hist["loss"][0],
                             loss_last=hist["loss"][-1])

    # the target, measured, balanced on the model's predictions on the
    # card; homing is planned apart, after the placement is held against
    # the CPU's from the same predictions
    target_p = build_problem(8192, 32, task_limit_u=96, seed=2)
    asm_kernel.reset_launches()
    kernel.reset_launches()
    launch.reset_stats()
    t0 = time.perf_counter()
    bal_m = balance_assembly(8192, 32, task_limit_u=96, durations="measured",
                             cost_model=model, seed=2, device="cuda")
    torch.cuda.synchronize()
    stage_s["target_measured"] = time.perf_counter() - t0
    n_target = count_launches(asm_kernel, target_p, "target, measured")
    if kernel.PAIR_LAUNCHES["float64"] != launch.STATS["calls"] \
            or launch.STATS["calls"] == 0 or sum(kernel.LAUNCHES.values()):
        fail(f"target, measured: scorer pair launches {kernel.PAIR_LAUNCHES}"
             f" vs calls {launch.STATS['calls']}, full-tile launches "
             f"{kernel.LAUNCHES}")
    scorer += kernel.PAIR_LAUNCHES["float64"]
    d = bal_m.durations_true
    if not (np.isfinite(d).all() and (d > 0).all()
            and np.isfinite(bal_m.durations_pred).all()
            and bal_m.speedup_overdecomposed > 0
            and bal_m.makespan_ccmlb > 0):
        fail("target, measured: implausible durations or makespans")
    # CCM-LB and homing read only the predictions: balanced on the CPU from
    # the same model, the placement must be the card's, and homing must
    # give the same plan or raise the same error
    t0 = time.perf_counter()
    bal_c = balance_assembly(8192, 32, task_limit_u=96, durations="analytic",
                             cost_model=model, seed=2, device="cpu")
    stage_s["target_cpu_placement"] = time.perf_counter() - t0
    if not same_placement(bal_m, bal_c):
        fail("target, measured: the card's CCM-LB placement differs from "
             "the CPU's from the same predictions")
    run_m, homing_fault = home(bal_m)
    run_mc, cpu_fault = home(bal_c)
    if homing_fault != cpu_fault or not same_plan(run_m.homing,
                                                  run_mc.homing):
        fail(f"target, measured: homing on the card's placement "
             f"({homing_fault}) differs from the CPU's ({cpu_fault})")
    out["target_durations_s"] = spread(d)
    pred = run_m.durations_pred
    out["target_prediction"] = dict(
        rel_err_median=float(np.median(np.abs(pred - d) / d)),
        over_predict_frac=float(np.mean(pred >= d)))
    runs["measured"] = run_summary(run_m, homing_fault)

    # the target, analytic: the card's run equals the CPU's
    kernel.reset_launches()
    launch.reset_stats()
    run_a = run_assembly_comparison(8192, 32, task_limit_u=96,
                                    durations="analytic", seed=0,
                                    device="cuda")
    torch.cuda.synchronize()
    if kernel.PAIR_LAUNCHES["float64"] != launch.STATS["calls"] \
            or launch.STATS["calls"] == 0 or sum(kernel.LAUNCHES.values()):
        fail(f"target, analytic: scorer pair launches {kernel.PAIR_LAUNCHES}"
             f" vs calls {launch.STATS['calls']}, full-tile launches "
             f"{kernel.LAUNCHES}")
    scorer += kernel.PAIR_LAUNCHES["float64"]
    run_c = run_assembly_comparison(8192, 32, task_limit_u=96,
                                    durations="analytic", seed=0,
                                    device="cpu")
    if not same_assembly_run(run_a, run_c):
        fail("target, analytic: cuda run differs from the cpu run")
    got = dict(tasks=run_a.problem.num_tasks,
               transfers=run_a.lb_result.transfers,
               off_home=run_a.n_off_home_ranks,
               waves=len(run_a.homing.waves) if run_a.homing else 0)
    if got != ASM_EXPECT:
        fail(f"target, analytic: {got}, the reference gives {ASM_EXPECT}")
    runs["analytic"] = run_summary(run_a)
    runs["analytic"]["cpu_stage_s"] = run_c.stage_seconds

    sigs = signatures(train_p) + signatures(target_p)
    out.update(launches=n_train + n_target, scorer_launches=scorer,
               real_task_max_abs_err=real_worst,
               launches_by_run=dict(train=n_train, target=n_target),
               stage_s=stage_s, runs=runs, signatures=sigs,
               problems=(train_p, target_p))
    a = runs["analytic"]
    print(f"assembly: training data {train_p.num_tasks} tasks, "
          f"{n_train} launches, durations {out['train_durations_s']}",
          flush=True)
    print(f"assembly: cost model rel-err median "
          f"{metrics['rel_err_median']!r}, over-predict fraction "
          f"{metrics['over_predict_frac']!r}", flush=True)
    m = runs["measured"]
    print(f"assembly: target measured, {m['tasks']} tasks, {n_target} "
          f"launches, durations {out['target_durations_s']}; prediction "
          f"{out['target_prediction']}; placement == cpu placement; "
          f"makespans {m['makespan_s']}, speedups {m['speedup']}, imbalance "
          f"{m['imbalance']}, {m['transfers']} transfers, "
          f"{m['off_home_copies']} off-home copies, "
          + (f"{m['homing_waves']} waves (cpu: the same plan)"
             if homing_fault is None else
             f"homing raised '{homing_fault}' on the card's and the cpu's "
             f"placement alike (the reference's fault, ROADMAP queue 3)"),
          flush=True)
    print(f"assembly: target analytic, cuda == cpu; {a['tasks']} tasks, "
          f"speedups {a['speedup']}, imbalance {a['imbalance']}, "
          f"{a['transfers']} transfers, {a['off_home_copies']} off-home "
          f"copies, {a['homing_waves']} waves", flush=True)
    print(f"assembly: stage seconds {stage_s}; measured run "
          f"{m['stage_s']}; analytic cuda {a['stage_s']}", flush=True)
    return out


# ------------------------------------------------------------ 6. serving
def fold_heads(x, heads):
    """(B, S, H, hd) -> (B * H, S, hd), the kernel's layout."""
    b, s, _, hd = x.shape
    return x.transpose(1, 2).reshape(b * heads, s, hd).contiguous()


def check_flash_kernel(torch, flash_ops, flash_ref, rng) -> dict:
    """The flash kernel against its plain version on the card, and in bf16
    also against the plain model of its rounding; returns the largest
    absolute error per dtype (``bfloat16_p``: against the model)."""
    worst = {"bfloat16_p": 0.0}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        worst[name] = 0.0
        for case in FLASH_CASES:
            b, sq, skv, hq, hkv, hd, causal, window, cap = case
            q, k, v = (torch.tensor(rng.standard_normal(shape), dtype=dtype,
                                    device="cuda")
                       for shape in ((b, sq, hq, hd), (b, skv, hkv, hd),
                                     (b, skv, hkv, hd)))
            got = flash_ops.flash_attention(q, k, v, causal=causal,
                                            window=window, softcap=cap)
            want = flash_ref.reference_attention(
                fold_heads(q, hq), fold_heads(k, hkv), fold_heads(v, hkv),
                causal=causal, window=window, softcap=cap)
            want = want.reshape(b, hq, sq, hd).transpose(1, 2)
            model = None
            if dtype == torch.bfloat16:
                model = flash_ref.reference_attention_bf16_p(
                    fold_heads(q, hq), fold_heads(k, hkv), fold_heads(v, hkv),
                    causal=causal, window=window, softcap=cap)
                model = model.reshape(b, hq, sq, hd).transpose(1, 2)
            label = f"flash {name} {case}"
            err, err_p = hold_flash(torch, got, want, model, label)
            del model
            if not causal and window and sq > skv + window:
                dead = got[:, skv + window:]
                if not (dead == 0).all():
                    fail(f"{label}: rows that see no key are not 0")
            worst[name] = max(worst[name], err)
            worst["bfloat16_p"] = max(worst["bfloat16_p"], err_p)
            n_cases += 1
    # block-shape independence (float32, the reference's atol 1e-5)
    q, k, v = (torch.tensor(rng.standard_normal((1, 200, 4, 64)),
                            dtype=torch.float32, device="cuda")
               for _ in range(3))
    outs = [flash_ops.flash_attention(q, k, v, block_q=bq, block_k=bk)
            for bq, bk in ((64, 64), (32, 32), (64, 17), (16, 64))]
    for o in outs[1:]:
        if not torch.allclose(o, outs[0], atol=1e-5, rtol=0):
            fail("flash: the result depends on the block shape")
    print(f"flash kernel == plain version on {n_cases} cases (float32 "
          f"atol=rtol=2e-5, bfloat16 2e-2; bfloat16 == the plain model of "
          f"its p rounding within {FLASH_P_TOL}; float32 block shapes (64, "
          f"64), (32, 32), (64, 17), (16, 64) within 1e-5); max_abs_err "
          f"{worst}", flush=True)
    return worst


def hold_flash(torch, got, want, model, label: str) -> tuple:
    """Fails unless flash's ``got`` has ``want``'s shape and dtype and
    agrees with the plain version ``want`` at ``FLASH_TOL`` and, unless
    ``model`` is None, with the plain model of its bf16 p (float32) at
    ``FLASH_P_TOL``; returns the largest absolute errors against each (0.0
    without a model)."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{label}: shape/dtype {tuple(got.shape)} {got.dtype}")
    tol = FLASH_TOL[dtype_name(got.dtype)]
    errs = [0.0, 0.0]
    for i, (what, ref, t) in enumerate((
            ("plain version", want, dict(atol=tol, rtol=tol)),
            ("the plain model of its bf16 p", model, FLASH_P_TOL))):
        if ref is None:
            continue
        try:
            torch.testing.assert_close(got.float(), ref.float(), **t)
        except AssertionError as err:
            fail(f"{label}: kernel != {what}: {err}")
        errs[i] = (got.float() - ref.float()).abs().max().item()
    return tuple(errs)


def check_gemm_kernel(torch, gemm_ops, gemm_ref, rng) -> dict:
    """The expert-GEMM kernel against its plain version on the card (no
    TF32 in the plain version); returns the largest absolute error per
    dtype."""
    worst = {}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        worst[name] = 0.0
        for e, c, d, f in GEMM_SHAPES:
            x = torch.tensor(rng.standard_normal((e, c, d)), dtype=dtype,
                             device="cuda")
            w = torch.tensor(rng.standard_normal((e, d, f)) / d ** 0.5,
                             dtype=dtype, device="cuda")
            got = gemm_ops.expert_gemm(x, w)
            worst[name] = max(worst[name], hold_gemm(
                torch, got, gemm_ref.reference_expert_gemm(x, w),
                f"expert_gemm {name} ({e}, {c}, {d}) x ({e}, {d}, {f})"))
            n_cases += 1
    print(f"expert_gemm kernel == plain version on {n_cases} cases (rtol "
          f"1e-5, atol 1e-4 in float32; rtol 3e-2, atol 3e-1 and within "
          f"{GEMM_P_TOL} in bfloat16); max_abs_err {worst}", flush=True)
    return worst


def hold_gemm(torch, got, want, label: str) -> float:
    """Fails unless the expert GEMM's ``got`` has ``want``'s shape and dtype
    and agrees with it at ``GEMM_TOL`` (rtol tol, atol 10 tol) and, in
    bf16, at ``GEMM_P_TOL``; returns the largest absolute error."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{label}: shape/dtype {tuple(got.shape)} {got.dtype}")
    tol = GEMM_TOL[dtype_name(got.dtype)]
    tols = [dict(rtol=tol, atol=10 * tol)]
    if got.dtype == torch.bfloat16:
        tols.append(GEMM_P_TOL)
    for t in tols:
        try:
            torch.testing.assert_close(got.float(), want.float(), **t)
        except AssertionError as err:
            fail(f"{label}: kernel != plain version within {t}: {err}")
    return (got.float() - want.float()).abs().max().item()


class RouteLog:
    """Wraps ``repro_torch.models.moe.route``: records each call's router
    logits and top-k indices, or replays recorded top-k choices."""

    def __init__(self, moe):
        self.moe, self.route = moe, moe.route
        self.calls, self.replay = [], None

    def __enter__(self):
        self.moe.route = self
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def __call__(self, x_flat, router_w, top_k):
        import torch
        probs, top_vals, top_idx = self.route(x_flat, router_w, top_k)
        if self.replay is not None:
            top_vals, top_idx = (t.to(x_flat.device)
                                 for t in self.replay.pop(0))
        self.calls.append(((x_flat.to(torch.float32) @ router_w).cpu(),
                           top_vals.cpu(), top_idx.cpu()))
        return probs, top_vals, top_idx


def route_flips(calls, ref_calls, top_k):
    """(tokens whose top-k set differs from the reference run's, of them
    those that rounding cannot explain: the reference's k-th and (k+1)-th
    router logits lie further apart than twice that token's largest logit
    change)."""
    import torch
    flips, unexplained = 0, 0
    for (lg, _, idx), (lg_r, _, idx_r) in zip(calls, ref_calls, strict=True):
        flipped = (torch.sort(idx, -1)[0] != torch.sort(idx_r, -1)[0]).any(-1)
        top = torch.sort(lg_r, -1, descending=True)[0]
        gap = top[:, top_k - 1] - top[:, top_k]
        drift = (lg - lg_r).abs().max(-1)[0]
        flips += int(flipped.sum())
        unexplained += int((flipped & (gap > 2 * drift)).sum())
    return flips, unexplained


def forced_logits(torch, model, params, tokens):
    """Prefill on ``tokens[:, :prompt]``, then teacher-forced decode steps
    on the rest: the last-position logits of each, float32 on the CPU."""
    from repro_torch.launch.serve import pad_caches
    prompt = tokens.shape[1] - CHECK_STEPS
    t = torch.as_tensor(tokens, dtype=torch.int64, device=model.device)
    with torch.inference_mode():
        caches, logits = model.prefill_fn(params, {"tokens": t[:, :prompt]})
        caches = pad_caches(caches, tokens.shape[1])
        out = [logits[:, 0].float().cpu()]
        for i in range(CHECK_STEPS):
            caches, logits = model.decode_fn(
                params, caches, t[:, prompt + i:prompt + i + 1], prompt + i)
            out.append(logits[:, 0].float().cpu())
    return out


def contract_errors(torch, got, want):
    """The serving contract (``tests/test_decode_parity.py``) on each step:
    normalised log-probs within ``atol=0.07, rtol=0.05`` and argmax equal.
    Returns (all steps met it, per-step max abs error, per-step worst
    excess over the tolerance)."""
    ok, errs, excess = True, [], []
    for g, w in zip(got, want, strict=True):
        g = g - g.max(-1, keepdim=True)[0]
        w = w - w.max(-1, keepdim=True)[0]
        diff = (g - w).abs()
        errs.append(diff.max().item())
        over = (diff - (0.07 + 0.05 * w.abs())).max().item()
        excess.append(over)
        ok = ok and over <= 0 and bool((g.argmax(-1) == w.argmax(-1)).all())
    return ok, errs, excess


class StepClock:
    """Wraps a model's prefill and decode functions with CUDA events, and
    keeps the prefill logits."""

    def __init__(self, torch, model):
        self.torch, self.model = torch, model
        self.prefill, self.decode = model.prefill_fn, model.decode_fn
        self.events, self.logits = [], None
        model.prefill_fn, model.decode_fn = self._prefill, self._decode

    def _timed(self, kind, fn, *args):
        start = self.torch.cuda.Event(enable_timing=True)
        end = self.torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        self.events.append((kind, start, end))
        return out

    def _prefill(self, *args):
        out = self._timed("prefill", self.prefill, *args)
        self.logits = out[1]
        return out

    def _decode(self, *args):
        return self._timed("decode", self.decode, *args)

    def restore(self):
        self.model.prefill_fn, self.model.decode_fn = self.prefill, \
            self.decode

    def seconds(self, kind):
        return [s.elapsed_time(e) / 1e3 for k, s, e in self.events
                if k == kind]


def serve_on_card(torch, cfg, full_layers: int, prompt_len: int, want,
                  mods):
    """``cfg`` served through ``serve_batch`` on the card: bf16 weights
    from the port's init (a seeded generator on the card), ``SERVE_BATCH``
    prompts of ``prompt_len`` tokens (numpy seed 0), ``SERVE_NEW`` new
    tokens, after a short warm-up.  Every kernel of ``mods`` has its
    launches counted from zero and its launch shapes logged; they must
    equal ``want`` ({kernel: (dtype, count)}, every other count 0).
    Returns (numbers, model, params, the numpy generator)."""
    import numpy as np

    from repro_torch.launch.serve import serve_batch
    from repro_torch.models.model import build_model

    t0 = time.perf_counter()
    model = build_model(cfg)                        # device "cuda"
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (SERVE_BATCH, prompt_len))
    serve_batch(model, params, prompts[:1, :16], 2)        # warm-up
    clock = StepClock(torch, model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.reset_launches()
    with ShapeLog(mods) as log:
        t0 = time.perf_counter()
        tokens = serve_batch(model, params, prompts, SERVE_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: dict(mod.LAUNCHES) for name, mod in mods.items()}
    peak = torch.cuda.max_memory_allocated()
    clock.restore()
    expected = {name: {"bfloat16": 0, "float32": 0} for name in mods}
    for name, (dt, n) in want.items():
        expected[name][dt] = n
    if launches != expected:
        fail(f"serve {cfg.name}: launches {launches}, expected {expected}")
    if tokens.shape != (SERVE_BATCH, SERVE_NEW) or tokens.min() < 0 \
            or tokens.max() >= cfg.vocab_size \
            or not torch.isfinite(clock.logits).all():
        fail(f"serve {cfg.name}: bad tokens {tokens.shape} or non-finite "
             "logits")
    prefill_s = clock.seconds("prefill")[0]
    decode_s = clock.seconds("decode")
    # the same prefill three times more, after the counted run (its
    # launches not counted): the spread of one prefill's time, and what of
    # the first one's is a one-off
    batch = {"tokens": torch.as_tensor(prompts, device="cuda")}
    again = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        model.prefill_fn(params, batch)
        end.record()
        end.synchronize()
        again.append(start.elapsed_time(end) / 1e3)
    del batch
    out = dict(
        arch=cfg.name, layers=f"{cfg.num_layers} of {full_layers}",
        q_heads=cfg.num_heads, params=n_params, batch=SERVE_BATCH,
        prompt=prompt_len, new_tokens=SERVE_NEW, init_s=init_s, wall_s=wall,
        prefill_s=prefill_s, prefill_again_s=again,
        decode_step_s_median=float(np.median(decode_s)),
        decode_step_s_min=min(decode_s), decode_step_s_max=max(decode_s),
        tokens_per_s=SERVE_BATCH * SERVE_NEW / wall,
        decode_tokens_per_s=SERVE_BATCH * len(decode_s) / sum(decode_s),
        peak_memory_gb=peak / 1e9, launches=launches,
        shapes={name: [[list(k), n] for k, n in c.most_common()]
                for name, c in log.shapes.items() if c},
        log_shapes=log.shapes)
    print(f"serve: {cfg.name}, {cfg.num_layers} of {full_layers} layers, "
          f"{n_params} parameters (bf16, init on the card {init_s:.2f} s); "
          f"{SERVE_BATCH} requests x {prompt_len}-token prompts, "
          f"{SERVE_NEW} new tokens: prefill {prefill_s!r} s (then "
          f"{again!r} s), decode step "
          f"median {out['decode_step_s_median']!r} s, {out['tokens_per_s']!r}"
          f" tokens/s over {wall!r} s, peak memory {peak / 1e9!r} GB; "
          f"launches {want}", flush=True)
    out["profile"] = profile_serve(torch, model, params, prompts)
    print(json.dumps({"serve_profile": {cfg.name: out["profile"]}}),
          flush=True)
    return out, model, params, rng


def serve_path(torch, mods) -> dict:
    """``qwen3-moe-30b-a3b`` at its published width, depth cut to
    ``SERVE_LAYERS`` of 48, served through ``serve_batch`` on the card
    (exactly one flash launch per layer and three expert-GEMM launches per
    layer and forward); then the same weights on the CPU against the card,
    teacher-forced."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.model import build_model

    # the router is a float32 product: TF32 would move its near-ties, so it
    # stays off (as it is by default) for every float32 product here
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full = configs.get_config(SERVE_ARCH)
    cfg = dataclasses.replace(full, num_layers=SERVE_LAYERS)
    want = {"flash": ("bfloat16", SERVE_LAYERS),
            "gemm": ("bfloat16", 3 * SERVE_LAYERS * (1 + SERVE_NEW))}
    out, model, params, rng = serve_on_card(torch, cfg, full.num_layers,
                                            SERVE_PROMPT, want, mods)

    # the same weights on the CPU against the card, teacher-forced: in bf16
    # (the served weights), then in float32 (the same values, widened)
    check = rng.integers(0, cfg.vocab_size, (1, CHECK_PROMPT + CHECK_STEPS))
    bf = card_vs_cpu(torch, cfg, model, params, check)
    if bf["router_flips_unexplained"] or bf["pinned"]["max_excess"] > 0 \
            or bf["pinned"]["argmax_unexplained"]:
        fail(f"card vs cpu, bf16: a difference that rounding does not "
             f"explain (a kernel fault): {bf}")
    wide = build_model(cfg, dtype=torch.float32)
    wide_params = tree_map(lambda t: t.to(torch.float32), params)
    f32 = card_vs_cpu(torch, cfg, wide, wide_params, check)
    del wide_params
    torch.cuda.empty_cache()
    if not f32["contract_met"]:
        fail(f"card vs cpu, float32: serving contract missed: {f32}")
    out["card_vs_cpu"] = {"bfloat16": bf, "float32": f32}
    # the expert re-placement loop on the served weights, before they go
    out["replacement"] = replacement_loop(torch, cfg, model, params, mods)
    return out


def prefill_stats(torch, cfg, params, tokens):
    """One prefill of ``tokens`` through ``transformer.run_stack`` that
    keeps its router statistics (``lm_prefill`` drops them): the
    last-position logits (B, V) float32 and the expert counts (one row per
    period of the block pattern, E), both on the CPU."""
    from repro_torch.models import transformer as tf
    with torch.inference_mode():
        x, positions = tf.lm_inputs(params, {"tokens": tokens}, cfg)
        x, stats, _ = tf.run_stack(params, x, positions, cfg)
        x = tf.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = tf.unembed(params, x[:, -1:], cfg)[:, 0]
    return logits.float().cpu(), stats["expert_counts"].cpu()


def rows_contract(torch, got, want) -> dict:
    """``compare_steps`` with each row of (B, V) logits as a step."""
    return compare_steps(torch, list(got.split(1)), list(want.split(1)))


def replacement_loop(torch, cfg, model, params, mods) -> dict:
    """The JAX package's ``launch/train.py::rebalance_experts`` flow on the
    weights ``serve_path`` has just served: one prefill of the served
    prompts through ``run_stack`` (router counts, one row per layer), an
    expert placement of those counts on 16 devices planned on the card
    (the card's memory as the HBM budget), the plan's slot permutations
    applied to every MoE layer on the card, and the same prefill again.

    Only the order in which the card's ``index_add_`` sums a token's expert
    outputs moves with the slots (the per-expert GEMMs are the same), and
    in bf16 that can move a later layer's near-tied top-k selection; the
    same prefill of the unpermuted weights, repeated, shows how much of it
    the card's unordered sums give anyway (reported, not held).  Held: the
    second run's counts are the first's permuted, exactly on the first
    layer (its router sees the same input) and on later layers unless
    every top-k selection that moved sits at a near tie (``route_flips``).
    That check of layers 1 to 7 cannot catch a wrongly permuted layer: a
    wrong permutation moves the router logits far, and ``route_flips``
    then calls every moved selection a near tie.  The permuted weights of
    those layers are held by the logits alone: a third prefill of the
    permuted weights, its routing pinned to the first run's selections in
    slot numbering, always runs, and its last-position logits must meet
    the serving contract against the first's (``rows_contract``: an
    argmax may differ only at a near tie); a token sent to a wrong expert
    would miss it.  The second run's logits must meet it too, unless a
    selection moved.  Each prefill launches exactly ``SERVE_LAYERS`` flash
    kernels and three expert GEMMs a layer, in bf16, and the plan the pair
    kernel; ``launches`` sums the counts read after every prefill the loop
    ran."""
    import numpy as np

    from repro_torch.balance import (apply_expert_permutation,
                                     plan_expert_placement)
    from repro_torch.configs.base import BLOCK_MOE
    from repro_torch.kernels.ccm_scorer import kernel as scorer
    from repro_torch.models import moe
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))   # serve_on_card's
    tokens = torch.as_tensor(prompts, device=model.device)
    want = {"flash": SERVE_LAYERS, "gemm": 3 * SERVE_LAYERS}
    ran = {k: 0 for k in want}     # launches read after each prefill, summed
    prefills = []

    def counted_prefill(p, label, replay=None):
        for mod in mods.values():
            mod.reset_launches()
        with RouteLog(moe) as routes:
            routes.replay = replay
            logits, counts = prefill_stats(torch, cfg, p, tokens)
        torch.cuda.synchronize()
        got = {k: dict(mods[k].LAUNCHES) for k in want}
        if any(got[k] != {"bfloat16": n, "float32": 0}
               for k, n in want.items()) or any(
                sum(mods[k].LAUNCHES.values()) for k in mods
                if k not in want):
            fail(f"re-placement {label} prefill: launches {got}, expected "
                 f"{want} in bf16 and nothing else")
        for k in want:
            ran[k] += got[k]["bfloat16"]
        prefills.append(label)
        return logits, counts, routes.calls

    logits0, counts0, calls0 = counted_prefill(params, "first")
    if counts0.shape != (SERVE_LAYERS, cfg.num_experts) or \
            not torch.isfinite(logits0).all():
        fail(f"re-placement: counts {tuple(counts0.shape)}, logits finite "
             f"{bool(torch.isfinite(logits0).all())}")
    logits_r, counts_r, calls_r = counted_prefill(params, "repeated")
    repeat = dict(counts_equal=bool(torch.equal(counts_r, counts0)),
                  router_flips=route_flips(calls_r, calls0, cfg.top_k)[0],
                  **rows_contract(torch, logits_r, logits0))
    counts = counts0.numpy().astype(np.float64)
    hbm = float(torch.cuda.get_device_properties(0).total_memory)
    scorer.reset_launches()
    t0 = time.perf_counter()
    plan = plan_expert_placement(counts, cfg, 16, hbm_budget_bytes=hbm,
                                 device="cuda")
    plan_s = time.perf_counter() - t0
    n_pair = scorer.PAIR_LAUNCHES["float64"]
    if n_pair == 0 or sum(scorer.LAUNCHES.values()) \
            or sum(scorer.SPEC_LAUNCHES.values()):
        fail(f"re-placement plan: pair launches {scorer.PAIR_LAUNCHES}, "
             f"full-tile {scorer.LAUNCHES}, window {scorer.SPEC_LAUNCHES}")
    perms = [torch.as_tensor(p) for p in plan.permutations]
    period = cfg.pattern_period
    placed = dict(params, blocks=[
        dict(b, moe=apply_expert_permutation(b["moe"], perms[i // period]))
        if kind == BLOCK_MOE else b
        for i, (b, kind) in enumerate(zip(params["blocks"],
                                          cfg.layer_kinds()))])
    logits1, counts1, calls1 = counted_prefill(placed, "second")
    exact = [bool(torch.equal(counts1[r], counts0[r][p]))
             for r, p in enumerate(perms)]
    # the second run's routings in the first run's expert numbering
    mapped = [(lg[:, torch.argsort(p)], vals, p[idx])
              for (lg, vals, idx), p in zip(calls1, perms, strict=True)]
    flips, unexplained = route_flips(mapped, calls0, cfg.top_k)
    if not exact[0] or (not all(exact) and unexplained):
        fail(f"re-placement: counts not permuted (exact per layer {exact};"
             f" {flips} top-k selections moved, {unexplained} not at a "
             "near tie)")
    contract = rows_contract(torch, logits1, logits0)
    # the first run's selections, in slot numbering
    inv = [torch.argsort(p) for p in perms]
    replay = [(vals, q[idx]) for (_, vals, idx), q
              in zip(calls0, inv, strict=True)]
    logits_p, _, _ = counted_prefill(placed, "pinned", replay)
    pinned = rows_contract(torch, logits_p, logits0)
    missed = contract["max_excess"] > 0 or contract["argmax_unexplained"]
    if (missed and not flips) or pinned["max_excess"] > 0 \
            or pinned["argmax_unexplained"]:
        fail(f"re-placement: logits outside the serving contract against "
             f"the first prefill ({contract}; {flips} top-k selections "
             f"moved) or with the routing pinned ({pinned})")
    del placed
    torch.cuda.empty_cache()
    out = dict(counts_shape=list(counts0.shape), counts_exact=exact,
               router_flips=flips, router_flips_unexplained=unexplained,
               imbalance=[plan.imbalance_before, plan.imbalance_after],
               max_work=[plan.max_work_before, plan.max_work_after],
               transfers=plan.lb_result.transfers,
               replicated_blocks=plan.replicated_blocks, plan_s=plan_s,
               pair_launches=n_pair, prefills=prefills, launches=ran,
               contract=contract, pinned=pinned, repeat=repeat)
    print(f"re-placement: counts {tuple(counts0.shape)} from the served "
          f"weights; plan on the card {plan_s!r} s, {n_pair} pair launches, "
          f"{plan.lb_result.transfers} transfers, imbalance "
          f"{plan.imbalance_before!r} -> {plan.imbalance_after!r}; second "
          f"prefill's counts permuted exactly per layer {exact} ({flips} "
          f"top-k selections moved, {unexplained} not at a near tie); "
          f"logits against the first prefill's {contract}; with the "
          f"routing pinned {pinned}; the unpermuted prefill repeated: "
          f"{repeat}; {len(prefills)} prefills {prefills} launched {ran} "
          f"({want} each)", flush=True)
    return out


def profile_serve(torch, model, params, prompts) -> dict:
    """The device's idle share over one more ``serve_batch`` run, and the
    eight kernels with the most device time (``profiled_run``)."""
    from repro_torch.launch.serve import serve_batch
    out = profiled_run(torch, lambda: serve_batch(model, params, prompts,
                                                  SERVE_NEW))
    rows = out.pop("by_name")
    out["top"] = [list(kv) for kv in sorted(
        rows.items(), key=lambda kv: -kv[1]["device_ms"])[:8]]
    return out


def compare_steps(torch, card, cpu) -> dict:
    """The card's teacher-forced logits against the CPU's: the serving
    contract per step, and each step whose argmax differs checked for a
    near tie (the CPU's top two logits closer than twice the step's largest
    logit error)."""
    ok, errs, excess = contract_errors(torch, card, cpu)
    gaps, argmax_eq, logit_err = [], [], []
    for g, w in zip(card, cpu, strict=True):
        top2 = torch.topk(w[0], 2).values
        gaps.append(float(top2[0] - top2[1]))
        logit_err.append(float((g - w).abs().max()))
        argmax_eq.append(bool((g.argmax(-1) == w.argmax(-1)).all()))
    return dict(
        contract_met=ok, max_abs_err=errs, excess_over_tolerance=excess,
        max_excess=max(excess), argmax_equal=argmax_eq,
        max_abs_logit_err=logit_err, cpu_top2_gap=gaps,
        argmax_unexplained=sum(not a and gap > 2 * err for a, gap, err
                               in zip(argmax_eq, gaps, logit_err)))


def card_vs_cpu(torch, cfg, model, params, check) -> dict:
    """``model`` with ``params`` on the card against the same weights on the
    CPU, on ``check`` teacher-forced (``compare_steps``).  Where the model
    routes tokens to experts, also the top-k router selections that differ
    (and how many of them rounding explains), and the steps compared again
    with the card's routing pinned to the CPU's."""
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    label = f"{cfg.name} {dtype_name(model.dtype)}"
    with RouteLog(moe) as card_routes:
        card = forced_logits(torch, model, params, check)
    t0 = time.perf_counter()
    cpu_params = tree_map(lambda t: t.cpu(), params)
    cpu_model = build_model(cfg, device="cpu", dtype=model.dtype)
    with RouteLog(moe) as cpu_routes:
        cpu = forced_logits(torch, cpu_model, cpu_params, check)
    cpu_s = time.perf_counter() - t0
    del cpu_params
    out = dict(layers=cfg.num_layers, prompt=check.shape[1] - CHECK_STEPS,
               steps=CHECK_STEPS, **compare_steps(torch, card, cpu))
    routing = ""
    if cpu_routes.calls:
        flips, unexplained = route_flips(card_routes.calls, cpu_routes.calls,
                                         cfg.top_k)
        with RouteLog(moe) as pinned:
            pinned.replay = [(c[1], c[2]) for c in cpu_routes.calls]
            card_pinned = forced_logits(torch, model, params, check)
        p = out["pinned"] = compare_steps(torch, card_pinned, cpu)
        out.update(
            router_tokens=sum(int(c[2].shape[0]) for c in cpu_routes.calls),
            router_flips=flips, router_flips_unexplained=unexplained)
        routing = (
            f"; top-k selections differing in {flips} of "
            f"{out['router_tokens']} token routings ({unexplained} not "
            f"explained by rounding); with the card's routing pinned to the "
            f"cpu's: contract {'met' if p['contract_met'] else 'MISSED'}, "
            f"max abs error {p['max_abs_err']}, argmax equal "
            f"{p['argmax_equal']} (cpu top-two gaps {p['cpu_top2_gap']})")
    out["cpu_s"] = cpu_s
    print(f"card vs cpu, {label} ({cfg.num_layers} layers, {out['prompt']}"
          f"-token prompt, {CHECK_STEPS} teacher-forced steps): serving "
          f"contract {'met' if out['contract_met'] else 'MISSED'}; max abs "
          f"error of normalised log-probs per step {out['max_abs_err']}; "
          f"argmax equal {out['argmax_equal']} (cpu top-two gaps "
          f"{out['cpu_top2_gap']}, max logit errors "
          f"{out['max_abs_logit_err']}){routing}; cpu {cpu_s:.1f} s",
          flush=True)
    return out


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


# ------------------------------------------------------- 7b. the training path
def rel_err(torch, got, want) -> float:
    """Largest |got - want| over the largest |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def check_flash_bwd(torch, flash_kernel, flash_ops, flash_ref) -> dict:
    """The flash backward kernel (through ``ops.flash_attention``'s
    autograd function: the forward kernel, then one backward launch)
    against autograd through the plain version in float32, on the same
    inputs (standard normal, drawn on the card from a seeded generator), at
    every ``FLASH_CASES`` shape in float32 and bf16: dq, dk, dv each within
    ``FLASH_BWD_TOL`` of its largest |value|.  Returns the largest absolute
    and relative errors per dtype."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        worst[name] = {"abs": 0.0, "rel": 0.0}
        for case in FLASH_CASES:
            b, sq, skv, hq, hkv, hd, causal, window, cap = case
            t = [torch.randn(shape, generator=gen, device="cuda")
                 .to(dtype).requires_grad_()
                 for shape in ((b, sq, hq, hd), (b, skv, hkv, hd),
                               (b, skv, hkv, hd))]
            d_out = torch.randn((b, sq, hq, hd), generator=gen,
                                device="cuda").to(dtype)
            n0 = flash_kernel.BWD_LAUNCHES[name]
            got = torch.autograd.grad(flash_ops.flash_attention(
                *t, causal=causal, window=window, softcap=cap), t, d_out)
            torch.cuda.synchronize()
            if flash_kernel.BWD_LAUNCHES[name] != n0 + 1:
                fail(f"flash backward {name} {case}: "
                     f"{flash_kernel.BWD_LAUNCHES[name] - n0} launches")
            fold = [fold_heads(x.detach().float(), h).requires_grad_()
                    for x, h in zip(t, (hq, hkv, hkv))]
            out = flash_ref.reference_attention(
                *fold, causal=causal, window=window, softcap=cap)
            want = torch.autograd.grad(out, fold,
                                       fold_heads(d_out.float(), hq))
            del out
            for g, w, h, what in zip(got, want, (hq, hkv, hkv), "qkv"):
                w = w.reshape(b, h, -1, hd).transpose(1, 2)
                if g.shape != w.shape or g.dtype != dtype \
                        or not torch.isfinite(g).all():
                    fail(f"flash backward {name} {case}: d{what} "
                         f"{tuple(g.shape)} {g.dtype}")
                err = rel_err(torch, g, w)
                if err > FLASH_BWD_TOL[name]:
                    fail(f"flash backward {name} {case}: d{what} off by "
                         f"{err} of its largest |value| (tolerance "
                         f"{FLASH_BWD_TOL[name]})")
                worst[name]["rel"] = max(worst[name]["rel"], err)
                worst[name]["abs"] = max(
                    worst[name]["abs"],
                    (g.float() - w).abs().max().item())
            del got, want, fold, t
            torch.cuda.empty_cache()
    print(f"flash backward kernel == plain version's autograd on "
          f"{2 * len(FLASH_CASES)} cases (dq, dk, dv within "
          f"{FLASH_BWD_TOL} of their largest |value|); worst {worst}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return worst


def check_gemm_bwd(torch, gemm_kernel, gemm_ops, gemm_ref) -> dict:
    """The expert GEMM's backward (``ops.expert_gemm``'s autograd
    function: dX and dW, one launch of the kernel each) against autograd
    through the plain version on the same inputs (normal, drawn on the
    card from a seeded generator; w scaled by 1 / sqrt(d)), at
    ``GEMM_BWD_SHAPES`` in float32 and bf16, at the forward's ``GEMM_TOL``
    (rtol tol, atol 10 tol).  Returns the largest absolute error per
    dtype."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        worst[name] = 0.0
        tol = GEMM_TOL[name]
        for e, c, d, f in GEMM_BWD_SHAPES:
            x, w, dy = (torch.randn(shape, generator=gen, device="cuda")
                        for shape in ((e, c, d), (e, d, f), (e, c, f)))
            x, w, dy = x.to(dtype), (w / d ** 0.5).to(dtype), dy.to(dtype)
            n0 = gemm_kernel.BWD_LAUNCHES[name]
            xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
            got = torch.autograd.grad(gemm_ops.expert_gemm(xg, wg),
                                      (xg, wg), dy)
            torch.cuda.synchronize()
            if gemm_kernel.BWD_LAUNCHES[name] != n0 + 2:
                fail(f"expert_gemm backward {name} ({e}, {c}, {d}, {f}): "
                     f"{gemm_kernel.BWD_LAUNCHES[name] - n0} launches")
            xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
            want = torch.autograd.grad(gemm_ref.reference_expert_gemm(xr, wr),
                                       (xr, wr), dy)
            for g, wt, what in zip(got, want, ("dX", "dW")):
                try:
                    torch.testing.assert_close(g.float(), wt.float(),
                                               rtol=tol, atol=tol * 10)
                except AssertionError as err:
                    fail(f"expert_gemm backward {name} ({e}, {c}, {d}, "
                         f"{f}): {what} != plain autograd: {err}")
                worst[name] = max(worst[name],
                                  (g.float() - wt.float()).abs().max().item())
    print(f"expert_gemm backward == plain autograd on "
          f"{2 * len(GEMM_BWD_SHAPES)} cases (dX and dW at rtol tol, atol 10 "
          f"tol, tol {GEMM_TOL}); max_abs_err {worst}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return worst


def time_train_kernels(torch, flash_kernel, flash_ref, gemm_kernel,
                       gemm_ref, per_step) -> dict:
    """The two backwards at the training shapes, bf16: kernel (CUDA events
    and ``device_ms``), plain version's autograd, one PyTorch call's
    backward (SDPA with K and V repeated to the q heads; ``torch.bmm``),
    timed only, and the bound: the larger of the bytes (q, k, v, o, dO
    read once, dq, dk, dv written once; x, w, dY read, dX, dW written)
    over the HBM rate and the operations (flash: five products over the
    visible pairs; the GEMM: two) over the bf16 tensor-core peak.
    ``per_step`` is the main path's launches a step (a GEMM backward is two
    launches; gate/up and down share it)."""
    import torch.nn.functional as F
    out = {}
    cfg_b, hq, hkv, hd = TRAIN_BATCH, 32, 4, 128
    sq = TRAIN_SEQ
    q = torch.randn((cfg_b * hq, sq, hd), dtype=torch.bfloat16, device="cuda")
    k = torch.randn((cfg_b * hkv, sq, hd), dtype=torch.bfloat16,
                    device="cuda")
    v = torch.randn_like(k)
    o = flash_kernel.flash_attention_fwd(q, k, v)
    d_out = torch.randn_like(q)
    qf, kf, vf = (t.detach().requires_grad_() for t in (q, k, v))
    plain = flash_ref.reference_attention(qf, kf, vf)
    group = hq // hkv
    q4 = q.reshape(cfg_b, hq, sq, hd).detach().requires_grad_()
    k4, v4 = (t.reshape(cfg_b, hkv, sq, hd).repeat_interleave(group, dim=1)
              .detach().requires_grad_() for t in (k, v))
    sdpa = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    do4 = d_out.reshape(cfg_b, hq, sq, hd)

    def launch_one():
        flash_kernel.flash_attention_bwd(q, k, v, o, d_out)

    k_ms = time_ms(torch, launch_one, 10)
    k_dev, k_host = queued_ms(torch, launch_one, 10)
    p_ms = time_ms(torch, lambda: torch.autograd.grad(
        plain, (qf, kf, vf), d_out, retain_graph=True), 2)
    l_ms = time_ms(torch, lambda: torch.autograd.grad(
        sdpa, (q4, k4, v4), do4, retain_graph=True), 10)
    pairs = cfg_b * hq * sq * (sq + 1) // 2
    ops = 5 * 2 * pairs * hd
    nbytes = 2 * (4 * q.numel() + 4 * k.numel())
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_BF16 * 1e3
    key = f"q={list(q.shape)},kv={list(k.shape)},causal"
    out["flash_bwd"] = {key: dict(
        ms=k_ms, device_ms=k_dev, host_ms=k_host, plain_ms=p_ms,
        library_ms=l_ms, bound_ms=max(t_b, t_o),
        bound_by="bytes" if t_b >= t_o else "operations", bytes=nbytes,
        operations=ops, launches_per_step=per_step["flash_bwd"])}
    print(f"time flash backward {key}: kernel {k_ms!r} ms (device "
          f"{k_dev!r} ms), plain autograd {p_ms!r} ms, sdpa backward "
          f"{l_ms!r} ms, bound {max(t_b, t_o)!r} ms ({nbytes} B, {ops} "
          f"operations)", flush=True)
    del plain, sdpa, q4, k4, v4
    out["gemm_bwd"] = {}
    for e, c, d, f in GEMM_BWD_SHAPES[:2]:
        x = torch.randn((e, c, d), dtype=torch.bfloat16, device="cuda")
        w = torch.randn((e, d, f), dtype=torch.bfloat16, device="cuda") \
            / d ** 0.5
        dy = torch.randn((e, c, f), dtype=torch.bfloat16, device="cuda")
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        plain = gemm_ref.reference_expert_gemm(xr, wr)
        xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
        lib = torch.bmm(xb, wb)

        def launch_one():
            gemm_kernel.expert_gemm_bwd(x, w, dy)

        k_ms = time_ms(torch, launch_one, 10)
        k_dev, k_host = queued_ms(torch, launch_one, 10)
        p_ms = time_ms(torch, lambda: torch.autograd.grad(
            plain, (xr, wr), dy, retain_graph=True), 5)
        l_ms = time_ms(torch, lambda: torch.autograd.grad(
            lib, (xb, wb), dy, retain_graph=True), 10)
        ops = 2 * 2 * e * c * d * f
        nbytes = 2 * 2 * (e * c * d + e * d * f) + 2 * e * c * f
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_BF16 * 1e3
        key = f"x={[e, c, d]},w={[e, d, f]}"
        out["gemm_bwd"][key] = dict(
            ms=k_ms, device_ms=k_dev, host_ms=k_host, plain_ms=p_ms,
            library_ms=l_ms, bound_ms=max(t_b, t_o),
            bound_by="bytes" if t_b >= t_o else "operations", bytes=nbytes,
            operations=ops, launches_per_step=per_step["gemm_bwd"] // 2)
        print(f"time expert_gemm backward {key}: kernel {k_ms!r} ms "
              f"(device {k_dev!r} ms, with the two transposed copies), "
              f"plain autograd {p_ms!r} ms, bmm backward {l_ms!r} ms, bound "
              f"{max(t_b, t_o)!r} ms ({nbytes} B, {ops} operations)",
              flush=True)
    return out


def train_card_vs_cpu(torch) -> dict:
    """``TRAIN_ARCH`` cut to ``TRAIN_CHECK_LAYERS`` layers in float32, the
    same weights on the card and the CPU (drawn on the card, copied to the
    CPU): the loss and every gradient leaf of one batch at the
    ``TRAIN_CHECK_*`` tolerances, then ``TRAIN_CHECK_STEPS`` train steps'
    losses within ``TRAIN_RESTART_RTOL``."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.checkpoint import tree_leaves as leaves
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.steps import (make_optimizer, make_train_step,
                                          to_device)
    from repro_torch.models.model import build_model
    import numpy as np
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_config(TRAIN_ARCH),
                              num_layers=TRAIN_CHECK_LAYERS)
    batches = [make_batch(cfg, TRAIN_CHECK_SEQ, TRAIN_CHECK_BATCH, i)
               for i in range(TRAIN_CHECK_STEPS)]
    t0 = time.perf_counter()
    card_model = build_model(cfg, device="cuda", dtype=torch.float32)
    card_params = card_model.init(torch.Generator(device="cuda")
                                  .manual_seed(1))
    cpu_model = build_model(cfg, device="cpu", dtype=torch.float32)
    cpu_params = tree_map(lambda t: t.cpu(), card_params)
    runs = {}
    for where, model, params in (("cuda", card_model, card_params),
                                 ("cpu", cpu_model, cpu_params)):
        opt = make_optimizer(params, lr=TRAIN_LR, warmup_steps=1,
                             total_steps=TRAIN_CHECK_STEPS)
        loss, _ = model.loss_fn(params, to_device(batches[0], model.device))
        loss.backward()
        runs[where] = {"loss": loss.item(), "opt": opt,
                       "step": make_train_step(model), "params": params}
    worst_grad = 0.0
    for g_card, g_cpu in zip(leaves(card_params), leaves(cpu_params),
                             strict=True):
        err = rel_err(torch, g_card.grad.cpu(), g_cpu.grad)
        worst_grad = max(worst_grad, err)
        if not err <= TRAIN_CHECK_GRAD:
            fail(f"train card vs cpu: a gradient leaf {tuple(g_cpu.shape)} "
                 f"off by {err} of its largest |value|")
    losses = {where: [] for where in runs}
    for batch in batches:
        for where, r in runs.items():
            losses[where].append(float(r["step"](r["params"], r["opt"],
                                                 batch)["loss"]))
    cpu_s = time.perf_counter() - t0
    out = dict(layers=TRAIN_CHECK_LAYERS, tokens=TRAIN_CHECK_BATCH
               * TRAIN_CHECK_SEQ, loss_card=runs["cuda"]["loss"],
               loss_cpu=runs["cpu"]["loss"], grad_rel_err=worst_grad,
               step_losses=losses, seconds=cpu_s)
    lc, lp = np.array(losses["cuda"]), np.array(losses["cpu"])
    if not (abs(out["loss_card"] - out["loss_cpu"])
            <= TRAIN_CHECK_RTOL * abs(out["loss_cpu"])
            and np.allclose(lc, lp, rtol=TRAIN_RESTART_RTOL, atol=0)):
        fail(f"train card vs cpu: losses differ: {out}")
    print(f"train card vs cpu ({cfg.name}, {TRAIN_CHECK_LAYERS} layers, "
          f"float32, {TRAIN_CHECK_BATCH} x {TRAIN_CHECK_SEQ} tokens): loss "
          f"{out['loss_card']!r} vs {out['loss_cpu']!r}; gradient leaves "
          f"within {worst_grad} of their largest |value|; "
          f"{TRAIN_CHECK_STEPS} steps' losses {losses}; {cpu_s:.1f} s",
          flush=True)
    return out


def train_path(torch, mods) -> dict:
    """The trainer on the card: ``train_loop`` on ``TRAIN_ARCH`` at its
    published width, ``TRAIN_LAYERS`` of 48 layers (the ``TRAIN_*``
    settings), launch counts zeroed just before and read just after; every
    step must launch flash forward twice a layer (forward and the remat's
    recompute) and its backward once, the expert GEMM six times a layer in
    the forward and six in the backward, all bf16, and each re-placement
    plan the pair kernel.  One more step profiled for the device's idle
    share.  Then the restart pair at ``TRAIN_RESTART_LAYERS``: the run
    uninterrupted, and failing at ``TRAIN_FAIL_AT`` under
    ``run_with_restarts`` with a checkpoint every ``TRAIN_CKPT_EVERY``
    steps; it must restore step 5 and its losses from there agree with the
    uninterrupted run's within ``TRAIN_RESTART_RTOL``."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import configs
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels.ccm_scorer import kernel as scorer
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import TrainLog, train_loop
    from repro_torch.models.model import build_model
    from repro_torch.runtime.fault import FaultInjector, run_with_restarts
    full = configs.get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, num_layers=TRAIN_LAYERS)
    common = dict(steps=TRAIN_STEPS, seq_len=TRAIN_SEQ,
                  global_batch=TRAIN_BATCH, rebalance_every=TRAIN_REBALANCE,
                  lr=TRAIN_LR, expert_ranks=TRAIN_RANKS, log_every=1,
                  device="cuda")
    for mod in mods.values():
        mod.reset_launches()
    scorer.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    log = TrainLog()
    t0 = time.perf_counter()
    params, opt, losses = train_loop(cfg, log=log, **common)
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = {k: dict(mods[k].LAUNCHES) for k in ("flash", "gemm")}
    counts.update({f"{k}_bwd": dict(mods[k].BWD_LAUNCHES)
                   for k in ("flash", "gemm")})
    pair = scorer.PAIR_LAUNCHES["float64"]
    others = {k: sum(mods[k].LAUNCHES.values()) for k in mods
              if k not in ("flash", "gemm")}
    n = TRAIN_LAYERS
    want_step = {"flash_fwd": 2 * n, "flash_bwd": n, "gemm_fwd": 6 * n,
                 "gemm_bwd": 6 * n}
    if any(rec != want_step for rec in log.launches) or any(
            c["float32"] for c in counts.values()) or any(
            others.values()) or pair == 0 or len(log.replacements) != 2:
        fail(f"train: launches a step {log.launches} (expected "
             f"{want_step}), totals {counts}, others {others}, pair "
             f"{pair}, re-placements {log.replacements}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"train: losses {losses}")
    batch = make_batch(cfg, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS)
    step = make_train_step(build_model(cfg, device="cuda"))
    prof = profiled_run(torch, lambda: step(params, opt, batch))
    del params, opt, step
    gc.collect()
    torch.cuda.empty_cache()

    # the restart pair: uninterrupted, then failing at TRAIN_FAIL_AT
    cut = dataclasses.replace(full, num_layers=TRAIN_RESTART_LAYERS)
    _, _, ref_losses = train_loop(cut, **common)
    gc.collect()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="train_ckpt_"))
    inj = FaultInjector(fail_at_steps=(TRAIN_FAIL_AT,))
    flog = TrainLog()
    parts = []

    def once():
        gc.collect()
        torch.cuda.empty_cache()
        parts.append(train_loop(cut, ckpt_dir=str(tmp),
                                ckpt_every=TRAIN_CKPT_EVERY, fault=inj,
                                log=flog, **common)[2])

    try:
        print(f"train: checkpoints under {tmp} (free "
              f"{shutil.disk_usage(tmp).free / 1e9:.1f} GB)", flush=True)
        t0 = time.perf_counter()
        stats = run_with_restarts(once)
        fault_wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    first = TRAIN_CKPT_EVERY
    resumed = parts[-1] if parts else []
    agree = len(resumed) == TRAIN_STEPS - first and np.allclose(
        resumed, ref_losses[first:], rtol=TRAIN_RESTART_RTOL, atol=0)
    if not (stats.completed and stats.restarts == 1
            and flog.restored_from == [first] and agree):
        fail(f"train restart: {stats}, restored from {flog.restored_from}, "
             f"losses {resumed} against {ref_losses[first:]}")
    step_s = sorted(log.step_s)
    med = step_s[len(step_s) // 2]
    out = dict(
        layers=TRAIN_LAYERS, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
        steps=TRAIN_STEPS, losses=losses, step_s=log.step_s,
        step_s_median=med, step_s_min=step_s[0], step_s_max=step_s[-1],
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / med, peak_gb=peak_gb,
        wall_s=wall, launches_per_step=log.launches[0], launches=counts,
        replacements=log.replacements, pair_launches=pair,
        device_idle_share=prof["device_idle_share"],
        device_idle_share_bounds=prof["device_idle_share_bounds"],
        profiled_step_s=prof["wall_s"],
        restart=dict(layers=TRAIN_RESTART_LAYERS, restarts=stats.restarts,
                     restored_from=flog.restored_from, losses=resumed,
                     uninterrupted=ref_losses, wall_s=fault_wall,
                     step_s=flog.step_s,
                     checkpoint_and_restore_s=fault_wall - sum(flog.step_s)))
    print(f"train {cfg.name} ({TRAIN_LAYERS} of 48 layers, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens): losses {losses}; step s median {med!r} "
          f"(min {step_s[0]!r}, max {step_s[-1]!r}); {out['tokens_per_s']!r} "
          f"tokens/s; peak {peak_gb!r} GB; run {wall:.1f} s; launches a "
          f"step {log.launches[0]}; re-placements {log.replacements}; "
          f"device idle {prof['device_idle_share']} "
          f"({prof['device_idle_share_bounds']}); restart at "
          f"{TRAIN_RESTART_LAYERS} layer(s) from {flog.restored_from} agrees "
          f"within {TRAIN_RESTART_RTOL} ({resumed} against "
          f"{ref_losses[first:]}), {fault_wall:.1f} s of which "
          f"{out['restart']['checkpoint_and_restore_s']:.1f} s not in steps",
          flush=True)
    return out


# ------------------------------------------------ 7. serving the recurrent LMs
def wkv6_inputs(torch, rng, b, s, h, hd, log_w, dtype):
    """tests/test_kernels.py's distributions: r, k at 0.5, v standard,
    log_w = -exp(N(0, 1)) unless given, u at 0.3; r, k, v in ``dtype``,
    log_w and u float32, on the card."""
    import numpy as np

    def card(a, dt=torch.float32):
        return torch.tensor(a, dtype=torch.float32, device="cuda").to(dt)
    lw = (-np.exp(rng.standard_normal((b, s, h, hd))) if log_w is None
          else np.full((b, s, h, hd), log_w))
    return (card(rng.standard_normal((b, s, h, hd)) * 0.5, dtype),
            card(rng.standard_normal((b, s, h, hd)) * 0.5, dtype),
            card(rng.standard_normal((b, s, h, hd)), dtype), card(lw),
            card(rng.standard_normal((h, hd)) * 0.3))


def check_wkv6_kernel(torch, wkv_ops, wkv_ref, rng) -> dict:
    """The WKV6 kernel against its plain versions on the card: y against
    the sequential oracle (the kernel's own form) and against the chunked
    version at chunks 16, 32 and 64 (16 only past 128 tokens), the final
    state against the chunked version's.  Returns the largest absolute
    errors per dtype."""
    worst = {}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        rtol = WKV_RTOL[name]
        worst[name] = {"y": 0.0, "state": 0.0}
        for b, s, h, hd, log_w in WKV_CASES:
            r, k, v, lw, u = wkv6_inputs(torch, rng, b, s, h, hd, log_w,
                                         dtype)
            y, state = wkv_ops.wkv6(r, k, v, lw, u)
            fold = [t.transpose(1, 2).reshape(b * h, s, hd)
                    for t in (r, k, v, lw)]
            oracle = wkv_ref.reference_wkv6(*fold, u.repeat(b, 1))
            oracle = oracle.reshape(b, h, s, hd).transpose(1, 2)
            torch.cuda.synchronize()
            label = f"wkv6 {name} (B, S, H, hd) = ({b}, {s}, {h}, {hd}), " \
                f"log_w {log_w or '-exp(N(0, 1))'}"
            if y.shape != r.shape or y.dtype != dtype \
                    or state.shape != (b, h, hd, hd) \
                    or not (torch.isfinite(y).all()
                            and torch.isfinite(state).all()):
                fail(f"{label}: shape/dtype {tuple(y.shape)} {y.dtype}, "
                     f"{tuple(state.shape)}, or non-finite output")
            # at the clip extreme the chunked form's cumulated log-decay
            # reaches -4.8e4 in a chunk, where a float32 ulp is 2^-8, so its
            # y is inexact there (tests/test_torch_wkv6.py); the oracle, the
            # kernel's own form, holds y, and the state (exact in both) is
            # held to the chunked form's
            chunked_y = log_w is None or log_w > -100
            try:
                torch.testing.assert_close(y.float(), oracle.float(),
                                           atol=WKV_ATOL, rtol=rtol)
                for chunk in (16, 32, 64) if s <= 128 else (16,):
                    want_y, want_state = wkv_ref.wkv6_chunked(
                        r, k, v, lw, u, chunk=chunk)
                    if chunked_y:
                        torch.testing.assert_close(
                            y.float(), want_y.to(dtype).float(),
                            atol=WKV_ATOL, rtol=rtol)
                    torch.testing.assert_close(state, want_state,
                                               atol=WKV_ATOL, rtol=1e-5)
            except AssertionError as err:
                fail(f"{label}: kernel != plain version: {err}")
            w = worst[name]
            w["y"] = max(w["y"], (y.float() - oracle.float()).abs().max()
                         .item())
            w["state"] = max(w["state"],
                             (state - want_state).abs().max().item())
            n_cases += 1
    print(f"wkv6 kernel == plain versions on {n_cases} cases (y and final "
          f"state; float32 atol={WKV_ATOL}, rtol=1e-5; bfloat16 y rtol=2^-7, "
          f"one ulp); max_abs_err {worst}", flush=True)
    return worst


def check_rglru_kernel(torch, rglru_ops, rglru_ref, rng) -> dict:
    """The RG-LRU kernel against its plain version on the card; returns the
    largest absolute error per dtype."""
    import numpy as np
    worst = {}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        worst[name] = 0.0
        for b, s, w in RGLRU_CASES:
            la = torch.tensor(-np.exp(rng.standard_normal((b, s, w))) * 0.1
                              - 1e-3, dtype=torch.float32, device="cuda")
            bb = torch.tensor(rng.standard_normal((b, s, w)),
                              dtype=torch.float32, device="cuda").to(dtype)
            got = rglru_ops.rglru_scan_op(la, bb)
            want = rglru_ref.reference_rglru(la, bb)
            torch.cuda.synchronize()
            label = f"rglru {name} (B, S, W) = ({b}, {s}, {w})"
            if got.shape != bb.shape or got.dtype != dtype:
                fail(f"{label}: shape/dtype {tuple(got.shape)} {got.dtype}")
            try:
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=RGLRU_ATOL,
                                           rtol=WKV_RTOL[name])
            except AssertionError as err:
                fail(f"{label}: kernel != plain version: {err}")
            worst[name] = max(worst[name],
                              (got.float() - want.float()).abs().max().item())
            n_cases += 1
    print(f"rglru kernel == plain version on {n_cases} cases (float32 "
          f"atol={RGLRU_ATOL}, rtol=1e-5; bfloat16 rtol=2^-7, one ulp); "
          f"max_abs_err {worst}", flush=True)
    return worst


class ShapeLog:
    """Wraps the kernel launchers ``mods[name].<FWD[name]>``: counts each
    launch's argument shapes (and keywords) while in the ``with``."""

    FWD = {"wkv6": "wkv6_fwd", "rglru": "rglru_fwd",
           "flash": "flash_attention_fwd", "gemm": "expert_gemm_fwd"}

    def __init__(self, mods):
        self.mods = mods
        self.shapes = {name: Counter() for name in mods}
        self.saved = {}

    def __enter__(self):
        for name, mod in self.mods.items():
            fn = self.saved[name] = getattr(mod, self.FWD[name])
            setattr(mod, self.FWD[name], self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def rec(*args, **kw):
            key = (tuple(tuple(a.shape) for a in args),
                   tuple(sorted(kw.items())))
            self.shapes[name][key] += 1
            return fn(*args, **kw)
        return rec

    def __exit__(self, *exc):
        for name, mod in self.mods.items():
            setattr(mod, self.FWD[name], self.saved[name])


def serve_recurrent(torch, arch, prompt_len, want, cut, check_lens,
                    mods) -> dict:
    """``arch`` at its published width and full depth, served through
    ``serve_batch`` on the card (``serve_on_card``, launches held to
    ``want``); then the first ``cut`` layers' weights on the CPU against
    the card, teacher-forced, on prompts of ``check_lens[dtype]``
    tokens."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.model import build_model

    # the rglru gates and the card-vs-cpu check are float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get_config(arch)
    out, model, params, rng = serve_on_card(torch, cfg, cfg.num_layers,
                                            prompt_len, want, mods)

    # the first `cut` layers' weights on the CPU against the card: in bf16
    # (the served weights), then in float32 (the same values, widened)
    cut_cfg = dataclasses.replace(cfg, num_layers=cut)
    cut_params = dict(params, blocks=params["blocks"][:cut])
    out["card_vs_cpu"] = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = dtype_name(dtype)
        check = rng.integers(0, cfg.vocab_size,
                             (1, check_lens[name] + CHECK_STEPS))
        res = card_vs_cpu(
            torch, cut_cfg, build_model(cut_cfg, dtype=dtype),
            tree_map(lambda t: t.to(dtype) if t.dtype == torch.bfloat16
                     else t, cut_params), check)
        torch.cuda.empty_cache()
        if name == "float32" and not res["contract_met"]:
            fail(f"card vs cpu, {arch} float32: serving contract missed: "
                 f"{res}")
        if res["max_excess"] > 0 or res["argmax_unexplained"]:
            fail(f"card vs cpu, {arch} {name}: a difference beyond the "
                 f"serving contract that rounding does not explain: {res}")
        out["card_vs_cpu"][name] = res
    return out


# -------------------------------------------------------------- 8. timing
def time_ms(torch, fn, reps: int, rounds: int = 7) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` calls, from CUDA
    events around the calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / reps)
    per.sort()
    return per[len(per) // 2]


def bound(name: str, e_n: int, a_n: int, b_n: int):
    """Least time for the work on an H100 SXM: the larger of the bytes
    (each input read once, the output written once) over the HBM rate and
    the operations over the peak rate of the dtype."""
    from repro_torch.kernels.ccm_scorer.layout import N_AV, N_OUT, N_PM, N_SC
    size = 8 if name == "float64" else 4
    nbytes = size * e_n * (N_AV * (a_n + b_n) + N_PM * a_n * b_n + N_SC
                           + N_OUT * a_n * b_n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = e_n * a_n * b_n * OPS_PER_LANE / PEAK_OPS[name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes)


def time_kernel(torch, kernel, ref, rng, shapes) -> dict:
    """Kernel, plain version and bound at the two shapes each dtype's main
    path launched most, and at one large tile."""
    times = {}
    for dtype in (torch.float64, torch.float32):
        name = dtype_name(dtype)
        top = [k for k, _ in shapes[name].most_common(2)]
        for e_n, a_n, b_n in top + [(64, 128, 128)]:
            t = random_tiles(torch, rng, dtype, e_n, a_n, b_n)
            k_ms = time_ms(torch, lambda: kernel.score_tiles(*t), 200)
            k_dev = device_ms(torch, lambda: kernel.score_tiles(*t))
            p_ms = time_ms(torch, lambda: ref.score_tiles(*t), 20)
            b_ms, b_by, nbytes = bound(name, e_n, a_n, b_n)
            key = f"E={e_n},A={a_n},B={b_n}"
            times.setdefault(name, {})[key] = dict(
                ms=k_ms, device_ms=k_dev, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by,
                bytes=nbytes, main_path_launches=shapes[name][(e_n, a_n,
                                                               b_n)])
            print(f"time {name} {key}: kernel {k_ms!r} ms (device {k_dev!r} "
                  f"ms), plain {p_ms!r} ms, bound {b_ms!r} ms ({b_by}, {nbytes} B)", flush=True)
    return times


def pair_bound(name: str, e_n: int, p_total: int, a_cols: int,
               b_cols: int):
    """Least time of the fused pair scorer's work on an H100 SXM: bytes of
    the pm entries at the pairs, the distinct a- and b-columns read, the
    scalar rows (in the dtype), the float64 combine rows, the int32 offsets
    and pairs, and the (3, P) float64 result, each once, over the HBM rate;
    against the scorer's operations per pair in the dtype plus the
    combine's float64 ones, over the peak rates."""
    from repro_torch.kernels.ccm_scorer.layout import N_AV, N_CF, N_PM, N_SC
    size = 8 if name == "float64" else 4
    nbytes = (size * (N_PM * p_total + N_AV * (a_cols + b_cols)
                      + N_SC * e_n)
              + 8 * N_CF * e_n + 4 * (e_n + 1) + 8 * p_total + 24 * p_total)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (p_total * OPS_PER_LANE / PEAK_OPS[name]
             + p_total * COMBINE_OPS / PEAK_OPS["float64"]) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes)


def time_pairs(torch, kernel, ref, launch, rng, pair_shapes) -> dict:
    """The fused pair kernel at the two (E, A, B, P) each dtype's main path
    launched most, and at E = 64, A = B = 128, P = 32 an event: the launch
    between events (``ms``) and queued behind a sleep (``device_ms``, and
    the host's time to queue one launch), the launcher's host time a call
    (``launch.score_events``: pack, copies, launch, wait and results, with
    its split), the plain version and the bound.  Each shape's launch is
    held to the plain version first."""
    import numpy as np
    from repro_torch.core import CCMParams
    params = CCMParams()
    dev = torch.device("cuda")
    times = {}
    for dtype in (torch.float64, torch.float32):
        name = dtype_name(dtype)
        top = [k for k, _ in pair_shapes[name].most_common(2)]
        for e_n, a_n, b_n, p_total in top + [(64, 128, 128, 64 * 32)]:
            counts = [p_total // e_n + (k < p_total % e_n)
                      for k in range(e_n)]
            feats, pairs = pair_events(rng, e_n, a_n, b_n, counts)
            t = pair_inputs(torch, launch, dtype, feats, pairs, params)
            out = torch.empty((3, p_total), dtype=torch.float64, device=dev)
            ptrs = [x.data_ptr() for x in t] + [out.data_ptr()]

            def launch_one():
                kernel.launch_pairs(dtype, *ptrs, e_n, a_n, b_n, p_total,
                                    params.memory_constraint,
                                    torch.cuda.current_stream().cuda_stream)

            key = f"E={e_n},A={a_n},B={b_n},P={p_total}"
            launch_one()
            want = ref.score_pairs_packed(*t, params.memory_constraint)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                fail(f"pair kernel != plain version at {name} {key}")
            k_ms = time_ms(torch, launch_one, 200)
            k_dev, q_host = queued_ms(torch, launch_one)
            p_ms = time_ms(torch, lambda: ref.score_pairs_packed(
                *t, params.memory_constraint), 20)
            reps = 200 if e_n * a_n * b_n < 10 ** 5 else 20
            launch.reset_stats()
            for _ in range(reps):
                launch.score_events(feats, pairs, params, device=dev,
                                    dtype=dtype)
            host_ms = launch.STATS["seconds"] / reps * 1e3
            split = {k: v / reps * 1e3
                     for k, v in launch.STATS["split"].items()}
            a_cols = sum(len(np.unique(pr[:, 0])) for pr in pairs)
            b_cols = sum(len(np.unique(pr[:, 1])) for pr in pairs)
            b_ms, b_by, nbytes = pair_bound(name, e_n, p_total, a_cols,
                                            b_cols)
            times.setdefault(name, {})[key] = dict(
                ms=k_ms, device_ms=k_dev, queue_host_ms=q_host,
                host_ms=host_ms, host_split_ms=split, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                main_path_launches=pair_shapes[name][(e_n, a_n, b_n,
                                                      p_total)])
            print(f"time pairs {name} {key}: kernel {k_ms!r} ms (device "
                  f"{k_dev!r} ms, queued in {q_host!r} ms), launcher "
                  f"{host_ms!r} ms a call {split}, plain {p_ms!r} ms, "
                  f"bound {b_ms!r} ms ({b_by}, {nbytes} B)", flush=True)
    return times


def spec_bound(buf, lanes: int, p_n: int):
    """Least time of the window kernel's work on these rows on an H100
    SXM: the rows read once and (W, 4) written once over the HBM rate,
    against this data's float64 operations over the float64 peak: each
    real edge's scatter add, the slice sums (four per group over a side's
    lanes, the eight flow sums) and, per valid shortlist slot, the scorer
    tree, the combine and the selection (pad rows need none)."""
    from repro_torch.kernels.ccm_scorer.layout import (spec_edge_bucket,
                                                       spec_groups,
                                                       spec_offsets)
    w_n, row_len = buf.shape
    eb = spec_edge_bucket(row_len, lanes, lanes, p_n)
    g_n = spec_groups(lanes, lanes)[2]
    o_ms = spec_offsets(eb, lanes, lanes, p_n)[7]
    counts = buf[:, o_ms + 5]
    real = counts > 0
    edges = int(((buf[:, :eb] != 0) & real[:, None]).sum().item())
    slots = int(counts.sum().item())
    ops = (edges + int(real.sum().item()) * (4 * g_n * lanes + 8 * lanes)
           + slots * (OPS_PER_LANE + COMBINE_OPS + SPEC_SLOT_OPS))
    nbytes = 8 * w_n * row_len + 8 * 4 * w_n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS["float64"] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def time_spec(torch, kernel, ref, launch, shape, n_main: int, raws,
              lanes: int, p_n: int) -> dict:
    """The window kernel at ``shape`` (W, eb), which a main path launched
    ``n_main`` times, on real rows: those of that edge bucket where
    ``raws`` has them (the 256-rank spec runs), else ``raws`` as captured
    (the fleet's rows, mixed buckets padded to eb as in its windows).  The
    launch between events (``ms``), queued behind a sleep (``device_ms``,
    and the host's time to queue one launch), the launcher's host time a
    call (``score_spec``: stacking, copies, launch, wait; with its split),
    the plain version and the bound.  The launch is held to the plain
    version first."""
    w_n, eb = shape
    same = [r for r in raws if r[1] == eb] or raws
    rows = [same[i % len(same)] for i in range(w_n)]
    buf = spec_buffer(torch, launch, rows, lanes, p_n)
    if buf.shape[0] != w_n or max(e for _, e in rows) != eb:
        fail(f"time_spec: built W={buf.shape[0]}, eb="
             f"{max(e for _, e in rows)} for ({w_n}, {eb})")
    out = torch.empty((w_n, 4), dtype=torch.float64, device="cuda")

    def launch_one():
        kernel.launch_spec(buf.data_ptr(), out.data_ptr(), 0, w_n, eb,
                           lanes, lanes, p_n, buf.stride(0),
                           torch.cuda.current_stream().cuda_stream)

    launch_one()
    want = ref.score_spec_rows(buf, lanes, lanes, p_n)
    torch.cuda.synchronize()
    if not same_bits(torch, out, want):
        fail(f"window kernel != plain version at W={w_n}, eb={eb}")
    k_ms = time_ms(torch, launch_one, 200)
    k_dev, q_host = queued_ms(torch, launch_one)
    p_ms = time_ms(torch, lambda: ref.score_spec_rows(buf, lanes, lanes,
                                                      p_n), 3, rounds=3)
    launch.reset_stats()
    reps = 200
    for _ in range(reps):
        launch.score_spec(rows, a_lanes=lanes, b_lanes=lanes, p_n=p_n,
                          device=torch.device("cuda"))
    rec = launch.STATS["spec"]
    host_ms = rec["seconds"] / reps * 1e3
    split = {k: v / reps * 1e3 for k, v in rec["split"].items()}
    b_ms, b_by, nbytes, ops = spec_bound(buf, lanes, p_n)
    key = f"W={w_n},eb={eb},A=B={lanes},P={p_n}"
    print(f"time spec {key}: kernel {k_ms!r} ms (device {k_dev!r} ms, "
          f"queued in {q_host!r} ms), launcher {host_ms!r} ms a call "
          f"{split}, plain {p_ms!r} ms, bound {b_ms!r} ms ({b_by}, {nbytes} "
          f"B, {ops} operations); {n_main} main-path launches at this "
          f"shape", flush=True)
    return dict(shape=key, ms=k_ms, device_ms=k_dev, queue_host_ms=q_host,
                host_ms=host_ms, host_split_ms=split, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, operations=ops,
                main_path_launches=n_main)


def task_inputs(torch, problem, sig):
    """The inputs of the first task of ``problem`` with signature ``sig``
    (rows, cols, quad order), on the card."""
    from repro_torch.assembly.execute import _task_inputs
    task = next(t for t in problem.tasks
                if (len(t.rows), len(t.cols), t.quad_order) == sig)
    return _task_inputs(problem, task, torch.device("cuda"))


def device_us(ev) -> float:
    """Device microseconds of a profiler row (the attribute's name differs
    between torch versions)."""
    dev_us = getattr(ev, "device_time_total", None)
    return getattr(ev, "cuda_time_total", 0.0) if dev_us is None else dev_us


def profiled_run(torch, run) -> dict:
    """``run()`` under ``torch.profiler``: its wall time, the device time
    and count of each kernel, copy and set by name, their busy total, and
    the device's idle share of the wall time.  The profiler can leave a
    few kernels unrecorded, so their number is counted: the kernel launch
    calls it recorded on the host (``cudaLaunchKernel*``,
    ``cuLaunchKernel*``) less the kernels it recorded on the card.  The
    idle share is given only where none is missing; the bounds always are,
    the lower one counting each missing kernel as long as the longest one
    recorded.  The run starts and ends ``PROFILE_MARGIN_S`` inside the
    profiled window, where fewer kernels went unrecorded on an H100 (the
    rwkv6 and recurrentgemma serve runs: 6 and 280 of about 10^5 without
    the margin; 3 and 0, then 4 and 6, with it), and the profiler keeps
    its events across cycles (``acc_events``), as its warning asked."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILE_MARGIN_S)
    cuda = torch.autograd.DeviceType.CUDA
    rows, calls = {}, 0
    for ev in prof.key_averages():
        if ev.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            calls += ev.count
        elif ev.device_type == cuda:
            rows[ev.key] = dict(count=ev.count, device_ms=device_us(ev) / 1e3)
    missing = calls - sum(r["count"] for k, r in rows.items()
                          if not k.startswith(("Memcpy", "Memset")))
    longest_ms = max((device_us(e) for e in prof.events()
                      if e.device_type == cuda), default=0.0) / 1e3
    busy_ms = sum(r["device_ms"] for r in rows.values())
    idle = 1.0 - busy_ms / 1e3 / wall
    bounds = [1.0 - (busy_ms + max(missing, 0) * longest_ms) / 1e3 / wall,
              idle]
    if missing:
        print(f"profiler: {missing} of {calls} launched kernels unrecorded; "
              f"device idle share within {bounds}", flush=True)
    return dict(wall_s=wall, launch_calls=calls, kernels_unrecorded=missing,
                device_busy_ms=busy_ms,
                device_idle_share=idle if missing == 0 else None,
                device_idle_share_bounds=bounds, by_name=rows)


def device_ms(torch, fn, reps: int = 50) -> float:
    """``queued_ms``'s device time."""
    return queued_ms(torch, fn, reps)[0]


def queued_ms(torch, fn, reps: int = 50) -> tuple:
    """Mean device time per call of ``fn``, from CUDA events around
    ``reps`` calls queued behind a sleep on the card, so that the host's
    time between launches is hidden (the event time of back-to-back calls
    is set by the host when a launch takes less than its Python wrapper),
    and the mean host time to queue one call.  Fails if the host took
    longer to queue the calls than the card slept."""
    fn()
    torch.cuda.synchronize()
    slept, start, end = (torch.cuda.Event(enable_timing=True)
                         for _ in range(3))
    slept.record()
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if host_ms >= slept.elapsed_time(start):
        fail(f"device_ms: queueing {reps} calls took {host_ms} ms, longer "
             f"than the card slept ({slept.elapsed_time(start)} ms)")
    return start.elapsed_time(end) / reps, host_ms / reps


def launch_mix(problems) -> Counter:
    """Assembly-kernel launches per quad order over the measured runs of
    ``problems``: each task twice, and each signature once more (warm-up)."""
    mix = Counter()
    for problem in problems:
        for (_, _, q), n in signatures(problem).items():
            mix[q] += 2 * n + 1
    return mix


def time_assembly_kernel(torch, asm_ops, asm_ref, asm_path) -> dict:
    """Assembly kernel (at the application's 16 x 16 tiles), plain version
    and bound at the signature the path launched most of each quad order,
    on a real task's inputs, with the path's launches of that quad order."""
    from repro_torch.assembly.execute import TILE_BLOCK
    sigs = asm_path["signatures"]
    mix = launch_mix(asm_path["problems"])
    if sum(mix.values()) != asm_path["launches"]:
        fail(f"assembly launch mix {dict(mix)} does not add up to "
             f"{asm_path['launches']} launches")
    print(f"assembly launches by quad order: {dict(sorted(mix.items()))}",
          flush=True)
    times = {}
    for quad in ASM_QUADS:
        sig = max((k for k in sigs if k[2] == quad), key=lambda k: sigs[k])
        problem = next(p for p in asm_path["problems"]
                       if sig in signatures(p))
        pr, pc, couple = task_inputs(torch, problem, sig)
        nr, nc, q = sig

        def launch_one():
            asm_ops.assembly_tile(pr, pc, couple, quad_order=q,
                                  block_r=TILE_BLOCK, block_c=TILE_BLOCK)

        k_ms = time_ms(torch, launch_one, 200)
        k_dev_ms, host_ms = queued_ms(torch, launch_one)
        p_ms = time_ms(torch, lambda: asm_ref.reference_tile(
            pr, pc, couple, q), 5 if q > 16 else 20)
        nbytes = nr * nc * (4 + 1) + (nr + nc) * 12
        ops = int(couple.sum().item()) * q * ASM_OPS_PER_STEP
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS["float32"] * 1e3
        key = f"rows={nr},cols={nc},Q={q}"
        times[key] = dict(
            ms=k_ms, device_ms=k_dev_ms, host_ms=host_ms, plain_ms=p_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes, operations=ops, main_path_tasks=sigs[sig],
            quad_order_launches=mix[q])
        print(f"time assembly_tile {key}: kernel {k_ms!r} ms (device "
              f"{k_dev_ms!r} ms, host {host_ms!r} ms a call), plain "
              f"{p_ms!r} ms, bound {max(t_bytes, t_ops)!r} ms "
              f"({times[key]['bound_by']}, {nbytes} B, {ops} operations); "
              f"{mix[q]} launches at Q = {q}", flush=True)
    return times


def launch_floor(torch) -> dict:
    """The card's cost of one launch: an empty kernel
    (``torch.cuda._sleep(0)``) timed as ``device_ms`` and between events."""
    out = dict(device_ms=device_ms(torch, lambda: torch.cuda._sleep(0),
                                   reps=200),
               event_ms=time_ms(torch, lambda: torch.cuda._sleep(0), 200))
    print(f"launch floor (empty kernel): {out['device_ms']!r} ms device, "
          f"{out['event_ms']!r} ms between events", flush=True)
    return out


def profile_main_path(torch, kernel) -> dict:
    """Device time of one float64 solo main-path run, by kernel and copy,
    and the device's idle share of the run's wall time."""
    from repro_torch.core import (CCMParams, ccm_lb, initial_assignment,
                                  scaling_phase)
    phase = scaling_phase(256)
    a0 = initial_assignment(phase)
    kernel.reset_launches()
    out = profiled_run(torch, lambda: ccm_lb(phase, a0, CCMParams(),
                                             device="cuda", **MAIN_KW))
    out["launches"] = kernel.PAIR_LAUNCHES["float64"]
    print(json.dumps({"profile": out}), flush=True)
    return out


def profile_spec_path(torch, kernel) -> dict:
    """The same for the first of ``SPEC_RUNS``."""
    from repro_torch.core import (CCMParams, ccm_lb, initial_assignment,
                                  scaling_phase)
    phase = scaling_phase(256)
    a0 = initial_assignment(phase)
    _, window, mode, fill = SPEC_RUNS[0]
    kernel.reset_launches()
    out = profiled_run(torch, lambda: ccm_lb(
        phase, a0, CCMParams(), device="cuda", spec_window=window,
        spec_mode=mode, spec_fill=fill, **MAIN_KW))
    out["launches"] = kernel.SPEC_LAUNCHES["float64"]
    print(json.dumps({"profile_spec": out}), flush=True)
    return out


def time_flash(torch, flash_kernel, flash_ref, q_shape, k_shape, hq: int,
               window: int, launches: int) -> dict:
    """Flash at one launched shape (bf16, causal, ``window`` if not 0):
    kernel, plain version, SDPA (K/V repeated to Hq, a window as a boolean
    mask; timed here only, never on the path) and the bound: the larger of
    the bytes (q, k, v read once, the output written once) over the HBM
    rate and the visible pairs' operations over the bf16 tensor-core
    peak."""
    import torch.nn.functional as F
    bhq, sq, hd = q_shape
    bhkv, skv, _ = k_shape
    q = torch.randn(q_shape, dtype=torch.bfloat16, device="cuda")
    k = torch.randn(k_shape, dtype=torch.bfloat16, device="cuda")
    v = torch.randn(k_shape, dtype=torch.bfloat16, device="cuda")
    b, group = bhq // hq, bhq // bhkv
    q4 = q.reshape(b, hq, sq, hd)
    k4, v4 = (t.reshape(b, hq // group, skv, hd)
              .repeat_interleave(group, dim=1) for t in (k, v))
    mask = None
    if window:
        q_pos = torch.arange(sq, device="cuda")[:, None]
        k_pos = torch.arange(skv, device="cuda")[None, :]
        mask = (k_pos <= q_pos) & (k_pos > q_pos - window)
    big = bhq * sq * skv > 2 ** 28
    key = f"q={list(q_shape)},kv={list(k_shape)}" \
        + (f",window={window}" if window else "")
    hold_flash(torch,
               flash_kernel.flash_attention_fwd(q, k, v, causal=True,
                                                window=window),
               flash_ref.reference_attention(q, k, v, causal=True,
                                             window=window),
               flash_ref.reference_attention_bf16_p(q, k, v, causal=True,
                                                    window=window),
               f"flash at the launched shape {key}")

    def launch_one():
        flash_kernel.flash_attention_fwd(q, k, v, causal=True, window=window)

    k_ms = time_ms(torch, launch_one, 20)
    k_dev, k_host = queued_ms(torch, launch_one)
    p_ms = time_ms(torch, lambda: flash_ref.reference_attention(
        q, k, v, causal=True, window=window), 2 if big else 10)
    l_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, is_causal=mask is None), 20)
    pairs = bhq * sum(min(i + 1, skv, window or skv) for i in range(sq))
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    ops = 4 * pairs * hd
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_BF16 * 1e3
    out = dict(ms=k_ms, device_ms=k_dev, host_ms=k_host, plain_ms=p_ms,
               library_ms=l_ms, bound_ms=max(t_b, t_o),
               bound_by="bytes" if t_b >= t_o else "operations",
               bytes=nbytes, operations=ops, launches=launches)
    print(f"time flash {key}: kernel {k_ms!r} ms (device {k_dev!r} ms, "
          f"host {k_host!r} ms a call), "
          f"plain {p_ms!r} ms, sdpa {l_ms!r} ms, bound {out['bound_ms']!r} ms "
          f"({out['bound_by']}, {nbytes} B, {ops} operations), {launches} "
          f"launches", flush=True)
    return {key: out}


def time_serve_kernels(torch, flash_kernel, flash_ref, gemm_kernel, gemm_ref,
                       serve) -> dict:
    """Each of the qwen serve path's kernels at the shapes it launched
    (bf16): kernel, plain version, one PyTorch call computing the same
    function (timed here only, never on the path) and the bound: the larger
    of the bytes (each input read once, the output written once) over the
    HBM rate and the operations over the bf16 tensor-core peak.  CUDA
    events, median of rounds."""
    times = {"flash": {}, "gemm": {}}
    for ((q_shape, k_shape, _), kw), n in \
            serve["log_shapes"]["flash"].items():
        times["flash"].update(time_flash(torch, flash_kernel, flash_ref,
                                         q_shape, k_shape, serve["q_heads"],
                                         dict(kw)["window"], n))
    for ((x_shape, w_shape), _), n in serve["log_shapes"]["gemm"].items():
        e, c, d = x_shape
        f = w_shape[2]
        x = torch.randn(x_shape, dtype=torch.bfloat16, device="cuda")
        w = torch.randn(w_shape, dtype=torch.bfloat16, device="cuda") \
            / d ** 0.5
        key = f"x={list(x_shape)},w={list(w_shape)}"
        hold_gemm(torch, gemm_kernel.expert_gemm_fwd(x, w),
                  gemm_ref.reference_expert_gemm(x, w),
                  f"expert_gemm at the launched shape {key}")

        def launch_one():
            gemm_kernel.expert_gemm_fwd(x, w)

        k_ms = time_ms(torch, launch_one, 20)
        k_dev, k_host = queued_ms(torch, launch_one)
        p_ms = time_ms(torch, lambda: gemm_ref.reference_expert_gemm(x, w),
                       10)
        l_ms = time_ms(torch, lambda: torch.bmm(x, w), 20)
        nbytes = 2 * (e * c * d + e * d * f + e * c * f)
        ops = 2 * e * c * d * f
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_BF16 * 1e3
        times["gemm"][key] = dict(
            ms=k_ms, device_ms=k_dev, host_ms=k_host, plain_ms=p_ms,
            library_ms=l_ms, bound_ms=max(t_b, t_o),
            bound_by="bytes" if t_b >= t_o else "operations", bytes=nbytes,
            operations=ops, launches=n)
        print(f"time expert_gemm {key}: kernel {k_ms!r} ms (device "
              f"{k_dev!r} ms, host {k_host!r} ms a call), plain {p_ms!r} ms, "
              f"bmm {l_ms!r} ms, bound "
              f"{max(t_b, t_o)!r} ms "
              f"({times['gemm'][key]['bound_by']}, {nbytes} B, {ops} "
              f"operations), {n} launches", flush=True)
    return times


def time_recurrent_kernels(torch, mods, refs, flash_ref, rec, rng) -> dict:
    """The recurrent paths' kernels at the shapes they launched: wkv6 (bf16
    r, k, v; float32 log_w and u) and rglru (float32) against their plain
    versions (the chunked WKV6 at chunk 16, the sequential RG-LRU) and
    their bounds (the larger of the bytes, each input read once and each
    output written once, over the HBM rate, and the float32 operations over
    the float32 peak: 4 hd^2 a token and head for WKV6, exp, multiply and
    add an element for the RG-LRU), kernel time also as ``device_ms``;
    and flash at recurrentgemma's local-attention shape.  No single
    PyTorch call computes a data-dependent-decay WKV or a linear
    recurrence, so both have no library time."""
    times = {"wkv6": {}, "rglru": {}, "flash": {}}
    for ((r_shape, *_), _), n in rec[RWKV_ARCH]["log_shapes"]["wkv6"].items():
        b, s, h, hd = r_shape
        r, k, v, lw, u = wkv6_inputs(torch, rng, b, s, h, hd, None,
                                     torch.bfloat16)

        def launch_one():
            mods["wkv6"].wkv6_fwd(r, k, v, lw, u)

        k_ms = time_ms(torch, launch_one, 50)
        k_dev = device_ms(torch, launch_one)
        p_ms = time_ms(torch, lambda: refs["wkv6"].wkv6_chunked(
            r, k, v, lw, u), 3)
        # r, k, v read and y written in bf16; log_w, u and the state float32
        nbytes = (2 * 4 * r.numel() + 4 * lw.numel() + 4 * u.numel()
                  + 4 * b * h * hd * hd)
        ops = 4 * hd * hd * b * s * h
        t_b, t_o = (nbytes / HBM_BYTES_PER_S * 1e3,
                    ops / PEAK_OPS["float32"] * 1e3)
        key = f"r={list(r_shape)}"
        times["wkv6"][key] = dict(
            ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=None,
            bound_ms=max(t_b, t_o),
            bound_by="bytes" if t_b >= t_o else "operations", bytes=nbytes,
            operations=ops, launches=n)
        print(f"time wkv6 {key}: kernel {k_ms!r} ms (device {k_dev!r} ms), "
              f"plain {p_ms!r} ms, bound {max(t_b, t_o)!r} ms "
              f"({times['wkv6'][key]['bound_by']}, {nbytes} B, {ops} "
              f"operations), {n} launches", flush=True)
    for ((la_shape, _), _), n in rec[RG_ARCH]["log_shapes"]["rglru"].items():
        la = -torch.rand(la_shape, device="cuda") * 0.1 - 1e-3
        bb = torch.randn(la_shape, device="cuda")

        def launch_one():
            mods["rglru"].rglru_fwd(la, bb)

        k_ms = time_ms(torch, launch_one, 20)
        k_dev = device_ms(torch, launch_one, reps=20)
        p_ms = time_ms(torch, lambda: refs["rglru"].reference_rglru(la, bb),
                       1, rounds=5)
        nbytes = 3 * 4 * la.numel()
        ops = 3 * la.numel()
        t_b, t_o = (nbytes / HBM_BYTES_PER_S * 1e3,
                    ops / PEAK_OPS["float32"] * 1e3)
        key = f"x={list(la_shape)}"
        times["rglru"][key] = dict(
            ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=None,
            bound_ms=max(t_b, t_o),
            bound_by="bytes" if t_b >= t_o else "operations", bytes=nbytes,
            operations=ops, launches=n)
        print(f"time rglru {key}: kernel {k_ms!r} ms (device {k_dev!r} ms), "
              f"plain {p_ms!r} ms, bound {max(t_b, t_o)!r} ms "
              f"({times['rglru'][key]['bound_by']}, {nbytes} B), {n} "
              f"launches", flush=True)
    for ((q_shape, k_shape, _), kw), n in \
            rec[RG_ARCH]["log_shapes"]["flash"].items():
        times["flash"].update(time_flash(
            torch, mods["flash"], flash_ref, q_shape, k_shape,
            rec[RG_ARCH]["q_heads"], dict(kw)["window"], n))
    return times


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"the repro_torch package is not at {SRC}; run from the root "
             "of a checkout")
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.kernels import _build
    from repro_torch.kernels.assembly import kernel as asm_kernel
    from repro_torch.kernels.assembly import ops as asm_ops
    from repro_torch.kernels.assembly import ref as asm_ref
    from repro_torch.kernels.ccm_scorer import kernel, launch, ref
    from repro_torch.kernels.flash import kernel as flash_kernel
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import ref as flash_ref
    from repro_torch.kernels.moe_gemm import kernel as gemm_kernel
    from repro_torch.kernels.moe_gemm import ops as gemm_ops
    from repro_torch.kernels.moe_gemm import ref as gemm_ref
    from repro_torch.kernels.rglru import kernel as rglru_kernel
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.kernels.rglru import ref as rglru_ref
    from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6 import ref as wkv_ref

    # 1. versions and the card
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}, capability "
          f"{torch.cuda.get_device_capability(0)}", flush=True)
    card = card_line()
    print(f"card: {card}", flush=True)
    # 2. build the seven kernel sources, one nvcc each, in parallel
    t0 = time.perf_counter()
    kernel_mods = (kernel, asm_kernel, flash_kernel, gemm_kernel, wkv_kernel,
                   rglru_kernel)
    reports = _build.compile_sources([m.SOURCE for m in kernel_mods]
                                     + [flash_kernel.BWD_SOURCE],
                                     verbose=True)
    libs = [m.build() for m in kernel_mods]
    for source, report in reports.items():
        print(f"nvcc {source.name}:\n{report}", flush=True)
        spills = [line.strip() for line in report.splitlines()
                  if any(int(n) for n in re.findall(
                      r"(\d+) bytes spill (?:stores|loads)", line))]
        if spills:
            fail(f"ptxas spills registers in {source.name}: {spills}")
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{[str(lib.relative_to(ROOT)) for lib in libs]}", flush=True)
    # 3. the kernel against its plain version
    rng = np.random.default_rng(0)
    worst = check_kernel(torch, kernel, ref, rng)
    pair_worst = check_pair_kernel(torch, kernel, launch, ref, rng)
    spec_worst, spec_rows, fleet_rows, spec_lanes, spec_p = \
        check_spec_kernel(torch, kernel, launch, ref)
    # 4. the main path (launch counts zeroed inside, per run), then through
    # the speculative driver, and the fleet
    mp = main_path(torch, kernel, launch)
    sp = spec_path(torch, kernel, launch, mp.pop("f64_cpu_run"))
    fleet = fleet_path(torch, kernel, launch)
    # 4c / 4d. the pipeline and the async balancer (counts zeroed inside)
    pipe = pipeline_path(torch, kernel, launch)
    asy = async_path(torch, kernel, launch, mp.pop("f64_cuda_run"))
    # 4e / 4f. the MILP certification and the three planners (counts
    # zeroed inside, per run and per plan)
    t0 = time.perf_counter()
    milp = milp_path(torch, kernel, launch)
    milp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    planners = planner_path(torch, kernel, launch)
    planner_s = time.perf_counter() - t0
    print(f"milp_path {milp_s:.1f} s, planner_path {planner_s:.1f} s",
          flush=True)
    # 5. the assembly application (launch counts zeroed inside, per run)
    asm_worst = check_assembly_kernel(torch, asm_ops, asm_ref, rng)
    asm = assembly_path(torch, asm_kernel, asm_ref, kernel, launch)
    # 6. serving qwen3-moe-30b-a3b (launch counts zeroed inside)
    flash_worst = check_flash_kernel(torch, flash_ops, flash_ref, rng)
    gemm_worst = check_gemm_kernel(torch, gemm_ops, gemm_ref, rng)
    serve_mods = {"wkv6": wkv_kernel, "rglru": rglru_kernel,
                  "flash": flash_kernel, "gemm": gemm_kernel}
    serve = serve_path(torch, serve_mods)
    gc.collect()
    torch.cuda.empty_cache()
    # 7. serving rwkv6-7b and recurrentgemma-9b (launch counts zeroed
    # inside); each model is freed before the next
    wkv_worst = check_wkv6_kernel(torch, wkv_ops, wkv_ref, rng)
    rglru_worst = check_rglru_kernel(torch, rglru_ops, rglru_ref, rng)
    rec = {}
    for arch, prompt, want, cut, check_lens in REC_SERVES:
        rec[arch] = serve_recurrent(torch, arch, prompt, want, cut,
                                    check_lens, serve_mods)
        gc.collect()
        torch.cuda.empty_cache()
    # 7b. training qwen3-moe-30b-a3b (launch counts zeroed inside)
    t0 = time.perf_counter()
    flash_bwd_worst = check_flash_bwd(torch, flash_kernel, flash_ops,
                                      flash_ref)
    gemm_bwd_worst = check_gemm_bwd(torch, gemm_kernel, gemm_ops, gemm_ref)
    train_check = train_card_vs_cpu(torch)
    gc.collect()
    torch.cuda.empty_cache()
    train = train_path(torch, serve_mods)
    gc.collect()
    torch.cuda.empty_cache()
    train_times = time_train_kernels(torch, flash_kernel, flash_ref,
                                     gemm_kernel, gemm_ref,
                                     train["launches_per_step"])
    train_s = time.perf_counter() - t0
    print(f"train phase {train_s:.1f} s", flush=True)
    # 8. times at the main paths' shapes, and where the time goes
    times = time_kernel(torch, kernel, ref, rng, mp["shapes"])
    pair_times = time_pairs(torch, kernel, ref, launch, rng,
                            mp["pair_shapes"])
    # the window kernel at the shape the spec runs launched most, and at
    # spec32's and the fleet's most launched
    spec_at = [sp["shapes"].most_common(1)[0] + (spec_rows,)]
    for top, raws in ((sp["runs"]["spec32 scan/disjoint"]["top_shapes"],
                       spec_rows), (fleet["top_shapes"], fleet_rows)):
        spec_at.append((tuple(top[0][0]), top[0][1], raws))
    spec_by_shape = {}
    for shape, n_main, raws in spec_at:
        t = time_spec(torch, kernel, ref, launch, shape, n_main, raws,
                      spec_lanes, spec_p)
        spec_by_shape.setdefault(t["shape"], t)
    spec_times = next(iter(spec_by_shape.values()))
    floor = launch_floor(torch)
    asm_times = time_assembly_kernel(torch, asm_ops, asm_ref, asm)
    serve_times = time_serve_kernels(torch, flash_kernel, flash_ref,
                                     gemm_kernel, gemm_ref, serve)
    rec_times = time_recurrent_kernels(
        torch, serve_mods, {"wkv6": wkv_ref, "rglru": rglru_ref}, flash_ref,
        rec, rng)
    prof = profile_main_path(torch, kernel)
    prof_spec = profile_spec_path(torch, kernel)

    # 9. imports, then the result
    import repro_torch
    for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        importlib.import_module(mod.name)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if bad:
        fail(f"imported JAX or the JAX package: {bad[:5]}")
    kernels = []
    for name in ("float64", "float32"):
        short = "f64" if name == "float64" else "f32"
        shape, _ = mp["pair_shapes"][name].most_common(1)[0]
        key = "E={},A={},B={},P={}".format(*shape)
        m = pair_times[name][key]
        by_path = {"ccm_lb_256": mp["launches"][name],
                   "assembly": asm["scorer_launches"]
                   if name == "float64" else 0}
        if name == "float64":
            by_path.update({f"pipeline_256 {k}": v["launches"]
                            for k, v in pipe.items()
                            if isinstance(v, dict) and v["kernel"] == "pair"})
            by_path.update({f"async {k}": v["launches"]
                            for k, v in asy.items()})
            by_path.update({f"milp delta {k}": v["pair_launches"]
                            for k, v in milp.items()})
            by_path.update({f"planner {k}": v["launches"]
                            for k, v in planners.items()
                            if isinstance(v, dict) and v["kernel"] == "pair"})
            by_path["re-placement plan"] = serve["replacement"][
                "pair_launches"]
        kernels.append({
            "name": f"ccm_scorer_pairs_{short}", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": pair_worst[name],
            "ms": m["ms"], "device_ms": m["device_ms"],
            "host_ms": m["host_ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None,
            "library_note": "no PyTorch call scores and combines CCM "
            "exchange pairs", "shape": key, "by_shape": pair_times[name],
        })
        # the full-tile kernel: held to its plain version, no longer on
        # the main path (main_path and assembly_path fail on a launch)
        shape, _ = mp["shapes"][name].most_common(1)[0]
        key = "E={},A={},B={}".format(*shape)
        m = times[name][key]
        kernels.append({
            "name": f"ccm_scorer_{short}",
            "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": 0,
            "launches_by_path": {"ccm_lb_256": 0, "assembly": 0},
            "max_abs_err": worst[name],
            "ms": m["ms"], "device_ms": m["device_ms"],
            "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None, "shape": key, "by_shape": times[name],
        })
    spec_by_path = {"ccm_lb_256_spec": sp["launches"],
                    f"fleet_{FLEET_N}": fleet["launches"],
                    "async": sum(v["spec_launches"] for v in asy.values())}
    spec_by_path.update({f"pipeline_256 {k}": v["launches"]
                         for k, v in pipe.items()
                         if isinstance(v, dict) and v["kernel"] == "window"})
    spec_by_path.update({f"planner {k}": v["launches"]
                         for k, v in planners.items()
                         if isinstance(v, dict) and v["kernel"] == "window"})
    kernels.append({
        "name": "ccm_scorer_spec_f64", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": SPEC_REPLACES,
        "launches": sum(spec_by_path.values()),
        "launches_by_path": spec_by_path, "max_abs_err": spec_worst,
        "ms": spec_times["ms"], "device_ms": spec_times["device_ms"],
        "host_ms": spec_times["host_ms"], "plain_ms": spec_times["plain_ms"],
        "bound_ms": spec_times["bound_ms"],
        "bound_by": spec_times["bound_by"], "library_ms": None,
        "library_note": "no PyTorch call scores a CCM window",
        "shape": spec_times["shape"], "by_shape": spec_by_shape,
    })
    key = max(asm_times, key=lambda k: asm_times[k]["quad_order_launches"])
    m = asm_times[key]
    kernels.append({
        "name": "assembly_tile_f32", "route": "cuda", "source": ASM_SOURCE,
        "replaces": ASM_REPLACES, "launches": asm["launches"],
        "launches_by_path": {"assembly": asm["launches"]},
        "max_abs_err": max(asm_worst, asm["real_task_max_abs_err"]),
        "ms": m["ms"], "device_ms": m["device_ms"], "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
        "library_ms": None, "shape": key, "by_shape": asm_times,
    })
    serve_times["flash"].update(rec_times["flash"])
    flash_by_path = {f"serve_{SERVE_ARCH}": serve["launches"]["flash"][
        "bfloat16"], f"serve_{RG_ARCH}": rec[RG_ARCH]["launches"]["flash"][
        "bfloat16"], f"re-placement_{SERVE_ARCH}": serve["replacement"][
            "launches"]["flash"], f"train_{TRAIN_ARCH}": train["launches"][
                "flash"]["bfloat16"]}
    for name, key, worst_err, source, replaces, by_path in (
            ("flash_attention_bf16", "flash", flash_worst, FLASH_SOURCE,
             FLASH_REPLACES, flash_by_path),
            ("expert_gemm_bf16", "gemm", gemm_worst, GEMM_SOURCE,
             GEMM_REPLACES, {f"serve_{SERVE_ARCH}": serve["launches"][
                 "gemm"]["bfloat16"], f"re-placement_{SERVE_ARCH}":
                 serve["replacement"]["launches"]["gemm"],
                 f"train_{TRAIN_ARCH}": train["launches"]["gemm"][
                     "bfloat16"]})):
        by_shape = serve_times[key]
        shape = max(by_shape, key=lambda k: by_shape[k]["launches"])
        m = by_shape[shape]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": worst_err["bfloat16"],
            "max_abs_err_float32": worst_err["float32"],
            "max_abs_err_bf16_p": worst_err.get("bfloat16_p"),
            "ms": m["ms"], "device_ms": m["device_ms"],
            "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "shape": shape,
            "by_shape": by_shape,
        })
    for name, key, dtype, arch, worst_bf16, worst_f32, source, replaces in (
            ("wkv6_bf16", "wkv6", "bfloat16", RWKV_ARCH,
             wkv_worst["bfloat16"]["y"], wkv_worst["float32"]["y"],
             WKV_SOURCE, WKV_REPLACES),
            ("rglru_f32", "rglru", "float32", RG_ARCH,
             rglru_worst["bfloat16"], rglru_worst["float32"], RGLRU_SOURCE,
             RGLRU_REPLACES)):
        by_shape = rec_times[key]
        shape = max(by_shape, key=lambda k: by_shape[k]["launches"])
        m = by_shape[shape]
        n = rec[arch]["launches"][key][dtype]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n,
            "launches_by_path": {f"serve_{arch}": n},
            "max_abs_err": worst_bf16 if dtype == "bfloat16" else worst_f32,
            "max_abs_err_bfloat16": worst_bf16,
            "max_abs_err_float32": worst_f32,
            "ms": m["ms"], "device_ms": m["device_ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes "
            + ("a data-dependent-decay WKV" if key == "wkv6"
               else "a linear recurrence"),
            "shape": shape, "by_shape": by_shape,
        })
    kernels[-2]["max_abs_err_state"] = {k: v["state"]
                                        for k, v in wkv_worst.items()}
    for name, key, source, replaces, note, worst_bf16, worst_f32 in (
            ("flash_attention_bwd_bf16", "flash_bwd", FLASH_BWD_SOURCE,
             FLASH_BWD_REPLACES, "no TPU kernel: the JAX package "
             "differentiates its jnp attention (_sdpa); this is the "
             "gradient of the forward kernel (row 5)",
             flash_bwd_worst["bfloat16"]["abs"],
             flash_bwd_worst["float32"]["abs"]),
            ("expert_gemm_bwd_bf16", "gemm_bwd", GEMM_SOURCE,
             GEMM_BWD_REPLACES, "no TPU kernel: the JAX package "
             "differentiates its per-expert jnp products; dX and dW are two "
             "launches of the forward kernel (row 4) on transposed copies",
             gemm_bwd_worst["bfloat16"], gemm_bwd_worst["float32"])):
        by_shape = train_times[key]
        shape = next(iter(by_shape))
        m = by_shape[shape]
        n = train["launches"][key]["bfloat16"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "replaces_note": note, "launches": n,
            "launches_by_path": {f"train_{TRAIN_ARCH}": n},
            "max_abs_err": worst_bf16, "max_abs_err_float32": worst_f32,
            "ms": m["ms"], "device_ms": m["device_ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "shape": shape, "by_shape": by_shape,
        })
    kernels[-2]["max_rel_err"] = {k: v["rel"]
                                  for k, v in flash_bwd_worst.items()}
    print(json.dumps({"serve": {k: v for k, v in serve.items()
                                if k != "log_shapes"}}), flush=True)
    print(json.dumps({"serve_recurrent": {
        arch: {k: v for k, v in r.items() if k != "log_shapes"}
        for arch, r in rec.items()}}), flush=True)
    print(json.dumps({"main_path": mp["runs"],
                      "device_idle_share": prof["device_idle_share"]}),
          flush=True)
    print(json.dumps({"spec_path": sp["runs"], "fleet": fleet,
                      "spec_device_idle_share": prof_spec[
                          "device_idle_share"],
                      "spec_device_idle_share_bounds": prof_spec[
                          "device_idle_share_bounds"]}), flush=True)
    print(json.dumps({"pipeline_path": pipe, "async_path": asy}),
          flush=True)
    print(json.dumps({"milp_path": milp, "milp_path_s": milp_s,
                      "planner_path": planners,
                      "planner_path_s": planner_s}), flush=True)
    print(json.dumps({"train": train, "train_card_vs_cpu": train_check,
                      "train_phase_s": train_s}), flush=True)
    print(json.dumps({"assembly": {
        k: v for k, v in asm.items() if k not in ("problems", "signatures")}}),
        flush=True)
    print(json.dumps({"launch_floor": floor}), flush=True)
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
