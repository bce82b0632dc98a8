#!/usr/bin/env python3
"""Where the assembly tile's, WKV6's, the CCM scorer call's, the window
kernel's, the RG-LRU scan's and the training backwards' time goes on one
GPU, how well conditioned rwkv6's float32 gradients are, and how flash's
bf16-p check fares on many inputs.

    python3 kernel_probe.py [--parent DIR] [--steps STEP ...]

from the root of a checkout, on a host with one CUDA card (what
``chip_smoke.py`` needs).  It imports nothing of JAX or of ``repro``.
Every time is ``chip_smoke.device_ms`` (launches queued behind a sleep on
the card; in step 1 also the host's time to queue one call), at the
shapes the main paths launch most: the tile at (96, 96) and quad orders
4, 16, 64, 192 on a random mask of 70% coupled entries and the
application's 16 x 16 tiles, WKV6 at (4, 512, 64, 64) in bf16.

1. ``--parent DIR``: DIR holds another checkout (for example ``git archive``
   of the parent commit, unpacked into an ignored directory); its kernels
   and this checkout's are timed in turns, parent, this, this, parent,
   each in a process of its own through the public entry points
   (``ops.assembly_tile``, ``kernel.wkv6_fwd``), on the same inputs; the
   tile also as ``measure_durations`` times a task (host clock around one
   launch and a synchronize).  Then the scorer step, in the same turns:
   the lock events of the 256-rank float64 solo ``ccm_lb`` run (the main
   path's f64 solo run of ``chip_smoke.py``), recorded once through this
   checkout's engine, are replayed through each checkout's
   ``launch.score_events`` (one pass to warm up, one timed), and each
   checkout also drives that run itself; both report the scorer's calls,
   host seconds and their split (``launch.STATS``, where the checkout
   has one).  The replays' results must agree bit for bit across turns.
2. The tile at every power of two of lanes an entry from 1 to 16 (the
   kernel takes any geometry it is given; ``launch_geometry`` picks one),
   and the host's time of the bare C call at the chosen geometry.
3. WKV6 with each phase of its group loop left out (staging, conversion,
   token walk, combine), built from ``csrc/wkv6.cu`` with those lines cut:
   timing only, the results are wrong.
4. The window kernel (``ccm_scorer_spec_f64``) whole and with each of
   its phases left out (``SPEC_CUTS``: the row staging, the scatter, the
   slice sums and features, the pairs, the selection, and all of them;
   for the redesigned kernel also the scatter's runs alone),
   built from each checkout's ``csrc/ccm_scorer.cu`` with those lines
   cut, at the (W, eb) that spec8, spec32 and the fleet launch most
   (``SPEC_SHAPES``; real rows of ``scaling_phase(256)`` and of the
   fleet's first phase), each variant's ``device_ms``.  With ``--parent``
   the parent's variants and this checkout's are timed in turns (parent,
   this, this, parent) in one process; the whole kernels are first held
   to this checkout's plain version, bit for bit.  The cut variants are
   for timing only: their results are wrong.
5. The card's cost of one empty launch.
6. ``chip_smoke.py``'s pipeline (``pipeline_phases()``, ``PIPE_KW``,
   ``CCMParams(delta=1e-9)``, warm with ``reuse_csr``) on the card in
   three variants taken in turns, ABC CBA ABC, after one untimed
   two-phase run: fresh state a phase, ``carry_engine``, and
   ``carry_engine`` with the carried engine's stale version-keyed
   entries (``_blk_cache``, ``_vol_cache``) dropped before each phase.
   Each run reports its wall, phase seconds, ``score``/``commit``
   seconds, the scorer calls' seconds, the collector's seconds and
   full collections (``gc.callbacks``), the live objects the collector
   tracks, and the last engine's ``_blk_cache`` entries; every run must
   equal the first, phase by phase.
7. ``--steps bwd``, the training path's two backwards in bf16 at its
   shapes (``chip_smoke.TRAIN_*``: flash at B·Hq 128, B·Hkv 16, S 512,
   hd 128, causal; the expert GEMM's gate/up and down at C 168): with
   ``--parent``, the parent's and this checkout's public entry points
   (``flash_attention_bwd`` on the forward's output, and its row
   statistics where this checkout's backward takes them;
   ``expert_gemm_bwd``) in turns, parent, this, this, parent, each in a
   process of its own, ``device_ms`` of each; then, for this checkout,
   each backward's kernels by name from ``torch.profiler`` (device ms a
   call), and each of the expert GEMM's backward launches at three block
   counts (one block a tile, one a streaming multiprocessor, two).

8. ``--steps rwkv_grad``: why phase 7d holds rwkv6's card-vs-CPU check
   at 2 x 512 tokens.  ``rwkv6-7b`` cut to 1 layer at full width, float32,
   the same weights (drawn on the card), at 2 x 64 and 2 x 512 tokens:
   every gradient leaf from the card with the WKV6 kernels, the card with
   a plain sequential WKV6 under autograd, the CPU's chunked form (the
   port's CPU path) and the CPU at chunk 1, each pair's largest error over
   the leaf's largest |value|; and, on the CPU, how far each leaf moves
   when every weight changes by one float32 ulp (random sign), its
   conditioning.

9. ``--steps rec_bwd``, the two recurrent backwards at their training
   shapes (``chip_smoke.time_rec_bwd``'s inputs: WKV6 (4, 512, 64, 64) in
   bf16, the RG-LRU (2, 2560, 4096) float32): with ``--parent``, the
   parent's and this checkout's public entry points (``kernel.wkv6_bwd``,
   ``kernel.rglru_bwd``) in turns, parent, this, this, parent, each in a
   process of its own, ``device_ms`` of each; then, for each checkout in
   a process of its own, each backward whole and with each of its phases
   left out (``REC_BWD_CUTS``: WKV6's staging, each role's walk, the
   per-token scalars, the stores and the finish kernel; the RG-LRU's
   loads, its dependent chain and its stores), built from that
   checkout's source with those lines cut, with ptxas's registers and
   spills of the whole kernels.  The cut variants are for timing only:
   their results are wrong.  For the redesigned kernels also the designs
   they were measured against (``REC_BWD_VARIANTS``: the copies issued by
   every warp, no register bound, a head's three roles launched together,
   the token loops unrolled by 2; the RG-LRU's exps of a chunk first, its
   walk fully unrolled), each held to the kernel's results and timed in
   turns with it.

10. ``--steps scan256``, the RG-LRU forward at its three timed shapes
   (``chip_smoke.RGLRU_TIMED``: the serve shape (4, 2560, 4096), the
   training shape (2, 2560, 4096), a 4-rank model axis's (4, 2560, 1024);
   float32) and the flash backward at recurrentgemma's training shape
   (``chip_smoke.RG_TRAIN_ATTN``: B·Hq 32 on B·Hkv 2, S 2560, hd 256,
   causal, window 2048; bf16): with ``--parent``, the parent's and this
   checkout's public entry points (``kernel.rglru_fwd``;
   ``kernel.flash_attention_bwd`` on the forward's output, and its row
   statistics where the checkout's backward takes them) in turns, parent,
   this, this, parent, each in a process of its own, ``device_ms`` of
   each; then, for each checkout in a process of its own, each kernel
   whole and with each of its phases left out (``SCAN256_CUTS``: the
   parent's scan's loads, chain and stores and its backward's three
   kernels; this checkout's chunked scan's loads, walks, carries and
   stores, and its backward's D pass,
   dK/dV, partial-sum and dQ kernels), built from that checkout's source
   with those lines cut, with ptxas's registers and spills of the whole
   kernels.  The cut variants are for timing only: their results are
   wrong.

11. ``--steps flash_p``: phase 8's bf16-p check of the flash forward at
   gemma2-27b's global layer on 12 seeds, against the plain model of the
   kernel's tile walk with its slack (the check), without it, and the
   model that rounds p against each row's final max, at
   ``chip_smoke.FLASH_P_TOL``.  Then the reading that sets the slack
   (``p_flips``): in each head's first ``FLIP_ROWS`` rows (one kv tile,
   few keys, so one p's rounding shows in the output), every p that lies
   within 2^-12 (relatively) of a bf16 midpoint, its distance from the
   midpoint computed in float64, and whether the kernel rounded it the
   other way: the least-squares weight of that flip's effect on the row's
   hd outputs (1 flipped, 0 not) and its standard error; and the check's
   misses at each slack of ``FLASH_P_SLACKS``.

12. ``--steps scan_sweep``: the RG-LRU forward through the public entry
   point (``kernel.rglru_fwd``) at S 2560 across B·W (``SCAN_SWEEP``),
   float32, on the same inputs; with ``--parent``, the parent's and this
   checkout's in turns (parent, this, this, parent), each in a process
   of its own, with the design each picks, the bytes' bound and how far
   the checkouts' sums of h differ.

``--steps`` runs only the named steps (``turns`` for step 1, ``tile``,
``wkv6``, ``spec``, ``floor``, ``pipeline``, ``bwd``, ``rwkv_grad``,
``rec_bwd``, ``scan256``, ``flash_p``, ``scan_sweep``); all by default.
Prints one JSON line of results, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pickle
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
QUADS = (4, 16, 64, 192)
WKV_SHAPE = (4, 512, 64, 64)
# (name, what the source says, what it is replaced by) for each phase of
# WKV6's group loop that a variant leaves out
WKV_CUTS = {
    "staging": ("    if (grp + 1 < n_groups) "
                "stage_group(t0 + TOKENS, buf ^ 1);",
                "    if (false) stage_group(t0 + TOKENS, buf ^ 1);"),
    "conversion": ("    for (int e = tid; e < n * HD; e += THREADS) {\n"
                   "      const int i = e % HD;",
                   "    for (int e = tid; false; e += THREADS) {\n"
                   "      const int i = e % HD;"),
    "token walk": ("    for (int tt = 0; tt < n; ++tt) {\n"
                   "      const float v0",
                   "    for (int tt = 0; false; ++tt) {\n"
                   "      const float v0"),
    "combine": ("    for (int e = tid; e < n * HD; e += THREADS) {\n"
                "      const int tt = e / HD;",
                "    for (int e = tid; false; e += THREADS) {\n"
                "      const int tt = e / HD;"),
}

#: the window kernel's launch shapes, (label, W, eb): the (W, eb) that
#: spec8, spec32 and the fleet launched most (lanes 16, P 32)
SPEC_SHAPES = (("spec8", 8, 256), ("spec32", 16, 512), ("fleet", 64, 1024))
# (name -> (what the source says, what it is replaced by), ...) for each
# phase of the window kernel that a variant leaves out: of the kernel
# before its redesign ("parent") and after it ("this"); a source is told
# apart by its C entry's arguments
SPEC_CUTS = {
    "parent": {
        "staging": (
            ("  for (int i = t; i < 7 * a_n; i += SPEC_THREADS) {",
             "  for (int i = t; false; i += SPEC_THREADS) {"),
            ("  for (int i = t; i < 7 * b_n; i += SPEC_THREADS) {",
             "  for (int i = t; false; i += SPEC_THREADS) {"),
            ("  if (t < N_SC) sc[t] = row[g.o_sc + t];",
             "  if (false) sc[t] = row[g.o_sc + t];"),
            ("  if (t < 4) {\n    cf[CF_ALPHA + t]",
             "  if (false) {\n    cf[CF_ALPHA + t]"),
            ("  } else if (t < N_CF) {", "  } else if (false) {")),
        "scatter": (
            ("  for (int e0 = 0; e0 < eb; e0 += SPEC_CHUNK) {",
             "  for (int e0 = 0; false; e0 += SPEC_CHUNK) {"),),
        "slice sums and features": (
            ("  for (int r = t; r < G; r += SPEC_THREADS) {",
             "  for (int r = t; false; r += SPEC_THREADS) {"),
            ("  for (int c = t; c < a_n; c += SPEC_THREADS) {",
             "  for (int c = t; false; c += SPEC_THREADS) {"),
            ("  for (int c = t; c < b_n; c += SPEC_THREADS) {",
             "  for (int c = t; false; c += SPEC_THREADS) {"),
            ("  if (t < 8) {\n    double f;",
             "  if (false) {\n    double f;")),
        "pairs": (
            ("  for (int p = t; p < p_n; p += SPEC_THREADS) {",
             "  for (int p = t; false; p += SPEC_THREADS) {"),),
        "selection": (
            ("    for (int k = 1; k < p_n; ++k) {",
             "    for (int k = 1; false; ++k) {"),),
    },
    "this": {
        "staging": (
            ("    hopper::mbar_expect_tx(&bars[0], bytes);\n"
             "    hopper::bulk_load(tail, row + g.o_av, bytes, &bars[0]);",
             "    hopper::mbar_arrive(&bars[0]);"),
            ("  hopper::mbar_expect_tx(&bars[1 + s], 2 * bytes);\n"
             "  hopper::bulk_load(dst, row + e0, bytes, &bars[1 + s]);\n"
             "  hopper::bulk_load(dst + SPEC_CHUNK, row + eb + e0, bytes, "
             "&bars[1 + s]);",
             "  hopper::mbar_arrive(&bars[1 + s]);")),
        "scatter": (
            ("    if (owner < SPEC_WARPS) {\n      const int at",
             "    if (false) {\n      const int at"),
            ("    for (int j0 = 0; j0 < cnt; j0 += 32) {",
             "    for (int j0 = 0; false; j0 += 32) {")),
        "scatter's runs": (
            ("    for (int j0 = 0; j0 < cnt; j0 += 32) {",
             "    for (int j0 = 0; false; j0 += 32) {"),),
        "slice sums and features": (
            ("  for (int k = t; k < 4 * gp; k += SPEC_THREADS) {",
             "  for (int k = t; false; k += SPEC_THREADS) {"),
            ("  if (t < 4) {    // f_ab", "  if (false) {    // f_ab")),
        "pairs": (
            ("  for (int p = t; p < p_n; p += SPEC_THREADS) {",
             "  for (int p = t; false; p += SPEC_THREADS) {"),),
        "selection": (
            ("  for (int off = 16; off > 0; off >>= 1) {",
             "  for (int off = 16; false; off >>= 1) {"),),
    },
}


#: the recurrent backwards' training shapes (``chip_smoke.time_rec_bwd``)
REC_WKV_SHAPE, REC_RGLRU_SHAPE = (4, 512, 64, 64), (2, 2560, 4096)
#: ``--steps flash_p``: gemma2-27b's global layer as phase 8 times it (B·Hq
#: 64 on B·Hkv 32, S 4608, hd 128, causal, soft-cap 50), and its seeds
FLASH_P_SHAPE = (64, 32, 4608, 128, dict(causal=True, softcap=50.0))
FLASH_P_SEEDS = 12
#: the rows of each head whose p roundings ``p_flips`` reads (all in the
#: first kv tile), and the distances from a midpoint it bins them by
#: (log2, relative)
FLIP_ROWS, FLIP_BINS = 32, tuple(range(-24, -11))
#: the slacks (log2) at which ``--steps flash_p`` also counts the check's
#: misses
FLASH_P_SLACKS = (-16, -18, -20, -21, -22, -23)
#: ``--steps scan_sweep``: the RG-LRU forward's (B, S, W), float32, from
#: 4096 to 32768 channels (a checkout with the forward's TMA ring picks it
#: from RING_WARPS warps an SM: 3 x 32 x 132 = 12672 channels)
SCAN_SWEEP = ((1, 2560, 4096), (2, 2560, 4096), (3, 2560, 4096),
              (4, 2560, 4096), (5, 2560, 4096), (6, 2560, 4096),
              (8, 2560, 4096), (4, 2560, 1024), (8, 2560, 1024),
              (16, 2560, 1024))
# (kernel -> kind -> name -> ((what the source says, what it is replaced
# by), ...)) for each phase of the recurrent backwards that a variant
# leaves out: of the first designs ("parent", told apart by their source)
# and of the redesigned kernels ("this")
REC_BWD_CUTS = {
    "wkv6": {
        "parent": {
            "staging": (
                ("    for (int e = tid; e < (n + 2) * HD; e += THREADS) {",
                 "    for (int e = tid; false; e += THREADS) {"),),
            "walk 0": (
                ("      for (int tt = 0; tt < n; ++tt) {\n"
                 "        const int row = tt + 1;\n"
                 "        const float* dyt",
                 "      for (int tt = 0; false; ++tt) {\n"
                 "        const int row = tt + 1;\n"
                 "        const float* dyt"),),
            "walk 1": (
                ("      for (int tt = n - 1; tt >= 0; --tt) {\n"
                 "        const int row = tt + 1;\n"
                 "        const int s = t0 + tt;",
                 "      for (int tt = n - 1; false; --tt) {\n"
                 "        const int row = tt + 1;\n"
                 "        const int s = t0 + tt;"),),
            "walk 2": (
                ("      for (int tt = n - 1; tt >= 0; --tt) {\n"
                 "        const int row = tt + 1;\n"
                 "        const float* ks",
                 "      for (int tt = n - 1; false; --tt) {\n"
                 "        const int row = tt + 1;\n"
                 "        const float* ks"),),
            "per-token scalars": (
                ("            pv[x & 1] = __fmaf_rn(pp[x], dd[x], pv[x & 1]);\n"
                 "            vd[x & 1] = __fmaf_rn(tv[x], dd[x], vd[x & 1]);\n",
                 ""),
                ("            pd[x & 1] = __fmaf_rn(nn[x], vv[x], pd[x & 1]);\n"
                 "            vd[x & 1] = __fmaf_rn(vv[x], ss[x], vd[x & 1]);\n",
                 ""),
                ("            bo[x & 1] = __fmaf_rn(__fmul_rn(rr[x], uq[c]), "
                 "kk[x], bo[x & 1]);\n", "")),
            "scattered stores": (
                ("          const size_t g = base + (size_t)(t0 + tt) * stride"
                 " + i;\n          dr[g]",
                 "          const size_t g = base + i;\n          dr[g]"),
                ("          const size_t g = base + (size_t)s * stride + i;",
                 "          const size_t g = base + i;"),
                ("          dv[base + (size_t)(t0 + tt) * stride + j] =",
                 "          dv[base + j] =")),
            "finish": (
                ("  wkv6_bwd_finish<<<", "  if (false) wkv6_bwd_finish<<<"),),
        },
        "this": {
            "staging": (
                ("    if (it + 1 < n_groups) stage_group(grp + step, buf ^ 1);",
                 "    if (false) stage_group(grp + step, buf ^ 1);"),),
            "the copies' wait": (
                ("    cp_async_wait_all();\n    __syncthreads();   // this "
                 "group staged",
                 "    __syncthreads();   // this group staged"),),
            "conversion and scalars": (
                ("    for (int e = tid; e < rows * HD; e += THREADS) {\n"
                 "      ca[e]",
                 "    for (int e = tid; false; e += THREADS) {\n      ca[e]"),
                ("    for (int task = tid; task < (rows * 8 + 31) / 32 * 32; "
                 "task += THREADS) {",
                 "    for (int task = tid; false; task += THREADS) {")),
            "walk 0": (
                ("      for (int tt = 0; tt < n; ++tt) {\n"
                 "        const float* dyt",
                 "      for (int tt = 0; false; ++tt) {\n"
                 "        const float* dyt"),),
            "walk 1": (
                ("      for (int tt = n - 1; tt >= 0; --tt) {\n"
                 "        const float* vs = ca",
                 "      for (int tt = n - 1; false; --tt) {\n"
                 "        const float* vs = ca"),),
            "walk 2": (
                ("      for (int tt = n - 1; tt >= 0; --tt) {\n"
                 "        const float* ks = ca",
                 "      for (int tt = n - 1; false; --tt) {\n"
                 "        const float* ks = ca"),),
            "sums and stores": (
                ("    for (int e = tid; e < n * (HD / ITEM); e += THREADS) {",
                 "    for (int e = tid; false; e += THREADS) {"),),
            "finish": (
                ("  wkv6_bwd_finish<<<", "  if (false) wkv6_bwd_finish<<<"),),
        },
    },
    "rglru": {
        "parent": {
            "loads": (
                ("        la[s] = log_a[at];\n"
                 "        dd[s] = widen(dh[at]);\n"
                 "        hp[s] = t > 0 ? widen(h[at - W]) : 0.0f;",
                 "        la[s] = -1e-3f * s;\n"
                 "        dd[s] = 1.0f;\n"
                 "        hp[s] = 0.5f;"),),
            "chain": (
                ("        g = __fadd_rn(dd[s], __fmul_rn(a_next, g));",
                 "        g = dd[s];"),),
            "stores": (
                ("  float g = 0.0f, a_next = 0.0f;",
                 "  float g = 0.0f, a_next = 0.0f, sink = 0.0f;"),
                ("        db[at] = narrow<T>(g);",
                 "        if (t == 0) db[at] = narrow<T>(g);"),
                ("        dlog_a[at] = __fmul_rn(__fmul_rn(g, a), hp[s]);",
                 "        sink = __fadd_rn(sink, __fmul_rn(__fmul_rn(g, a), "
                 "hp[s]));"),
                ("      }\n    }\n  }\n}\n\ntemplate <typename T>\n"
                 "int launch_bwd(",
                 "      }\n    }\n  }\n  if (sink == 1.2345f) dlog_a[base] = "
                 "sink;\n}\n\ntemplate <typename T>\nint launch_bwd(")),
        },
        "this": {
            "loads": (
                ("    hopper::mbar_expect_tx(&full[st], P::STAGE);\n"
                 "    hopper::tma_load_3d(s, &map_la, &full[st], c0, t0, b);\n"
                 "    hopper::tma_load_3d(s + P::H, &map_h, &full[st], c0, "
                 "t0 - 1, b);\n"
                 "    hopper::tma_load_3d(s + P::DH, &map_dh, &full[st], c0, "
                 "t0, b);",
                 "    hopper::mbar_arrive(&full[st]);"),),
            "chain": (
                ("  g = __fadd_rn(dd, __fmul_rn(a_next, g));", "  g = dd;"),),
            "walk": (
                ("    for (int j = BWD_STEPS - 1; j >= 0; --j) {",
                 "    for (int j = BWD_STEPS - 1; false; --j) {"),),
            "stores": (
                ("      hopper::tma_store_3d(&map_dla, o_dla, c0, t0, b);\n"
                 "      hopper::tma_store_3d(&map_db, o_db, c0, t0, b);\n", ""),),
        },
    },
}

#: (kernel -> name -> ((what the source says, what it is replaced by), ...))
#: designs the redesigned kernels were measured against: each is built
#: from this checkout's source with its lines replaced and timed in turns
#: with the kernel as it is (whole, each variant, then in reverse); their
#: results are held to the whole kernel's within ``REC_BWD_TOL``
REC_BWD_VARIANTS = {
    "wkv6": {
        "copies by every warp": (
            ("    constexpr int HALF = THREADS / 2;\n"
             "    for (int c = tid - HALF + lo * CHUNKS; tid >= HALF && c < "
             "hi * CHUNKS;\n         c += HALF) {",
             "    for (int c = tid + lo * CHUNKS; c < hi * CHUNKS; "
             "c += THREADS) {"),),
        "no register bound": (
            ("__launch_bounds__(Bwd<T, HD>::THREADS, Bwd<T, HD>::MIN_BLOCKS)",
             "__launch_bounds__(Bwd<T, HD>::THREADS)"),),
        "a head's three roles launched together": (
            ("  const int bh = blockIdx.x;\n  const int role = blockIdx.y;\n",
             "  const int bh = blockIdx.x / 3;\n"
             "  const int role = blockIdx.x - 3 * bh;\n"),
            ("  wkv6_bwd_scan<T, HD><<<dim3((unsigned)(B * H), 3), P::THREADS,"
             " P::SMEM,",
             "  wkv6_bwd_scan<T, HD><<<(unsigned)(3 * B * H), P::THREADS, "
             "P::SMEM,")),
        "token loops unrolled by 2": tuple(
            (head, "#pragma unroll 2\n" + head) for head in (
                "      for (int tt = 0; tt < n; ++tt) {\n"
                "        const float* dyt",
                "      for (int tt = n - 1; tt >= 0; --tt) {\n"
                "        const float* vs = ca",
                "      for (int tt = n - 1; tt >= 0; --tt) {\n"
                "        const float* ks = ca")),
    },
    "rglru": {
        "a chunk's exps first": (
            ("#pragma unroll 8\n"
             "    for (int j = BWD_STEPS - 1; j >= 0; --j) {\n"
             "      const int e = j * BWD_CHANNELS + c;\n"
             "      bwd_step(la[e], widen(dd[e]), widen(hp[e]), g, a_next, "
             "o_db + e,\n               o_dla + e);\n    }",
             "    float a[BWD_STEPS];\n"
             "#pragma unroll\n"
             "    for (int j = 0; j < BWD_STEPS; ++j)\n"
             "      a[j] = expf(la[j * BWD_CHANNELS + c]);\n"
             "#pragma unroll\n"
             "    for (int j = BWD_STEPS - 1; j >= 0; --j) {\n"
             "      const int e = j * BWD_CHANNELS + c;\n"
             "      g = __fadd_rn(widen(dd[e]), __fmul_rn(a_next, g));\n"
             "      o_db[e] = narrow<T>(g);\n"
             "      o_dla[e] = __fmul_rn(__fmul_rn(g, a[j]), widen(hp[e]));\n"
             "      a_next = a[j];\n    }"),),
        "the walk fully unrolled": (
            ("#pragma unroll 8\n    for (int j = BWD_STEPS - 1;",
             "#pragma unroll\n    for (int j = BWD_STEPS - 1;"),),
    },
}


def rec_bwd_kind(name: str, text: str) -> str:
    """Which design of a recurrent backward ``text`` (its source) holds."""
    if name == "wkv6":
        return "parent" if "auto stage = [&](int t0, int n) {" in text \
            else "this"
    return "this" if "int stages" in text else "parent"


#: (kernel -> design -> name -> ((what the source says, what it is
#: replaced by), ...)): the phases of the RG-LRU forward and of the hd 256
#: flash backward that a variant of ``--steps scan256`` leaves out, for the
#: design each checkout's source holds (``scan256_kind``): the parent's
#: RG-LRU walk (one thread a channel, loads ahead in registers) and its
#: float32-core backward; this checkout's chunked scan and its tensor-core
#: backward
SCAN256_CUTS = {
    "rglru": {
        "parent": {
            "loads": (("        la[s] = log_a[g];\n"
                       "        bb[s] = widen(b[g]);",
                       "        la[s] = -1e-3f * s;\n        bb[s] = 0.5f;"),),
            "chain": (("        h = __fadd_rn(__fmul_rn(expf(la[s]), h), "
                       "bb[s]);", "        h = bb[s];"),),
            "stores": (("        h_out[base + (size_t)(t0 + s) * W] = "
                        "narrow<T>(h);",
                        "        if (t0 + s == S - 1) h_out[base + (size_t)"
                        "(t0 + s) * W] = narrow<T>(h);"),),
        },
        "chunked": {
            "loads": (("      x[j] = in ? pa[(size_t)j * W] : 0.0f;\n"
                       "      y[j] = in ? widen(pb[(size_t)j * W]) : 0.0f;",
                       "      x[j] = in ? -1e-3f * j : 0.0f;\n"
                       "      y[j] = in ? 0.5f : 0.0f;"),),
            "walks": (("    for (int j = 0; j < SCAN_STEPS; ++j) x[j] = "
                       "expf(x[j]);",
                       "    for (int j = 0; false; ++j) x[j] = expf(x[j]);"),
                      ("      e = __fadd_rn(__fmul_rn(x[j], e), y[j]);\n"
                       "      prod = __fmul_rn(x[j], prod);",
                       "      e = y[j];\n      prod = x[j];"),
                      ("      h = __fadd_rn(__fmul_rn(x[j], h), y[j]);\n"
                       "      if (live && t0 + j < S)",
                       "      h = y[j];\n      if (live && t0 + j < S)")),
            "carries": (("  if (warp == 0 && k + 1 < chunks) {",
                         "  if (false) {"),
                        ("  if (j >= 0 && j < k) {  // chunk",
                         "  if (false) {  // chunk")),
            "stores": (("      if (live && t0 + j < S) out[(size_t)j * W]",
                        "      if (live && t0 + j == S - 1) "
                        "out[(size_t)j * W]"),),
        },
    },
    "flash256": {
        "parent": {
            "prep": (("  prep<<<grid_q, THREADS, smem, stream>>>(",
                      "  if (false) prep<<<grid_q, THREADS, smem, "
                      "stream>>>("),),
            "dK/dV": (("  dkdv<<<grid_kv, THREADS, smem, stream>>>(",
                       "  if (false) dkdv<<<grid_kv, THREADS, smem, "
                       "stream>>>("),),
            "dQ": (("  dqk<<<grid_q, THREADS, smem, stream>>>(",
                    "  if (false) dqk<<<grid_q, THREADS, smem, stream>>>("),),
        },
        "this": {
            "D": (("  bwd_delta_tc<<<(unsigned)((rows + 7) / 8), 256, 0, "
                   "stream>>>(\n      o, dout, delta, (int)rows, sq, sq_pad, "
                   "P::HD);",
                   "  if (false) bwd_delta_tc<<<(unsigned)((rows + 7) / 8), "
                   "256, 0, stream>>>(\n      o, dout, delta, (int)rows, sq, "
                   "sq_pad, P::HD);"),),
            "dK/dV": (("  dkdv<<<(unsigned)((skv + 63) / 64 * bhkv * splits),",
                       "  if (false) dkdv<<<(unsigned)((skv + 63) / 64 * bhkv "
                       "* splits),"),),
            "sum": (("  bwd_dkdv_sum256<<<",
                     "  if (false) bwd_dkdv_sum256<<<"),),
            "dQ": (("  dqk<<<(unsigned)((sq + 127) / 128 * bhq), P::THREADS, "
                    "Dq256::SMEM,",
                    "  if (false) dqk<<<(unsigned)((sq + 127) / 128 * bhq), "
                    "P::THREADS, Dq256::SMEM,"),),
        },
    },
}


def scan256_kind(name: str, text: str) -> str:
    """Which design of the RG-LRU forward or the hd 256 flash backward
    ``text`` (its source) holds: ``parent`` or ``this``."""
    key = "rglru_chunked_kernel" if name == "rglru" else "bwd_dkdv_tc256"
    return "this" if key in text else "parent"


def scan256_inputs(torch, cs):
    """The RG-LRU forward's arguments at ``chip_smoke.RGLRU_TIMED``
    (float32, ``chip_smoke``'s distributions) and the hd 256 flash
    backward's at recurrentgemma's training shape
    (``chip_smoke.RG_TRAIN_ATTN``, bf16: q, k, v, dO), on the card."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    scans = [(-torch.rand(shape, generator=gen, device="cuda") * 0.1 - 1e-3,
              torch.randn(shape, generator=gen, device="cuda"))
             for shape in cs.RGLRU_TIMED]
    b, sq, skv, hq, hkv, hd, *_ = cs.RG_TRAIN_ATTN
    attn = [torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in ((b * hq, sq, hd), (b * hkv, skv, hd),
                                      (b * hkv, skv, hd), (b * hq, sq, hd))]
    return scans, attn


def scan256_times(torch, cs) -> dict:
    """The checkout's (the package on ``sys.path``) RG-LRU forward at
    ``RGLRU_TIMED`` and hd 256 flash backward at ``RG_TRAIN_ATTN`` through
    its public entry points (the backward on the forward's LSE output where
    the checkout's backward takes it): ``device_ms`` of each."""
    from repro_torch.kernels.flash import kernel as fk
    from repro_torch.kernels.rglru import kernel as rk
    scans, (q, k, v, do) = scan256_inputs(torch, cs)
    out = {}
    for la, bb in scans:
        out[f"rglru_fwd x={list(la.shape)}"] = cs.device_ms(
            torch, lambda: rk.rglru_fwd(la, bb), 20)
    *_, causal, window, cap = cs.RG_TRAIN_ATTN
    kw = dict(causal=causal, window=window, softcap=cap)
    lse_kw = {}
    if fk.tc_backward(q.dtype, q.shape[-1]):
        o, lse_kw["lse"] = fk.flash_attention_fwd(q, k, v, with_lse=True,
                                                  **kw)
    else:
        o = fk.flash_attention_fwd(q, k, v, **kw)
    out["flash_bwd hd256"] = cs.device_ms(
        torch, lambda: fk.flash_attention_bwd(q, k, v, o, do, **lse_kw,
                                              **kw), 5)
    return out


def scan256_phases(torch, cs) -> dict:
    """The checkout's RG-LRU forward and hd 256 flash backward whole and
    with each of ``SCAN256_CUTS`` of its design left out, at their timed
    shapes, launched through the C entries as the checkout's wrappers
    launch them: ``device_ms`` of each variant, and
    ptxas's registers and spills of the whole kernels.  The cut variants
    are for timing only: their results are wrong."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash import kernel as fk
    from repro_torch.kernels.rglru import kernel as rk
    scans, (q, k, v, do) = scan256_inputs(torch, cs)
    kinds = {name: scan256_kind(name, src.read_text())
             for name, src in (("rglru", rk.SOURCE),
                               ("flash256", fk.BWD_SOURCE))}
    cuts = SCAN256_CUTS["rglru"]
    design = "parent" if kinds["rglru"] == "parent" else "chunked"
    r_vars = cut_variants(rk.SOURCE, cuts[design], f"s256{design}")
    f_vars = cut_variants(fk.BWD_SOURCE,
                          SCAN256_CUTS["flash256"][kinds["flash256"]],
                          "s256")
    reports = _build.compile_sources([r_vars["whole"], f_vars["whole"]],
                                     verbose=True)
    _build.compile_sources([p for v in (r_vars, f_vars) for p in v.values()])
    out = {"kinds": kinds, "ptxas": {
        path.stem: [line.strip() for line in rep.splitlines()
                    if "registers" in line or "spill" in line]
        for path, rep in reports.items()}}
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for la, bb in scans:
        bsz, s, w = la.shape
        h = torch.empty_like(bb)
        extra, scratch = (), None
        if design == "chunked":
            g = rk.fwd_geometry(bsz, s, w)
            extra = (g.threads, g.chunks, g.steps)
            scratch = torch.empty(g.scratch_bytes, dtype=torch.uint8,
                                  device="cuda")
        for variant, path in r_vars.items():
            fn = _build.load(path).rglru_f32
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * (
                3 + len(extra)) + [ctypes.c_void_p] * (2 if extra else 1)
            args = (la.data_ptr(), bb.data_ptr(), h.data_ptr(), bsz, s, w,
                    *extra) + ((scratch.data_ptr(),) if extra else ())

            def launch():
                if fn(*args, stream) != 0:
                    sys.exit(f"kernel_probe: rglru {variant} failed")
            out[f"rglru_fwd x={[bsz, s, w]} ({design}) {variant}"] = \
                cs.device_ms(torch, launch, 20)
    b, sq, skv, hq, hkv, hd, causal, window, cap = cs.RG_TRAIN_ATTN
    outs = [torch.empty_like(t) for t in (q, k, v)]
    scale = 1.0 / hd ** 0.5
    if kinds["flash256"] == "this":
        o, lse = fk.flash_attention_fwd(q, k, v, with_lse=True,
                                        causal=causal, window=window,
                                        softcap=cap)
        splits = fk.dkdv_splits(b * hq, b * hkv, skv, sms)
        scratch = [torch.empty((b * hq, fk.lse_rows(sq)), device="cuda"),
                   torch.empty((2, splits, b * hkv, skv, hd), device="cuda")]
        name, n_ptr = "flash_attention_bwd_bf16_tc256", 11
        head = (q, k, v, o, do, lse, *outs, *scratch)
        ints = (b * hq, b * hkv, sq, skv, splits, int(causal), int(window))
    else:
        o = fk.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   softcap=cap)
        scratch = [torch.empty((2, b * hq, sq), device="cuda"),
                   torch.empty((b * hq, sq), device="cuda")]
        name, n_ptr = "flash_attention_bwd_bf16", 10
        head = (q, k, v, o, do, *outs, *scratch)
        ints = (b * hq, b * hkv, sq, skv, hd, int(causal), int(window))
    for variant, path in f_vars.items():
        fn = getattr(_build.load(path), name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7 \
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        args = tuple(t.data_ptr() for t in head) + ints + (scale, cap)

        def launch():
            if fn(*args, stream) != 0:
                sys.exit(f"kernel_probe: flash256 {variant} failed")
        out[f"flash_bwd hd256 {variant}"] = cs.device_ms(torch, launch, 5)
    return out


# the RG-LRU forward and the hd 256 flash backward through a checkout's
# public entry points, then whole and with each phase cut, in a process of
# its own
SCAN256_TIMES = r'''
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
import kernel_probe as kp
print(json.dumps(kp.scan256_times(torch, cs)))
'''
SCAN256_PHASES = r'''
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
import kernel_probe as kp
print(json.dumps(kp.scan256_phases(torch, cs)))
'''


# the RG-LRU forward across SCAN_SWEEP through a checkout's public entry
# point, in a process of its own
SCAN_SWEEP_TIMES = r'''
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
import kernel_probe as kp
print(json.dumps(kp.scan_sweep_times(torch, cs)))
'''


# the recurrent backwards at their training shapes through a checkout's
# public entry points, in a process of its own
REC_BWD_TIMES = r'''
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
import kernel_probe as kp
from repro_torch.kernels.rglru import kernel as rk
from repro_torch.kernels.rwkv6 import kernel as wk
w_in, r_in = kp.rec_bwd_inputs(torch, cs)
print(json.dumps({"wkv6_bwd": cs.device_ms(torch, lambda: wk.wkv6_bwd(*w_in),
                                           20),
                  "rglru_bwd": cs.device_ms(torch,
                                            lambda: rk.rglru_bwd(*r_in), 20)}))
'''

# a checkout's recurrent backwards whole and with each phase cut, in a
# process of its own
REC_BWD_PHASES = r'''
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
import kernel_probe as kp
print(json.dumps(kp.rec_bwd_phases(torch, cs)))
'''


# the timed part, run in a process of its own for each checkout
ENTRY_TIMES = r'''
import json, sys, time
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from repro_torch.kernels.assembly import ops as asm_ops
from repro_torch.kernels.rwkv6 import kernel as wkv
rng = np.random.default_rng(0)
out = {}
for q in (4, 16, 64, 192):
    t = cs.tile_inputs(torch, rng, 96, 96)
    def launch():
        asm_ops.assembly_tile(*t, quad_order=q, block_r=16, block_c=16)
    out[f"tile Q={q}"], out[f"tile Q={q} host"] = cs.queued_ms(torch, launch)
    # a task as measure_durations times it: the host clock around one
    # launch and a synchronize (median of 201, in milliseconds)
    spans = []
    for _ in range(201):
        t0 = time.perf_counter()
        launch()
        torch.cuda.synchronize()
        spans.append((time.perf_counter() - t0) * 1e3)
    out[f"tile Q={q} task"] = float(np.median(spans))
x = cs.wkv6_inputs(torch, rng, 4, 512, 64, 64, None, torch.bfloat16)
out["wkv6"], out["wkv6 host"] = cs.queued_ms(torch,
                                             lambda: wkv.wkv6_fwd(*x), 20)
print(json.dumps(out))
'''


# the scorer step, run in a process of its own for each checkout: replay
# the recorded lock events through the checkout's launcher, then drive the
# 256-rank float64 solo run
SCORER_TIMES = r'''
import hashlib, json, pickle, sys, time
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from repro_torch.core import (CCMParams, ccm_lb, initial_assignment,
                              scaling_phase)
from repro_torch.kernels.ccm_scorer import launch
with open(sys.argv[2], "rb") as f:
    events = pickle.load(f)
params, dev = CCMParams(), torch.device("cuda")


def stats(n_calls):
    out = dict(calls=launch.STATS["calls"], seconds=launch.STATS["seconds"],
               call_ms=launch.STATS["seconds"] / n_calls * 1e3)
    split = launch.STATS.get("split")
    if split is not None:
        out["split_call_ms"] = {k: v / n_calls * 1e3
                                for k, v in split.items()}
    return out


out = {}
digest = hashlib.sha256()
for feats, pairs in events:                       # warm-up pass
    for w_a, w_b, feas in launch.score_events(feats, pairs, params,
                                              device=dev,
                                              dtype=torch.float64):
        digest.update(np.ascontiguousarray(w_a).tobytes())
        digest.update(np.ascontiguousarray(w_b).tobytes())
        digest.update(np.ascontiguousarray(feas).tobytes())
launch.reset_stats()
t0 = time.perf_counter()
for feats, pairs in events:
    launch.score_events(feats, pairs, params, device=dev,
                        dtype=torch.float64)
out["replay"] = stats(len(events))
out["replay"]["loop_call_ms"] = (time.perf_counter() - t0) / len(events) * 1e3
out["digest"] = digest.hexdigest()
phase = scaling_phase(256)
a0 = initial_assignment(phase)
launch.reset_stats()
t0 = time.perf_counter()
run = ccm_lb(phase, a0, params, device="cuda", profile=True, **cs.MAIN_KW)
torch.cuda.synchronize()
wall = time.perf_counter() - t0
out["f64_solo"] = stats(launch.STATS["calls"])
out["f64_solo"].update(wall_s=wall, score_stage_s=sum(
    t["score"] for t in run.stage_timings), transfers=run.transfers)
print(json.dumps(out))
'''


# the backwards at the training shapes, run in a process of its own for
# each checkout through its public entry points
BWD_TIMES = r'''
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from repro_torch.kernels.flash import kernel as fk
from repro_torch.kernels.moe_gemm import kernel as gk
out = {}
torch.manual_seed(0)
q, k, v, do = [t.to(torch.bfloat16) for t in (
    torch.randn((cs.TRAIN_BATCH * 32, cs.TRAIN_SEQ, 128), device="cuda"),
    torch.randn((cs.TRAIN_BATCH * 4, cs.TRAIN_SEQ, 128), device="cuda"),
    torch.randn((cs.TRAIN_BATCH * 4, cs.TRAIN_SEQ, 128), device="cuda"),
    torch.randn((cs.TRAIN_BATCH * 32, cs.TRAIN_SEQ, 128), device="cuda"))]
kw = {}
if hasattr(fk, "tc_backward") and fk.tc_backward(q.dtype, q.shape[-1]):
    o, kw["lse"] = fk.flash_attention_fwd(q, k, v, with_lse=True)
else:
    o = fk.flash_attention_fwd(q, k, v)
out["flash_bwd"] = cs.device_ms(
    torch, lambda: fk.flash_attention_bwd(q, k, v, o, do, **kw), 20)
for e, c, d, f in cs.GEMM_BWD_SHAPES[:2]:
    x = torch.randn((e, c, d), device="cuda").to(torch.bfloat16)
    w = (torch.randn((e, d, f), device="cuda") / d ** 0.5).to(torch.bfloat16)
    dy = torch.randn((e, c, f), device="cuda").to(torch.bfloat16)
    out[f"gemm_bwd x={[e, c, d]}"] = cs.device_ms(
        torch, lambda: gk.expert_gemm_bwd(x, w, dy), 20)
print(json.dumps(out))
'''


def run_in(checkout: Path, script: str, *args: str) -> dict:
    """``script`` in a fresh process on ``checkout``'s package; its last
    line of output, as JSON."""
    env = dict(os.environ, PYTHONPATH=str(checkout / "src"))
    proc = subprocess.run([sys.executable, "-c", script, str(ROOT), *args],
                          capture_output=True, text=True, env=env,
                          timeout=600, cwd=checkout)
    if proc.returncode != 0:
        sys.exit(f"kernel_probe: timing {checkout} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def record_scorer_events(path: Path) -> int:
    """Record every ``launch.score_events`` call's (feats, pairs) of the
    256-rank float64 solo run on the card, through this checkout, into
    ``path``; returns the number of calls."""
    import torch

    import chip_smoke as cs
    from repro_torch.core import (CCMParams, ccm_lb, initial_assignment,
                                  scaling_phase)
    from repro_torch.kernels.ccm_scorer import launch
    events, score = [], launch.score_events

    def record(feats, pairs_list, *args, **kw):
        events.append((list(feats), list(pairs_list)))
        return score(feats, pairs_list, *args, **kw)

    phase = scaling_phase(256)
    launch.score_events = record
    try:
        ccm_lb(phase, initial_assignment(phase), CCMParams(), device="cuda",
               **cs.MAIN_KW)
        torch.cuda.synchronize()
    finally:
        launch.score_events = score
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(events, f, protocol=pickle.HIGHEST_PROTOCOL)
    return len(events)


def tile_lanes(torch, cs, rng) -> dict:
    """The tile at 1, 2, 4, 8 and 16 lanes an entry, at each quad order."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.assembly import kernel
    kernel.build()
    out = {}
    for q in QUADS:
        pr, pc, couple = cs.tile_inputs(torch, rng, 96, 96)
        y = torch.empty((96, 96), device="cuda")
        for lanes in (1, 2, 4, 8, 16):
            if lanes > q:
                continue
            geo = kernel.launch_geometry(96, 96, q, 16, 16)
            tile_c = min(16, 256 // lanes)
            tile_r = min(16, 256 // lanes // tile_c)
            slots = tile_r * tile_c
            smem = 4 * (3 * (tile_r + tile_c) + 2 * q
                        + slots * (geo.segment | 1)) + slots
            if smem > _build.MAX_SMEM_BYTES:
                continue
            args = (pr.data_ptr(), pc.data_ptr(), couple.data_ptr(),
                    y.data_ptr(), 96, 96, q, tile_r, tile_c, lanes,
                    geo.segment, -(-slots * lanes // 32) * 32, smem, 0)

            def launch():
                rc = kernel._lib.assembly_tile_f32(
                    *args, torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    sys.exit(f"kernel_probe: tile launch failed ({rc})")
            out[f"Q={q} lanes={lanes}"] = cs.device_ms(torch, launch)
            if lanes == geo.lanes:   # the host's time of the bare C call
                out[f"Q={q} C call host"] = cs.queued_ms(torch, launch)[1]
    return out


def wkv6_phases(torch, cs, rng) -> dict:
    """WKV6 whole and with each phase of its group loop left out."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6 import kernel
    text = kernel.SOURCE.read_text()
    variants = {"whole": kernel.SOURCE}
    probe_dir = _build.BUILD_DIR / "probe"
    probe_dir.mkdir(parents=True, exist_ok=True)
    for name, (was, cut) in WKV_CUTS.items():
        if text.count(was) != 1:
            sys.exit(f"kernel_probe: csrc/wkv6.cu no longer has the {name} "
                     "lines this probe cuts")
        path = probe_dir / f"wkv6_without_{name.replace(' ', '_')}.cu"
        path.write_text(text.replace(was, cut))
        variants[f"without {name}"] = path
    _build.compile_sources(list(variants.values()))
    b, s, h, hd = WKV_SHAPE
    r, k, v, lw, u = cs.wkv6_inputs(torch, rng, b, s, h, hd, None,
                                    torch.bfloat16)
    y = torch.empty_like(r)
    state = torch.empty((b, h, hd, hd), device="cuda")
    geo = kernel.launch_geometry(b, h, hd, torch.bfloat16)
    out = {}
    for name, path in variants.items():
        fn = _build.load(path).wkv6_bf16
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]

        def launch():
            rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
                    u.data_ptr(), y.data_ptr(), state.data_ptr(), b, s, h,
                    hd, geo.threads, geo.smem_bytes,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                sys.exit(f"kernel_probe: wkv6 {name} failed ({rc})")
        out[name] = cs.device_ms(torch, launch, 20)
    return out


def cut_variants(source: Path, cuts: dict, tag: str,
                 label: str = "without", every_cut: bool = True) -> dict:
    """``source`` whole and with each of ``cuts`` applied, each written
    under ``build/kernels/probe/`` (local includes made absolute):
    ``{"whole": path, "<label> <name>": path, ..., "<label> all": path}``
    (the last, all of them, when ``every_cut``).  Exits if a cut's text is
    not in the source exactly once."""
    from repro_torch.kernels import _build
    text = source.read_text()
    probe_dir = _build.BUILD_DIR / "probe"
    probe_dir.mkdir(parents=True, exist_ok=True)
    for name in {n.decode() for n in _build._LOCAL_INCLUDE.findall(
            text.encode())}:
        text = text.replace(f'#include "{name}"',
                            f'#include "{(source.parent / name).resolve()}"')
    variants, every = {}, []
    for name, pairs in list(cuts.items()) + [("all", None)] * every_cut:
        pairs = every if pairs is None else pairs
        every = every + list(pairs)
        cut = text
        for was, now in pairs:
            if text.count(was) != 1:
                sys.exit(f"kernel_probe: {source} no longer has the {name} "
                         f"lines this probe cuts: {was!r}")
            cut = cut.replace(was, now)
        variants[f"{label} {name}"] = cut
    out = {}
    for name, body in [("whole", text)] + list(variants.items()):
        stem = "".join(ch if ch.isalnum() else "_" for ch in name)
        path = probe_dir / f"{source.stem}_{tag}_{stem}.cu"
        path.write_text(body)
        out[name] = path
    return out


def rec_bwd_inputs(torch, cs):
    """The recurrent backwards' arguments at their training shapes, on the
    card: WKV6's (r, k, v, log_w, u, dy) in bf16 (``chip_smoke``'s
    distributions) and the RG-LRU's (log_a, h, dh) float32, h from the
    forward kernel."""
    import numpy as np
    from repro_torch.kernels.rglru import kernel as rk
    rng = np.random.default_rng(23)
    gen = torch.Generator(device="cuda").manual_seed(23)
    b, s, h, hd = REC_WKV_SHAPE
    wkv = cs.wkv6_inputs(torch, rng, b, s, h, hd, None, torch.bfloat16)
    dy = torch.randn(wkv[0].shape, generator=gen, device="cuda").to(
        torch.bfloat16)
    la = -torch.rand(REC_RGLRU_SHAPE, generator=gen, device="cuda") * 0.1 \
        - 1e-3
    hh = rk.rglru_fwd(la, torch.randn(REC_RGLRU_SHAPE, generator=gen,
                                      device="cuda"))
    dh = torch.randn(REC_RGLRU_SHAPE, generator=gen, device="cuda")
    return (*wkv, dy), (la, hh, dh)


def rec_bwd_phases(torch, cs) -> dict:
    """The checkout's (the package on ``sys.path``) two recurrent
    backwards whole and with each of ``REC_BWD_CUTS`` of its design left
    out, at their training shapes: ``device_ms`` of each variant, and
    ptxas's registers and spills of the whole kernels.  For the redesigned
    kernels also ``REC_BWD_VARIANTS``, first held to the whole kernel's
    results within ``chip_smoke.REC_BWD_TOL``, then timed in turns with
    it (``in_turns``: a list of times each)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru import kernel as rk
    from repro_torch.kernels.rwkv6 import kernel as wk
    (r, k, v, lw, u, dy), (la, hh, dh) = rec_bwd_inputs(torch, cs)
    kinds, variants, designs = {}, {}, {}
    for name, source in (("wkv6", wk.BWD_SOURCE), ("rglru", rk.SOURCE)):
        kinds[name] = rec_bwd_kind(name, source.read_text())
        variants[name] = cut_variants(source, REC_BWD_CUTS[name][kinds[name]],
                                      "rec")
        designs[name] = {} if kinds[name] == "parent" else cut_variants(
            source, REC_BWD_VARIANTS[name], "design", "variant", False)
    reports = _build.compile_sources([v["whole"] for v in variants.values()],
                                     verbose=True)
    _build.compile_sources([p for d in (variants, designs)
                            for v in d.values() for p in v.values()])
    out = {"kinds": kinds, "ptxas": {
        path.stem: [line.strip() for line in rep.splitlines()
                    if "registers" in line or "spill" in line]
        for path, rep in reports.items()}}
    stream = torch.cuda.current_stream().cuda_stream
    b, s, h, hd = REC_WKV_SHAPE
    geo = wk.bwd_geometry(b, h, hd, torch.bfloat16) \
        if kinds["wkv6"] == "this" else wk.bwd_geometry(b, h, hd)
    w_out = [torch.empty_like(r) for _ in range(3)] \
        + [torch.empty_like(lw), torch.zeros_like(u)]
    scratch = torch.empty(2 * r.numel() + 2 * b * h * hd,
                          dtype=torch.float32, device="cuda")

    def wkv_launcher(path, label):
        fn = _build.load(path).wkv6_bwd_bf16
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]

        def launch():
            rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
                    u.data_ptr(), dy.data_ptr(), None,
                    *(x.data_ptr() for x in w_out), scratch.data_ptr(), b,
                    s, h, hd, geo.threads, geo.smem_bytes, stream)
            if rc != 0:
                sys.exit(f"kernel_probe: wkv6_bwd {label} failed ({rc})")
        return launch
    bsz, seq, width = REC_RGLRU_SHAPE
    r_out = [torch.empty_like(la), torch.empty_like(la)]
    extra = ()
    if kinds["rglru"] == "this":
        g = rk.bwd_geometry(width, torch.float32)
        extra = (g.threads, g.stages, g.smem_bytes)

    def rglru_launcher(path, label):
        fn = _build.load(path).rglru_bwd_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * (
            3 + len(extra)) + [ctypes.c_void_p]

        def launch():
            rc = fn(la.data_ptr(), hh.data_ptr(), dh.data_ptr(),
                    *(x.data_ptr() for x in r_out), bsz, seq, width, *extra,
                    stream)
            if rc != 0:
                sys.exit(f"kernel_probe: rglru_bwd {label} failed ({rc})")
        return launch
    for name, make, outs in (("wkv6", wkv_launcher, w_out),
                             ("rglru", rglru_launcher, r_out)):
        for variant, path in variants[name].items():
            out[f"{name}_bwd {variant}"] = cs.device_ms(
                torch, make(path, variant), 20)
        if not designs[name]:
            continue
        launchers = {"whole": make(variants[name]["whole"], "whole")}
        launchers["whole"]()
        torch.cuda.synchronize()
        want = [x.clone() for x in outs]
        for variant, path in designs[name].items():
            launchers[variant] = make(path, variant)
            launchers[variant]()
            torch.cuda.synchronize()
            for got, ref in zip(outs, want):
                if cs.rel_err(torch, got, ref) > cs.REC_BWD_TOL[
                        cs.dtype_name(got.dtype)]:
                    sys.exit(f"kernel_probe: {name}_bwd {variant} differs "
                             "from the whole kernel")
        turns = {n: [] for n in launchers}
        for n in list(launchers) + list(launchers)[::-1]:
            turns[n].append(cs.device_ms(torch, launchers[n], 20))
        out[f"{name}_bwd in_turns"] = turns
    return out


def spec_rows(torch, cs, launch) -> dict:
    """Window buffers on the card at each of ``SPEC_SHAPES``: rows of that
    edge bucket from ``scaling_phase(256)``'s first lock events for spec8
    and spec32, the fleet's first phase's first 64 rows (mixed buckets,
    padded to eb as its windows are) for the fleet.  Returns ``{label:
    (buf, eb, lanes, p_n)}``."""
    import numpy as np
    from repro_torch.core import CCMParams, random_phase, scaling_phase
    from repro_torch.kernels.ccm_scorer.layout import spec_offsets
    big, lanes, p_n = cs.spec_capture(scaling_phase(256), CCMParams(), 12,
                                      96)
    fleet, _, _ = cs.spec_capture(random_phase(1000, **cs.FLEET_PHASE),
                                  CCMParams(delta=1e-9), 12, 64)
    out = {}
    for label, w_n, eb in SPEC_SHAPES:
        pool = fleet if label == "fleet" else [r for r in big if r[1] == eb]
        if not pool or max(e for _, e in pool) != eb:
            sys.exit(f"kernel_probe: no captured row of edge bucket {eb}")
        rows = [pool[i % len(pool)] for i in range(w_n)]
        offs = spec_offsets(eb, lanes, lanes, p_n)
        buf = np.zeros((w_n, offs[-1]))
        launch.stack_spec(rows, buf, eb, offs[4])
        out[label] = (torch.from_numpy(buf).cuda(), eb, lanes, p_n)
    return out


def spec_phases(torch, cs, parent) -> dict:
    """The window kernel whole and without each phase, at ``SPEC_SHAPES``,
    of this checkout and (in turns) ``parent``'s."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ccm_scorer import launch, ref
    checkouts = [("this", ROOT)] if parent is None else [
        ("parent", parent), ("this", ROOT), ("this", ROOT),
        ("parent", parent)]
    libs = {}
    for name, path in dict(checkouts).items():
        source = path / "src" / "repro_torch" / "csrc" / "ccm_scorer.cu"
        kind = ("this" if "int p_n, int stride" in source.read_text()
                else "parent")
        libs[name] = (kind, cut_variants(source, SPEC_CUTS[kind], name))
    _build.compile_sources([p for _, v in libs.values() for p in v.values()])
    fns = {}
    for name, (kind, variants) in libs.items():
        for variant, path in variants.items():
            fn = _build.load(path).ccm_scorer_spec_f64
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * (
                6 if kind == "this" else 5) + [ctypes.c_void_p] * 2
            fns[name, variant] = (kind, fn)
    res = {}
    for label, (buf, eb, lanes, p_n) in spec_rows(torch, cs,
                                                 launch).items():
        w_n, row_len = buf.shape
        out = torch.empty((w_n, 4), dtype=torch.float64, device="cuda")
        want = ref.score_spec_rows(buf, lanes, lanes, p_n)

        def call(key):
            kind, fn = fns[key]
            extra = (row_len,) if kind == "this" else ()
            rc = fn(buf.data_ptr(), out.data_ptr(), 0, w_n, eb, lanes, lanes,
                    p_n, *extra, 0, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                sys.exit(f"kernel_probe: window kernel {key} failed ({rc})")
        for name in dict(checkouts):
            call((name, "whole"))
            torch.cuda.synchronize()
            if not cs.same_bits(torch, out, want):
                sys.exit(f"kernel_probe: {name}'s window kernel != the plain "
                         f"version at {label}")
        res[label] = []
        for name, _ in checkouts:
            turn = {"checkout": name}
            for variant in libs[name][1]:
                turn[variant] = cs.device_ms(
                    torch, lambda: call((name, variant)), 50)
            res[label].append(turn)
    return res


def pipeline_turns(torch, cs) -> dict:
    """Step 6: the smoke's pipeline in three variants, in turns."""
    import gc
    import time

    from repro_torch.core import CCMParams, pipeline
    from repro_torch.kernels.ccm_scorer import launch
    phases = cs.pipeline_phases()
    params = CCMParams(delta=1e-9)
    inner = pipeline.ccm_lb
    variant = {"drop": False}

    def dropping(*args, **lb):
        carry = lb.get("carry")
        if variant["drop"] and carry is not None and carry.engine:
            carry.engine._blk_cache.clear()
            carry.engine._vol_cache.clear()
        return inner(*args, **lb)

    gc_acc = {"s": 0.0, "full": 0, "t0": 0.0}

    def on_gc(ph, info):
        if ph == "start":
            gc_acc["t0"] = time.perf_counter()
        else:
            gc_acc["s"] += time.perf_counter() - gc_acc["t0"]
            gc_acc["full"] += info["generation"] == 2

    variants = {"fresh": (False, False), "carry": (True, False),
                "carry, stale dropped": (True, True)}
    order = ["fresh", "carry", "carry, stale dropped"]
    order = order + order[::-1] + order
    pipeline.ccm_lb = dropping
    gc.callbacks.append(on_gc)
    out, first = [], None
    try:
        pipeline.ccm_lb_pipeline(phases[:2], params, device="cuda",
                                 **cs.PIPE_KW)
        for name in order:
            carry, variant["drop"] = variants[name]
            launch.reset_stats()
            gc_acc.update(s=0.0, full=0)
            t0 = time.perf_counter()
            res = pipeline.ccm_lb_pipeline(phases, params, device="cuda",
                                           profile=True, carry_engine=carry,
                                           **cs.PIPE_KW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if first is None:
                first = res
            elif not all(cs.same_run(a.result, b.result)
                         for a, b in zip(res.runs, first.runs)):
                sys.exit(f"kernel_probe: pipeline {name} differs")
            out.append(dict(
                variant=name, wall_s=wall,
                phase_s=[r.seconds for r in res.runs],
                score_s=sum(t["score"] for r in res.runs
                            for t in r.result.stage_timings),
                commit_s=sum(t["commit"] for r in res.runs
                             for t in r.result.stage_timings),
                scorer_calls=launch.STATS["calls"],
                scorer_s=launch.STATS["seconds"],
                gc_s=gc_acc["s"], gc_full=gc_acc["full"],
                gc_objects=len(gc.get_objects()),
                blk_entries=len(res.runs[-1].result.engine._blk_cache)))
            print(f"pipeline {name}: {out[-1]}", flush=True)
            del res
    finally:
        pipeline.ccm_lb = inner
        gc.callbacks.remove(on_gc)
    return {"runs": out}


def bwd_breakdown(torch, cs) -> dict:
    """This checkout's two backwards at the training shapes: each kernel's
    device ms a call by name (``torch.profiler``, ten calls), and each of
    the expert GEMM's backward launches (``plan_bwd``) at three block
    counts (``device_ms``)."""
    from repro_torch.kernels.flash import kernel as fk
    from repro_torch.kernels.moe_gemm import kernel as gk
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    def by_name(fn):
        fn()
        rows = cs.profiled_run(torch, lambda: [fn() for _ in range(10)])
        return {k: r["device_ms"] / r["count"]
                for k, r in rows["by_name"].items()}

    b, s = cs.TRAIN_BATCH, cs.TRAIN_SEQ
    q, k, v, do = (randn(b * 32, s, 128), randn(b * 4, s, 128),
                   randn(b * 4, s, 128), randn(b * 32, s, 128))
    o, lse = fk.flash_attention_fwd(q, k, v, with_lse=True)
    out = {"flash_bwd_kernels": by_name(
        lambda: fk.flash_attention_bwd(q, k, v, o, do, lse=lse))}
    for e, c, d, f in cs.GEMM_BWD_SHAPES[:2]:
        x, w, dy = randn(e, c, d), randn(e, d, f, scale=d ** -0.5), \
            randn(e, c, f)
        key = f"x={[e, c, d]}"
        out[f"gemm_bwd_kernels {key}"] = by_name(
            lambda: gk.expert_gemm_bwd(x, w, dy))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for run in gk.plan_bwd(x, w, dy):
            for n in (0, sms, 2 * sms):
                out[f"gemm_bwd {key} {run.out} blocks {n}"] = cs.device_ms(
                    torch, lambda: gk._launch_tma(run, n), 20)
    return out


def rwkv_grad(torch) -> dict:
    """Step 8: rwkv6's float32 gradient leaves at 1 layer, full width,
    from four computations of WKV6 (the card's kernels, the card's plain
    sequential form, the CPU's chunked form and chunk 1) and their
    one-ulp conditioning on the CPU, at 2 x 64 and 2 x 512 tokens."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.checkpoint import tree_leaves
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels.rwkv6 import ops, ref
    from repro_torch.launch.steps import to_device
    from repro_torch.models.model import build_model

    def plain(r, k, v, log_w, u, chunk=16):
        b, s, h, hd = r.shape
        fold = [t.float().transpose(1, 2).reshape(b * h, s, hd)
                for t in (r, k, v, log_w)]
        return ref.reference_wkv6(*fold[:3], fold[3], u.float().repeat(
            b, 1)).reshape(b, h, s, hd).transpose(1, 2), None

    def chunk_one(r, k, v, log_w, u, chunk=16):
        return chunked(r, k, v, log_w, u, chunk=1)

    def share(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_config("rwkv6-7b"), num_layers=1)
    card_model = build_model(cfg, device="cuda", dtype=torch.float32)
    params = card_model.init(torch.Generator(device="cuda").manual_seed(1))
    cpu_model = build_model(cfg, device="cpu", dtype=torch.float32)
    chunked, wkv = ref.wkv6_chunked, ops.wkv6
    shapes = [list(t.shape) for t in tree_leaves(params)]
    out = {"leaves": shapes}
    for seq in (64, 512):
        batch = make_batch(cfg, seq, 2, 0)

        def grads(model, p):
            leaves = tree_leaves(p)
            for t in leaves:
                t.grad = None
                t.requires_grad_(True)
            loss, _ = model.loss_fn(p, to_device(batch, model.device))
            loss.backward()
            return [t.grad.detach().cpu().clone() for t in leaves]

        cpu_params = _tree_cpu(params)
        runs = {"card kernels": grads(card_model, params)}
        ops.wkv6 = plain
        runs["card plain"] = grads(card_model, params)
        ops.wkv6 = wkv
        runs["cpu chunked"] = grads(cpu_model, cpu_params)
        ref.wkv6_chunked = chunk_one
        runs["cpu chunk 1"] = grads(cpu_model, cpu_params)
        ref.wkv6_chunked = chunked
        names = list(runs)
        pairs = {f"{a} | {b}": [share(x, y) for x, y in zip(runs[a],
                                                           runs[b])]
                 for i, a in enumerate(names) for b in names[i + 1:]}
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for t in tree_leaves(cpu_params):
                if t.numel() > 1000 and t.abs().max() > 0:
                    sign = torch.randint(0, 2, t.shape, generator=gen) * 2 - 1
                    t.mul_(1 + 2.0 ** -23 * sign)
        ulp = [share(x, y) for x, y in zip(grads(cpu_model, cpu_params),
                                            runs["cpu chunked"])]
        out[f"2x{seq}"] = {"pairs": pairs, "one_ulp": ulp}
        worst = {k: max(v) for k, v in pairs.items()}
        print(f"rwkv_grad 2 x {seq}: worst leaf by pair {worst}; one ulp "
              f"moves a leaf by at most {max(ulp)}", flush=True)
        del runs, cpu_params
    return out


def flash_p_seeds(torch, cs) -> dict:
    """Phase 8's bf16-p check of the flash forward at gemma2-27b's global
    layer (``FLASH_P_SHAPE``), on ``FLASH_P_SEEDS`` inputs drawn as phase
    8 draws them (``torch.randn`` in bf16 on the card, here after
    ``torch.manual_seed(seed)``): the kernel against the plain model of
    its tile walk (``ref.reference_attention_bf16_tiles``) with its slack
    (the check: ``tiles``) and without (``tiles_no_slack``), and against
    the model that rounds p against each row's final max
    (``ref.reference_attention_bf16_p``, the check's model until now), each
    at ``chip_smoke.FLASH_P_TOL``: the largest absolute error, the
    elements over the limit, the largest error over its limit, and at
    that element the slack and the keys its row sees; and whether kernel
    and models repeat bit for bit."""
    from repro_torch.kernels.flash import kernel as fk
    from repro_torch.kernels.flash import ref as fr
    bhq, bhkv, s, hd, kw = FLASH_P_SHAPE
    atol, rtol = cs.FLASH_P_TOL["atol"], cs.FLASH_P_TOL["rtol"]
    out = {}
    for seed in range(FLASH_P_SEEDS):
        torch.manual_seed(seed)
        q = torch.randn((bhq, s, hd), dtype=torch.bfloat16, device="cuda")
        k = torch.randn((bhkv, s, hd), dtype=torch.bfloat16, device="cuda")
        v = torch.randn((bhkv, s, hd), dtype=torch.bfloat16, device="cuda")
        got = fk.flash_attention_fwd(q, k, v, **kw).float()
        rec = {"repeats": torch.equal(
            got, fk.flash_attention_fwd(q, k, v, **kw).float())}
        tiles, slack = fr.reference_attention_bf16_tiles(q, k, v, **kw,
                                                         slack=True)
        row_max = fr.reference_attention_bf16_p(q, k, v, **kw)
        rec["tiles_repeats"] = torch.equal(
            tiles, fr.reference_attention_bf16_tiles(q, k, v, **kw))
        rec["row_max_repeats"] = torch.equal(
            row_max, fr.reference_attention_bf16_p(q, k, v, **kw))
        for name, model, sl in (("tiles", tiles, slack),
                                ("tiles_no_slack", tiles, None),
                                ("row_max", row_max, None)):
            err = (got - model).abs()
            share = err / (atol + rtol * model.abs()
                           + (0.0 if sl is None else sl))
            at = int(share.argmax())
            row = (at // hd) % s
            rec[name] = dict(max_abs=err.max().item(),
                             over=int((share > 1).sum().item()),
                             worst_share=share.flatten()[at].item(),
                             worst_slack=slack.flatten()[at].item(),
                             worst_row_keys=row + 1,
                             worst_at=[at // (s * hd), row, at % hd])
            del err, share
        rec["over_by_log2_slack"] = {}
        for e in FLASH_P_SLACKS:
            keep, fr.P_SLACK = fr.P_SLACK, 2.0 ** e
            try:
                model, sl = fr.reference_attention_bf16_tiles(q, k, v, **kw,
                                                              slack=True)
            finally:
                fr.P_SLACK = keep
            rec["over_by_log2_slack"][e] = int(
                ((got - model).abs() - sl - atol - rtol * model.abs() > 0)
                .sum().item())
            del model, sl
        rec["flips"] = p_flips(torch, q, k, v, got, kw)
        bh, row, _ = rec["tiles_no_slack"]["worst_at"]
        rec["worst_row_flips"] = [f for f in rec["flips"]
                                  if f[0] == bh and f[1] == row]
        out[seed] = rec
        print(f"flash_p seed {seed}: "
              f"{ {k: v for k, v in rec.items() if k != 'flips'} }",
              flush=True)
        del q, k, v, got, tiles, slack, row_max
        torch.cuda.empty_cache()
    out["flip_summary"] = flip_summary(
        [f for rec in out.values() for f in rec["flips"]])
    for rec in out.values():
        if "flips" in rec:
            rec["flips"] = len(rec["flips"])
    print(f"flash_p flips: {out['flip_summary']}", flush=True)
    return out


def bf16_neighbours(np, p):
    """The bf16 values either side of each p in (0, 1] (float64, exact),
    and the midpoint between them."""
    e = np.floor(np.log2(p))
    ulp = np.exp2(e - 7)
    lo = np.floor(p / ulp) * ulp
    return lo, lo + ulp, lo + ulp / 2


def p_flips(torch, q, k, v, got, kw) -> list:
    """For each head's rows 1 .. ``FLIP_ROWS`` - 1 (keys 0 .. row, all in
    the first kv tile, so p = 2^(s - the row's max)): every visible p of
    the plain model (``ref.reference_attention_bf16_tiles``' float32
    arithmetic, step for step) within 2^-12 of a bf16 midpoint.  The
    residual of the kernel's row (``got``) against the model's output in
    float64 (each p rounded to its nearest bf16) is fitted, by least
    squares over the hd outputs, with the effects of rounding those p the
    other way ((other - near) v_j / l each).  Returns, for each such p,
    (head, row, log2 of its relative distance |p - midpoint| / p, the
    same with p and the scores in float64, the weight, its standard
    error): a weight near 1 is a p the kernel rounded the other way."""
    import math

    import numpy as np
    from repro_torch.kernels.flash import ref as fr
    bhq, _, hd = q.shape
    group = bhq // k.shape[0]
    n = FLIP_ROWS
    cap = kw.get("softcap", 0.0)
    # the model's first tile, as it computes it
    kf = torch.repeat_interleave(k.float(), group, dim=0)
    sm_scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    sc = torch.einsum("bqd,bkd->bqk", q.float(), kf[:, :fr.KV_TILE])
    if cap > 0.0:
        sc = cap * torch.tanh(sc * sm_scale.item() / cap) * fr.LOG2E
    else:
        sc = sc * (sm_scale * torch.tensor(fr.LOG2E,
                                           dtype=torch.float32)).item()
    sc = sc[:, :n, :n].cpu()
    del kf
    qd = q[:, :n].double().cpu().numpy()
    kd = np.repeat(k[:, :n].double().cpu().numpy(), group, 0)
    vd = np.repeat(v[:, :n].double().cpu().numpy(), group, 0)
    gd = got[:, :n].double().cpu().numpy()
    sd = np.einsum("bqd,bkd->bqk", qd, kd) / math.sqrt(hd)
    if cap > 0.0:
        sd = cap * np.tanh(sd / cap)
    sd = sd * fr.LOG2E
    out = []
    for bh in range(bhq):
        for row in range(1, n):
            s32 = sc[bh, row, :row + 1]
            p = torch.exp2(s32 - s32.max()).double().numpy()
            lo, hi, mid = bf16_neighbours(np, p)
            up = (p > mid) | ((p == mid) & (np.round(lo / (hi - lo)) % 2 == 1))
            near, other = np.where(up, hi, lo), np.where(up, lo, hi)
            dist = np.abs(p - mid) / p
            cand = np.nonzero((dist < 2.0 ** -12) & (p < 1.0))[0]
            if len(cand) == 0:
                continue
            cand = cand[np.argsort(dist[cand])[:6]]
            s64 = sd[bh, row, :row + 1]
            p64 = np.exp2(s64 - s64.max())
            dist64 = np.abs(p64 - mid) / p64
            l = p.sum()
            vr = vd[bh, :row + 1]
            resid = gd[bh, row] - (near[:, None] * vr).sum(0) / l
            eff = (other - near)[cand, None] * vr[cand] / l
            w, *_ = np.linalg.lstsq(eff.T, resid, rcond=None)
            rest = resid - eff.T @ w
            sigma = np.sqrt((rest ** 2).sum() / max(1, hd - len(cand)))
            se = sigma * np.sqrt(np.diag(np.linalg.pinv(eff @ eff.T)))
            out.extend((bh, row, float(np.log2(dist[j])),
                        float(np.log2(dist64[j])), float(wj), float(sj))
                       for j, wj, sj in zip(cand, w, se))
    return out


def flip_summary(flips) -> dict:
    """``p_flips``' p read where a flip shows clearly (standard error
    under 0.2): by bin of log2 distance of the model's p from the midpoint,
    the count and the flipped ones (weight over 0.5); the farthest flip and
    the nearest p not flipped."""
    clear = [f for f in flips if f[5] < 0.2]
    flipped = [f for f in clear if f[4] > 0.5]
    kept = [f for f in clear if f[4] <= 0.5]
    bins = {}
    for lo in FLIP_BINS:
        inside = [f for f in clear if lo <= f[2] < lo + 1
                  or (lo == FLIP_BINS[0] and f[2] < lo)]
        bins[f"[2^{lo}, 2^{lo + 1})"] = [len(inside), sum(
            f[4] > 0.5 for f in inside)]
    return dict(candidates=len(flips), clear=len(clear),
                flipped=len(flipped),
                farthest_flip=max(flipped, key=lambda f: f[2], default=None),
                farthest_flip_float64=max(flipped, key=lambda f: f[3],
                                          default=None),
                nearest_kept=min(kept, key=lambda f: f[2], default=None),
                by_log2_distance=bins)


def scan_sweep_times(torch, cs) -> dict:
    """The checkout's (the package on ``sys.path``) RG-LRU forward through
    its public entry point (``kernel.rglru_fwd``) at each ``SCAN_SWEEP``
    shape, float32, on inputs drawn from one seed: ``device_ms``, the
    design its ``fwd_geometry`` picks (``ring``, ``chunked``, or
    ``parent`` where it has none: one thread a channel), and the float64
    sum of h, which the checkouts' runs must agree on."""
    from repro_torch.kernels.rglru import kernel as rk
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(31)
    out = {}
    for shape in SCAN_SWEEP:
        la = -torch.rand(shape, generator=gen, device="cuda") * 0.1 - 1e-3
        bb = torch.randn(shape, generator=gen, device="cuda")
        # a checkout with the ring picks it from RING_WARPS warps an SM
        ring = getattr(rk, "RING_WARPS", 0)
        design = ("parent" if not hasattr(rk, "fwd_geometry") else "ring"
                  if ring and shape[0] * shape[2] >= ring * 32 * sms
                  else "chunked")
        out[f"x={list(shape)}"] = dict(
            design=design, ms=cs.device_ms(
                torch, lambda: rk.rglru_fwd(la, bb), 20),
            h_sum=rk.rglru_fwd(la, bb).double().sum().item())
        del la, bb
    return out


def scan_sweep(torch, cs, parent) -> dict:
    """:func:`scan_sweep_times` of this checkout, and with ``parent`` of
    both in turns (parent, this, this, parent), each in a process of its
    own; by shape the times in that order, the designs, the bytes' bound,
    and the largest relative difference of the h sums between turns."""
    runs = [("this", ROOT)] if parent is None else [
        ("parent", parent), ("this", ROOT), ("this", ROOT),
        ("parent", parent)]
    turns = [(name, run_in(path, SCAN_SWEEP_TIMES)) for name, path in runs]
    out = {}
    for shape in SCAN_SWEEP:
        key = f"x={list(shape)}"
        sums = [t[key]["h_sum"] for _, t in turns]
        out[key] = dict(
            channels=shape[0] * shape[2],
            designs={name: t[key]["design"] for name, t in turns},
            ms=[[name, t[key]["ms"]] for name, t in turns],
            bound_ms=12 * shape[0] * shape[1] * shape[2]
            / cs.HBM_BYTES_PER_S * 1e3,
            h_sum_rel_diff=(max(sums) - min(sums)) / abs(sums[0]))
        print(f"scan_sweep {key}: {out[key]}", flush=True)
    return out


def _tree_cpu(tree):
    if isinstance(tree, dict):
        return {k: _tree_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_cpu(v) for v in tree]
    return tree.detach().cpu().clone()


STEPS = ("turns", "tile", "wkv6", "spec", "floor", "pipeline", "bwd",
         "rwkv_grad", "rec_bwd", "scan256", "flash_p", "scan_sweep")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="another checkout whose kernels to time in "
                        "turns with this one's")
    parser.add_argument("--steps", nargs="+", choices=STEPS, default=STEPS,
                        help="the steps to run (all by default)")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_probe: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as cs
    rng = np.random.default_rng(0)
    res = {}
    parent = None if args.parent is None else args.parent.resolve()
    if parent is not None and "turns" in args.steps:
        runs = [("parent", parent), ("this", ROOT), ("this", ROOT),
                ("parent", parent)]
        res["in_turns"] = [dict(checkout=name, **run_in(path, ENTRY_TIMES))
                           for name, path in runs]
        from repro_torch.kernels import _build
        events = _build.BUILD_DIR / "probe" / "scorer_events.pkl"
        res["scorer_events"] = record_scorer_events(events)
        res["scorer_in_turns"] = [
            dict(checkout=name, **run_in(path, SCORER_TIMES, str(events)))
            for name, path in runs]
        if len({r["digest"] for r in res["scorer_in_turns"]}) != 1:
            sys.exit("kernel_probe: the checkouts' scorers disagree on the "
                     "recorded events")
    if "tile" in args.steps:
        res["tile_lanes"] = tile_lanes(torch, cs, rng)
    if "wkv6" in args.steps:
        res["wkv6_phases"] = wkv6_phases(torch, cs, rng)
    if "spec" in args.steps:
        res["spec_phases"] = spec_phases(torch, cs, parent)
    if "floor" in args.steps:
        res["empty_launch_device_ms"] = cs.device_ms(
            torch, lambda: torch.cuda._sleep(0), reps=200)
    if "pipeline" in args.steps:
        res["pipeline_turns"] = pipeline_turns(torch, cs)
    if "bwd" in args.steps:
        if parent is not None:
            res["bwd_in_turns"] = [
                dict(checkout=name, **run_in(path, BWD_TIMES))
                for name, path in (("parent", parent), ("this", ROOT),
                                   ("this", ROOT), ("parent", parent))]
        res["bwd_breakdown"] = bwd_breakdown(torch, cs)
    if "rwkv_grad" in args.steps:
        res["rwkv_grad"] = rwkv_grad(torch)
    if "rec_bwd" in args.steps:
        runs = [("this", ROOT)]
        if parent is not None:
            runs = [("parent", parent), ("this", ROOT), ("this", ROOT),
                    ("parent", parent)]
            res["rec_bwd_in_turns"] = [
                dict(checkout=name, **run_in(path, REC_BWD_TIMES))
                for name, path in runs]
        res["rec_bwd_phases"] = {name: run_in(path, REC_BWD_PHASES)
                                 for name, path in dict(runs).items()}
        print(f"rec_bwd: {json.dumps(res['rec_bwd_phases'])}", flush=True)
    if "scan256" in args.steps:
        runs = [("this", ROOT)]
        if parent is not None:
            runs = [("parent", parent), ("this", ROOT), ("this", ROOT),
                    ("parent", parent)]
            res["scan256_in_turns"] = [
                dict(checkout=name, **run_in(path, SCAN256_TIMES))
                for name, path in runs]
            print(f"scan256 in turns: {json.dumps(res['scan256_in_turns'])}",
                  flush=True)
        res["scan256_phases"] = {name: run_in(path, SCAN256_PHASES)
                                 for name, path in dict(runs).items()}
        print(f"scan256: {json.dumps(res['scan256_phases'])}", flush=True)
    if "flash_p" in args.steps:
        res["flash_p"] = flash_p_seeds(torch, cs)
    if "scan_sweep" in args.steps:
        res["scan_sweep"] = scan_sweep(torch, cs, parent)
    print(json.dumps(res), flush=True)
    print(f"card: {cs.card_line()}", flush=True)


if __name__ == "__main__":
    main()
