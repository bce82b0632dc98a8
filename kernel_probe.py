#!/usr/bin/env python3
"""Where the assembly tile's, WKV6's, the CCM scorer call's and the window
kernel's time goes on one GPU.

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

``--steps`` runs only the named steps (``turns`` for step 1, ``tile``,
``wkv6``, ``spec``, ``floor``, ``pipeline``); all by default.  Prints one JSON line of
results, then the card's name and power limit.
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


def cut_variants(source: Path, cuts: dict, tag: str) -> dict:
    """``source`` whole and with each of ``cuts`` applied, each written
    under ``build/kernels/probe/`` (local includes made absolute):
    ``{"whole": path, "without <name>": path, ..., "without all": path}``.
    Exits if a cut's text is not in the source exactly once."""
    from repro_torch.kernels import _build
    text = source.read_text()
    probe_dir = _build.BUILD_DIR / "probe"
    probe_dir.mkdir(parents=True, exist_ok=True)
    for name in {n.decode() for n in _build._LOCAL_INCLUDE.findall(
            text.encode())}:
        text = text.replace(f'#include "{name}"',
                            f'#include "{(source.parent / name).resolve()}"')
    variants, every = {}, []
    for name, pairs in list(cuts.items()) + [("all", None)]:
        pairs = every if pairs is None else pairs
        every = every + list(pairs)
        cut = text
        for was, now in pairs:
            if text.count(was) != 1:
                sys.exit(f"kernel_probe: {source} no longer has the {name} "
                         f"lines this probe cuts: {was!r}")
            cut = cut.replace(was, now)
        variants[f"without {name}"] = cut
    out = {}
    for name, body in [("whole", text)] + list(variants.items()):
        stem = "".join(ch if ch.isalnum() else "_" for ch in name)
        path = probe_dir / f"{source.stem}_{tag}_{stem}.cu"
        path.write_text(body)
        out[name] = path
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


STEPS = ("turns", "tile", "wkv6", "spec", "floor", "pipeline")


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
    print(json.dumps(res), flush=True)
    print(f"card: {cs.card_line()}", flush=True)


if __name__ == "__main__":
    main()
