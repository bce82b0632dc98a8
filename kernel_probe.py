#!/usr/bin/env python3
"""Where the assembly tile's, WKV6's and the CCM scorer call's time goes
on one GPU.

    python3 kernel_probe.py [--parent DIR]

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
4. The card's cost of one empty launch.

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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="another checkout whose kernels to time in "
                        "turns with this one's")
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
    if args.parent is not None:
        parent = args.parent.resolve()
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
    res["tile_lanes"] = tile_lanes(torch, cs, rng)
    res["wkv6_phases"] = wkv6_phases(torch, cs, rng)
    res["empty_launch_device_ms"] = cs.device_ms(
        torch, lambda: torch.cuda._sleep(0), reps=200)
    print(json.dumps(res), flush=True)
    print(f"card: {cs.card_line()}", flush=True)


if __name__ == "__main__":
    main()
