#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

from the root of a checkout, on a host with one CUDA card, the CUDA toolkit
(nvcc) and PyTorch built for CUDA.  It imports nothing of JAX and nothing of
the JAX package ``repro``.  Phases, each fatal on failure (exit 1, no result
line):

1. Print the python, torch and CUDA versions, the card, and the card's name
   and power limit as nvidia-smi reports them.
2. Build the scorer kernel (``src/repro_torch/csrc/ccm_scorer.cu``) from the
   checkout's sources into ``build/`` and print the build seconds.
3. Hold the kernel against its plain torch version on the card: float64 and
   float32, E in {1, 8, 64}, A, B in {1, 13, 16, 128}, random masks, exact
   equality (``torch.equal``), the masked tail (0 / +inf) and NaN
   propagation.
4. Drive the main path, ``ccm_lb`` with ``n_iter=4, k_rounds=2,
   fanout=4`` on ``device="cuda"``: ``scaling_phase(256)`` (256 ranks, 6400
   tasks, 12,799 comm edges) in float64 solo, float64 with
   ``batch_lock_events=8`` and float32 with ``batch_lock_events=8``, and a
   memory-binding phase (the same shape with a 2.4e8-byte cap) in float64
   solo.  Each run is held against the port's own ``device="cpu"`` run
   (identical assignment, transfer log, transfers and max_work), and its
   kernel launches (counted from zero just before the run, read just after)
   must equal its scorer calls and be more than zero.  A 16-rank run is also
   held against the port's scalar reference path (``use_engine=False``),
   which never calls the scorer.  The launched (E, A, B) shapes are
   recorded.
5. Time the kernel, its plain version and its bound at the shapes the main
   path launched most (CUDA events, median of repeats), and profile one
   float64 solo main-path run with ``torch.profiler``: device time by
   kernel and copy, and the device's idle share of the run's wall time.
6. Check that no module of JAX or ``repro`` was loaded, then print one JSON
   line of per-run numbers, the card line, one JSON line of per-kernel
   numbers and, as the last line,
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Exits non-zero, printing no result, without a CUDA card or when the
``repro_torch`` package is not beside this script.
"""
from __future__ import annotations

import json
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
PEAK_OPS = {"float64": 34e12, "float32": 67e12}
# operations per (ia, ib) lane of the scorer: 106 adds, subtractions and
# maxima plus the two mask compares (csrc/ccm_scorer.cu); selects not counted
OPS_PER_LANE = 108
MAIN_KW = dict(n_iter=4, k_rounds=2, fanout=4)
KERNEL_SOURCE = "src/repro_torch/csrc/ccm_scorer.cu"
REPLACES = "src/repro/kernels/ccm_scorer/kernel.py:35"


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
    n16 = kernel.LAUNCHES["float64"]
    if not same_run(scalar, eng):
        fail("16 ranks: cuda engine run differs from the scalar reference")
    if n16 == 0 or n16 != launch.STATS["calls"]:
        fail(f"16 ranks: {n16} launches vs {launch.STATS['calls']} calls")
    launches["float64"] += n16
    shapes["float64"].update(launch.STATS["shapes"])
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
        n_launch = dict(kernel.LAUNCHES)
        calls = launch.STATS["calls"]

        if not same_run(gpu, cpu):
            fail(f"{label}: cuda run differs from the cpu run")
        if n_launch[name] == 0 or n_launch[name] != calls \
                or calls != cpu_calls:
            fail(f"{label}: kernel launches {n_launch} vs scorer calls "
                 f"{calls} (cpu run {cpu_calls})")
        if sum(n_launch.values()) != n_launch[name]:
            fail(f"{label}: launches of the other dtype {n_launch}")
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
        if name == "float32" and not np.array_equal(gpu.assignment,
                                                    f64_assignment):
            fail(f"{label}: float32 assignment differs from float64")
        launches[name] += n_launch[name]
        shapes[name].update(launch.STATS["shapes"])
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
            top_shapes=[[list(k), v] for k, v
                        in launch.STATS["shapes"].most_common(5)])
        print(f"{label}: identical to cpu; {gpu.transfers} transfers, "
              f"{calls} scorer calls = {n_launch[name]} launches; max_work "
              f"{float(mw[0])!r} -> {float(mw[-1])!r}"
              + (f"; ranks over the cap {over[0]} -> {over[1]}"
                 if over else "")
              + f"; wall cuda {gpu_s:.3f} s, cpu {cpu_s:.3f} s", flush=True)
    return dict(launches=launches, shapes=shapes, runs=runs)


# -------------------------------------------------------------- 5. timing
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
            p_ms = time_ms(torch, lambda: ref.score_tiles(*t), 20)
            b_ms, b_by, nbytes = bound(name, e_n, a_n, b_n)
            key = f"E={e_n},A={a_n},B={b_n}"
            times.setdefault(name, {})[key] = dict(
                ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes, main_path_launches=shapes[name][(e_n, a_n,
                                                               b_n)])
            print(f"time {name} {key}: kernel {k_ms!r} ms, plain {p_ms!r} "
                  f"ms, bound {b_ms!r} ms ({b_by}, {nbytes} B)", flush=True)
    return times


def profile_main_path(torch, kernel) -> dict:
    """Device time of one float64 solo main-path run, by kernel and copy,
    and the device's idle share of the run's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (CCMParams, ccm_lb, initial_assignment,
                                  scaling_phase)
    phase = scaling_phase(256)
    a0 = initial_assignment(phase)
    kernel.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ccm_lb(phase, a0, CCMParams(), device="cuda", **MAIN_KW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if dev_us:
            rows[ev.key] = dict(count=ev.count, device_ms=dev_us / 1e3)
    busy_ms = sum(r["device_ms"] for r in rows.values())
    out = dict(wall_s=wall, launches=kernel.LAUNCHES["float64"],
               device_busy_ms=busy_ms,
               device_idle_share=(1.0 - busy_ms / 1e3 / wall)
               if busy_ms else None, by_name=rows)
    print(json.dumps({"profile": out}), flush=True)
    return out


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

    from repro_torch.kernels.ccm_scorer import kernel, launch, ref

    # 1. versions and the card
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}, capability "
          f"{torch.cuda.get_device_capability(0)}", flush=True)
    card = card_line()
    print(f"card: {card}", flush=True)
    # 2. build
    t0 = time.perf_counter()
    lib = kernel.build(verbose=True)
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{lib.relative_to(ROOT)}", flush=True)
    # 3. the kernel against its plain version
    rng = np.random.default_rng(0)
    worst = check_kernel(torch, kernel, ref, rng)
    # 4. the main path (launch counts zeroed inside, per run)
    mp = main_path(torch, kernel, launch)
    # 5. times at the main path's shapes, and where the time goes
    times = time_kernel(torch, kernel, ref, rng, mp["shapes"])
    prof = profile_main_path(torch, kernel)

    # 6. imports, then the result
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if bad:
        fail(f"imported JAX or the JAX package: {bad[:5]}")
    kernels = []
    for name in ("float64", "float32"):
        shape, _ = mp["shapes"][name].most_common(1)[0]
        key = "E={},A={},B={}".format(*shape)
        m = times[name][key]
        kernels.append({
            "name": f"ccm_scorer_{'f64' if name == 'float64' else 'f32'}",
            "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": mp["launches"][name], "max_abs_err": worst[name],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None, "shape": key, "by_shape": times[name],
        })
    print(json.dumps({"main_path": mp["runs"],
                      "device_idle_share": prof["device_idle_share"]}),
          flush=True)
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
