#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

from the root of a checkout, on a host with one CUDA card, the CUDA toolkit
(nvcc) and PyTorch built for CUDA.  It imports nothing of JAX and nothing of
the JAX package ``repro``.  Phases, each fatal on failure (exit 1, no result
line):

1. Print the python, torch and CUDA versions, the card, and the card's name
   and power limit as nvidia-smi reports them.
2. Build the scorer and assembly-tile kernels (``src/repro_torch/csrc/``)
   from the checkout's sources into ``build/``, one nvcc each, in parallel,
   and print the build seconds and ptxas's report.
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
6. Time the kernels, their plain versions and their bounds at the shapes
   the main paths launched most (CUDA events, median of repeats), and
   profile one float64 solo main-path run with ``torch.profiler``: device
   time by kernel and copy, and the device's idle share of the run's wall
   time.
7. Import every module of ``repro_torch``, check that no module of JAX or
   ``repro`` was loaded, then print one JSON line of per-run numbers, the
   card line, one JSON line of per-kernel numbers and, as the last line,
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Exits non-zero, printing no result, without a CUDA card or when the
``repro_torch`` package is not beside this script.
"""
from __future__ import annotations

import importlib
import json
import pkgutil
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
    if kernel.LAUNCHES["float64"] != launch.STATS["calls"] \
            or launch.STATS["calls"] == 0:
        fail(f"target, measured: scorer launches {kernel.LAUNCHES} vs "
             f"calls {launch.STATS['calls']}")
    scorer += kernel.LAUNCHES["float64"]
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
    if kernel.LAUNCHES["float64"] != launch.STATS["calls"] \
            or launch.STATS["calls"] == 0:
        fail(f"target, analytic: scorer launches {kernel.LAUNCHES} vs "
             f"calls {launch.STATS['calls']}")
    scorer += kernel.LAUNCHES["float64"]
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


# -------------------------------------------------------------- 6. timing
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


def device_ms(torch, fn, name: str, reps: int = 50) -> float:
    """Mean device time of kernel ``name`` per call of ``fn``, from
    ``torch.profiler`` (the CUDA-event time of back-to-back calls is set by
    the host when a launch takes less than its Python wrapper)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if name in ev.key:
            return device_us(ev) / 1e3 / reps
    return None


def time_assembly_kernel(torch, asm_ops, asm_ref, asm_path) -> dict:
    """Assembly kernel (at the application's 16 x 16 tiles), plain version
    and bound at the signature the path launched most and at (96, 96, 192),
    on a real task's inputs."""
    from repro_torch.assembly.execute import TILE_BLOCK
    sigs = asm_path["signatures"]
    top = sigs.most_common(1)[0][0]
    times = {}
    for sig in (top, (96, 96, 192)):
        problem = next((p for p in asm_path["problems"]
                        if sig in signatures(p)), None)
        if problem is None:
            fail(f"no task of signature {sig} on the assembly path")
        pr, pc, couple = task_inputs(torch, problem, sig)
        nr, nc, q = sig
        def launch_one():
            asm_ops.assembly_tile(pr, pc, couple, quad_order=q,
                                  block_r=TILE_BLOCK, block_c=TILE_BLOCK)

        k_ms = time_ms(torch, launch_one, 200)
        k_dev_ms = device_ms(torch, launch_one, "assembly_tile_kernel")
        p_ms = time_ms(torch, lambda: asm_ref.reference_tile(
            pr, pc, couple, q), 5 if q > 16 else 20)
        nbytes = nr * nc * (4 + 1) + (nr + nc) * 12
        ops = int(couple.sum().item()) * q * ASM_OPS_PER_STEP
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS["float32"] * 1e3
        key = f"rows={nr},cols={nc},Q={q}"
        times[key] = dict(
            ms=k_ms, device_ms=k_dev_ms, plain_ms=p_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes, operations=ops, main_path_tasks=sigs[sig])
        print(f"time assembly_tile {key}: kernel {k_ms!r} ms (device "
              f"{k_dev_ms!r} ms), plain "
              f"{p_ms!r} ms, bound {max(t_bytes, t_ops)!r} ms "
              f"({times[key]['bound_by']}, {nbytes} B, {ops} operations)",
              flush=True)
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
        dev_us = device_us(ev)
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

    from repro_torch.kernels import _build
    from repro_torch.kernels.assembly import kernel as asm_kernel
    from repro_torch.kernels.assembly import ops as asm_ops
    from repro_torch.kernels.assembly import ref as asm_ref
    from repro_torch.kernels.ccm_scorer import kernel, launch, ref

    # 1. versions and the card
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}, capability "
          f"{torch.cuda.get_device_capability(0)}", flush=True)
    card = card_line()
    print(f"card: {card}", flush=True)
    # 2. build both kernels, one nvcc each, in parallel
    t0 = time.perf_counter()
    reports = _build.compile_sources([kernel.SOURCE, asm_kernel.SOURCE],
                                     verbose=True)
    libs = [kernel.build(), asm_kernel.build()]
    for source, report in reports.items():
        print(f"nvcc {source.name}:\n{report}", flush=True)
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{[str(lib.relative_to(ROOT)) for lib in libs]}", flush=True)
    # 3. the kernel against its plain version
    rng = np.random.default_rng(0)
    worst = check_kernel(torch, kernel, ref, rng)
    # 4. the main path (launch counts zeroed inside, per run)
    mp = main_path(torch, kernel, launch)
    # 5. the assembly application (launch counts zeroed inside, per run)
    asm_worst = check_assembly_kernel(torch, asm_ops, asm_ref, rng)
    asm = assembly_path(torch, asm_kernel, asm_ref, kernel, launch)
    # 6. times at the main paths' shapes, and where the time goes
    times = time_kernel(torch, kernel, ref, rng, mp["shapes"])
    asm_times = time_assembly_kernel(torch, asm_ops, asm_ref, asm)
    prof = profile_main_path(torch, kernel)

    # 7. imports, then the result
    import repro_torch
    for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        importlib.import_module(mod.name)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if bad:
        fail(f"imported JAX or the JAX package: {bad[:5]}")
    kernels = []
    for name in ("float64", "float32"):
        shape, _ = mp["shapes"][name].most_common(1)[0]
        key = "E={},A={},B={}".format(*shape)
        m = times[name][key]
        by_path = {"ccm_lb_256": mp["launches"][name],
                   "assembly": asm["scorer_launches"]
                   if name == "float64" else 0}
        kernels.append({
            "name": f"ccm_scorer_{'f64' if name == 'float64' else 'f32'}",
            "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": worst[name],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None, "shape": key, "by_shape": times[name],
        })
    key = next(iter(asm_times))
    m = asm_times[key]
    kernels.append({
        "name": "assembly_tile_f32", "route": "cuda", "source": ASM_SOURCE,
        "replaces": ASM_REPLACES, "launches": asm["launches"],
        "launches_by_path": {"assembly": asm["launches"]},
        "max_abs_err": max(asm_worst, asm["real_task_max_abs_err"]),
        "ms": m["ms"], "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
        "library_ms": None, "shape": key, "by_shape": asm_times,
    })
    print(json.dumps({"main_path": mp["runs"],
                      "device_idle_share": prof["device_idle_share"]}),
          flush=True)
    print(json.dumps({"assembly": {
        k: v for k, v in asm.items() if k not in ("problems", "signatures")}}),
        flush=True)
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
