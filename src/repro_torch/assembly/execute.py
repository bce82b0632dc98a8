"""Task execution: the MoM-analogue tile on the card, with measured
durations (the ground truth the cost model learns — paper §VI-D collects
task data the same way).

Each task computes its tile of the interaction matrix with a regularized
Green's-function quadrature whose depth (``quad_order``) was set by the
near-singularity of the DOF pair — the source of the heavy-tailed costs.
The port's counterpart of ``repro/assembly/execute.py``: :func:`tile_kernel`
is ``kernels.assembly.ops.assembly_tile``, the CUDA kernel on CUDA tensors
and its plain torch version on CPU tensors.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.assembly.problem import AssemblyProblem, AssemblyTask
from repro_torch.kernels.assembly.ops import assembly_tile
from repro_torch.kernels.ccm_scorer.launch import resolve_device

#: the bound on the kernel's tile on the application path: tasks are at
#: most 96 x 96 (``task_limit_u``), and with about sqrt(Q) lanes an entry
#: (``kernel.launch_geometry``) 16 x 16 tiles give such a task 72 blocks
#: at Q = 4 and 288 at Q = 64 and 192, where the TPU's 128 x 128 would put
#: it on one SM
TILE_BLOCK = 16


def tile_kernel(pr: torch.Tensor, pc: torch.Tensor, couple: torch.Tensor,
                quad_order: int) -> torch.Tensor:
    """pr: (nr,3), pc: (nc,3), couple: (nr,nc) bool -> (nr,nc) f32 tile.

    Z_ij = sum_q w_q * cos(k d r_q) / (d + eps_q) over a quadrature ladder —
    a real-valued stand-in for the singular Green's function integral whose
    cost scales with quad_order like the true near-interaction refinement.
    """
    return assembly_tile(pr, pc, couple, quad_order=quad_order,
                         block_r=TILE_BLOCK, block_c=TILE_BLOCK)


def _task_inputs(problem: AssemblyProblem, t: AssemblyTask,
                 device: torch.device):
    g = problem.geom
    pr = torch.from_numpy(g.points[t.rows].astype(np.float32)).to(device)
    pc = torch.from_numpy(g.points[t.cols].astype(np.float32)).to(device)
    reg_r = g.region[t.rows][:, None]
    reg_c = g.region[t.cols][None, :]
    couple = torch.from_numpy((reg_r == reg_c) | (reg_r == 2)
                              | (reg_c == 2)).to(device)
    return pr, pc, couple


def execute_task(problem: AssemblyProblem, t: AssemblyTask,
                 device=None) -> np.ndarray:
    dev = resolve_device(device)
    pr, pc, couple = _task_inputs(problem, t, dev)
    return tile_kernel(pr, pc, couple, t.quad_order).cpu().numpy()


def measure_durations(problem: AssemblyProblem, *, repeats: int = 2,
                      warmup: bool = True, device=None) -> np.ndarray:
    """Wall-clock seconds per task (min over repeats) on ``device``
    (``None`` means ``"cuda"``, which raises without a card).

    A task's inputs are built and copied to the device once, outside the
    timed window; each repeat is a host clock around one launch followed
    by ``torch.cuda.synchronize()``.  The warmup runs each distinct
    ``(rows, cols, quad_order)`` signature once first, so on the card the
    kernel launches ``repeats * tasks + signatures`` times."""
    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if warmup:
        seen = set()
        for t in problem.tasks:
            sig = (len(t.rows), len(t.cols), t.quad_order)
            if sig not in seen:
                seen.add(sig)
                execute_task(problem, t, dev)
    out = np.zeros(problem.num_tasks)
    for i, t in enumerate(problem.tasks):
        pr, pc, couple = _task_inputs(problem, t, dev)
        sync()
        best = np.inf
        for _ in range(repeats):
            t0 = time.perf_counter()
            tile_kernel(pr, pc, couple, t.quad_order)
            sync()
            best = min(best, time.perf_counter() - t0)
        out[i] = best
    return out


def analytic_durations(problem: AssemblyProblem,
                       flops_per_s: float = 2e9) -> np.ndarray:
    """Deterministic cost model used by fast tests: FLOPs / rate."""
    out = np.zeros(problem.num_tasks)
    for i, t in enumerate(problem.tasks):
        out[i] = (len(t.rows) * len(t.cols) * t.quad_order * 8.0) / flops_per_s
    return out
