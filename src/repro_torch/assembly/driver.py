"""End-to-end assembly comparison (paper Fig. 5): A baseline / B
overdecomposed / C overdecomposed + CCM-LB.

A — the solver's native layout: every rank computes its full dense row-block,
    including non-coupling (zero) entries, as one unsplittable unit;
B — overdecomposed tasks co-located at their slab's home (zero tiles are
    skipped — the paper's ~1.3x);
C — CCM-LB redistributes the tasks using *predicted* durations from the cost
    model; reported makespan uses the TRUE durations plus the wave-based
    homing transfer time.

The port's counterpart of ``repro/assembly/driver.py``: measured durations
come from the CUDA tile kernel and CCM-LB scores on the card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.assembly.execute import analytic_durations, measure_durations
from repro_torch.assembly.homing import HomingPlan, plan_homing
from repro_torch.assembly.problem import AssemblyProblem, build_problem
from repro_torch.core import CCMParams, ccm_lb
from repro_torch.core.problem import initial_assignment
from repro_torch.kernels.ccm_scorer.launch import resolve_device


@dataclasses.dataclass
class AssemblyRun:
    problem: AssemblyProblem
    durations_true: np.ndarray
    durations_pred: np.ndarray
    makespan_baseline: float          # A
    makespan_overdecomposed: float    # B
    makespan_ccmlb: float             # C (compute only)
    homing: Optional[HomingPlan]      # C transfer phase
    imbalance_before: float
    imbalance_after: float
    n_off_home_ranks: int
    lb_result: object
    #: host seconds per stage: build, durations, predict, ccm_lb,
    #: baseline, homing
    stage_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def speedup_overdecomposed(self) -> float:
        return self.makespan_baseline / self.makespan_overdecomposed

    @property
    def speedup_ccmlb(self) -> float:
        total_c = self.makespan_ccmlb + (self.homing.est_time_s
                                         if self.homing else 0.0)
        return self.makespan_baseline / total_c


def baseline_makespan(problem: AssemblyProblem,
                      flops_per_s: float = 2e9) -> float:
    """Mode A: dense row-block per rank, zero entries computed too."""
    geom = problem.geom
    n = geom.n
    worst = 0.0
    for rows in problem.rank_rows:
        # dense: every (row, col) pair at the tile's quadrature depth.
        # approximate cost per row set: sum over column tiles of nr*nc*q.
        cost = 0.0
        for c0 in range(0, n, 512):
            csel = np.arange(c0, min(c0 + 512, n))
            pr = geom.points[rows]
            pc = geom.points[csel]
            d = np.sqrt(((pr[:, None] - pc[None]) ** 2).sum(-1))
            dmin = d.min() if d.size else np.inf
            q = (192 if dmin < 0.005 else 64 if dmin < 0.05
                 else 16 if dmin < 0.2 else 4)
            cost += len(rows) * len(csel) * q * 8.0 / flops_per_s
        worst = max(worst, cost)
    return worst


def balance_assembly(
        n_unknowns: int = 4096, num_ranks: int = 16, *,
        durations: str = "analytic", cost_model=None,
        ccm_params: Optional[CCMParams] = None, mem_cap_frac: float = 0.6,
        seed: int = 0, n_iter: int = 4, fanout: int = 4,
        task_limit_u: int = 96, use_engine: bool = True, device=None,
        dtype: torch.dtype = torch.float64) -> AssemblyRun:
    """Every stage of :func:`run_assembly_comparison` but homing: the run
    it returns has ``homing=None`` until :func:`plan_assembly_homing`.

    ``device`` (``None`` means ``"cuda"``, which raises without a card) is
    where measured durations are taken and where ``ccm_lb`` scores;
    ``dtype`` is ``ccm_lb``'s scoring dtype."""
    dev = resolve_device(device)
    clock = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        t1 = time.perf_counter()
        clock[name] = t1 - t0
        t0 = t1

    problem = build_problem(n_unknowns, num_ranks, seed=seed,
                            task_limit_u=task_limit_u)
    lap("build")
    if durations == "measured":
        durations_true = measure_durations(problem, device=dev)
    else:
        durations_true = analytic_durations(problem)
    lap("durations")

    # cost model predictions (perfect predictions if no model given)
    if cost_model is not None:
        durations_pred = cost_model.predict(problem.features())
    else:
        durations_pred = durations_true.copy()
    lap("predict")

    # memory cap: fraction of what a rank would need to hold ALL slabs
    total_block_bytes = problem.slab_bytes.sum()
    per_rank_all = total_block_bytes / num_ranks
    mem_cap = max(per_rank_all * 4.0 * mem_cap_frac, problem.slab_bytes.max() * 3)

    params = ccm_params or CCMParams(alpha=1.0, beta=2e-10, gamma=1e-12,
                                     delta=2e-10)
    phase_pred = problem.to_phase(durations_pred, mem_cap_bytes=mem_cap)
    a0 = initial_assignment(phase_pred, "home")

    # B: overdecomposed, tasks at home
    loads_b = np.bincount(a0, weights=durations_true, minlength=num_ranks)
    makespan_b = float(loads_b.max())

    # C: CCM-LB on predictions, evaluated with true durations
    res = ccm_lb(phase_pred, a0, params, n_iter=n_iter, fanout=fanout,
                 seed=seed, use_engine=use_engine, device=dev, dtype=dtype)
    loads_c = np.bincount(res.assignment, weights=durations_true,
                          minlength=num_ranks)
    makespan_c = float(loads_c.max())
    lap("ccm_lb")

    makespan_a = baseline_makespan(problem)
    lap("baseline")
    return AssemblyRun(
        problem=problem,
        durations_true=durations_true,
        durations_pred=durations_pred,
        makespan_baseline=makespan_a,
        makespan_overdecomposed=makespan_b,
        makespan_ccmlb=makespan_c,
        homing=None,
        imbalance_before=float(loads_b.max() / max(loads_b.mean(), 1e-12) - 1),
        imbalance_after=float(loads_c.max() / max(loads_c.mean(), 1e-12) - 1),
        n_off_home_ranks=len(_off_home_copies(res.state)[0]),
        lb_result=res,
        stage_seconds=clock,
    )


def _off_home_copies(st):
    """(bytes, home, holder) of every slab copy held off its home rank."""
    phase = st.phase
    items_bytes, items_home, items_loc = [], [], []
    for b in range(phase.num_blocks):
        holders = np.nonzero(st.block_count[:, b] > 0)[0]
        for r in holders:
            if r != phase.block_home[b]:
                items_bytes.append(phase.block_size[b])
                items_home.append(phase.block_home[b])
                items_loc.append(r)
    return items_bytes, items_home, items_loc


def plan_assembly_homing(run: AssemblyRun) -> AssemblyRun:
    """The homing stage of a :func:`balance_assembly` run: every off-home
    rank holding a slab copy ships it home in waves.  Raises
    ``plan_homing``'s ``RuntimeError`` where the reference does."""
    t0 = time.perf_counter()
    st = run.lb_result.state
    phase = st.phase
    items_bytes, items_home, items_loc = _off_home_copies(st)
    homing = None
    if items_bytes:
        ranks_per_node = 2
        n_nodes = (phase.num_ranks + ranks_per_node - 1) // ranks_per_node
        node_used = np.zeros(n_nodes)
        for b in range(phase.num_blocks):
            holders = np.nonzero(st.block_count[:, b] > 0)[0]
            for r in holders:
                node_used[r // ranks_per_node] += phase.block_size[b]
        homing = plan_homing(
            np.array(items_bytes), np.array(items_home, np.int64),
            np.array(items_loc, np.int64), ranks_per_node=ranks_per_node,
            node_mem_cap=float(node_used.max() + phase.block_size.max() * 2),
            node_mem_used=node_used)
    return dataclasses.replace(
        run, homing=homing,
        stage_seconds={**run.stage_seconds,
                       "homing": time.perf_counter() - t0})


def run_assembly_comparison(
        n_unknowns: int = 4096, num_ranks: int = 16, **kw) -> AssemblyRun:
    """A/B/C on one problem: :func:`balance_assembly` (same keywords),
    then :func:`plan_assembly_homing`."""
    return plan_assembly_homing(balance_assembly(n_unknowns, num_ranks,
                                                 **kw))
