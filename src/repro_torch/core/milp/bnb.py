"""Branch & bound over the chi (task-assignment) binaries.

Structure exploited (see paper §V remarks):
  * SOS1 branching on TASKS: the consistency rows (14) make each task's chi
    row a one-hot — a node branches a fractional task into one child per
    candidate rank, fixing chi_ik=1 and chi_jk=0 for j != i.  Much stronger
    than 0/1 branching on single entries.
  * fixed variables are ELIMINATED by substitution (columns removed, RHS
    adjusted, empty rows dropped), so node LPs shrink as the tree deepens;
  * with chi integral, minimization + Thm V.2/V.4 force phi/psi to their
    Boolean values wherever they carry cost, so an all-integral-chi LP
    optimum is a valid MILP solution;
  * a heuristic incumbent (e.g. CCM-LB's W_max) can seed pruning.

The root LP relaxation is the continuous lower bound used for the paper's
"gap" = (W_int - W_lp) / W_lp (§VII-A).

The port's copy of the JAX package's ``core/milp/bnb.py``: the heap order
(ties on the bound broken by the push counter, children pushed in
``argsort(-chi)`` order) decides which node is expanded, so it is the
reference's line for line.  ``time_limit_s`` is checked on the host's wall
clock at every node: a solve that reaches it ends as ``node_limit`` after
however many nodes the host managed, which no other run reproduces.  A
reproducible solve ends by optimality or by ``max_nodes``.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.milp.fwmp import MILP
from repro_torch.core.milp.lp import LPResult, simplex_solve

_INT_TOL = 1e-5


@dataclasses.dataclass
class MILPResult:
    status: str        # "optimal" | "node_limit" | "infeasible"
    x: Optional[np.ndarray]
    objective: float
    lp_bound: float    # root relaxation (continuous lower bound)
    best_bound: float  # best proven lower bound at termination
    nodes: int
    gap: float         # (objective - lp_bound) / lp_bound
    wall_s: float


def _solve_node(milp: MILP, fixed: Dict[int, float]) -> LPResult:
    """LP relaxation with variables in ``fixed`` eliminated by substitution."""
    n = milp.n_vars
    if not fixed:
        return simplex_solve(milp.c, milp.A_eq, milp.b_eq, milp.A_ub,
                             milp.b_ub)
    fixed_idx = np.fromiter(fixed.keys(), np.int64)
    fixed_val = np.fromiter(fixed.values(), np.float64)
    free = np.ones(n, bool)
    free[fixed_idx] = False
    free_idx = np.nonzero(free)[0]

    b_eq = milp.b_eq - milp.A_eq[:, fixed_idx] @ fixed_val
    A_eq = milp.A_eq[:, free_idx]
    keep = np.abs(A_eq).sum(1) > 1e-12
    if np.any(np.abs(b_eq[~keep]) > 1e-9):
        return LPResult("infeasible", None, np.nan)
    A_eq, b_eq = A_eq[keep], b_eq[keep]

    b_ub = milp.b_ub - milp.A_ub[:, fixed_idx] @ fixed_val
    A_ub = milp.A_ub[:, free_idx]
    keep = np.abs(A_ub).sum(1) > 1e-12
    if np.any(b_ub[~keep] < -1e-9):
        return LPResult("infeasible", None, np.nan)
    A_ub, b_ub = A_ub[keep], b_ub[keep]

    res = simplex_solve(milp.c[free_idx], A_eq, b_eq, A_ub, b_ub)
    if res.status != "optimal":
        return res
    x = np.zeros(n)
    x[free_idx] = res.x
    x[fixed_idx] = fixed_val
    return LPResult("optimal", x, res.objective + float(
        milp.c[fixed_idx] @ fixed_val))


def _fix_task(milp: MILP, fixed: Dict[int, float], k: int, rank: int):
    """chi_{rank,k}=1, chi_{j,k}=0 for j != rank."""
    out = dict(fixed)
    for i in range(milp.meta["I"]):
        out[milp.chi(i, k)] = 1.0 if i == rank else 0.0
    return out


def solve_milp(milp: MILP, *, incumbent_obj: float = np.inf,
               incumbent_x: Optional[np.ndarray] = None,
               max_nodes: int = 3000, gap_tol: float = 1e-4,
               time_limit_s: float = 300.0) -> MILPResult:
    t0 = time.time()
    i_n, k_n = milp.meta["I"], milp.meta["K"]
    root = _solve_node(milp, {})
    if root.status != "optimal":
        return MILPResult("infeasible", None, np.inf, np.inf, np.inf, 1,
                          np.inf, time.time() - t0)
    lp_bound = root.objective

    best_obj = incumbent_obj
    best_x = incumbent_x
    counter = 0
    # node = (lp_obj, tiebreak, fixed, x)
    heap: List[Tuple[float, int, Dict[int, float], np.ndarray]] = []
    heapq.heappush(heap, (root.objective, counter, {}, root.x))
    nodes = 0
    status = "optimal"

    while heap:
        if nodes >= max_nodes or (time.time() - t0) > time_limit_s:
            status = "node_limit"
            break
        bound, _, fixed, x = heapq.heappop(heap)
        if bound >= best_obj - gap_tol * max(abs(best_obj), 1.0):
            continue
        nodes += 1
        chi = x[: i_n * k_n].reshape(i_n, k_n)
        frac = np.abs(chi - np.round(chi)).max(axis=0)   # per task
        k_branch = int(np.argmax(frac))
        if frac[k_branch] <= _INT_TOL:
            if bound < best_obj:
                best_obj = bound
                best_x = x
            continue
        # SOS1 branch on task k_branch: one child per candidate rank,
        # largest LP weight first.
        order = np.argsort(-chi[:, k_branch])
        for i in order:
            if chi[i, k_branch] < 1e-9 and i != order[0]:
                continue  # keep at least the top candidate
            child = _fix_task(milp, fixed, k_branch, int(i))
            res = _solve_node(milp, child)
            if res.status != "optimal":
                continue
            if res.objective >= best_obj - gap_tol * max(abs(best_obj), 1.0):
                continue
            counter += 1
            heapq.heappush(heap, (res.objective, counter, child, res.x))

    best_bound = min([h[0] for h in heap], default=best_obj)
    best_bound = min(best_bound, best_obj)
    gap = ((best_obj - lp_bound) / lp_bound) if np.isfinite(best_obj) \
        and lp_bound > 0 else np.inf
    if best_x is None:
        return MILPResult("infeasible" if status == "optimal" else status,
                          None, np.inf, lp_bound, best_bound, nodes, np.inf,
                          time.time() - t0)
    final_status = status if status == "node_limit" else "optimal"
    return MILPResult(final_status, best_x, float(best_obj), float(lp_bound),
                      float(best_bound), nodes, float(gap), time.time() - t0)
