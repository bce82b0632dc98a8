"""Dense two-phase primal simplex (host numpy), the port's copy of the JAX
package's ``core/milp/lp.py``.  No external solver is assumed, so the MILP
path (paper §V) runs on this.  The pivot's operation order, the
Dantzig-to-Bland switch and Bland's tie rule decide which vertex a tie
resolves to (and so which optimum branch and bound reports), so every line
is the reference's: the tableau stays a host array, x comes out bit for bit
(tests/test_torch_milp.py).

Solves::

    min c.x   s.t.  A_eq x = b_eq,  A_ub x <= b_ub,  x >= 0

Anti-cycling: Dantzig pricing with a switch to Bland's rule after a stall
budget.  Sizes here are small (FWMP instances used for certification are a
few hundred variables / ~1-2k rows), so a dense tableau is appropriate.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

_TOL = 1e-9


@dataclasses.dataclass
class LPResult:
    status: str            # "optimal" | "infeasible" | "unbounded" | "maxiter"
    x: Optional[np.ndarray]
    objective: float


def _pivot(t: np.ndarray, basis: np.ndarray, row: int, col: int):
    t[row] /= t[row, col]
    factor = t[:, col].copy()
    factor[row] = 0.0
    t -= np.outer(factor, t[row])
    basis[row] = col


def _run_simplex(t: np.ndarray, basis: np.ndarray, ncols: int,
                 maxiter: int) -> str:
    """Minimize the objective in the last row of tableau ``t`` over columns
    [0, ncols).  Last column is RHS.  Returns status."""
    m = t.shape[0] - 1
    bland_after = max(200, 4 * (m + ncols))
    for it in range(maxiter):
        obj = t[-1, :ncols]
        if it < bland_after:
            col = int(np.argmin(obj))
            if obj[col] >= -_TOL:
                return "optimal"
        else:  # Bland
            neg = np.nonzero(obj < -_TOL)[0]
            if neg.size == 0:
                return "optimal"
            col = int(neg[0])
        ratios = np.full(m, np.inf)
        pos = t[:m, col] > _TOL
        ratios[pos] = t[:m, -1][pos] / t[:m, col][pos]
        if not np.isfinite(ratios).any():
            return "unbounded"
        row = int(np.argmin(ratios))
        if it >= bland_after:
            # Bland: smallest basis index among ties
            best = ratios[row]
            ties = np.nonzero(np.isclose(ratios, best, atol=1e-12))[0]
            row = int(min(ties, key=lambda r: basis[r]))
        _pivot(t, basis, row, col)
    return "maxiter"


def simplex_solve(c, A_eq=None, b_eq=None, A_ub=None, b_ub=None,
                  maxiter: int = 50000) -> LPResult:
    c = np.asarray(c, np.float64)
    n = c.shape[0]
    A_eq = np.zeros((0, n)) if A_eq is None else np.asarray(A_eq, np.float64)
    b_eq = np.zeros(0) if b_eq is None else np.asarray(b_eq, np.float64)
    A_ub = np.zeros((0, n)) if A_ub is None else np.asarray(A_ub, np.float64)
    b_ub = np.zeros(0) if b_ub is None else np.asarray(b_ub, np.float64)
    m_eq, m_ub = A_eq.shape[0], A_ub.shape[0]
    m = m_eq + m_ub

    # standard form with slacks on <= rows
    A = np.zeros((m, n + m_ub))
    A[:m_eq, :n] = A_eq
    A[m_eq:, :n] = A_ub
    A[m_eq:, n:] = np.eye(m_ub)
    b = np.concatenate([b_eq, b_ub])

    # make b >= 0
    neg = b < 0
    A[neg] *= -1.0
    b[neg] *= -1.0

    # rows with a usable identity column (non-negated slack rows) need no
    # artificial; all others do.
    slack_ok = np.zeros(m, bool)
    slack_ok[m_eq:] = ~neg[m_eq:]
    art_rows = np.nonzero(~slack_ok)[0]
    n_art = art_rows.size
    ncols = n + m_ub
    total = ncols + n_art

    t = np.zeros((m + 1, total + 1))
    t[:m, :ncols] = A
    t[:m, -1] = b
    basis = np.zeros(m, np.int64)
    for j, r in enumerate(art_rows):
        t[r, ncols + j] = 1.0
        basis[r] = ncols + j
    for r in np.nonzero(slack_ok)[0]:
        basis[r] = n + (r - m_eq)

    # ---- phase 1: minimize sum of artificials --------------------------------
    if n_art:
        t[-1, ncols:total] = 1.0
        # price out basic artificials
        for r in art_rows:
            t[-1] -= t[r]
        status = _run_simplex(t, basis, total, maxiter)
        if status != "optimal":
            return LPResult(status, None, np.nan)
        phase1_obj = -t[-1, -1]
        if phase1_obj > 1e-6:
            return LPResult("infeasible", None, np.nan)
        # drive remaining basic artificials out where possible
        for r in range(m):
            if basis[r] >= ncols:
                cand = np.nonzero(np.abs(t[r, :ncols]) > 1e-7)[0]
                if cand.size:
                    _pivot(t, basis, r, int(cand[0]))
        # degenerate artificial rows (all-zero) are redundant; keep, they
        # stay basic at 0 and never pivot (their columns are zeroed below).
        t[:, ncols:total] = 0.0

    # ---- phase 2 --------------------------------------------------------------
    t[-1, :] = 0.0
    t[-1, :n] = c
    for r in range(m):
        if basis[r] < ncols and np.abs(t[-1, basis[r]]) > 0:
            t[-1] -= t[-1, basis[r]] * t[r]
    status = _run_simplex(t, basis, ncols, maxiter)
    if status != "optimal":
        return LPResult(status, None, np.nan)
    x = np.zeros(ncols)
    for r in range(m):
        if basis[r] < ncols:
            x[basis[r]] = t[r, -1]
    return LPResult("optimal", x[:n], float(np.dot(c, x[:n])))
