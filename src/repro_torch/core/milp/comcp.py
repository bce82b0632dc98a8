"""Compute-Only Memory-Constrained Problem (COMCP) builder — paper §V-B.

alpha=1, beta=gamma=delta=0 in (13): variables chi, phi, W_max with
constraints (14), (17), (18), (19) and makespan rows (20).

The port's copy of the JAX package's ``core/milp/comcp.py``: host
numpy, the same matrices bit for bit.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.ccm import effective_mem_cap
from repro_torch.core.milp.fwmp import MILP
from repro_torch.core.problem import CCMParams, Phase


def build_comcp(phase: Phase, params: CCMParams = None) -> MILP:
    params = params or CCMParams()
    I, K, N = phase.num_ranks, phase.num_tasks, phase.num_blocks
    n_chi, n_phi = I * K, I * N
    n = n_chi + n_phi + 1
    W = n - 1

    def chi(i, k):
        return i * K + k

    def phi(i, b):
        return n_chi + i * N + b

    c = np.zeros(n)
    c[W] = 1.0

    A_eq = np.zeros((K, n))
    for k in range(K):
        for i in range(I):
            A_eq[k, chi(i, k)] = 1.0
    b_eq = np.ones(K)

    rows: List[np.ndarray] = []
    rhs: List[float] = []

    def add(row, b):
        rows.append(row)
        rhs.append(b)

    for k in range(K):               # (17)
        bk = phase.task_block[k]
        if bk < 0:
            continue
        for i in range(I):
            row = np.zeros(n)
            row[chi(i, k)] = 1.0
            row[phi(i, bk)] = -1.0
            add(row, 0.0)

    for b in range(N):               # (18)
        members = np.nonzero(phase.task_block == b)[0]
        for i in range(I):
            row = np.zeros(n)
            row[phi(i, b)] = 1.0
            for k in members:
                row[chi(i, k)] = -1.0
            add(row, 0.0)

    if params.memory_constraint:     # (19), RHS on the heuristic's
        for i in range(I):           # effective_mem_cap soft cap
            cap = (effective_mem_cap(phase.rank_mem_cap[i], params)
                   - phase.rank_mem_base[i])
            for k in range(K):
                row = np.zeros(n)
                for l in range(K):
                    row[chi(i, l)] += phase.task_mem[l]
                row[chi(i, k)] += phase.task_overhead[k]
                for b in range(N):
                    row[phi(i, b)] += phase.block_size[b]
                add(row, cap)

    for i in range(I):               # (20)
        row = np.zeros(n)
        for k in range(K):
            row[chi(i, k)] = phase.task_load[k]
        row[W] = -1.0
        add(row, 0.0)

    for v in range(n - 1):           # [0,1]
        row = np.zeros(n)
        row[v] = 1.0
        add(row, 1.0)

    return MILP(
        c=c, A_eq=A_eq, b_eq=b_eq,
        A_ub=np.array(rows), b_ub=np.array(rhs),
        integer_vars=np.arange(n_chi),
        n_vars=n,
        meta={"I": I, "K": K, "N": N, "M": 0, "kind": "comcp"},
    )
