"""Reduced FWMP (beyond-paper formulation improvement).

The paper's FWMP (§V-C) carries the full IxIxM communication tensor psi.
For the CCM objective only three aggregates per rank matter, and the task
consistency rows (14) give  sum_j chi_{j,l} = 1,  so with

    y_{i,m} := chi_{i,k_m} * chi_{i,l_m}        (both endpoints on rank i)

we get exactly:
    sent_off(i) = sum_m V_m (chi_{i,k_m} - y_{i,m})
    recv_off(i) = sum_m V_m (chi_{i,l_m} - y_{i,m})
    on_rank(i)  = sum_m V_m y_{i,m}

with the usual product linearization (y <= chi_a, y <= chi_b,
y >= chi_a + chi_b - 1, y >= 0).  Both bounds of y are active in the
directions the objective pushes (beta wants y large -> upper bounds bind;
gamma wants y small -> lower bound binds), so the optimum equals the paper's
formulation — verified against it in tests — with I*M variables instead of
I^2*M and 3*I*M rows instead of 3*I^2*M.

The port's copy of the JAX package's ``core/milp/fwmp_reduced.py``: host
numpy, the same matrices bit for bit.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.ccm import effective_mem_cap
from repro_torch.core.milp.fwmp import MILP
from repro_torch.core.problem import CCMParams, Phase


def build_fwmp_reduced(phase: Phase, params: CCMParams) -> MILP:
    I, K = phase.num_ranks, phase.num_tasks
    N, M = phase.num_blocks, phase.num_comms
    n_chi, n_phi, n_y = I * K, I * N, I * M
    n = n_chi + n_phi + n_y + 1
    W = n - 1

    def chi(i, k):
        return i * K + k

    def phi(i, b):
        return n_chi + i * N + b

    def y(i, m):
        return n_chi + n_phi + i * M + m

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

    # y linearization
    for m in range(M):
        km, lm = int(phase.comm_src[m]), int(phase.comm_dst[m])
        for i in range(I):
            r1 = np.zeros(n)
            r1[y(i, m)] = 1.0
            r1[chi(i, km)] = -1.0
            add(r1, 0.0)
            r2 = np.zeros(n)
            r2[y(i, m)] = 1.0
            r2[chi(i, lm)] = -1.0
            add(r2, 0.0)
            r3 = np.zeros(n)
            r3[chi(i, km)] += 1.0
            r3[chi(i, lm)] += 1.0
            r3[y(i, m)] = -1.0
            add(r3, 1.0)

    # work rows: send / recv variants
    for i in range(I):
        for direction in ("send", "recv"):
            row = np.zeros(n)
            for k in range(K):
                row[chi(i, k)] += params.alpha * phase.task_load[k]
            for m in range(M):
                v = phase.comm_vol[m]
                km, lm = int(phase.comm_src[m]), int(phase.comm_dst[m])
                endpoint = km if direction == "send" else lm
                row[chi(i, endpoint)] += params.beta * v
                row[y(i, m)] += (params.gamma - params.beta) * v
            for b in range(N):
                if phase.block_home[b] != i:
                    row[phi(i, b)] += params.delta * phase.block_size[b]
            row[W] = -1.0
            add(row, 0.0)

    for v_i in range(n - 1):         # [0,1] bounds
        row = np.zeros(n)
        row[v_i] = 1.0
        add(row, 1.0)

    return MILP(
        c=c, A_eq=A_eq, b_eq=b_eq,
        A_ub=np.array(rows), b_ub=np.array(rhs),
        integer_vars=np.arange(n_chi),
        n_vars=n,
        meta={"I": I, "K": K, "N": N, "M": M, "kind": "fwmp_reduced"},
    )
