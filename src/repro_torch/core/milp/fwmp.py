"""Full Work Model Problem (FWMP) builder — paper §V-C.

Decision vector x = vec(chi (IxK), phi (IxN), psi (IxIxM), W_max), with:
  (14) task assignment consistency (eq),
  (17)/(18) integer shared-block relations (Thm V.2),
  (19) per-rank memory capacity,
  (25)-(27) integer communication-tensor relations (Thm V.4),
  (30) makespan work rows (both send/recv permutations of the beta term),
  [0,1] bounds on all binary variables.

The port's copy of the JAX package's ``core/milp/fwmp.py``: host
numpy, the same matrices bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.ccm import effective_mem_cap
from repro_torch.core.problem import CCMParams, Phase


@dataclasses.dataclass
class MILP:
    c: np.ndarray
    A_eq: np.ndarray
    b_eq: np.ndarray
    A_ub: np.ndarray
    b_ub: np.ndarray
    integer_vars: np.ndarray          # indices to branch on (the chi block)
    n_vars: int
    meta: dict

    def chi(self, i: int, k: int) -> int:
        return i * self.meta["K"] + k

    def decode_assignment(self, x: np.ndarray) -> np.ndarray:
        i_n, k_n = self.meta["I"], self.meta["K"]
        chi = x[: i_n * k_n].reshape(i_n, k_n)
        return np.argmax(chi, axis=0).astype(np.int64)


def build_fwmp(phase: Phase, params: CCMParams) -> MILP:
    I, K = phase.num_ranks, phase.num_tasks
    N, M = phase.num_blocks, phase.num_comms
    n_chi, n_phi, n_psi = I * K, I * N, I * I * M
    n = n_chi + n_phi + n_psi + 1
    W = n - 1

    def chi(i, k):
        return i * K + k

    def phi(i, b):
        return n_chi + i * N + b

    def psi(i, j, m):
        return n_chi + n_phi + (i * I + j) * M + m

    c = np.zeros(n)
    c[W] = 1.0

    # (14) equality: sum_i chi_ik = 1
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

    # (17): chi_ik - phi_i,b(k) <= 0 for tasks with a block
    for k in range(K):
        bk = phase.task_block[k]
        if bk < 0:
            continue
        for i in range(I):
            row = np.zeros(n)
            row[chi(i, k)] = 1.0
            row[phi(i, bk)] = -1.0
            add(row, 0.0)

    # (18): phi_ib - sum_{k in block b} chi_ik <= 0
    for b in range(N):
        members = np.nonzero(phase.task_block == b)[0]
        for i in range(I):
            row = np.zeros(n)
            row[phi(i, b)] = 1.0
            for k in members:
                row[chi(i, k)] = -1.0
            add(row, 0.0)

    # (19) memory, per (i, k).  The RHS goes through the same
    # effective_mem_cap soft cap the heuristic feasibility layer tests
    # against (relative tolerance + optional pressure headroom), so
    # MILP-feasible chi always decode to CCMState.memory_feasible
    # assignments and the two sides agree on eq. 7 to the bit.
    if params.memory_constraint:
        for i in range(I):
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

    # (25)-(27) communication tensor relations
    for m in range(M):
        km, lm = int(phase.comm_src[m]), int(phase.comm_dst[m])
        for i in range(I):
            for j in range(I):
                r1 = np.zeros(n)   # psi <= chi_i,km
                r1[psi(i, j, m)] = 1.0
                r1[chi(i, km)] = -1.0
                add(r1, 0.0)
                r2 = np.zeros(n)   # psi <= chi_j,lm
                r2[psi(i, j, m)] = 1.0
                r2[chi(j, lm)] = -1.0
                add(r2, 0.0)
                r3 = np.zeros(n)   # chi_i,km + chi_j,lm - psi <= 1
                r3[chi(i, km)] += 1.0
                r3[chi(j, lm)] += 1.0
                r3[psi(i, j, m)] = -1.0
                add(r3, 1.0)

    # (30) work rows (two permutations of the off-rank term)
    for i in range(I):
        for direction in ("send", "recv"):
            row = np.zeros(n)
            for k in range(K):
                row[chi(i, k)] += params.alpha * phase.task_load[k]
            for m in range(M):
                v = phase.comm_vol[m]
                for j in range(I):
                    if j == i:
                        continue
                    if direction == "send":
                        row[psi(i, j, m)] += params.beta * v
                    else:
                        row[psi(j, i, m)] += params.beta * v
                row[psi(i, i, m)] += params.gamma * v
            for b in range(N):
                if phase.block_home[b] != i:
                    row[phi(i, b)] += params.delta * phase.block_size[b]
            row[W] = -1.0
            add(row, 0.0)

    # [0,1] bounds on the binaries
    for v in range(n - 1):
        row = np.zeros(n)
        row[v] = 1.0
        add(row, 1.0)

    return MILP(
        c=c, A_eq=A_eq, b_eq=b_eq,
        A_ub=np.array(rows), b_ub=np.array(rhs),
        integer_vars=np.arange(n_chi),
        n_vars=n,
        meta={"I": I, "K": K, "N": N, "M": M, "kind": "fwmp"},
    )
