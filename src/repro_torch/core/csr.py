"""Flat CSR/SoA view of a :class:`~repro_torch.core.problem.Phase`.

The CCM evaluation hot path needs three adjacency structures over and over:

  * task -> incident communication edges  (update formulae, Thm III.1);
  * block -> member tasks                 (homing / shared-memory deltas);
  * rank -> member tasks                  (cluster build, batched scoring).

The seed implementation re-derived these with Python loops and
list-of-arrays at every call site.  This module stores each of them ONCE as
a pair of flat ``indptr``/``indices`` arrays (classic CSR), which

  * makes every traversal a vectorized gather instead of a Python loop;
  * is a layout a device kernel can consume directly (contiguous segments).

The port's own copy of ``repro/core/csr.py``.

Everything here is immutable with respect to the *phase*: task→edge and
block→task adjacency never change during balancing (the balancer only moves
tasks between ranks).  Rank membership does change, so ``rank_segments`` is
a cheap function of the current assignment rather than a cached structure.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.problem import Phase

_EMPTY = np.zeros(0, np.int64)


@dataclasses.dataclass(frozen=True)
class CSR:
    """Rows of variable length stored as ``indices[indptr[i]:indptr[i+1]]``."""

    indptr: np.ndarray   # (R+1,) int64
    indices: np.ndarray  # (nnz,) int64

    def row(self, i: int) -> np.ndarray:
        return self.indices[self.indptr[i]:self.indptr[i + 1]]

    def gather(self, rows: np.ndarray) -> np.ndarray:
        """Concatenation of ``row(r) for r in rows`` without a Python loop."""
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return _EMPTY
        starts = self.indptr[rows]
        counts = self.indptr[rows + 1] - starts
        total = int(counts.sum())
        if total == 0:
            return _EMPTY
        # segment gather: out[j] = indices[starts[seg(j)] + offset_in_seg(j)]
        seg_ends = np.cumsum(counts)
        seg_base = np.repeat(seg_ends - counts, counts)
        idx = np.arange(total, dtype=np.int64) - seg_base \
            + np.repeat(starts, counts)
        return self.indices[idx]


def csr_from_groups(group: np.ndarray, payload: np.ndarray,
                    num_groups: int) -> CSR:
    """CSR with ``row(g) = payload[group == g]`` (payload order preserved
    within a row via a stable sort)."""
    group = np.asarray(group, np.int64)
    payload = np.asarray(payload, np.int64)
    order = np.argsort(group, kind="stable")
    counts = np.bincount(group, minlength=num_groups)
    indptr = np.zeros(num_groups + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSR(indptr, payload[order])


def build_task_edge_csr(phase: Phase) -> CSR:
    """task -> ids of incident comm edges (each edge listed once per distinct
    endpoint; a self-edge appears once under its task)."""
    not_self = phase.comm_dst != phase.comm_src
    eid = np.arange(phase.num_comms, dtype=np.int64)
    tasks = np.concatenate([phase.comm_src, phase.comm_dst[not_self]])
    eids = np.concatenate([eid, eid[not_self]])
    return csr_from_groups(tasks, eids, phase.num_tasks)


def build_block_task_csr(phase: Phase) -> CSR:
    """block -> member task ids (ascending within a block)."""
    has = phase.task_block >= 0
    tasks = np.nonzero(has)[0]
    return csr_from_groups(phase.task_block[has], tasks, phase.num_blocks)


def rank_segments(assignment: np.ndarray, num_ranks: int) -> CSR:
    """rank -> member task ids as sorted segments of one flat array."""
    assignment = np.asarray(assignment, np.int64)
    tasks = np.arange(assignment.shape[0], dtype=np.int64)
    return csr_from_groups(assignment, tasks, num_ranks)


@dataclasses.dataclass(frozen=True)
class PhaseCSR:
    """The frozen CSR bundle the evaluation engine reads.

    ``task_edges`` and ``block_tasks`` are valid for the lifetime of the
    phase; rank membership is derived on demand with :func:`rank_segments`.
    """

    task_edges: CSR    # task -> incident edge ids
    block_tasks: CSR   # block -> member task ids

    @staticmethod
    def from_phase(phase: Phase) -> "PhaseCSR":
        return PhaseCSR(task_edges=build_task_edge_csr(phase),
                        block_tasks=build_block_task_csr(phase))
