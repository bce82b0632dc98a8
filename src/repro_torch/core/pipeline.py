"""Multi-phase CCM-LB orchestrator (paper §III-B, iterative executions).

The paper's setting is an application that runs a SEQUENCE of phases and
re-invokes the balancer each time — warm, not from scratch.  This module
turns the single-phase :func:`repro_torch.core.ccmlb.ccm_lb` into that
loop:

  * **warm-started assignments** — phase ``k+1`` starts from phase ``k``'s
    balanced output, mapped through shared persistent task ids
    (:func:`warm_start_assignment`).  Tasks present in both phases keep
    their rank; new tasks fall back to the phase's initial-assignment rule.
    On slowly-drifting workloads this leaves the balancer a near-balanced
    start, so later phases converge in a fraction of the transfers.
  * **amortized CSR builds** — consecutive phases whose adjacency topology
    is unchanged (same comm endpoints, same task->block map;
    :func:`same_topology`) share one frozen :class:`PhaseCSR` bundle
    instead of rebuilding it per phase.  The bundle's content is identical
    to a fresh build, so sharing cannot change results.
  * **per-phase traces** — :class:`PipelineResult` keeps every phase's
    :class:`CCMLBResult` plus orchestration metadata (warm-start coverage,
    CSR reuse, wall-clock seconds).

Parity contract: over phases run with ``warm_start=True`` the pipeline is
trajectory-IDENTICAL to hand-chaining ``ccm_lb`` calls with each phase
seeded ``seed + k`` and started from the previous result's assignment
— the orchestrator only removes redundant work, it never changes what
the balancer computes.  The port's copy of ``repro/core/pipeline.py``;
every phase's stage 2 scores through the engine on ``device`` (a keyword
passed through to :func:`ccm_lb`), so a pipeline on the card launches the
pair kernel every phase, and the window kernel when it passes
``spec_window``.  tests/test_torch_pipeline.py holds it to the JAX
package's pipeline bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.ccmlb import CCMLBResult, ccm_lb
from repro_torch.core.csr import PhaseCSR
from repro_torch.core.problem import (CCMParams, Phase,
                                      initial_assignment, same_topology)
from repro_torch.runtime.elastic import RankJoin, expand_phase

__all__ = ["PipelinePhase", "PhaseRun", "PipelineResult",
           "ccm_lb_pipeline", "same_topology", "warm_start_assignment",
           "RankJoin"]


@dataclasses.dataclass
class PipelinePhase:
    """One phase of an iterative execution.

    ``task_ids``: optional persistent GLOBAL id per task (shape
    ``(num_tasks,)``, unique).  Two phases' tasks are matched by these ids
    for warm starting; omitted, tasks are matched positionally (valid only
    when consecutive phases have the same task count).
    """

    phase: Phase
    task_ids: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.task_ids is not None:
            self.task_ids = np.asarray(self.task_ids, np.int64)
            if self.task_ids.shape[0] != self.phase.num_tasks:
                raise ValueError("task_ids must have one id per task")


@dataclasses.dataclass
class PhaseRun:
    """One phase's balancing outcome plus orchestration metadata."""

    result: CCMLBResult
    warm_started: bool      # start mapped from the previous phase's output
    csr_reused: bool        # PhaseCSR shared with the previous phase
    carried_tasks: int      # tasks whose rank was carried over
    seconds: float          # wall-clock of this phase's ccm_lb call
    engine_carried: bool = False    # state+engine retargeted, not rebuilt


@dataclasses.dataclass
class PipelineResult:
    """Per-phase results of one pipeline run (index = phase position)."""

    runs: List[PhaseRun]

    @property
    def assignments(self) -> List[np.ndarray]:
        return [r.result.assignment for r in self.runs]

    @property
    def final_assignment(self) -> np.ndarray:
        return self.runs[-1].result.assignment

    @property
    def total_transfers(self) -> int:
        return sum(r.result.transfers for r in self.runs)

    @property
    def total_seconds(self) -> float:
        return sum(r.seconds for r in self.runs)

    def max_work(self) -> List[List[float]]:
        """Per-phase max-work traces (incl. each phase's initial point)."""
        return [r.result.max_work for r in self.runs]


def warm_start_assignment(prev_phase: Phase, prev_assignment: np.ndarray,
                          next_phase: Phase, *,
                          prev_ids: Optional[np.ndarray] = None,
                          next_ids: Optional[np.ndarray] = None,
                          mode: str = "home") -> Tuple[np.ndarray, int]:
    """Map a balanced assignment onto the next phase's task set.

    Tasks matched between the phases (by persistent id, or positionally
    when both id arrays are omitted and the counts agree) start on their
    previous rank — clipped to ranks that exist in ``next_phase``;
    unmatched tasks start from ``initial_assignment(next_phase, mode)``.
    Returns ``(assignment, carried)`` where ``carried`` counts the matched
    tasks.

    The rank clipping doubles as the crash-recovery path: the async fault
    harness (core/async_sim.py) renumbers the survivor set with
    ``repro_torch.runtime.elastic.survivor_resize`` — dead ranks map OUT of
    range — and warm-starts through here, so exactly the tasks stranded
    on dead ranks fall back to the fresh initial placement while every
    surviving task keeps its rank.
    """
    prev_assignment = np.asarray(prev_assignment, np.int64)
    base = initial_assignment(next_phase, mode)
    if prev_ids is None and next_ids is None:
        if prev_phase.num_tasks != next_phase.num_tasks:
            return base, 0
        ok = prev_assignment < next_phase.num_ranks
        out = np.where(ok, prev_assignment, base).astype(np.int64)
        return out, int(ok.sum())
    if prev_ids is None:
        prev_ids = np.arange(prev_phase.num_tasks, dtype=np.int64)
    if next_ids is None:
        next_ids = np.arange(next_phase.num_tasks, dtype=np.int64)
    order = np.argsort(prev_ids, kind="stable")
    sorted_ids = prev_ids[order]
    if sorted_ids.size == 0:    # empty previous phase: nothing to carry
        return base, 0
    pos = np.searchsorted(sorted_ids, next_ids)
    pos_c = np.minimum(pos, sorted_ids.shape[0] - 1)
    hit = sorted_ids[pos_c] == next_ids
    ranks = prev_assignment[order[pos_c]]
    ok = hit & (ranks < next_phase.num_ranks)
    out = np.where(ok, ranks, base).astype(np.int64)
    return out, int(ok.sum())


def ccm_lb_pipeline(phases: Sequence[Union[Phase, PipelinePhase]],
                    params: Union[CCMParams, Sequence[CCMParams]], *,
                    warm_start: bool = True,
                    reuse_csr: bool = True,
                    carry_engine: bool = False,
                    initial_mode: str = "home",
                    a0: Optional[np.ndarray] = None,
                    seed: int = 0,
                    membership: tuple = (),
                    **lb_kwargs) -> PipelineResult:
    """Balance a sequence of phases with warm-started assignments and
    amortized CSR builds.

    ``params`` is one :class:`CCMParams` shared by every phase, or a
    sequence with one entry per phase (consumers that re-derive
    coefficients per phase, e.g. a beta tracking the activation size).
    ``a0`` overrides the derived start: with ``warm_start=True`` it seeds
    the first phase (later phases warm-start from the previous output);
    with ``warm_start=False`` — the cold reference — every phase of
    matching task count starts from ``a0``, or from ``initial_mode`` when
    ``a0`` is omitted.  Phase ``k`` runs with seed ``seed + k``.

    ``carry_engine=True`` additionally hands each ``ccm_lb`` call the
    previous phase's result as ``carry``: when the phases share topology
    and the warm start carried the full assignment, the CCMState is
    retargeted in place (bitwise-equal to a rebuild; see
    ``CCMState.retarget``) and the incremental engine — segments, edge
    caches — survives across the phase boundary, as does the phase's
    :class:`~repro_torch.core.quiesce.QuiesceTracker`: when the new phase's
    value arrays and params are unchanged too, its cluster/summary/gossip
    caches stay live across the boundary (epochs restart at 0 and the new
    seed forces the same full gossip redraw a fresh run performs, so
    trajectories are bitwise those of an uncarried run).  ``ccm_lb``
    falls back to a fresh build silently whenever the carry conditions
    fail, so enabling this can only remove redundant work; ``PhaseRun.
    engine_carried`` reports which happened per phase.  Requires
    ``warm_start`` (a cold start discards the assignment the carried
    state serves).
    ``membership``: :class:`~repro_torch.runtime.elastic.RankJoin` events (or
    plain ``(iteration, count)`` tuples) whose ``iteration`` names the
    PHASE index at which fresh ranks join the stream.  From that phase
    onward every phase's rank set is expanded with the joined rows
    (capacities/speed resolved once, at join time, against the
    then-current mesh — median defaults), so a pod that joins mid-stream
    persists; the warm start carries every task (old ranks all remain
    valid) and the joiners fill through ordinary balancing.  Topology is
    rank-independent, so CSR sharing across the join boundary is
    unaffected; ``carry_engine`` falls back to a fresh build for exactly
    the join phase (rank counts differ) and resumes after it.
    Remaining keyword arguments (``n_iter``, ``fanout``, ``use_engine``,
    ``device`` — ``None`` means ``"cuda"`` and raises without a card,
    ``"cpu"`` runs the plain scorer — ``dtype``, ``batch_lock_events``,
    ``spec_window``, ``quiesce_after`` for early exit once a phase stops
    transferring, ...) pass through to every :func:`ccm_lb` call.
    """
    if not phases:
        raise ValueError("ccm_lb_pipeline needs at least one phase")
    if carry_engine and not warm_start:
        raise ValueError("carry_engine requires warm_start=True")
    if isinstance(params, CCMParams):
        params_seq: List[CCMParams] = [params] * len(phases)
    else:
        params_seq = list(params)
        if len(params_seq) != len(phases):
            raise ValueError("params sequence must match the phase count")
    joins = [j if isinstance(j, RankJoin) else RankJoin(*j)
             for j in membership]
    for j in joins:
        if not 0 <= j.iteration < len(phases):
            raise ValueError(f"membership event {j!r}: phase index out of "
                             f"range [0, {len(phases)})")
    joined_rows: List[Tuple[float, float, float]] = []
    runs: List[PhaseRun] = []
    prev: Optional[Tuple[Phase, np.ndarray, Optional[np.ndarray]]] = None
    csr: Optional[PhaseCSR] = None
    csr_phase: Optional[Phase] = None
    for k, item in enumerate(phases):
        pp = item if isinstance(item, PipelinePhase) else PipelinePhase(item)
        ph = pp.phase
        # ranks joined at an earlier phase persist: re-apply their rows,
        # then resolve this phase's joins against the expanded mesh
        for mb, mc, sp in joined_rows:
            ph = expand_phase(ph, 1, mem_base=mb, mem_cap=mc, speed=sp)
        for j in joins:
            if j.iteration != k:
                continue
            for _ in range(j.count):
                mb = (float(np.median(ph.rank_mem_base))
                      if j.mem_base is None else float(j.mem_base))
                mc = (float(np.median(ph.rank_mem_cap))
                      if j.mem_cap is None else float(j.mem_cap))
                sp = (float(np.median(ph.rank_speed))
                      if j.speed is None else float(j.speed))
                joined_rows.append((mb, mc, sp))
                ph = expand_phase(ph, 1, mem_base=mb, mem_cap=mc, speed=sp)
        carried = 0
        use_a0 = a0 is not None and (k == 0 or not warm_start) \
            and np.asarray(a0).shape[0] == ph.num_tasks
        if use_a0:
            start = np.asarray(a0, np.int64).copy()
        elif warm_start and prev is not None:
            start, carried = warm_start_assignment(
                prev[0], prev[1], ph, prev_ids=prev[2], next_ids=pp.task_ids,
                mode=initial_mode)
        else:
            start = initial_assignment(ph, initial_mode)
        # timer covers the CSR build too: a cold run (csr=None) pays it
        # inside ccm_lb, so starting the clock here keeps cold/warm
        # per-phase seconds comparable
        t0 = time.perf_counter()
        reused = csr is not None and same_topology(csr_phase, ph)
        if not reused:
            if not reuse_csr:
                csr = None
            else:
                csr = PhaseCSR.from_phase(ph)
                csr_phase = ph
        carry = (runs[-1].result
                 if carry_engine and warm_start and runs else None)
        res = ccm_lb(ph, start, params_seq[k], seed=seed + k, csr=csr,
                     carry=carry, **lb_kwargs)
        runs.append(PhaseRun(result=res, warm_started=carried > 0,
                             csr_reused=reused, carried_tasks=carried,
                             seconds=time.perf_counter() - t0,
                             engine_carried=res.engine_carried))
        prev = (ph, res.assignment, pp.task_ids)
    return PipelineResult(runs)
