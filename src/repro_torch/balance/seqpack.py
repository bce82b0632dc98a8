"""DP-batch sequence rebalancing via CCM (dense-arch application of the
paper's technique + straggler mitigation).

Variable-length sequences make data-parallel step time = the slowest rank's
work.  Sequences are CCM tasks (cost from the learned cost model or an
analytic len->time curve), ranks carry measured speed factors (EWMA from
repro_torch.runtime.straggler), and CCM-LB plans the sequence->rank map;
with alpha=1 and no blocks this degenerates to speed-aware multiway number
partitioning — exactly the paper's model with beta=gamma=delta=0.

The port's copy of the JAX package's ``balance/seqpack.py``: host numpy,
the engine's stage 2 scored on ``device`` (the pair kernel on the card).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import CCMParams, ccm_lb_pipeline, run_ccm_lb
from repro_torch.core.problem import Phase


@dataclasses.dataclass
class SeqPackResult:
    assignment: np.ndarray
    makespan_before: float
    makespan_after: float
    imbalance_before: float
    imbalance_after: float


def _seq_phase(costs: np.ndarray, n_ranks: int,
               rank_speed: Optional[np.ndarray],
               act_bytes: Optional[np.ndarray], mem_cap: float) -> Phase:
    k = costs.shape[0]
    return Phase(
        task_load=costs,
        task_mem=act_bytes if act_bytes is not None else np.zeros(k),
        task_overhead=np.zeros(k),
        task_block=np.full(k, -1, np.int64),
        block_size=np.zeros(0),
        block_home=np.zeros(0, np.int64),
        comm_src=np.zeros(0, np.int64),
        comm_dst=np.zeros(0, np.int64),
        comm_vol=np.zeros(0),
        rank_mem_base=np.zeros(n_ranks),
        rank_mem_cap=np.full(n_ranks, mem_cap),
        rank_speed=rank_speed,
    )


def _seq_result(res) -> SeqPackResult:
    return SeqPackResult(
        assignment=res.assignment,
        makespan_before=float(res.max_work[0]),
        makespan_after=res.state.max_work(),
        imbalance_before=float(res.imbalance[0]),
        imbalance_after=res.state.imbalance(),
    )


def rebalance_sequences(costs: np.ndarray, n_ranks: int, *,
                        rank_speed: Optional[np.ndarray] = None,
                        act_bytes: Optional[np.ndarray] = None,
                        mem_cap: float = np.inf, seed: int = 0,
                        n_iter: int = 3,
                        use_engine: bool = True,
                        device=None,
                        dtype: torch.dtype = torch.float64,
                        batch_lock_events: int = 1,
                        spec_window: int = 1,
                        spec_mode: str = "scan",
                        async_mode: bool = False,
                        latency=0.0,
                        gossip_timeout=None,
                        quiesce_after: Optional[int] = None
                        ) -> SeqPackResult:
    """costs: (n_seqs,) predicted step-time contribution per sequence.

    ``device`` is where the engine scores stage 2: ``None`` (default) means
    ``"cuda"`` and raises without a card, ``"cpu"`` runs the plain torch
    scorer; ``dtype`` ``torch.float64`` (bitwise the JAX package's
    ``backend="numpy"``) or ``torch.float32``, as in
    :func:`repro_torch.core.ccm_lb`.  ``spec_window`` / ``spec_mode``
    route stage 2 through the speculative driver (core/spec.py, the
    window kernel on the card).  ``async_mode`` packs through the
    distributed event-loop simulator (``latency``/``gossip_timeout`` per
    core/async_sim.py; zero latency packs identically).
    ``quiesce_after`` stops early after that many consecutive
    zero-transfer iterations (core/quiesce.py)."""
    k = costs.shape[0]
    phase = _seq_phase(costs, n_ranks, rank_speed, act_bytes, mem_cap)
    a0 = (np.arange(k) % n_ranks).astype(np.int64)
    params = CCMParams(alpha=1.0, beta=0.0, gamma=0.0, delta=0.0,
                       memory_constraint=np.isfinite(mem_cap))
    res = run_ccm_lb(phase, a0, params, n_iter=n_iter, fanout=4, seed=seed,
                     use_engine=use_engine, device=device, dtype=dtype,
                     batch_lock_events=batch_lock_events,
                     spec_window=spec_window, spec_mode=spec_mode,
                     async_mode=async_mode, latency=latency,
                     gossip_timeout=gossip_timeout,
                     quiesce_after=quiesce_after)
    return _seq_result(res)


def rebalance_sequences_stream(
        cost_batches: Sequence[np.ndarray], n_ranks: int, *,
        rank_speed: Optional[np.ndarray] = None,
        mem_cap: float = np.inf, seed: int = 0, n_iter: int = 3,
        warm_start: bool = True, use_engine: bool = True,
        device=None, dtype: torch.dtype = torch.float64,
        batch_lock_events: int = 1, spec_window: int = 1,
        spec_mode: str = "scan",
        quiesce_after: Optional[int] = None) -> List[SeqPackResult]:
    """Rebalance a STREAM of DP batches (one phase per step): slot ``i`` of
    batch ``k+1`` warm-starts on the rank slot ``i`` of batch ``k`` landed
    on — under steady length distributions the previous map is already
    near-balanced, so each step only repairs the drift.  Equal-sized
    batches also share the (trivial, comm-free) PhaseCSR.  Runs through
    :func:`repro_torch.core.ccm_lb_pipeline`; ``warm_start=False`` is the
    per-batch-from-scratch cold reference.  ``device`` / ``dtype`` as in
    :func:`rebalance_sequences`.
    """
    cost_batches = [np.asarray(c, np.float64) for c in cost_batches]
    if not cost_batches:
        return []
    phases = [_seq_phase(c, n_ranks, rank_speed, None, mem_cap)
              for c in cost_batches]
    params = CCMParams(alpha=1.0, beta=0.0, gamma=0.0, delta=0.0,
                       memory_constraint=np.isfinite(mem_cap))
    a0 = (np.arange(cost_batches[0].shape[0]) % n_ranks).astype(np.int64)
    pipe = ccm_lb_pipeline(phases, params, warm_start=warm_start, a0=a0,
                           initial_mode="round_robin", seed=seed,
                           n_iter=n_iter, fanout=4, use_engine=use_engine,
                           device=device, dtype=dtype,
                           batch_lock_events=batch_lock_events,
                           spec_window=spec_window, spec_mode=spec_mode,
                           quiesce_after=quiesce_after)
    return [_seq_result(run.result) for run in pipe.runs]
