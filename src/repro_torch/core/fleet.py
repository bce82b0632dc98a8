"""Fleet mode: balance MANY independent CCM-LB instances through shared
window launches (``ccm_lb_many``; the port's counterpart of
``repro/core/fleet.py``).

The target workload is a scheduler balancing a fleet of similar problems —
per-job expert placements, per-replica pipeline stages, a sweep of phase
families — where each instance is small enough that a solo run is
dominated by fixed per-event host cost and, on the card, by one scorer
launch per lock event.

``ccm_lb_many`` advances all instances in LOCKSTEP: each iteration runs
every instance's prologue (cluster/summarize/gossip/work lists) on the
host, derives each instance's deterministic event sequence
(:func:`repro_torch.core.spec.event_sequence`), and drains ALL the queues
through shared :func:`repro_torch.core.spec.run_spec` windows — one launch
of the window kernel scores a window of events drawn round-robin across
the whole fleet.  Each instance owns a
:class:`~repro_torch.core.quiesce.QuiesceTracker` (clusters and summaries
patched for dirty ranks only, quiet gossip roots replayed, work lists
re-scored only where info changed) and a per-``(r, p, version)`` capture
cache (:class:`SpecInstance` ``cache``), so converged instances pay a
small constant per iteration.  Both reuses are value-exact: the reused
objects are deterministic functions of an unchanged state, and every
mutation bumps the state version, so stale captures are never looked up
again.

Parity contract: per-instance results are IDENTICAL (assignment and
transfer log) to solo ``ccm_lb(phase_i, a_i, params, seed=seeds[i], ...)``
runs — per-instance dirty sets and strict-prefix rollback keep each
instance's committed order equal to its solo event order, and the window
scorer sits in the trajectory-identity tier (core/spec.py).
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.ccm import CCMState
from repro_torch.core.ccmlb import CCMLBResult, ProtocolStats, _rebuild_local
from repro_torch.core.engine import PhaseEngine
from repro_torch.core.problem import CCMParams, Phase
from repro_torch.core.quiesce import QuiesceTracker
from repro_torch.core.spec import SpecInstance, event_sequence, run_spec
from repro_torch.kernels.ccm_scorer.launch import SPEC_MODES, resolve_device

__all__ = ["ccm_lb_many"]


def _mk_rebuild(state, clusters, engine, max_clusters_per_rank):
    # factory so each instance's closure binds ITS objects (late binding
    # in a loop would alias every closure to the last instance)
    return lambda r, p: _rebuild_local(state, clusters, engine,
                                       max_clusters_per_rank, r, p)


def _mk_log(log):
    def _cb(t, a, b):
        log.append((tuple(int(x) for x in t), int(a), int(b)))
    return _cb


def ccm_lb_many(phases: Sequence[Phase],
                assignments: Sequence[np.ndarray],
                params: CCMParams, *,
                n_iter: int = 4, k_rounds: int = 2, fanout: int = 4,
                seeds: Optional[Sequence[int]] = None, seed: int = 0,
                max_candidates: int = 12,
                max_clusters_per_rank: Optional[int] = None,
                device=None, dtype: torch.dtype = torch.float64,
                window: Optional[int] = None, mode: str = "vmap",
                spec_trace: bool = False) -> List[CCMLBResult]:
    """Balance ``phases[i]`` from ``assignments[i]`` for every ``i``, in
    lockstep, scoring all instances' lock events through shared windows.
    Returns one :class:`CCMLBResult` per instance, identical to the
    corresponding solo ``ccm_lb`` run (module docstring).

    ``seeds[i]`` is instance ``i``'s gossip seed (solo-equivalent ``seed``
    argument); defaults to ``seed + i``.  ``window`` is the shared window
    size, default ``len(phases)`` (every instance's next event fits one
    launch).  ``mode`` is the window scorer's (``"vmap"`` default, or
    ``"scan"``: the same kernel).  ``device`` is where the windows are
    scored (None means CUDA, ``"cpu"`` the plain version); ``dtype`` must
    be ``torch.float64`` (the window kernel is float64 only).
    """
    n = len(phases)
    if n == 0:
        raise ValueError("ccm_lb_many needs at least one instance")
    if len(assignments) != n:
        raise ValueError("one assignment per phase required")
    if seeds is None:
        seeds = [seed + i for i in range(n)]
    elif len(seeds) != n:
        raise ValueError("one seed per phase required")
    win = int(window) if window is not None else n
    if win < 1:
        raise ValueError("window must be >= 1")
    if dtype != torch.float64:
        raise ValueError("ccm_lb_many scores in float64 only (the window "
                         f"kernel has no {dtype} form)")
    if mode not in SPEC_MODES:
        raise ValueError(f"unknown spec mode: {mode!r}")
    device = resolve_device(device)

    states: List[CCMState] = []
    engines: List[PhaseEngine] = []
    trackers: List[QuiesceTracker] = []
    logs: List[list] = []
    stats: List[ProtocolStats] = []
    straces: List[Optional[list]] = []
    # speculative captures are keyed (r, p, state.version): any mutation
    # bumps the version, so stale entries are unreachable — no clearing
    caches: List[dict] = [dict() for _ in range(n)]
    t_max: List[List[float]] = []
    t_tot: List[List[float]] = []
    t_imb: List[List[float]] = []
    for i in range(n):
        st = CCMState.build(phases[i], assignments[i], params)
        states.append(st)
        engines.append(PhaseEngine(st, device=device, dtype=dtype,
                                   incremental=True))
        trackers.append(QuiesceTracker(
            st, engines[i], params, seed=seeds[i], k_rounds=k_rounds,
            fanout=fanout, max_clusters_per_rank=max_clusters_per_rank))
        log: list = []
        cb = _mk_log(log)
        st.add_transfer_listener(cb)
        st.add_transfer_listener(trackers[i].note_transfer)
        logs.append(log)
        stats.append(ProtocolStats())
        straces.append([] if spec_trace else None)
        t_max.append([st.max_work()])
        t_tot.append([st.total_work()])
        t_imb.append([st.imbalance()])

    for it in range(n_iter):
        insts: List[SpecInstance] = []
        for i in range(n):
            st = states[i]
            tr = trackers[i]
            tr.begin_iteration(it)
            clusters, _summaries = tr.update_summaries()
            info = tr.update_gossip()
            work_lists = tr.update_work_lists(info)
            seq = event_sequence(phases[i].num_ranks, work_lists)
            if seq:
                insts.append(SpecInstance(
                    state=st, engine=engines[i], clusters=clusters,
                    stats=stats[i],
                    rebuild=_mk_rebuild(st, clusters, engines[i],
                                        max_clusters_per_rank),
                    queue=deque(seq), max_candidates=max_candidates,
                    trace=straces[i], cache=caches[i]))
        if insts:
            run_spec(insts, window=win, mode=mode)
        for i in range(n):
            trackers[i].end_iteration()
            t_max[i].append(states[i].max_work())
            t_tot[i].append(states[i].total_work())
            t_imb[i].append(states[i].imbalance())

    return [CCMLBResult(states[i].assignment.copy(), states[i], t_max[i],
                        t_tot[i], t_imb[i], stats[i].transfers,
                        stats[i].conflicts, engine_used=True,
                        transfer_log=logs[i],
                        spec_rollbacks=stats[i].spec_rollbacks,
                        spec_windows=stats[i].spec_windows,
                        spec_trace=straces[i], engine=engines[i])
            for i in range(n)]
