"""CCM-LB: the distributed, heuristic load-balancing algorithm (paper §IV,
Fig. 1), as a deterministic multi-rank discrete-event simulation.

Per iteration:
  1. cluster tasks on every rank (shared blocks + heavy comm edges);
  2. augmented inform stage — gossip rank+cluster summaries with ``fanout``
     over ``k_rounds`` (core/gossip.py);
  3. every rank scores its known peers with the stale-info approximation and
     builds a sorted work_list;
  4. lock/transfer stage — ranks try to lock their best peers (deadlock-free
     priority rule), then evaluate exactly (update formulae) with fresh info
     and execute the best cluster give/swap.

Evaluation engine: with ``use_engine=True`` (default) stages 3 and 4 run on
the vectorized :class:`~repro_torch.core.engine.PhaseEngine` — stage 3
scores all of a rank's known peers with one matrix op, stage 4 scores all
shortlisted cluster pairs of a lock event in one batched pass, whose tile
scorer is the CUDA kernel on ``device="cuda"`` (the default) or the plain
torch version on ``device="cpu"``.  ``use_engine=False`` keeps the scalar
per-candidate loops (the reference path, host numpy only); both produce
identical transfer traces on the parity suites (stage-2 scores may differ
by summation-order ulps, so a sub-ulp near-tie between two candidate
exchanges could in principle diverge the paths).

The port's counterpart of ``repro/core/ccmlb.py``: the same host control
flow and the same §IV-B protocol handlers.  ``spec_window > 1`` routes
stage 2 through the speculative-scan driver (core/spec.py): a window of
lock events a launch of the window kernel.  Not ported yet: the async
driver and multi-phase carry-over (see ROADMAP.md).

Batched lock events: ``batch_lock_events=k`` defers the scoring of up to
``k`` executable lock events whose rank pairs are pairwise disjoint, then
scores them in ONE engine call (one block-diagonal flow assembly, one
kernel launch).  Trajectory-exact in exact
arithmetic: a transfer between ranks (a, b) cannot change the score,
shortlist or clusters of a disjoint pair (c, d) — see
``PhaseEngine.batch_exchange_eval_multi`` — and the event sequence itself
is independent of scoring outcomes (turn order is fixed by the stage-3
work lists and the lock protocol).  The batch is flushed the moment a turn
touches a rank with a deferred event, on a full batch, and at stage end,
so the sequential order of state mutations is preserved.  Grant-chain
handoffs ride the same deferred machinery as single-event batches: each
chain transfer on (cur, p) is appended to the pending batch (joining
already-deferred disjoint events) and the shared rank p forces a flush
before the next chain element scores — the same disjointness argument, the
same sequential mutation order.
The guarantee carries the same sub-ulp caveat as the engine-vs-scalar
contract: a disjoint (a, b) swap relabels entries of vol rows/columns of
third ranks without changing their true sums, so the ``st.vol[r].sum()``
bases a deferred event reads can differ from the sequential path's
post-swap re-summation by summation-order ulps — a near-tie inside that
window could in principle flip the selected exchange.
The parity tests assert identical trajectories empirically (they hold on
every tested instance).

The §IV-B lock/grant handlers (:func:`lock_request`, :func:`note_yield`,
:func:`lock_release`, :func:`execute_transfer`) are the only code paths
that touch the lock manager or execute a transfer.  On this synchronous
round-robin driver every lock is requested, used and released within the
turn that took it, so lock conflicts, deadlock-avoidance yields and grant
chains are structurally unreachable (``CCMLBResult.lock_conflicts`` is zero
by construction); the JAX package's asynchronous driver reaches them.

Returns the improved assignment plus a trace (max work, imbalance, transfers
per iteration) used by tests and benchmarks.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from time import perf_counter
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ccm import CCMState
from repro_torch.core.clusters import (build_clusters, summarize_clusters,
                                       summarize_rank)
from repro_torch.core.engine import (ExchangeEvent, PhaseEngine,
                                     batch_peer_diffs, build_summary_tables)
from repro_torch.core.locks import LockManager
from repro_torch.core.problem import CCMParams, Phase
from repro_torch.core.quiesce import QuiesceTracker
from repro_torch.core.spec import (SPEC_FILLS, SpecInstance, event_sequence,
                                   run_spec)
from repro_torch.core.transfer import (approx_best_diff, select_best,
                                       shortlist_pairs, try_transfer)
from repro_torch.kernels.ccm_scorer.launch import SPEC_MODES, resolve_device


@dataclasses.dataclass
class CCMLBResult:
    assignment: np.ndarray
    state: CCMState
    max_work: List[float]          # per iteration (incl. initial)
    total_work: List[float]
    imbalance: List[float]
    transfers: int
    lock_conflicts: int
    engine_used: bool = True
    # §IV-B protocol counters (uniform accounting via ProtocolStats; all of
    # them — lock_conflicts included — are structurally zero on this
    # synchronous driver)
    yields: int = 0
    grant_chains: int = 0
    max_grant_chain: int = 0
    # every state mutation in execution order: (task-id tuple, r_from,
    # r_to); replaying it onto the initial assignment reproduces
    # ``assignment`` exactly
    transfer_log: Optional[list] = None
    # speculative-scan observability (zero/None off the spec driver)
    spec_rollbacks: int = 0        # window events rolled back + re-queued
    spec_windows: int = 0          # windows (launches when any row scored)
    spec_trace: Optional[list] = None   # (window, kind, r, p) commit trace
    engine: Optional[PhaseEngine] = None
    # quiescence observability (core/quiesce.py): per-iteration transfer
    # counts, optional per-iteration stage timing dicts (``profile=True``),
    # cumulative tracker-counter snapshots, and the live tracker itself
    iter_transfers: Optional[List[int]] = None
    stage_timings: Optional[List[dict]] = None
    quiesce_counters: Optional[List[dict]] = None
    memo_hits: int = 0
    gossip_noop_merges: int = 0
    tracker: Optional[QuiesceTracker] = None


@dataclasses.dataclass
class ProtocolStats:
    """Uniform accounting of the §IV-B lock protocol.

    On this synchronous driver every lock is released within the turn that
    took it, so ``conflicts`` / ``yields`` / chain counters can only ever be
    zero here — by construction (the JAX package's async driver reaches
    them).  ``conflicts`` counts both queued lock requests and
    deadlock-avoidance yields; ``yields`` separates the Fig. 1 line 45
    releases.  A *grant chain* is a maximal run of queue handoffs on one
    target (release -> grant to next queued requester);
    ``max_grant_chain`` is the longest such run's handoff count.
    """

    conflicts: int = 0
    yields: int = 0
    grant_chains: int = 0
    max_grant_chain: int = 0
    transfers: int = 0
    # speculative-scan counters (core/spec.py; zero on the other drivers)
    spec_rollbacks: int = 0
    spec_windows: int = 0
    # failed-evaluation memo (core/quiesce.py): (r, p) -> the
    # ``state.version`` at which the pair's exact evaluation last failed.
    # A hit at the CURRENT version proves nothing has mutated since, so
    # the evaluation is skipped — bitwise-neutral, because the skipped
    # path's only effect would be returning False again.  ``None`` (the
    # rebuild reference and the scalar path) disables the memo.  The
    # lock dance is NEVER skipped: the memo is consulted only after the
    # grant, so conflict/yield/grant-chain patterns are unchanged.
    memo: Optional[Dict[tuple, int]] = None
    memo_hits: int = 0
    # per-iteration stage-timing dict (``ccm_lb(profile=True)``): the
    # stage-2 drivers split their time into "score" (exact evaluation)
    # and "commit" (state mutation + cluster rebuild) buckets
    timings: Optional[dict] = None
    # target -> current consecutive queue-handoff count (internal)
    _chain_run: Dict[int, int] = dataclasses.field(default_factory=dict)


# --------------------------------------------------------------------------
# Shared §IV-B protocol handlers — the ONLY code paths through which either
# driver touches the lock manager or executes a transfer, so the two
# drivers cannot drift apart in semantics or accounting.

def lock_request(locks: LockManager, stats: ProtocolStats, r: int,
                 p: int) -> bool:
    """Fig. 1 line 42: rank ``r`` requests ``p``'s lock.  A busy target
    queues the request FIFO (granted later through a release handoff) and
    counts one conflict."""
    granted = locks.request(r, p)
    if not granted:
        stats.conflicts += 1
    return granted


def note_yield(stats: ProtocolStats) -> None:
    """Fig. 1 line 45 fired: the holder is itself locked by r_x <= target,
    so it releases the lock unused and retries later."""
    stats.conflicts += 1
    stats.yields += 1


def lock_release(locks: LockManager, stats: ProtocolStats, holder: int,
                 target: int) -> Optional[int]:
    """Fig. 1 line 49: release ``target``; a queued requester (returned)
    receives the lock — one handoff link of ``target``'s grant chain."""
    nxt = locks.release(holder, target)
    if nxt is None:
        stats._chain_run.pop(target, None)     # chain episode over
    else:
        run = stats._chain_run.get(target, 0) + 1
        stats._chain_run[target] = run
        if run == 1:
            stats.grant_chains += 1
        if run > stats.max_grant_chain:
            stats.max_grant_chain = run
    return nxt


def execute_transfer(state, clusters, engine, stats: ProtocolStats, r: int,
                     p: int, max_candidates: int,
                     max_clusters_per_rank, replicate: bool = False) -> bool:
    """Fig. 1 lines 46–48 (recvUpdate / TryTransfer / sendUpdate): exact
    evaluation with fresh info, execute the best positive exchange, rebuild
    the two touched ranks' clusters.  Returns True iff a transfer ran.

    ``stats.memo`` (when enabled) short-circuits a pair whose exact
    evaluation already failed at the current ``state.version`` — the
    dominant cost of a converged iteration, where every candidate scores
    positive on stale info and fails the fresh-info evaluation again.
    (The memo stays valid with ``replicate``: the extra candidates are a
    pure function of the state, so a failed evaluation at a version fails
    again at the same version.)"""
    memo = stats.memo
    if memo is not None and memo.get((r, p)) == state.version:
        stats.memo_hits += 1
        return False
    tm = stats.timings
    t0 = perf_counter() if tm is not None else 0.0
    best = try_transfer(state, clusters[r], clusters[p], r, p,
                        max_candidates, engine=engine, replicate=replicate)
    if tm is not None:
        tm["score"] += perf_counter() - t0
    if best is None:
        if memo is not None:
            memo[(r, p)] = state.version
        return False
    stats.transfers += 1
    t0 = perf_counter() if tm is not None else 0.0
    _rebuild_local(state, clusters, engine, max_clusters_per_rank, r, p)
    if tm is not None:
        tm["commit"] += perf_counter() - t0
    return True


def iteration_summaries(state, phase, max_clusters_per_rank,
                        replicate=False):
    """Per-iteration prologue shared by both drivers: cluster every rank
    and summarize (rank + cluster summaries are this iteration's gossip
    payloads).  With ``replicate`` the cluster summaries carry virtual
    half-split entries so stage 1 can score replication moves."""
    clusters = build_clusters(state,
                              max_clusters_per_rank=max_clusters_per_rank)
    csum = summarize_clusters(state, clusters, replicate=replicate)
    summaries = {r: summarize_rank(state, r, csum[r])
                 for r in range(phase.num_ranks)}
    return clusters, summaries


def build_work_lists(phase, summaries, info, params,
                     engine) -> Dict[int, deque]:
    """Stage 1 (Fig. 1 lines 31–40): every rank scores its gossip-known
    peers with the stale-info approximation and sorts a best-first work
    list (ties broken by peer id, so the lists depend only on the known-
    peer SETS, not dict insertion order).  Shared by both drivers — the
    async zero-latency parity bar starts from identical lists.

    The batched path reads the global summary tables — valid because
    gossip payloads are references to this iteration's summary objects, so
    only the known-peer SETS are stale, never the values (see
    batch_peer_diffs).
    """
    work_lists: Dict[int, deque] = {}
    tables = (build_summary_tables(summaries, params)
              if engine is not None else None)
    for r in range(phase.num_ranks):
        scored: List[Tuple[float, int]] = []
        if engine is not None:
            peers = np.array([p for p in info[r] if p != r], np.int64)
            # the tables are valid stand-ins for the gossip payloads
            # only while payloads alias this iteration's summaries
            assert all(info[r][int(p)] is summaries[int(p)]
                       for p in peers), \
                "gossip payloads must alias current summaries"
            diffs = batch_peer_diffs(tables, r, peers, params)
            scored = [(float(d), int(p)) for d, p in zip(diffs, peers)
                      if d > 0]
        else:
            for p, psum in info[r].items():
                if p == r:
                    continue
                diff = approx_best_diff(summaries[r], psum, params)
                if diff > 0:
                    scored.append((diff, p))
        scored.sort(key=lambda t: (-t[0], t[1]))
        work_lists[r] = deque(scored)
    return work_lists


def ccm_lb(phase: Phase, assignment: np.ndarray, params: CCMParams, *,
           n_iter: int = 4, k_rounds: int = 2, fanout: int = 4,
           seed: int = 0, max_candidates: int = 12,
           max_clusters_per_rank: Optional[int] = None,
           use_engine: bool = True, device=None,
           dtype: torch.dtype = torch.float64,
           batch_lock_events: int = 1, incremental: bool = True,
           spec_window: int = 1, spec_mode: str = "scan",
           spec_fill: str = "disjoint", spec_trace: bool = False,
           quiesce_after: Optional[int] = None,
           profile: bool = False, replicate: bool = False) -> CCMLBResult:
    """Run CCM-LB on ``phase`` from ``assignment``.

    ``device`` is where the engine scores stage 2: ``None`` (default) means
    ``"cuda"`` and raises when ``torch.cuda.is_available()`` is false;
    ``"cpu"`` runs the plain torch scorer.  ``dtype`` is
    ``torch.float64`` (default; bitwise-equal to the JAX package's
    ``backend="numpy"``) or ``torch.float32`` (tiles scored in float32, the
    counterpart of ``backend="pallas_compiled"``; assignment-identity tier).

    ``incremental`` keeps the engine's per-rank segments current via the
    transfer hook (default; ``False`` re-gathers per event — the rebuild
    reference) and enables the quiescence caches (core/quiesce.py):
    dirty-rank gossip replay, patched cluster/rank summaries and summary
    tables, cached sorted work lists, and the failed-evaluation memo —
    bitwise-identical trajectories to the ``incremental=False`` rebuild
    reference.

    ``quiesce_after=k`` stops the iteration loop after ``k`` consecutive
    zero-transfer iterations; ``None`` (default) always runs ``n_iter``.
    ``profile=True`` records a per-iteration host-cost breakdown (clusters
    / gossip / work_lists / score / commit seconds) in
    ``CCMLBResult.stage_timings``.

    ``batch_lock_events=k`` scores up to ``k`` rank-disjoint lock events in
    one engine call (see the module docstring).

    ``replicate=True`` extends every lock event's candidate set with block
    replication splits and de-replication consolidations
    (``core.transfer.memory_move_candidates``), scored through the scalar
    reference evaluator after the base vocabulary and accepted only on a
    strictly greater work diff.  Incompatible with
    ``batch_lock_events > 1``, which can only score the engine's cluster
    vocabulary.

    ``spec_window > 1`` routes stage 2 through the speculative-scan driver
    (core/spec.py): windows of up to ``spec_window`` lock events score in
    one launch of the window kernel (``spec_mode`` "scan" or "vmap", which
    launch the same kernel), with host-side rollback of invalidated
    speculations; float64 only.  Trajectory-identity tier: the same
    assignment and transfer log as the host engine, asserted empirically.
    ``spec_fill`` picks the speculation policy — ``"disjoint"`` (default)
    takes only rank-disjoint event prefixes per window, making rollback
    structurally impossible; ``"greedy"`` fills blindly and rolls back
    invalidated speculations (``core.spec.run_spec``).
    ``spec_trace=True`` records the per-event commit/rollback trace in
    ``CCMLBResult.spec_trace``.
    """
    if batch_lock_events < 1:
        raise ValueError("batch_lock_events must be >= 1")
    if batch_lock_events > 1 and not use_engine:
        raise ValueError("batch_lock_events > 1 requires use_engine=True")
    if spec_window < 1:
        raise ValueError("spec_window must be >= 1")
    if spec_window > 1 and not use_engine:
        raise ValueError("spec_window > 1 requires use_engine=True")
    if spec_window > 1 and batch_lock_events > 1:
        raise ValueError("spec_window and batch_lock_events are mutually "
                         "exclusive stage-2 drivers")
    if spec_window > 1 and dtype != torch.float64:
        raise ValueError("spec_window > 1 scores in float64 only (the "
                         f"window kernel has no {dtype} form)")
    if spec_mode not in SPEC_MODES:
        raise ValueError(f"unknown spec mode: {spec_mode!r}")
    if spec_fill not in SPEC_FILLS:
        raise ValueError("spec_fill must be 'disjoint' or 'greedy'")
    if quiesce_after is not None and quiesce_after < 1:
        raise ValueError("quiesce_after must be >= 1 (or None)")
    if replicate and batch_lock_events > 1:
        raise ValueError("replicate requires the scalar stage-2 loop — "
                         "incompatible with batch_lock_events > 1")
    if replicate and spec_window > 1:
        raise ValueError("replicate requires the scalar stage-2 loop — "
                         "incompatible with spec_window > 1")
    device = resolve_device(device)
    state = CCMState.build(phase, assignment, params)
    engine = (PhaseEngine(state, device=device, dtype=dtype,
                          incremental=incremental)
              if use_engine else None)
    tracker = QuiesceTracker(state, engine, params, seed=seed,
                             k_rounds=k_rounds, fanout=fanout,
                             max_clusters_per_rank=max_clusters_per_rank,
                             caching=incremental, replicate=replicate)
    transfer_log: list = []

    def _log_cb(t, a, b):
        transfer_log.append((tuple(int(x) for x in t), int(a), int(b)))

    state.add_transfer_listener(_log_cb)
    state.add_transfer_listener(tracker.note_transfer)
    trace_max = [state.max_work()]
    trace_tot = [state.total_work()]
    trace_imb = [state.imbalance()]
    stats = ProtocolStats()
    stats.memo = tracker.memo if tracker.caching else None
    strace: Optional[list] = [] if spec_trace else None
    stage_timings: Optional[List[dict]] = [] if profile else None
    iter_transfers: List[int] = []
    quiet = 0

    for it in range(n_iter):
        tm = ({"clusters": 0.0, "gossip": 0.0, "work_lists": 0.0,
               "score": 0.0, "commit": 0.0} if profile else None)
        stats.timings = tm
        tracker.begin_iteration(it)
        t0 = perf_counter() if profile else 0.0
        clusters, summaries = tracker.update_summaries()
        if profile:
            t1 = perf_counter()
            tm["clusters"] = t1 - t0
            t0 = t1
        info = tracker.update_gossip()
        if profile:
            t1 = perf_counter()
            tm["gossip"] = t1 - t0
            t0 = t1
        if tracker.caching:
            work_lists = tracker.update_work_lists(info)
        else:
            work_lists = build_work_lists(phase, summaries, info, params,
                                          engine)
        if profile:
            tm["work_lists"] = perf_counter() - t0
        before = stats.transfers

        # stage 2: lock/transfer event loop
        if spec_window > 1:
            _stage2_spec(phase, state, clusters, work_lists, engine,
                         max_candidates, max_clusters_per_rank, spec_window,
                         spec_mode, spec_fill, stats, strace)
        elif batch_lock_events > 1:
            _stage2_batched(phase, state, clusters, work_lists, engine,
                            max_candidates, max_clusters_per_rank,
                            batch_lock_events, stats)
        else:
            _stage2(phase, state, clusters, work_lists, engine,
                    max_candidates, max_clusters_per_rank, stats,
                    replicate=replicate)

        delta = stats.transfers - before
        iter_transfers.append(delta)
        tracker.end_iteration()
        trace_max.append(state.max_work())
        trace_tot.append(state.total_work())
        trace_imb.append(state.imbalance())
        if profile:
            stage_timings.append(tm)
        if quiesce_after is not None:
            quiet = quiet + 1 if delta == 0 else 0
            if quiet >= quiesce_after:
                break

    return CCMLBResult(state.assignment.copy(), state, trace_max, trace_tot,
                       trace_imb, stats.transfers, stats.conflicts,
                       engine_used=engine is not None, yields=stats.yields,
                       grant_chains=stats.grant_chains,
                       max_grant_chain=stats.max_grant_chain,
                       transfer_log=transfer_log,
                       spec_rollbacks=stats.spec_rollbacks,
                       spec_windows=stats.spec_windows,
                       spec_trace=strace, engine=engine,
                       iter_transfers=iter_transfers,
                       stage_timings=stage_timings,
                       quiesce_counters=tracker.iter_counters,
                       memo_hits=stats.memo_hits,
                       gossip_noop_merges=tracker.counters.get(
                           "gossip_noop_merges", 0),
                       tracker=tracker)


def _stage2_spec(phase, state, clusters, work_lists, engine, max_candidates,
                 max_clusters_per_rank, window, mode, fill,
                 stats: ProtocolStats, trace: Optional[list]) -> None:
    """Stage 2 through the speculative-scan driver: derive the reference
    event sequence up front (deterministic on this driver — see
    core/spec.py), then drain it through windowed launches with
    strict-prefix commit/rollback."""
    seq = event_sequence(phase.num_ranks, work_lists)
    if not seq:
        return
    inst = SpecInstance(
        state=state, engine=engine, clusters=clusters, stats=stats,
        rebuild=lambda r, p: _rebuild_local(state, clusters, engine,
                                            max_clusters_per_rank, r, p),
        queue=deque(seq), max_candidates=max_candidates, trace=trace)
    run_spec([inst], window=window, mode=mode, fill=fill,
             timings=stats.timings)


def _rebuild_local(state, clusters, engine, max_clusters_per_rank, r, p):
    """Post-transfer cluster rebuild for the two touched ranks, fed from the
    engine's incremental segments when available."""
    rt = (engine.rank_tasks
          if engine is not None and engine.incremental else None)
    local = build_clusters(state, max_clusters_per_rank=max_clusters_per_rank,
                           only_ranks=[r, p], rank_tasks=rt)
    clusters[r] = local[r]
    clusters[p] = local[p]


def _stage2(phase, state, clusters, work_lists, engine, max_candidates,
            max_clusters_per_rank, stats: ProtocolStats,
            replicate: bool = False) -> None:
    """One-event-at-a-time lock/transfer loop (the reference event order).

    Every lock taken here is released before the turn ends and queued
    requests are drained synchronously on release (_handle_grant), so the
    not-granted and must-yield branches are structurally unreachable
    through this driver — they exist for protocol fidelity and are
    load-bearing under the async driver, which shares the handlers.
    """
    locks = LockManager(phase.num_ranks)
    # round-robin over ranks for fairness; each "turn" a rank either
    # requests its best remaining peer or is idle.  Queued lock requests
    # are drained synchronously on release (_handle_grant), so a
    # non-empty active deque is the only liveness condition.
    active = deque(r for r in range(phase.num_ranks) if work_lists[r])
    spins = 0
    max_spins = 50 * phase.num_ranks + 1000
    while active and spins < max_spins:
        spins += 1
        r = active.popleft()
        if not work_lists[r]:
            continue
        diff, p = work_lists[r].popleft()
        if not lock_request(locks, stats, r, p):
            # re-queue the attempt at the back (retry later)
            work_lists[r].append((diff * 0.5, p))
            if work_lists[r]:
                active.append(r)
            continue
        # granted: deadlock-avoidance check (Fig.1 line 45)
        if locks.must_yield(r, p):
            note_yield(stats)
            nxt = lock_release(locks, stats, r, p)
            work_lists[r].append((diff, p))
            active.append(r)
            if nxt is not None:
                _handle_grant(nxt, p, state, clusters, locks, work_lists,
                              active, max_candidates, max_clusters_per_rank,
                              engine, stats, replicate=replicate)
            continue
        # fresh info exchange + exact transfer (recvUpdate/TryTransfer)
        execute_transfer(state, clusters, engine, stats, r, p,
                         max_candidates, max_clusters_per_rank,
                         replicate=replicate)
        nxt = lock_release(locks, stats, r, p)
        if nxt is not None:
            _handle_grant(nxt, p, state, clusters, locks, work_lists, active,
                          max_candidates, max_clusters_per_rank, engine,
                          stats, replicate=replicate)
        if work_lists[r]:
            active.append(r)


@dataclasses.dataclass
class _PendingEvent:
    """An executable lock event whose scoring has been deferred."""

    r: int
    p: int
    cand_a: list
    cand_b: list
    pairs: np.ndarray       # (P, 2) shortlist rows
    agg_a: object
    agg_b: object
    w_before: float


def _stage2_batched(phase, state, clusters, work_lists, engine,
                    max_candidates, max_clusters_per_rank,
                    batch: int, stats: ProtocolStats) -> None:
    """Lock/transfer loop with deferred, batched event scoring.

    Identical turn order to :func:`_stage2` (lock state never outlives a
    turn, so request/grant outcomes cannot differ); only the try_transfer
    evaluation of up to ``batch`` pairwise-disjoint events is deferred and
    executed at flush points in original event order.  Flushes happen
    before any turn that touches a deferred rank, on a full batch, and at
    stage end — exactly the moments the sequential loop would have
    interleaved state mutations.  Grant-chain handoffs go through
    :func:`_handle_grant_deferred`: each chain event joins the pending
    batch as a single-event entry (it may share a flush with
    already-deferred DISJOINT events; the chain's shared rank ``p`` forces
    a flush before the next chain element scores), so chains ride the same
    deferred-scoring machinery with the same trajectory argument.
    """
    locks = LockManager(phase.num_ranks)
    active = deque(r for r in range(phase.num_ranks) if work_lists[r])
    pending: List[_PendingEvent] = []
    busy: set = set()

    def flush():
        if not pending:
            return
        tm = stats.timings
        t0 = perf_counter() if tm is not None else 0.0
        results = engine.batch_exchange_eval_multi([
            ExchangeEvent(e.r, e.p, e.cand_a, e.cand_b, e.pairs,
                          e.agg_a, e.agg_b) for e in pending])
        if tm is not None:
            t1 = perf_counter()
            tm["score"] += t1 - t0
            t0 = t1
        # commit bookkeeping is batched: swaps run per event in original
        # order (their float accumulation order is load-bearing), the
        # cluster rebuilds fold into ONE build_clusters call over all
        # touched ranks.  Valid because the flushed events are pairwise
        # rank-disjoint and nothing reads the cluster lists before the
        # flush returns; bitwise because build_clusters is per-rank local
        # (same labels, caps and thresholds either way).
        touched: List[int] = []
        for e, (wa, wb, feas) in zip(pending, results):
            best = select_best(e.cand_a, e.cand_b, e.pairs, wa, wb, feas,
                               e.w_before)
            if best is not None:
                state.swap(best.tasks_ab, e.r, best.tasks_ba, e.p)
                stats.transfers += 1
                touched.extend((e.r, e.p))
            elif stats.memo is not None:
                # record at the current version — exactly what the
                # sequential path would have recorded at this event's
                # turn (earlier flush commits already bumped it)
                stats.memo[(e.r, e.p)] = state.version
        if touched:
            rt = (engine.rank_tasks
                  if engine is not None and engine.incremental else None)
            local = build_clusters(state,
                                   max_clusters_per_rank=max_clusters_per_rank,
                                   only_ranks=touched, rank_tasks=rt)
            for r in touched:
                clusters[r] = local[r]
        if tm is not None:
            tm["commit"] += perf_counter() - t0
        pending.clear()
        busy.clear()

    def defer(r, p):
        # the memo short-circuit mirrors execute_transfer's: a pair whose
        # evaluation failed at the current version cannot succeed now
        # (pending deferred events haven't mutated anything yet), so the
        # event is dropped without joining the batch — the sequential
        # path returns the same False
        if stats.memo is not None and stats.memo.get((r, p)) == state.version:
            stats.memo_hits += 1
            return
        # capture candidates/shortlist now (invariant under the other
        # deferred events' transfers — disjoint ranks), score at flush
        cand_a, cand_b, pairs, agg_a, agg_b = shortlist_pairs(
            state, clusters[r], clusters[p], r, p, max_candidates,
            engine=engine)
        w_before = max(state.work(r), state.work(p))
        pending.append(_PendingEvent(r, p, cand_a, cand_b, pairs,
                                     agg_a, agg_b, w_before))
        busy.update((r, p))
        if len(pending) >= batch:
            flush()

    spins = 0
    max_spins = 50 * phase.num_ranks + 1000
    while active and spins < max_spins:
        spins += 1
        r = active.popleft()
        if not work_lists[r]:
            continue
        if r in busy or work_lists[r][0][1] in busy:
            flush()     # this turn reads/mutates a deferred rank
        diff, p = work_lists[r].popleft()
        if not lock_request(locks, stats, r, p):
            work_lists[r].append((diff * 0.5, p))
            if work_lists[r]:
                active.append(r)
            continue
        if locks.must_yield(r, p):
            note_yield(stats)
            nxt = lock_release(locks, stats, r, p)
            work_lists[r].append((diff, p))
            active.append(r)
            if nxt is not None:
                _handle_grant_deferred(nxt, p, state, locks, work_lists,
                                       active, busy, defer, flush, stats)
            continue
        defer(r, p)
        nxt = lock_release(locks, stats, r, p)
        if nxt is not None:
            _handle_grant_deferred(nxt, p, state, locks, work_lists, active,
                                   busy, defer, flush, stats)
        if work_lists[r]:
            active.append(r)
    flush()


def _handle_grant_deferred(r: int, p: int, state, locks, work_lists, active,
                           busy, defer, flush,
                           stats: ProtocolStats) -> None:
    """Grant-chain drain for the batched path: chain events are deferred
    through the same single-flush machinery instead of scored scalarly.

    Mirrors :func:`_handle_grant`'s control flow exactly — the chain
    structure (who yields, who releases to whom, re-activation order) never
    depends on scoring outcomes, so deferring the evaluations preserves the
    sequential trajectory: an event only joins the pending batch when its
    ranks are disjoint from every deferred event (otherwise ``flush()``
    first), and consecutive chain elements share ``p``, so each forces the
    previous element's flush before it captures its shortlist.
    """
    post: List[int] = []
    cur: Optional[int] = r
    while cur is not None:
        if locks.must_yield(cur, p):
            note_yield(stats)
            nxt = lock_release(locks, stats, cur, p)
            active.append(cur)
            cur = nxt
            continue
        if cur in busy or p in busy:
            flush()     # chain event must see the deferred swaps it touches
        defer(cur, p)
        nxt = lock_release(locks, stats, cur, p)
        post.append(cur)
        cur = nxt
    for rr in reversed(post):
        if work_lists[rr]:
            active.append(rr)


def _handle_grant(r: int, p: int, state, clusters, locks, work_lists, active,
                  max_candidates, max_clusters_per_rank, engine,
                  stats: ProtocolStats, replicate: bool = False) -> int:
    """Drain the lock-release handoff chain on ``p`` starting at requester
    ``r``.  Iterative (a long chain of queued requesters must not hit the
    Python recursion limit at large rank counts); the re-activation order
    matches the original recursive formulation: yielding ranks re-activate
    immediately, transferring ranks re-activate after everyone deeper in the
    chain.  Returns the number of executed transfers.
    """
    before = stats.transfers
    post: List[int] = []  # ranks to re-activate after the chain, innermost first
    cur: Optional[int] = r
    while cur is not None:
        if locks.must_yield(cur, p):
            note_yield(stats)
            nxt = lock_release(locks, stats, cur, p)
            active.append(cur)
            cur = nxt
            continue
        execute_transfer(state, clusters, engine, stats, cur, p,
                         max_candidates, max_clusters_per_rank,
                         replicate=replicate)
        nxt = lock_release(locks, stats, cur, p)
        post.append(cur)
        cur = nxt
    for rr in reversed(post):
        if work_lists[rr]:
            active.append(rr)
    return stats.transfers - before
