"""FindBestCCM / TryTransfer (paper Fig. 1, lines 6–23).

Two evaluation layers:
  * ``approx_best_diff`` — stage 1 (peer ranking): only gossip summaries are
    available (possibly stale), so the work after a transfer is approximated
    at cluster granularity.
  * ``find_best_exchange`` — stage 2 (after locking a peer): exact evaluation
    with the CCM update formulae over cluster give/swap candidates.

Each layer has a scalar reference path (this module's per-candidate loops)
and a batched production path (``engine=`` / ``repro_torch.core.engine``): pass a
:class:`~repro_torch.core.engine.PhaseEngine` to ``find_best_exchange`` /
``try_transfer`` and every shortlisted candidate pair is scored in one
vectorized pass; stage-1 batching lives in ``engine.batch_peer_diffs``.
Candidate enumeration, shortlisting, and the selection rule are shared by
both paths, so they pick the same exchange.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.ccm import (INF, CCMState, ExchangeEval, effective_mem_cap,
                            exchange_eval)
from repro_torch.core.clusters import (ClusterSummary, RankSummary,  # noqa: F401
                                 _half_split)


def _w_of(summary: RankSummary, params) -> float:
    # eq. 9 barrier against the soft cap (effective_mem_cap): a rank over
    # its (headroom-shrunk) capacity carries infinite work, so stage 1
    # ranks any feasibility-restoring peer ahead of every balance move.
    # Mirrored bitwise by engine.build_summary_tables' work column and the
    # QuiesceTracker work-list patch.
    if (params.memory_constraint
            and summary.mem_used > effective_mem_cap(summary.mem_cap,
                                                     params)):
        return INF
    return (params.alpha * summary.load / summary.speed
            + params.beta * summary.vol_off
            + params.gamma * summary.vol_on
            + params.delta * summary.homing)


def approx_transfer(me: RankSummary, peer: RankSummary, c: ClusterSummary,
                    params) -> Optional[Tuple[float, float]]:
    """Approximate (W_me_after, W_peer_after) when cluster c moves me->peer.

    Approximations (documented; stage 2 re-checks exactly): the cluster's
    external volume becomes off-rank for the peer and stops counting against
    me; its intra volume stays on-rank; its blocks land off-home on the peer
    unless the peer is their home (unknowable from summaries for sure — we
    assume off-home, the conservative direction).
    """
    if me.rank == peer.rank:
        return None
    # memory feasibility on the receiving side (soft cap, matched with
    # engine.batch_peer_diffs)
    if peer.mem_used + c.mem + c.block_bytes > effective_mem_cap(
            peer.mem_cap, params):
        return None
    w_me = (params.alpha * (me.load - c.load) / me.speed
            + params.beta * max(me.vol_off - c.vol_ext, 0.0)
            + params.gamma * max(me.vol_on - c.vol_intra, 0.0)
            + params.delta * me.homing)
    w_peer = (params.alpha * (peer.load + c.load) / peer.speed
              + params.beta * (peer.vol_off + c.vol_ext)
              + params.gamma * (peer.vol_on + c.vol_intra)
              + params.delta * (peer.homing + c.block_bytes))
    return w_me, w_peer


def approx_best_diff(me: RankSummary, peer: RankSummary, params) -> float:
    """Stage-1 criterion: best max-work reduction over my clusters -> peer."""
    w_me, w_peer = _w_of(me, params), _w_of(peer, params)
    max_before = max(w_me, w_peer)
    best = -np.inf
    for c in me.clusters:
        res = approx_transfer(me, peer, c, params)
        if res is None:
            continue
        diff = max_before - max(res)
        best = max(best, diff)
    # also consider pulling the peer's clusters here (peer may be overloaded)
    for c in peer.clusters:
        res = approx_transfer(peer, me, c, params)
        if res is None:
            continue
        diff = max_before - max(res)
        best = max(best, diff)
    return float(best)


@dataclasses.dataclass
class BestExchange:
    tasks_ab: np.ndarray   # move a -> b
    tasks_ba: np.ndarray   # move b -> a
    work_diff: float
    eval: ExchangeEval


_EMPTY = np.zeros(0, np.int64)


def memory_move_candidates(state: CCMState, r_from: int, r_to: int,
                           clusters_from: Sequence[np.ndarray],
                           max_candidates: int = 12) -> List[np.ndarray]:
    """Extra one-sided move candidates (r_from -> r_to) that trade memory
    against parallelism — the paper's replication trade-off (§III-A4) made
    an explicit part of the move vocabulary:

      * **replication splits** — a block-affine cluster (>= 2 tasks, all
        sharing one block) is bipartitioned by :func:`_half_split`; moving
        the lighter half materializes the block on ``r_to`` while the
        heavier half keeps it live on ``r_from``, i.e. deliberate
        replication buying load parallelism for block bytes;
      * **de-replication consolidations** — for each block replicated on
        BOTH ranks, ALL of ``r_from``'s tasks of that block move to
        ``r_to``: the move evicts ``r_from``'s copy (frees its bytes)
        without adding block bytes on ``r_to``, the eviction half of the
        pressure policy.

    Both shapes are plain task-set transfers, so they ride
    ``apply_transfer`` unchanged — transfer log, listeners, quiesce
    dirty-marking and the replay invariant all cover them for free — and
    they are scored through the same eq. 4 work model as every other
    candidate (``exchange_eval``), so the optimizer, not a rule, decides
    between migration, replication, eviction, or refusal.  Deterministic
    order: splits in cluster order, then consolidations in ascending block
    id, each capped at ``max_candidates``.
    """
    ph = state.phase
    out: List[np.ndarray] = []
    for c in clusters_from[:max_candidates]:
        c = np.asarray(c, np.int64)
        if c.shape[0] < 2:
            continue
        blocks = ph.task_block[c]
        if blocks[0] < 0 or not (blocks == blocks[0]).all():
            continue
        out.append(_half_split(ph.task_load, c))
    both = np.flatnonzero((state.block_count[r_from] > 0)
                          & (state.block_count[r_to] > 0))
    if both.size:
        mine = np.flatnonzero(state.assignment == r_from)
        tb = ph.task_block[mine]
        for b in both[:max_candidates]:
            cand = mine[tb == b]
            if cand.size:
                out.append(cand)
    return out


_PAIRS_CACHE: dict = {}


def _pairs_template(n_a: int, n_b: int) -> np.ndarray:
    """The full (n_a * n_b - 1, 2) candidate-pair index grid, cached per
    shape.  The grid is hot-path-invariant and the cached array is marked
    read-only, so sharing it is safe: consumers only read it, and the one
    mutation-shaped use (``pairs[order]`` fancy indexing) copies.  Anyone
    needing a writable grid must copy explicitly."""
    pairs = _PAIRS_CACHE.get((n_a, n_b))
    if pairs is None:
        ia, ib = np.divmod(np.arange(1, n_a * n_b, dtype=np.int64), n_b)
        pairs = np.stack([ia, ib], axis=1)
        pairs.setflags(write=False)
        _PAIRS_CACHE[(n_a, n_b)] = pairs
    return pairs


def shortlist_pairs(state: CCMState, clusters_a: List[np.ndarray],
                    clusters_b: List[np.ndarray], r_a: int, r_b: int,
                    max_candidates: int = 12, shortlist: int = 32,
                    engine=None):
    """Candidate enumeration + load-only shortlist, shared by
    ``find_best_exchange`` and ccm_lb's batched lock events.

    Beyond-paper speedup: a vectorized load-only estimate shortlists the
    most promising ``shortlist`` pairs; only those get the exact CCM
    update-formula evaluation (alpha dominates realistic instances, so the
    shortlist rarely excludes the true best; the final choice is exact).
    Depends only on the two ranks' own loads and cluster lists, so the
    shortlist of a lock event is invariant under transfers between OTHER
    (disjoint) rank pairs — the property batched lock events rest on.

    Returns ``(cand_a, cand_b, pairs, agg_a, agg_b)`` with ``pairs`` a
    (P, 2) int64 array of (ia, ib) rows; the aggregates are None on the
    scalar path (and capped at ``max_candidates`` clusters on the engine
    path — nothing past the candidate cut is ever scored).
    """
    empty = np.zeros((0,), np.int64)
    cand_a = [empty] + clusters_a[:max_candidates]
    cand_b = [empty] + clusters_b[:max_candidates]
    agg_a = agg_b = None
    if engine is not None:
        agg_a = engine.cluster_aggregates(r_a, clusters_a,
                                          limit=max_candidates)
        agg_b = engine.cluster_aggregates(r_b, clusters_b,
                                          limit=max_candidates)

    n_a, n_b = len(cand_a), len(cand_b)
    pairs = _pairs_template(n_a, n_b)           # (ia, ib) != (0, 0)
    if pairs.shape[0] > shortlist:
        ph = state.phase
        if engine is not None:  # cached, bitwise-equal per-cluster sums
            la = np.concatenate([[0.0], agg_a.loads[:max_candidates]])
            lb = np.concatenate([[0.0], agg_b.loads[:max_candidates]])
        else:
            la = np.array([ph.task_load[c].sum() for c in cand_a])
            lb = np.array([ph.task_load[c].sum() for c in cand_b])
        ia, ib = pairs[:, 0], pairs[:, 1]
        after_a = (state.load[r_a] - la[ia] + lb[ib]) / ph.rank_speed[r_a]
        after_b = (state.load[r_b] + la[ia] - lb[ib]) / ph.rank_speed[r_b]
        score = np.maximum(after_a, after_b)
        order = np.argsort(score)[:shortlist]
        pairs = pairs[order]
    return cand_a, cand_b, pairs, agg_a, agg_b


def select_best(cand_a, cand_b, pairs, wa, wb, feas,
                w_before: float) -> Optional[BestExchange]:
    """Selection rule over batched scores — shared by the engine path of
    ``find_best_exchange`` and ccm_lb's batched lock events, so deferred
    scoring picks the exact same exchange.

    Vectorized, selection-identical to the scalar scan it replaces: the
    scan kept the FIRST pair (in ``pairs`` order) whose positive diff was
    strictly greater than every earlier one — i.e. the first occurrence of
    the maximum, which is what ``argmax`` returns.
    """
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    wa, wb = np.asarray(wa), np.asarray(wb)
    ok = np.flatnonzero(np.asarray(feas, bool))  # before diff: infeasible
    if ok.size == 0:                             # rows hold inf - inf = nan
        return None
    diff = w_before - np.maximum(wa[ok], wb[ok])
    pos = np.flatnonzero(diff > 1e-12)
    if pos.size == 0:
        return None
    j = pos[np.argmax(diff[pos])]
    k = int(ok[j])
    ia, ib = int(pairs[k, 0]), int(pairs[k, 1])
    ev = ExchangeEval(float(wa[k]), float(wb[k]), True)
    return BestExchange(cand_a[ia], cand_b[ib], float(diff[j]), ev)


def find_best_exchange(state: CCMState, clusters_a: List[np.ndarray],
                       clusters_b: List[np.ndarray], r_a: int, r_b: int,
                       max_candidates: int = 12,
                       shortlist: int = 32,
                       engine=None,
                       replicate: bool = False) -> Optional[BestExchange]:
    """Exact FindBestCCM: best give/swap among cluster pairs (incl. one-sided
    gives via the empty cluster).  ``max_candidates`` bounds each side
    (clusters come sorted by load) — the paper's quality/cost tunable.

    ``engine``: a :class:`~repro_torch.core.engine.PhaseEngine` scores every
    shortlisted pair in one batched pass; ``None`` falls back to one
    ``exchange_eval`` call per pair (reference path).

    ``replicate`` extends the candidate set with
    :func:`memory_move_candidates` (replication splits + de-replication
    consolidations, both directions).  The extras are scored through the
    scalar ``exchange_eval`` — even on the engine path — because they are
    one-sided gives outside the engine's cached cluster-aggregate space;
    an extra wins only on a STRICTLY greater work diff, so a run where no
    extra ever beats the base vocabulary is bitwise-identical to
    ``replicate=False``.
    """
    cand_a, cand_b, pairs, agg_a, agg_b = shortlist_pairs(
        state, clusters_a, clusters_b, r_a, r_b, max_candidates, shortlist,
        engine)
    w_before = max(state.work(r_a), state.work(r_b))

    if engine is not None:
        wa, wb, feas = engine.batch_exchange_eval(r_a, r_b, cand_a, cand_b,
                                                  pairs, agg_a, agg_b)
        best = select_best(cand_a, cand_b, pairs, wa, wb, feas, w_before)
    else:
        best = None
        for ia, ib in pairs:
            ca, cb = cand_a[ia], cand_b[ib]
            ev = exchange_eval(state, ca, cb, r_a, r_b)
            if not ev.feasible:
                continue
            diff = w_before - ev.max_after
            if diff > 1e-12 and (best is None or diff > best.work_diff):
                best = BestExchange(ca, cb, float(diff), ev)
    if not replicate:
        return best
    extras = [(c, _EMPTY) for c in memory_move_candidates(
        state, r_a, r_b, clusters_a, max_candidates)]
    extras += [(_EMPTY, c) for c in memory_move_candidates(
        state, r_b, r_a, clusters_b, max_candidates)]
    for ca, cb in extras:
        ev = exchange_eval(state, ca, cb, r_a, r_b)
        if not ev.feasible:
            continue
        diff = w_before - ev.max_after
        if diff > 1e-12 and (best is None or diff > best.work_diff):
            best = BestExchange(ca, cb, float(diff), ev)
    return best


def try_transfer(state: CCMState, clusters_a, clusters_b, r_a: int, r_b: int,
                 max_candidates: int = 12,
                 engine=None, replicate: bool = False
                 ) -> Optional[BestExchange]:
    """TryTransfer: execute the best positive exchange, if any (mutates)."""
    best = find_best_exchange(state, clusters_a, clusters_b, r_a, r_b,
                              max_candidates, engine=engine,
                              replicate=replicate)
    if best is None:
        return None
    state.swap(best.tasks_ab, r_a, best.tasks_ba, r_b)
    return best
