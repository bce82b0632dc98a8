"""Vectorized, incrementally-maintained CCM evaluation engine (the port's
counterpart of ``repro/core/engine.py``).

Everything here is host numpy, as in the JAX package: the CSR gathers, the
per-event group-flow matrices (one flat ``np.bincount``), the per-event
feature tiles and the stage-1 peer scores.  Only the stage-2 scorer leaves
the host: :func:`repro_torch.kernels.ccm_scorer.launch.score_events` packs
a batch of events with their shortlisted pairs into one buffer and scores
it where the engine's device says.  On the card one launch of the
hand-written CUDA pair kernel (``csrc/ccm_scorer.cu``) computes the ten
work components of each shortlisted pair, the affine work combine and
eq. 9's feasibility, and only (w_a, w_b, feasible) per pair comes back; on
the CPU the plain torch version of the same function does
(``ref.score_pairs_packed``).  The host combines ``ops.combine_work*``
are the oracle both are held to.  The speculative driver (core/spec.py)
takes a shorter way: :meth:`PhaseEngine.spec_raw` gathers one float64 row
per event (the flow matrix's edge list in a fixed label layout, the host
feature rows and scalars), and the window kernel builds the flow matrix,
the features, the scores, the combine and the selection on the card.

Incremental state
-----------------
:class:`PhaseEngine` is a LONG-LIVED object that owns mutable per-rank
state and keeps it current across transfers instead of re-deriving it per
lock event:

  * ``rank segments`` — each rank's member-task id array, sorted ascending
    (bitwise what ``np.nonzero(assignment == r)[0]`` would return), kept
    exact by a transfer listener on the wrapped ``CCMState``;
  * ``cluster aggregates`` — per-cluster loads/mems/overheads and (block,
    count) tables, cached per cluster-list identity and capped at the
    caller's candidate limit;
  * per-rank block counters and shared/homing byte caches live on the
    wrapped ``CCMState`` and are maintained by the update formulae.

``PhaseEngine(..., incremental=False)`` re-gathers rank membership from the
assignment on every use: the full-rebuild parity reference.

Parity contract
---------------
  * stage 1 (``batch_peer_diffs``) is arithmetic-identical to the scalar
    ``approx_best_diff``;
  * stage 2 aggregates edge volumes through a group-flow matrix, so its
    scores can differ from the scalar ``exchange_eval`` by summation-order
    ulps; identical trajectories are empirical, not absolute;
  * ``dtype=torch.float64`` (default) is the bitwise tier: the packed tiles,
    the flow matrices and the host combine are the JAX package's own
    operations, and the scorer (CUDA kernel on the card, plain torch on the
    CPU) evaluates the reference expression tree with adds, subtracts,
    maxima and selects only, so scores equal ``backend="numpy"`` bit for
    bit.  ``dtype=torch.float32`` scores the tiles in float32 (the
    counterpart of the JAX package's ``backend="pallas_compiled"``) and is
    held to assignment identity.

Stage-2 decomposition
---------------------
For a lock event on ranks (a, b) with candidate clusters A_1..A_na on a and
B_1..B_nb on b, label every task with a *group*:

  0 = other rank, 1 = stays on a, 2 = stays on b, 3+i = A_i, 3+na+j = B_j

and accumulate the group-to-group flow matrix F[g, h] = sum of edge volumes
src-group g -> dst-group h over the edges incident to a or b.  Every
sent/recv/on-rank volume before AND after any exchange pair (A_i, B_j) is a
small linear combination of F entries, so all (na+1) x (nb+1) candidate
pairs are scored by elementwise ops.  Batched lock events extend this to E
pairwise-disjoint rank pairs: one flat bincount builds every event's block
of a block-diagonal flow matrix, bitwise equal to the solo construction,
and the E score tiles go to the scorer in one launch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.ccm import CCMState, INF, effective_mem_cap
from repro_torch.core.csr import CSR, PhaseCSR, rank_segments
from repro_torch.kernels.ccm_scorer import launch
from repro_torch.kernels.ccm_scorer import layout as L

__all__ = ["PhaseEngine", "ExchangeEvent", "SummaryTables",
           "build_summary_tables", "batch_peer_diffs"]


@dataclasses.dataclass
class ClusterAggregates:
    """Per-cluster scalar/block aggregates for one rank's cluster list.

    Everything here depends only on the cluster task sets (NOT on the
    current assignment or block counters), so it is cached per cluster list
    and reused across every lock event until the rank's clusters are
    rebuilt.  ``loads``/``mems``/``overheads`` use the same numpy reductions
    as the scalar path, so downstream arithmetic stays bitwise-compatible.
    """

    loads: np.ndarray       # (C,) task_load[c].sum() per cluster
    mems: np.ndarray        # (C,)
    overheads: np.ndarray   # (C,) max task overhead (0 for empty)
    blk_ci: np.ndarray      # (B,) cluster index per (cluster, block) pair
    blk_ids: np.ndarray     # (B,) block id
    blk_cnts: np.ndarray    # (B,) member tasks of that block in the cluster
    blk_sizes: np.ndarray   # (B,)
    blk_home: np.ndarray    # (B,) home rank of the block
    blk_map: Dict[int, List[Tuple[int, int]]]  # block -> [(ci, cnt)]


@dataclasses.dataclass
class ExchangeEvent:
    """One lock event to score: candidate cluster lists of a rank pair.

    ``cand_a[0]``/``cand_b[0]`` must be the empty cluster; ``pairs`` is the
    (ia, ib) shortlist to return scores for — a (P, 2) int64 array (what
    ``shortlist_pairs`` produces) or an equivalent sequence of tuples.
    ``agg_*`` are the cached aggregates of the rank's cluster lists
    (``cand_*[1:]`` must be a prefix of them; tables capped at the
    candidate cut are sufficient); omitted, they are computed on the fly.
    """

    r_a: int
    r_b: int
    cand_a: Sequence[np.ndarray]
    cand_b: Sequence[np.ndarray]
    pairs: Sequence  # (P, 2) int64 array or sequence of (ia, ib) tuples
    agg_a: Optional[ClusterAggregates] = None
    agg_b: Optional[ClusterAggregates] = None


class PhaseEngine:
    """Batched move scoring over a CCMState.

    Long-lived: owns phase-static structure (the CSR view, reusable label
    buffers), per-cluster-list aggregate caches validated by list identity,
    and — with ``incremental=True`` (default) — per-rank member-task
    segments kept exact across transfers via a ``CCMState`` transfer
    listener.  ``incremental=False`` re-gathers rank membership from the
    assignment on every use: the full-rebuild parity reference.

    ``device`` is where the stage-2 tiles are scored: ``None`` (default)
    means ``"cuda"`` and raises when no card is present; ``"cpu"`` runs
    the plain torch scorer.  ``dtype`` is ``torch.float64`` (bitwise tier)
    or ``torch.float32`` (assignment-identity tier).
    """

    def __init__(self, state: CCMState, device=None,
                 dtype: torch.dtype = torch.float64,
                 incremental: bool = True):
        self.device = launch.resolve_device(device)
        self.dtype = launch.check_dtype(dtype)
        self.state = state
        self.csr: PhaseCSR = state.csr
        self.incremental = incremental
        self._glab = np.zeros(self.phase.num_tasks, np.int64)
        self._elab = np.full(self.phase.num_tasks, -1, np.int64)
        # spec_raw's label scratch: stamp-validated (a task's group label
        # only counts when its stamp equals the current call's tick), so
        # per-call resets are unnecessary — stale labels are masked out
        self._sp_g = np.zeros(self.phase.num_tasks, np.int64)
        self._sp_stamp = np.zeros(self.phase.num_tasks, np.int64)
        self._sp_tick = 0
        # rank -> (cluster list reference, aggregates, limit); holding the
        # list reference both validates the cache (ccm_lb installs a NEW
        # list when a rank's clusters are rebuilt) and pins its id.
        self._agg: Dict[int, Tuple[list, ClusterAggregates,
                                   Optional[int]]] = {}
        # version-validated caches of per-event quantities that only change
        # when a transfer mutates the state: cached values are the arrays a
        # recompute would return (same inputs, same ops), so hits are
        # bitwise-neutral.  Keyed by state.version (one int compare).
        self._blk_cache: Dict[Tuple[int, int], tuple] = {}
        self._vol_cache: Dict[int, Tuple[int, float, float]] = {}
        # rank-touch stamps: _rank_touch[r] = state version of the last
        # transfer that moved tasks in or out of r (stamped by the transfer
        # hook).  _incident entries are validated against the touch stamps
        # of THEIR two ranks instead of the global version, so transfers
        # between other ranks do not invalidate them.  _touch_seen detects
        # version bumps the hook never saw (retarget, or non-incremental
        # engines, where the hook is not registered): those invalidate
        # every rank.
        self._rank_touch = np.full(self.phase.num_ranks, state.version,
                                   np.int64)
        self._touch_seen = state.version
        self._eids_cache: Dict[int, Tuple[int, np.ndarray]] = {}
        self._edge_cache: Dict[Tuple[int, int], tuple] = {}
        self._segments: Optional[List[np.ndarray]] = None
        if incremental:
            segs = rank_segments(state.assignment, self.phase.num_ranks)
            self._segments = [segs.row(r)
                              for r in range(self.phase.num_ranks)]
            state.add_transfer_listener(self._on_transfer)

    @property
    def phase(self):
        """The CURRENT phase of the wrapped state — read through on every
        access, so an engine carried across ``CCMState.retarget`` (pipeline
        phase carry-over) follows the new phase's value arrays instead of
        pinning the build-time ones.  The retarget also bumps the state
        version, which invalidates every version-validated cache below."""
        return self.state.phase

    # ------------------------------------------------- incremental segments
    def _on_transfer(self, tasks: np.ndarray, r_from: int, r_to: int):
        """Transfer hook: splice the moved ids out of ``r_from``'s segment
        and merge them into ``r_to``'s, keeping both sorted — O(|segment| +
        |moved|), vs the O(num_tasks) assignment scan it replaces."""
        t = np.sort(np.asarray(tasks, np.int64))
        seg = self._segments[r_from]
        # every moved id is present in seg (transfer precondition), so the
        # searchsorted positions are exactly the entries to drop
        self._segments[r_from] = np.delete(seg, np.searchsorted(seg, t))
        seg = self._segments[r_to]
        self._segments[r_to] = np.insert(seg, np.searchsorted(seg, t), t)
        # the hook runs after apply_transfer's version bump (one bump per
        # transfer), so when every bump since the last stamp was a hooked
        # transfer, stamping the two ranks marks exactly this transfer;
        # a gap in the version sequence means unobserved bumps (retarget)
        # happened in between — then every rank may have changed
        v = self.state.version
        if self._touch_seen == v - 1:
            self._rank_touch[r_from] = self._rank_touch[r_to] = v
        else:
            self._rank_touch[:] = v
        self._touch_seen = v

    def rank_tasks(self, r: int) -> np.ndarray:
        """Member-task ids of rank ``r``, ascending — bitwise what
        ``np.nonzero(assignment == r)[0]`` returns, served from the
        incrementally-maintained segment (or gathered fresh when
        ``incremental=False``).  Callers must not mutate the array."""
        if self._segments is not None:
            return self._segments[r]
        return np.nonzero(self.state.assignment == r)[0]

    def cluster_aggregates(self, r: int, clusters: List[np.ndarray],
                           limit: Optional[int] = None) -> ClusterAggregates:
        """Aggregates of ``clusters[:limit]`` (all of them when ``limit`` is
        None), cached by cluster-list identity.  A cached full table serves
        any limited request; a cached limited table serves requests up to
        its limit and is recomputed otherwise."""
        cached = self._agg.get(r)
        if cached is not None and cached[0] is clusters:
            have = cached[2]
            if have is None or (limit is not None and have >= limit):
                return cached[1]
        agg = self._compute_aggregates(
            clusters if limit is None else clusters[:limit])
        self._agg[r] = (clusters, agg, limit)
        return agg

    def _compute_aggregates(self, clusters: List[np.ndarray]
                            ) -> ClusterAggregates:
        ph = self.phase
        loads = np.array([ph.task_load[c].sum() for c in clusters])
        mems = np.array([ph.task_mem[c].sum() for c in clusters])
        overheads = np.array([ph.task_overhead[c].max() if len(c) else 0.0
                              for c in clusters])
        # (cluster, block, count) table in one lexsorted run-length pass —
        # identical rows (ascending block within ascending cluster, integer
        # counts) to the per-cluster np.unique loop it replaces
        if clusters:
            ci = np.repeat(np.arange(len(clusters), dtype=np.int64),
                           [len(c) for c in clusters])
            tb = ph.task_block[np.concatenate(clusters)]
            has = tb >= 0
            ci, tb = ci[has], tb[has]
            order = np.lexsort((tb, ci))
            ci, tb = ci[order], tb[order]
            new = np.ones(ci.shape[0], bool)
            new[1:] = (ci[1:] != ci[:-1]) | (tb[1:] != tb[:-1])
            starts = np.nonzero(new)[0]
            blk_ci = ci[starts]
            blk_ids = tb[starts]
            blk_cnts = np.diff(np.append(starts, ci.shape[0]))
        else:
            blk_ci = blk_ids = blk_cnts = np.zeros(0, np.int64)
        blk_map: Dict[int, List[Tuple[int, int]]] = {}
        for i, blk, cnt in zip(blk_ci.tolist(), blk_ids.tolist(),
                               blk_cnts.tolist()):
            blk_map.setdefault(blk, []).append((i, cnt))
        return ClusterAggregates(
            loads=loads, mems=mems, overheads=overheads,
            blk_ci=blk_ci, blk_ids=blk_ids, blk_cnts=blk_cnts,
            blk_sizes=ph.block_size[blk_ids], blk_home=ph.block_home[blk_ids],
            blk_map=blk_map)

    # ------------------------------------------------------------- stage 2
    def batch_exchange_eval(
            self, r_a: int, r_b: int,
            cand_a: Sequence[np.ndarray], cand_b: Sequence[np.ndarray],
            pairs: Sequence[Tuple[int, int]],
            agg_a: ClusterAggregates = None, agg_b: ClusterAggregates = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Score every candidate pair ``(cand_a[ia] a->b, cand_b[ib] b->a)``.

        Returns ``(work_a_after, work_b_after, feasible)`` arrays aligned
        with ``pairs``; infeasible pairs get ``inf`` work, matching the
        scalar ``exchange_eval``.  One-event convenience wrapper around
        :meth:`batch_exchange_eval_multi`.
        """
        [res] = self.batch_exchange_eval_multi([
            ExchangeEvent(r_a, r_b, cand_a, cand_b, pairs, agg_a, agg_b)])
        return res

    def batch_exchange_eval_multi(
            self, events: Sequence[ExchangeEvent],
    ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Score a batched lock event: E pairwise-disjoint rank pairs.

        All events' block-diagonal flow matrices come from one flat
        bincount and all score tiles from one scorer call (one kernel
        launch on the card).  Returns per-event
        ``(work_a_after, work_b_after, feasible)`` aligned with each
        event's ``pairs``.
        """
        if not events:
            return []
        events = [dataclasses.replace(
            e,
            agg_a=(e.agg_a if e.agg_a is not None
                   else self._compute_aggregates(list(e.cand_a[1:]))),
            agg_b=(e.agg_b if e.agg_b is not None
                   else self._compute_aggregates(list(e.cand_b[1:]))))
            for e in events]
        flows = self._flow_matrices(events)
        feats = [self._event_features(e, F) for e, F in zip(events, flows)]
        pairs_list = [np.asarray(e.pairs, np.int64).reshape(-1, 2)
                      for e in events]
        return launch.score_events(feats, pairs_list, self.state.params,
                                   device=self.device, dtype=self.dtype)

    def _rank_eids(self, r: int, touch: int) -> np.ndarray:
        """Ascending unique incident edge ids of rank ``r``, cached per
        rank-touch stamp — ``np.unique(task_edges.gather(rank_tasks(r)))``
        exactly, recomputed only when a transfer touches ``r``."""
        hit = self._eids_cache.get(r)
        if hit is not None and hit[0] == touch:
            return hit[1]
        eids = np.unique(self.csr.task_edges.gather(self.rank_tasks(r)))
        self._eids_cache[r] = (touch, eids)
        return eids

    def _incident(self, r_a: int, r_b: int):
        """``(both, n_a, src, dst, vol)`` for the edges incident to the two
        ranks: the concatenated member-task ids (``both[:n_a]`` = rank a's),
        and the endpoint/volume columns gathered at the ascending unique
        incident edge ids.  The batched flow assembly re-reads these per
        event; entries are
        validated against the TOUCH STAMPS of their two ranks, so only a
        transfer in or out of ``r_a``/``r_b`` (not anywhere else) forces a
        recompute, and a hit returns exactly the arrays the gathers
        produced (bitwise-neutral).  The per-rank edge sets are cached the
        same way and merged — a stable sort of two ascending unique arrays
        deduped adjacently IS ``np.unique`` of their concatenation, so the
        result is bitwise what the direct gather produced.  Callers must
        not mutate the returned arrays."""
        st = self.state
        if st.version != self._touch_seen:
            # version bumps the transfer hook never saw (retarget, or a
            # non-incremental engine with no hook at all): every rank may
            # have changed, and the phase value arrays may differ too
            self._rank_touch[:] = st.version
            self._touch_seen = st.version
            self._eids_cache.clear()
            self._edge_cache.clear()
        ta = self._rank_touch[r_a]
        tb = self._rank_touch[r_b]
        cached = self._edge_cache.get((r_a, r_b))
        if cached is not None and cached[0] == ta and cached[1] == tb:
            return cached[2:]
        tasks_a = self.rank_tasks(r_a)
        n_a = tasks_a.shape[0]
        both = np.concatenate([tasks_a, self.rank_tasks(r_b)])
        m = np.sort(np.concatenate([self._rank_eids(r_a, ta),
                                    self._rank_eids(r_b, tb)]),
                    kind="stable")
        if m.shape[0]:
            eids = m[np.concatenate([[True], m[1:] != m[:-1]])]
        else:
            eids = m
        ph = self.phase
        entry = (both, n_a, ph.comm_src[eids], ph.comm_dst[eids],
                 ph.comm_vol[eids])
        self._edge_cache[(r_a, r_b)] = (ta, tb) + entry
        return entry

    def _flow_matrices(self, events: Sequence[ExchangeEvent]
                       ) -> List[np.ndarray]:
        """Per-event group-flow matrices via ONE flat bincount.

        Event k's bins only ever receive edges incident to event k's ranks,
        gathered in ascending edge-id order — exactly the edge list and
        order a solo evaluation uses — so each returned F is bitwise-equal
        to the single-event construction.  Tasks of other events read as
        group 0 ("other rank") through the event-id mask.
        """
        g, ev = self._glab, self._elab
        metas = []      # (tasks_both, cand_flat, src, dst, vol, G, offset)
        bins_l, w_l = [], []
        offset = 0

        def _reset_labels(upto):
            # candidate ids are reset too: a direct caller may pass arrays
            # with tasks no longer assigned to the event's ranks (a stale
            # label here would corrupt every later evaluation)
            for m in metas[:upto]:
                both_, cflat_ = m[0], m[1]
                g[both_] = 0
                ev[both_] = -1
                g[cflat_] = 0
                ev[cflat_] = -1

        for k, e in enumerate(events):
            na, nb = len(e.cand_a) - 1, len(e.cand_b) - 1
            G = 3 + na + nb
            both, n_a, src, dst, vol = self._incident(e.r_a, e.r_b)
            if (ev[both] != -1).any():
                # detected BEFORE this event touches the buffers: roll back
                # the earlier events' labels so the engine stays usable
                _reset_labels(k)
                raise ValueError(
                    "batched lock events must have pairwise-disjoint rank "
                    f"sets (event {k} on ranks ({e.r_a}, {e.r_b}) overlaps "
                    "an earlier event)")
            cl = list(e.cand_a[1:]) + list(e.cand_b[1:])
            if cl:
                cflat = np.concatenate(cl)
                cg = np.repeat(np.arange(3, 3 + na + nb, dtype=np.int64),
                               [len(c) for c in cl])
            else:
                cflat = cg = np.zeros(0, np.int64)
            g[both[:n_a]] = 1
            g[both[n_a:]] = 2
            ev[both] = k
            g[cflat] = cg       # duplicate ids resolve to the LAST write,
            ev[cflat] = k       # matching the per-cluster loop order
            metas.append((both, cflat, src, dst, vol, G, offset))
            offset += G * G
        for k, (both, cflat, src, dst, vol, G, off) in enumerate(metas):
            gs = np.where(ev[src] == k, g[src], 0)
            gd = np.where(ev[dst] == k, g[dst], 0)
            bins_l.append(off + gs * G + gd)
            w_l.append(vol)
        flat = np.bincount(
            np.concatenate(bins_l) if bins_l else np.zeros(0, np.int64),
            weights=np.concatenate(w_l) if w_l else None,
            minlength=offset)
        _reset_labels(len(metas))
        return [flat[off:off + G * G].reshape(G, G)
                for _, _, _, _, _, G, off in metas]

    def _event_features(self, e: ExchangeEvent, F: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
        """Feature planes of one event (see kernels/ccm_scorer/ops.py for
        the layout) — host-side reductions only; everything downstream is
        elementwise per pair."""
        st, ph = self.state, self.phase
        r_a, r_b = e.r_a, e.r_b
        agg_a, agg_b = e.agg_a, e.agg_b
        na, nb = len(e.cand_a) - 1, len(e.cand_b) - 1
        G = 3 + na + nb

        # group layout is contiguous (1 | 2 | a-clusters | b-clusters), so
        # every flow aggregate reduces to slice sums of F:
        # row_to_a[g] = v(g -> Ra), col_from_a[g] = v(Ra -> g), etc.
        sa, sb = 3, 3 + na
        row_to_a = F[:, 1] + F[:, sa:sb].sum(1)
        row_to_b = F[:, 2] + F[:, sb:].sum(1)
        col_from_a = F[1, :] + F[sa:sb, :].sum(0)
        col_from_b = F[2, :] + F[sb:, :].sum(0)

        ar = np.arange(sa, sb)
        br = np.arange(sb, G)

        # column 0 is the empty candidate (stays zero); writes go straight
        # into the [1:] slice
        av = np.zeros((L.N_AV, na + 1))
        av[L.AV.intra, 1:] = F[ar, ar]
        av[L.AV.out_own, 1:] = row_to_a[sa:sb]    # v(A -> Ra)
        av[L.AV.in_own, 1:] = col_from_a[sa:sb]   # v(Ra -> A)
        av[L.AV.out_peer, 1:] = row_to_b[sa:sb]   # v(A -> Rb)
        av[L.AV.in_peer, 1:] = col_from_b[sa:sb]  # v(Rb -> A)
        av[L.AV.out_other, 1:] = F[sa:sb, 0]
        av[L.AV.in_other, 1:] = F[0, sa:sb]
        av[L.AV.load, 1:] = agg_a.loads[:na]
        av[L.AV.mem, 1:] = agg_a.mems[:na]
        av[L.AV.ovh, 1:] = agg_a.overheads[:na]
        (av[L.AV.s_rm], av[L.AV.h_rm], av[L.AV.s_add_peer],
         av[L.AV.h_add_peer]) = self._block_terms(agg_a, na, r_a, r_b)

        bv = np.zeros((L.N_AV, nb + 1))
        bv[L.AV.intra, 1:] = F[br, br]
        bv[L.AV.out_own, 1:] = row_to_b[sb:]
        bv[L.AV.in_own, 1:] = col_from_b[sb:]
        bv[L.AV.out_peer, 1:] = row_to_a[sb:]
        bv[L.AV.in_peer, 1:] = col_from_a[sb:]
        bv[L.AV.out_other, 1:] = F[sb:, 0]
        bv[L.AV.in_other, 1:] = F[0, sb:]
        bv[L.AV.load, 1:] = agg_b.loads[:nb]
        bv[L.AV.mem, 1:] = agg_b.mems[:nb]
        bv[L.AV.ovh, 1:] = agg_b.overheads[:nb]
        (bv[L.AV.s_rm], bv[L.AV.h_rm], bv[L.AV.s_add_peer],
         bv[L.AV.h_add_peer]) = self._block_terms(agg_b, nb, r_b, r_a)

        pm = np.zeros((L.N_PM, na + 1, nb + 1))
        if na and nb:
            pm[L.PM.x_ab, 1:, 1:] = F[sa:sb, sb:]       # v(A_i -> B_j)
            pm[L.PM.x_ba, 1:, 1:] = F[sb:, sa:sb].T     # v(B_j -> A_i)
        pm[L.PM.cs_a:] = self._pm_corrections(e, na, nb)

        # one literal in layout.SC index order (0..31) — a single array
        # construction instead of 32 scalar __setitem__ calls on the hot
        # path; the deltas are applied to the incrementally-maintained
        # bases, mirroring the scalar path's base-plus-dvol structure so
        # both paths share any drift in vol.
        vol_aa, vol_bb = st.vol[r_a, r_a], st.vol[r_b, r_b]
        row_a, col_a = self._vol_sums(r_a)
        row_b, col_b = self._vol_sums(r_b)
        sc = np.array([
            row_to_b[1] + row_to_b[sa:sb].sum(),   # f_ab: v(Ra -> Rb)
            row_to_a[2] + row_to_a[sb:].sum(),     # f_ba
            row_to_a[1] + row_to_a[sa:sb].sum(),   # f_aa
            row_to_b[2] + row_to_b[sb:].sum(),     # f_bb
            F[1, 0] + F[sa:sb, 0].sum(),           # f_ao
            F[0, 1] + F[0, sa:sb].sum(),           # f_oa
            F[2, 0] + F[sb:, 0].sum(),             # f_bo
            F[0, 2] + F[0, sb:].sum(),             # f_ob
            row_a - vol_aa,                        # base_sent_a
            col_a - vol_aa,                        # base_recv_a
            row_b - vol_bb,                        # base_sent_b
            col_b - vol_bb,                        # base_recv_b
            vol_aa,                                # vol_aa
            vol_bb,                                # vol_bb
            st.load[r_a],                          # load_a
            st.load[r_b],                          # load_b
            st.shared_cache[r_a],                  # shared_a
            st.shared_cache[r_b],                  # shared_b
            st.hom_cache[r_a],                     # hom_a
            st.hom_cache[r_b],                     # hom_b
            ph.rank_mem_base[r_a],                 # mem_base_a
            st.mem_task[r_a],                      # mem_task_a
            st.mem_overhead_max[r_a],              # ovh_a
            ph.rank_mem_base[r_b],                 # mem_base_b
            st.mem_task[r_b],                      # mem_task_b
            st.mem_overhead_max[r_b],              # ovh_b
            float(na),                             # na
            float(nb),                             # nb
            ph.rank_speed[r_a],                    # speed_a
            ph.rank_speed[r_b],                    # speed_b
            # caps packed pre-scaled through the soft-cap helper: the
            # compiled combines compare plain <=, so the feasibility bit
            # matches the scalar exchange_eval exactly
            effective_mem_cap(ph.rank_mem_cap[r_a], st.params),  # mem_cap_a
            effective_mem_cap(ph.rank_mem_cap[r_b], st.params),  # mem_cap_b
        ])
        assert sc.shape[0] == L.N_SC
        return av, bv, pm, sc

    def _pm_corrections(self, e: ExchangeEvent, na: int, nb: int
                        ) -> np.ndarray:
        """The sparse pairwise shared-block correction planes (cs_a, ch_a,
        cs_b, ch_b) as a dense (4, na+1, nb+1) stack: blocks present in
        BOTH moving clusters, where the independent leave terms over-fire
        because the counter-flow keeps the block present (Thm III.1)."""
        st, ph = self.state, self.phase
        agg_a, agg_b = e.agg_a, e.agg_b
        r_a, r_b = e.r_a, e.r_b
        pm = np.zeros((4, na + 1, nb + 1))
        for blk, lst_a in agg_a.blk_map.items():
            lst_b = agg_b.blk_map.get(blk)
            if not lst_b:
                continue
            size = ph.block_size[blk]
            off_home_a = ph.block_home[blk] != r_a
            off_home_b = ph.block_home[blk] != r_b
            for i, cnt_a in lst_a:
                if i >= na:
                    continue
                for j, cnt_b in lst_b:
                    if j >= nb:
                        continue
                    if st.block_count[r_a, blk] == cnt_a:
                        pm[0, i + 1, j + 1] += size
                        if off_home_a:
                            pm[1, i + 1, j + 1] += size
                    if st.block_count[r_b, blk] == cnt_b:
                        pm[2, i + 1, j + 1] += size
                        if off_home_b:
                            pm[3, i + 1, j + 1] += size
        return pm

    # -------------------------------------------- speculative window rows
    def spec_raw(self, e: ExchangeEvent, a_lanes: int, b_lanes: int,
                 p_n: int) -> Tuple[np.ndarray, int]:
        """One complete float64 window row for the speculative scorer
        (``launch.score_spec``): everything the window kernel needs to
        assemble the event's flow matrix and score its shortlist on the
        card, gathered from the CURRENT (speculative) state.

        Unlike :meth:`_flow_matrices`' per-event group space, the label
        layout is FIXED by the lane buckets (``layout.spec_groups``), so
        every row of a run shares one layout: group 0 = other ranks, 1 =
        stays on a, 2 = stays on b, a-candidate i at ``3 + (i-1)``,
        b-candidate j at ``3 + (a_lanes-1) + (j-1)``.  Unused candidate
        groups receive no edges, so their slice sums are exact zeros.

        Returns ``(row, eb)``: ``row`` in the ``layout.spec_offsets(eb,
        a_lanes, b_lanes, p_n)`` layout ``[bins | w | avh | bvh | pmh | sch
        | iaf | ibf | misc]``, with the incident edges' bins and volumes in
        ascending edge-id order (pad edges in bin 0 with volume 0), the
        params columns, the memory caps pre-scaled by ``effective_mem_cap``
        (``inf`` when the constraint is off) and the shortlist's pair count
        baked in; ``eb`` is its edge bucket.  The driver fills only
        ``row[-2]`` (the pre-exchange work bound).  The row equals the JAX
        package's ``PhaseEngine.spec_raw`` row bit for bit.
        """
        st, ph = self.state, self.phase
        r_a, r_b = e.r_a, e.r_b
        agg_a, agg_b = e.agg_a, e.agg_b
        na, nb = len(e.cand_a) - 1, len(e.cand_b) - 1
        if na >= a_lanes or nb >= b_lanes:
            raise ValueError("candidate count exceeds the spec lane bucket")
        sa, sb, g_n = L.spec_groups(a_lanes, b_lanes)
        g, stamp = self._sp_g, self._sp_stamp
        tick = self._sp_tick = self._sp_tick + 1
        both, n_a, src, dst, vol = self._incident(r_a, r_b)
        cl = list(e.cand_a[1:]) + list(e.cand_b[1:])
        if cl:
            cflat = np.concatenate(cl)
            cg = np.repeat(
                np.concatenate([np.arange(sa, sa + na, dtype=np.int64),
                                np.arange(sb, sb + nb, dtype=np.int64)]),
                [len(c) for c in cl])
        else:
            cflat = cg = np.zeros(0, np.int64)
        g[both[:n_a]] = 1
        g[both[n_a:]] = 2
        stamp[both] = tick
        g[cflat] = cg           # duplicate ids: LAST write wins, matching
        stamp[cflat] = tick     # the per-cluster loop order
        # stale labels from earlier calls fail the stamp test, so no reset
        # scatters are needed between events
        gs = np.where(stamp[src] == tick, g[src], 0)
        gd = np.where(stamp[dst] == tick, g[dst], 0)

        ne = src.shape[0]
        eb = L.bucket_edges(ne)
        (o_w, o_av, o_bv, o_pm, o_sc, o_ia, o_ib, o_ms,
         row_len) = L.spec_offsets(eb, a_lanes, b_lanes, p_n)
        row = np.zeros(row_len)
        row[:ne] = gs * g_n + gd            # pad edges land in bin (0, 0),
        row[o_w:o_w + ne] = vol             # which no feature reads

        avh = row[o_av:o_bv].reshape(7, a_lanes)
        avh[0, 1:na + 1] = agg_a.loads[:na]
        avh[1, 1:na + 1] = agg_a.mems[:na]
        avh[2, 1:na + 1] = agg_a.overheads[:na]
        avh[3:7, :na + 1] = self._block_terms(agg_a, na, r_a, r_b)
        bvh = row[o_bv:o_pm].reshape(7, b_lanes)
        bvh[0, 1:nb + 1] = agg_b.loads[:nb]
        bvh[1, 1:nb + 1] = agg_b.mems[:nb]
        bvh[2, 1:nb + 1] = agg_b.overheads[:nb]
        bvh[3:7, :nb + 1] = self._block_terms(agg_b, nb, r_b, r_a)

        pr = np.asarray(e.pairs, np.int64).reshape(-1, 2)
        p = pr.shape[0]
        if p > p_n:
            raise ValueError("shortlist exceeds the spec pair bucket")
        ia, ib = pr[:, 0], pr[:, 1]
        row[o_pm:o_sc].reshape(4, p_n)[:, :p] = \
            self._pm_corrections(e, na, nb)[:, ia, ib]

        params = st.params
        mc = params.memory_constraint
        vol_aa, vol_bb = st.vol[r_a, r_a], st.vol[r_b, r_b]
        row_a, col_a = self._vol_sums(r_a)
        row_b, col_b = self._vol_sums(r_b)
        # the scalar row: the 8 f_* flow slots stay zero (derived on the
        # card)
        row[o_sc + L.SC.base_sent_a:o_ia] = (
            row_a - vol_aa, col_a - vol_aa,        # base_sent/recv_a
            row_b - vol_bb, col_b - vol_bb,        # base_sent/recv_b
            vol_aa, vol_bb,
            st.load[r_a], st.load[r_b],
            st.shared_cache[r_a], st.shared_cache[r_b],
            st.hom_cache[r_a], st.hom_cache[r_b],
            ph.rank_mem_base[r_a], st.mem_task[r_a],
            st.mem_overhead_max[r_a],
            ph.rank_mem_base[r_b], st.mem_task[r_b],
            st.mem_overhead_max[r_b],
            float(na), float(nb),
            ph.rank_speed[r_a], ph.rank_speed[r_b],
            effective_mem_cap(ph.rank_mem_cap[r_a], params)
            if mc else np.inf,                         # mem_cap_a
            effective_mem_cap(ph.rank_mem_cap[r_b], params)
            if mc else np.inf,                         # mem_cap_b
        )
        row[o_ia:o_ia + p] = ia             # pad pair slots read pair
        row[o_ib:o_ib + p] = ib             # (0, 0); p_count masks them
        row[o_ms + 0] = params.alpha
        row[o_ms + 1] = params.beta
        row[o_ms + 2] = params.gamma
        row[o_ms + 3] = params.delta
        row[o_ms + 5] = p                   # row[o_ms + 4] = driver's
        return row, eb                      # w_before

    def _vol_sums(self, r: int) -> Tuple[float, float]:
        """(row sum, column sum) of the vol matrix for rank ``r``, cached
        per state version — transfers between ANY ranks relabel entries of
        third ranks' rows/columns, so the cache is version-global; a hit
        returns exactly what the two ``np.sum`` calls produced."""
        st = self.state
        hit = self._vol_cache.get(r)
        if hit is not None and hit[0] == st.version:
            return hit[1], hit[2]
        row, col = st.vol[r].sum(), st.vol[:, r].sum()
        self._vol_cache[r] = (st.version, row, col)
        return row, col

    def _block_terms(self, agg: ClusterAggregates, n: int, r_src: int,
                     r_dst: int):
        """Independent (one-sided) block transition terms for the first
        ``n`` clusters: bytes leaving ``r_src``'s shared/homing caches and
        arriving at ``r_dst``'s (index 0 = empty candidate).  Uses the
        CURRENT block counters — cached per (src, dst) direction and
        invalidated by the state version, so repeat events between
        transfers skip the recompute (the cached arrays ARE what the
        recompute would return)."""
        st = self.state
        key = (r_src, r_dst)
        hit = self._blk_cache.get(key)
        if hit is not None and hit[0] == st.version and hit[1] is agg \
                and hit[2] == n:
            return hit[3]
        hi = np.searchsorted(agg.blk_ci, n)  # blk_ci ascending -> prefix
        ci = agg.blk_ci[:hi] + 1
        ids = agg.blk_ids[:hi]
        sizes = agg.blk_sizes[:hi]
        leaves = st.block_count[r_src, ids] == agg.blk_cnts[:hi]
        arrives = st.block_count[r_dst, ids] == 0
        # the four per-cluster sums share one index vector, so one fused
        # bincount over four shifted copies replaces four calls; each
        # output bin still receives its addends in the same ascending-ci
        # order, so every row is bitwise the separate bincount it replaces
        m = n + 1
        t = np.bincount(
            np.concatenate([ci, ci + m, ci + 2 * m, ci + 3 * m]),
            weights=np.concatenate([
                sizes * leaves,
                sizes * (leaves & (agg.blk_home[:hi] != r_src)),
                sizes * arrives,
                sizes * (arrives & (agg.blk_home[:hi] != r_dst)),
            ]),
            minlength=4 * m).reshape(4, m)
        terms = (t[0], t[1], t[2], t[3])
        self._blk_cache[key] = (st.version, agg, n, terms)
        return terms


# ---------------------------------------------------------------- stage 1
@dataclasses.dataclass
class SummaryTables:
    """SoA mirror of one iteration's Rank/ClusterSummary objects.

    Per-rank arrays are indexed by rank id; per-cluster arrays are flat with
    ``c_indptr`` rank segments (same order as ``RankSummary.clusters``).
    """

    load: np.ndarray
    vol_on: np.ndarray
    vol_off: np.ndarray
    homing: np.ndarray
    mem_used: np.ndarray
    mem_cap: np.ndarray
    speed: np.ndarray
    work: np.ndarray          # _w_of(summary) per rank
    c_ids: CSR                # rank -> flat cluster ids (indptr is (I+1,))
    c_load: np.ndarray
    c_mem: np.ndarray
    c_block_bytes: np.ndarray
    c_vol_intra: np.ndarray
    c_vol_ext: np.ndarray


def build_summary_tables(summaries: Dict, params) -> SummaryTables:
    n = len(summaries)
    ranks = [summaries[r] for r in range(n)]
    load = np.array([s.load for s in ranks])
    vol_on = np.array([s.vol_on for s in ranks])
    vol_off = np.array([s.vol_off for s in ranks])
    homing = np.array([s.homing for s in ranks])
    speed = np.array([s.speed for s in ranks])
    work = (params.alpha * load / speed + params.beta * vol_off
            + params.gamma * vol_on + params.delta * homing)
    mem_used = np.array([s.mem_used for s in ranks])
    mem_cap = np.array([s.mem_cap for s in ranks])
    if params.memory_constraint:
        # eq. 9 barrier, mirrored bitwise with the scalar ``_w_of`` and the
        # quiesce work-list patch: a rank over its soft cap carries
        # infinite work, so stage 1 ranks feasibility-restoring peers first
        # (the np.where is the identity when every rank fits)
        work = np.where(mem_used <= effective_mem_cap(mem_cap, params),
                        work, INF)
    c_indptr = np.zeros(n + 1, np.int64)
    np.cumsum([len(s.clusters) for s in ranks], out=c_indptr[1:])
    flat = [c for s in ranks for c in s.clusters]
    c_ids = CSR(c_indptr, np.arange(len(flat), dtype=np.int64))
    return SummaryTables(
        load=load, vol_on=vol_on, vol_off=vol_off, homing=homing,
        mem_used=mem_used, mem_cap=mem_cap,
        speed=speed, work=work, c_ids=c_ids,
        c_load=np.array([c.load for c in flat]),
        c_mem=np.array([c.mem for c in flat]),
        c_block_bytes=np.array([c.block_bytes for c in flat]),
        c_vol_intra=np.array([c.vol_intra for c in flat]),
        c_vol_ext=np.array([c.vol_ext for c in flat]),
    )


def _seg_gather(t: SummaryTables, ranks: np.ndarray):
    """(owner index, flat cluster ids) for all clusters of ``ranks``."""
    idx = t.c_ids.gather(ranks)
    counts = t.c_ids.indptr[ranks + 1] - t.c_ids.indptr[ranks]
    owner = np.repeat(np.arange(ranks.shape[0]), counts)
    return owner, idx


def batch_peer_diffs(t: SummaryTables, r: int, peers: np.ndarray,
                     params) -> np.ndarray:
    """Stage-1 peer scores for rank ``r`` against ``peers`` in one pass.

    Arithmetic-identical to ``approx_best_diff(summaries[r], summaries[p])``
    per peer: same expressions, same IEEE evaluation order, with the scalar
    max-over-candidates rewritten as ``max_before - min(after)`` (exactly
    equal for finite IEEE values since x -> M - x is antitone).

    ASSUMPTION: the tables hold THIS iteration's summaries and gossip
    payloads are references to those same objects (``info[r][p] is
    summaries[p]``, true of ``build_peer_networks``) — staleness is only
    in WHICH peers a rank knows, never in the values.  If gossip ever
    carries summaries from older iterations, the scalar path would score
    from what rank ``r`` actually received while this path scores from the
    global tables, and the identical-trajectory contract breaks; the tables
    would then need to be built per recipient from ``info[r]``.
    """
    peers = np.asarray(peers, np.int64)
    n_p = peers.shape[0]
    if n_p == 0:
        return np.zeros(0)
    a, b, g, d = params.alpha, params.beta, params.gamma, params.delta
    max_before = np.maximum(t.work[r], t.work[peers])

    # my clusters -> each peer (give direction)
    sl = slice(t.c_ids.indptr[r], t.c_ids.indptr[r + 1])
    cl, cm = t.c_load[sl], t.c_mem[sl]
    cbb, cvi, cve = t.c_block_bytes[sl], t.c_vol_intra[sl], t.c_vol_ext[sl]
    after_give = np.full(n_p, np.inf)
    if cl.shape[0]:
        feas = ~((t.mem_used[peers][None, :] + cm[:, None] + cbb[:, None])
                 > effective_mem_cap(t.mem_cap[peers], params)[None, :])
        w_me = (a * (t.load[r] - cl) / t.speed[r]
                + b * np.maximum(t.vol_off[r] - cve, 0.0)
                + g * np.maximum(t.vol_on[r] - cvi, 0.0)
                + d * t.homing[r])
        w_peer = (a * (t.load[peers][None, :] + cl[:, None])
                  / t.speed[peers][None, :]
                  + b * (t.vol_off[peers][None, :] + cve[:, None])
                  + g * (t.vol_on[peers][None, :] + cvi[:, None])
                  + d * (t.homing[peers][None, :] + cbb[:, None]))
        after = np.where(feas, np.maximum(w_me[:, None], w_peer), np.inf)
        after_give = after.min(axis=0)

    # each peer's clusters -> me (pull direction)
    owner, idx = _seg_gather(t, peers)
    after_pull = np.full(n_p, np.inf)
    if idx.shape[0]:
        own = peers[owner]
        pl, pm = t.c_load[idx], t.c_mem[idx]
        pbb, pvi, pve = (t.c_block_bytes[idx], t.c_vol_intra[idx],
                         t.c_vol_ext[idx])
        feas = ~((t.mem_used[r] + pm + pbb)
                 > effective_mem_cap(t.mem_cap[r], params))
        w_src = (a * (t.load[own] - pl) / t.speed[own]
                 + b * np.maximum(t.vol_off[own] - pve, 0.0)
                 + g * np.maximum(t.vol_on[own] - pvi, 0.0)
                 + d * t.homing[own])
        w_me = (a * (t.load[r] + pl) / t.speed[r]
                + b * (t.vol_off[r] + pve)
                + g * (t.vol_on[r] + pvi)
                + d * (t.homing[r] + pbb))
        after = np.where(feas, np.maximum(w_src, w_me), np.inf)
        np.minimum.at(after_pull, owner, after)

    with np.errstate(invalid="ignore"):
        # inf - inf (both sides pressure-barriered) -> nan, dropped by
        # the caller's d > 0 filter
        return max_before - np.minimum(after_give, after_pull)
