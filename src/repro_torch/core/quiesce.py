"""Quiescence tracking: make quiet CCM-LB iterations nearly free.

The port's copy of ``repro/core/quiesce.py`` (host numpy), without the
hooks only the JAX package's async and multi-phase drivers use.  The
paper's algorithm converges in a handful of iterations and then mostly
*confirms* quiescence; most of a converged iteration is host work — gossip
network construction, work-list assembly, cluster/summary rebuilds and
commit bookkeeping.  :class:`QuiesceTracker` makes all four cost centers
incremental in the number of **dirty ranks**, with bitwise-identical
trajectories as the bar (the rebuild reference and the amortized path
must produce the same assignments, transfer logs and work traces).

Dirty propagation per committed transfer ``(tasks, r_from, r_to)``
(delivered through ``CCMState.add_transfer_listener``):

  * **cluster-dirty** = ``{r_from, r_to}`` — cluster membership is a
    function of the rank's own task set, so third ranks' clusters cannot
    change;
  * **value-dirty**  = cluster-dirty ∪ ranks hosting an endpoint of any
    edge incident to the moved tasks.  Third ranks' loads, memory,
    homing and on-rank volumes are untouched by construction
    (``apply_transfer`` only shifts block presence on the two endpoint
    ranks), but ``off_rank_volume`` row/column sums can shift by ulps
    when touched-edge buckets are rearranged, so those ranks' summaries
    must be recomputed to stay bitwise-faithful.

Per-rank **epochs** then drive the gossip stream keys: ``epoch[r]`` is
the iteration at which rank ``r`` last became value-dirty, and root
``r``'s epidemic draws from ``gossip_root_key(gossip_seed(seed,
epoch[r]), r)``.  Epochs are ALGORITHM state, not cache state: the
tracker runs (and folds epochs) in every configuration — incremental or
not — so the full-rebuild reference re-draws each root
from exactly the key whose cached reach the amortized path replays.
That is the whole bitwise-equality argument: both paths evaluate the
same pure function of the same key; one of them just remembers the
answer (see core/gossip.py).

Caching (``self.caching``) additionally retains, across iterations:
maintained cluster lists + cluster/rank summaries (patched for dirty
ranks only), the flat :class:`~repro_torch.core.engine.SummaryTables` (rows
patched in place while per-rank cluster counts are stable), each rank's
sorted stage-2 work list (re-scored only for ranks whose ``info`` map
content changed), and a version-validated memo of failed exact
evaluations (``memo[(r, p)] == state.version`` proves the pair still
fails — the version is bumped by every mutation).  A converged
(zero-transfer) iteration therefore performs zero cluster builds, zero
gossip draws, zero work-list scorings and zero exact evaluations: its
cost is a small constant in the number of ranks actually changing, not
O(ranks + tasks + edges).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Set

import numpy as np

from repro_torch.core.clusters import (build_clusters, summarize_clusters,
                                       summarize_rank)
from repro_torch.core.ccm import INF, effective_mem_cap
from repro_torch.core.engine import batch_peer_diffs, build_summary_tables
from repro_torch.core.gossip import (build_peer_networks, gossip_root_key,
                                     gossip_seed, update_peer_networks)

__all__ = ["QuiesceTracker"]

class QuiesceTracker:
    """Per-run activity tracker + amortized-iteration cache (module
    docstring).  One tracker per balancer instance; register
    :meth:`note_transfer` as a transfer listener on the instance's
    ``CCMState`` and drive each iteration as::

        tracker.begin_iteration(it)            # fold dirty -> epochs
        clusters, summaries = tracker.update_summaries()
        info = tracker.update_gossip()
        work_lists = tracker.update_work_lists(info)   # caching only
        ... stage 2 ...
        tracker.end_iteration()
    """

    def __init__(self, state, engine, params, *, seed: int, k_rounds: int,
                 fanout: int, max_clusters_per_rank: Optional[int] = None,
                 caching: bool = True, replicate: bool = False):
        self.state = state
        self.engine = engine
        self.params = params
        self.seed = int(seed)
        self.k_rounds = int(k_rounds)
        self.fanout = int(fanout)
        self.mcpr = max_clusters_per_rank
        # thread the replication vocabulary into the summary prologue:
        # stage 1 needs the virtual half-split entries (summarize_clusters)
        # or replication-shaped surplus can never initiate a lock event
        self.replicate = bool(replicate)
        self.n = int(state.phase.num_ranks)
        # caching needs the engine's incrementally-maintained rank
        # segments (cluster rebuild scope) and flat summary tables
        self.caching = bool(caching and engine is not None
                            and getattr(engine, "incremental", False))
        self.counters: Dict[str, int] = {}
        self.iter_counters: List[Dict[str, int]] = []
        self.memo: Dict[tuple, int] = {}
        self.reset()

    # ---- dirty propagation ------------------------------------------------

    def note_transfer(self, tasks, r_from: int, r_to: int) -> None:
        """Transfer listener (``CCMState.add_transfer_listener``): mark
        the endpoint ranks cluster-dirty and every rank hosting an
        endpoint of a touched edge value-dirty (module docstring)."""
        r_from, r_to = int(r_from), int(r_to)
        self.cluster_dirty.update((r_from, r_to))
        vd = self.value_dirty
        vd.update((r_from, r_to))
        st = self.state
        eids = st._touched_edges(np.asarray(tasks))
        if eids.size:
            ph = st.phase
            a = st.assignment
            for x in np.unique(a[ph.comm_src[eids]]):
                vd.add(int(x))
            for x in np.unique(a[ph.comm_dst[eids]]):
                vd.add(int(x))

    # ---- lifecycle --------------------------------------------------------

    def reset(self) -> None:
        """Drop every cache and mark everything dirty (fresh run)."""
        n = self.n
        self.cluster_dirty: Set[int] = set(range(n))
        self.value_dirty: Set[int] = set(range(n))
        self.epoch = np.zeros(n, np.int64)
        self.clusters = None
        self.csum = None
        self.summaries = None
        self.tables = None
        self.info = None
        self.reach: Dict[int, List[int]] = {}
        self.reach_key: Dict[int, tuple] = {}
        self.scores: Optional[Dict[int, list]] = None
        self.memo.clear()
        self._cd: List[int] = []
        self._vd: List[int] = []
        self._affected: Optional[Set[int]] = None

    def begin_iteration(self, it: int) -> None:
        """Fold the pending dirty sets: value-dirty ranks stamp their
        epoch with this iteration (their gossip key changes), and the
        folded sets become this iteration's patch scope."""
        for r in self.value_dirty:
            self.epoch[r] = it
        self._cd = sorted(self.cluster_dirty)
        self._vd = sorted(self.value_dirty)
        self.cluster_dirty = set()
        self.value_dirty = set()

    def end_iteration(self) -> None:
        """Snapshot the cumulative counters (tests diff consecutive
        snapshots to assert a converged iteration did zero work)."""
        self.iter_counters.append(dict(self.counters))

    def _count(self, key: str, inc: int = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + inc

    # ---- stage 0: clusters + summaries ------------------------------------

    def _full_summaries(self):
        st = self.state
        clusters = build_clusters(st, max_clusters_per_rank=self.mcpr)
        csum = summarize_clusters(st, clusters, replicate=self.replicate)
        summaries = {r: summarize_rank(st, r, csum[r]) for r in range(self.n)}
        self._count("cluster_rank_builds", self.n)
        return clusters, csum, summaries

    def update_summaries(self):
        """Returns ``(clusters, summaries)`` for this iteration, bitwise
        what ``iteration_summaries`` recomputes from scratch.  Caching
        path: rebuild clusters + cluster summaries only for cluster-dirty
        ranks (one ``build_clusters(only_ranks=...)`` call over the edges
        incident to their tasks) and rank summaries only for value-dirty
        ranks; everything else is reused by object."""
        st = self.state
        if not self.caching:
            clusters, csum, summaries = self._full_summaries()
            # retained for update_gossip (epochs still key the streams on
            # the rebuild reference); rebuilt from scratch next iteration
            self.summaries = summaries
            return clusters, summaries
        if self.clusters is None:
            # post-reset invariant: the pending dirty sets were full, so
            # the epoch fold already covered every rank
            self.clusters, self.csum, self.summaries = self._full_summaries()
            return self.clusters, self.summaries
        if self._cd:
            eng = self.engine
            sub = build_clusters(st, max_clusters_per_rank=self.mcpr,
                                 only_ranks=self._cd,
                                 rank_tasks=eng.rank_tasks)
            for r in self._cd:
                self.clusters[r] = sub[r]
            self._count("cluster_rank_builds", len(self._cd))
            # cluster summaries from the edges incident to the dirty
            # ranks' tasks only: per summary bucket that is the same
            # contributing edge subsequence in the same order as the
            # global pass, so the bincount partial sums are bitwise equal
            tasks = [eng.rank_tasks(r) for r in self._cd]
            eids = np.unique(st.csr.task_edges.gather(
                np.concatenate(tasks) if tasks else
                np.zeros(0, np.int64)))
            csl = summarize_clusters(st, {r: sub[r] for r in self._cd},
                                     eids=eids, replicate=self.replicate)
            for r in self._cd:
                self.csum[r] = csl[r]
        for r in self._vd:
            self.summaries[r] = summarize_rank(st, r, self.csum[r])
        return self.clusters, self.summaries

    # ---- stage 1: gossip ---------------------------------------------------

    def root_key(self, r: int) -> list:
        """Root ``r``'s epidemic stream key for the current epoch —
        shared verbatim by the full rebuild and the cached replay."""
        return gossip_root_key(gossip_seed(self.seed, int(self.epoch[r])), r)

    def update_gossip(self):
        """Returns this iteration's per-rank info maps.  Rebuild path:
        every root re-drawn from its epoch key.  Caching path: re-draw
        only roots whose key changed (value-dirty ranks bumped their
        epoch), splicing old reach out and new
        reach in — content-identical to the rebuild because clean roots'
        epidemics are pure functions of their unchanged keys."""
        n = self.n
        keys = {r: self.root_key(r) for r in range(n)}
        if not self.caching:
            self.info = build_peer_networks(
                self.summaries, k_rounds=self.k_rounds, fanout=self.fanout,
                root_seeds=keys, stats=self.counters)
            self._count("gossip_redraws", n)
            self._affected = None
            return self.info
        if self.info is None:
            self.info = {r: {r: self.summaries[r]} for r in range(n)}
            self.reach = {}
            self.reach_key = {}
        dirty = [r for r in range(n)
                 if self.reach_key.get(r) != tuple(keys[r])]
        affected = update_peer_networks(
            self.summaries, self.info, self.reach, k_rounds=self.k_rounds,
            fanout=self.fanout, root_seeds=keys, dirty_roots=dirty,
            stats=self.counters)
        for r in dirty:
            self.reach_key[r] = tuple(keys[r])
        self._affected = affected
        return self.info

    # ---- stage 1b: work lists ----------------------------------------------

    def update_work_lists(self, info) -> Dict[int, deque]:
        """Caching twin of ``ccmlb.build_work_lists`` (engine path): keep
        the flat summary tables patched in place and each rank's sorted
        candidate list cached, re-scoring only ranks whose info content
        changed.  Valid because ``batch_peer_diffs`` reads nothing but
        the (r, peer) rows/segments, and the final ``(-diff, peer)`` sort
        canonicalizes any insertion-order difference."""
        n = self.n
        params = self.params
        counts_ok = self.tables is not None
        if counts_ok and self._cd:
            ip = self.tables.c_ids.indptr
            for r in self._cd:
                if len(self.csum[r]) != ip[r + 1] - ip[r]:
                    counts_ok = False     # cluster-count change shifts the
                    break                 # flat segment layout: rebuild
        if not counts_ok:
            self.tables = build_summary_tables(self.summaries, params)
            self._count("tables_rebuilds")
        else:
            t = self.tables
            for r in self._vd:
                s = self.summaries[r]
                t.load[r] = s.load
                t.vol_on[r] = s.vol_on
                t.vol_off[r] = s.vol_off
                t.homing[r] = s.homing
                t.mem_used[r] = s.mem_used
                # elementwise re-evaluation of the vectorized work
                # expression: same IEEE ops on the same float64 scalars,
                # including build_summary_tables' eq. 9 soft-cap barrier
                if (params.memory_constraint and t.mem_used[r]
                        > effective_mem_cap(t.mem_cap[r], params)):
                    t.work[r] = INF
                else:
                    t.work[r] = (params.alpha * t.load[r] / t.speed[r]
                                 + params.beta * t.vol_off[r]
                                 + params.gamma * t.vol_on[r]
                                 + params.delta * t.homing[r])
            ip = t.c_ids.indptr
            for r in self._cd:
                cl = self.csum[r]
                sl = slice(ip[r], ip[r + 1])
                t.c_load[sl] = [c.load for c in cl]
                t.c_mem[sl] = [c.mem for c in cl]
                t.c_block_bytes[sl] = [c.block_bytes for c in cl]
                t.c_vol_intra[sl] = [c.vol_intra for c in cl]
                t.c_vol_ext[sl] = [c.vol_ext for c in cl]
        if self.scores is None:
            self.scores = {}
            affected = list(range(n))
        elif self._affected is None:
            affected = list(range(n))
        else:
            affected = sorted(self._affected)
        for r in affected:
            self._rescore(r, info)
        self._count("worklist_rescored", len(affected))
        return {r: deque(self.scores[r]) for r in range(n)}

    def _rescore(self, r: int, info) -> None:
        t = self.tables
        peers = np.array([p for p in info[r] if p != r], dtype=np.int64)
        for p in peers:
            assert info[r][int(p)] is self.summaries[int(p)], \
                "info payload must alias the current summary object"
        diffs = batch_peer_diffs(t, r, peers, self.params)
        scored = [(float(d), int(p)) for d, p in zip(diffs, peers) if d > 0]
        scored.sort(key=lambda x: (-x[0], x[1]))
        self.scores[r] = scored
