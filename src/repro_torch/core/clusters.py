"""Cluster generation (paper §IV, before the inform stage).

On each rank, tasks that access the same shared block or that communicate
heavily are clustered so they migrate together — splitting them would
replicate the block on more ranks (more memory + homing cost) or turn
intra-rank edges into off-rank ones (more work).

Implementation: connected components per rank over (a) same-shared-block
relations and (b) comm edges whose volume is above ``heavy_quantile`` of
local edge volumes.  :func:`build_clusters` runs one vectorized
min-label propagation over flat union-edge arrays (rank membership read
from CSR segments).  The port's copy of ``repro/core/clusters.py``; the
JAX package keeps the per-rank union-find reference its parity tests use,
and the port's tests hold whole runs against the JAX package instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.ccm import CCMState
from repro_torch.core.csr import rank_segments


@dataclasses.dataclass
class ClusterSummary:
    """What the inform stage sends per cluster (§IV-A)."""

    rank: int
    local_id: int
    load: float            # L(c)
    mem: float             # M-(c) task baseline footprint
    overhead: float        # max task overhead in the cluster
    block_ids: np.ndarray  # shared blocks accessed
    block_bytes: float     # total size of those blocks
    vol_intra: float       # V(c): volume among the cluster's tasks
    vol_ext: float         # V∉(c): volume between cluster and anything else
    size: int


def _heavy_threshold(state: CCMState, heavy_quantile: float) -> float:
    """Heavy-edge volume threshold from the global edge-volume distribution
    (static per phase -> cached on the state across the many incremental
    rebuilds)."""
    ph = state.phase
    qcache = getattr(state, "_quantile_cache", None)
    if qcache is None:
        qcache = {}
        state._quantile_cache = qcache
    thresh = qcache.get(heavy_quantile)
    if thresh is None:
        thresh = (np.quantile(ph.comm_vol, heavy_quantile)
                  if ph.num_comms else np.inf)
        qcache[heavy_quantile] = thresh
    return thresh


def build_clusters(state: CCMState, heavy_quantile: float = 0.75,
                   max_clusters_per_rank: Optional[int] = None,
                   split_frac: float = 0.25,
                   only_ranks: Optional[List[int]] = None,
                   rank_tasks=None) -> Dict[int, List[np.ndarray]]:
    """rank -> list of task-id arrays (clusters).  Singletons included.

    ``split_frac``: clusters whose load exceeds ``split_frac * mean rank
    load`` are split into load-bounded sub-clusters.  This is what enables the
    paper's replication trade-off (§III-A4): a shared block's tasks may then
    land on several ranks, replicating the block at a memory + homing cost
    that the delta term charges.

    ``only_ranks``: restrict to these ranks (incremental rebuild after a
    transfer touches two ranks).  ``rank_tasks``: optional ``r -> sorted
    member-task id array`` accessor (PhaseEngine.rank_tasks); with it, the
    ``only_ranks`` rebuild touches only the selected ranks' tasks and their
    incident edges instead of scanning every task and edge of the phase —
    same output bitwise (see ``_local_labels``).

    Vectorized: union relations become flat (u, v) pair arrays — consecutive
    tasks of each (block, rank) group plus the heavy same-rank edges — and
    components are found by min-label propagation with pointer jumping, so
    no per-task Python work is done.  Output is identical (composition AND
    order) to the JAX package's union-find reference.
    """
    ph = state.phase
    a = state.assignment
    mean_load = ph.task_load.sum() / max(ph.num_ranks, 1)
    load_cap = max(split_frac * mean_load, ph.task_load.max(initial=0.0))
    out: Dict[int, List[np.ndarray]] = {}
    thresh = _heavy_threshold(state, heavy_quantile)
    ranks = list(range(ph.num_ranks)) if only_ranks is None else list(only_ranks)

    if only_ranks is not None and rank_tasks is not None:
        tasks_sel, lab, lab_of = _local_labels(state, ranks, rank_tasks,
                                               thresh)
        rank_members = {r: rank_tasks(r) for r in ranks}
    else:
        lab = _global_labels(state, ranks, thresh)
        lab_of = None
        # full build: one argsort gives every rank's segment; incremental
        # rebuild (2 ranks): a direct membership scan per rank is cheaper
        segs = rank_segments(a, ph.num_ranks) if only_ranks is None else None
        rank_members = {
            r: (segs.row(r) if segs is not None else np.nonzero(a == r)[0])
            for r in ranks}

    for r in ranks:
        tasks = rank_members[r]
        if tasks.size == 0:
            out[r] = []
            continue
        labs = lab_of(tasks) if lab_of is not None else lab[tasks]
        uniq, inv = np.unique(labs, return_inverse=True)
        sorted_tasks = tasks[np.argsort(inv, kind="stable")]
        bounds = np.cumsum(np.bincount(inv, minlength=uniq.shape[0]))[:-1]
        clusters: List[np.ndarray] = []
        for g in np.split(sorted_tasks, bounds):
            clusters.extend(_split_by_load(g, ph.task_load, load_cap))
        clusters.sort(key=lambda c: -ph.task_load[c].sum())
        if max_clusters_per_rank is not None:
            clusters = clusters[:max_clusters_per_rank]
        out[r] = clusters
    return out


def _propagate_min_labels(lab: np.ndarray, u: np.ndarray,
                          v: np.ndarray) -> np.ndarray:
    """Min-label propagation + pointer jumping over union pairs (u, v):
    labels only ever decrease, so the fixpoint labels each element with its
    component's minimum initial label."""
    while u.size:
        m = np.minimum(lab[u], lab[v])
        np.minimum.at(lab, u, m)
        np.minimum.at(lab, v, m)
        while True:
            nl = lab[lab]
            if np.array_equal(nl, lab):
                break
            lab = nl
        if np.array_equal(lab[u], lab[v]):
            break
    return lab


def _global_labels(state: CCMState, ranks: List[int],
                   thresh: float) -> np.ndarray:
    """Component labels over all tasks of the selected ranks, scanning every
    task and edge of the phase (the full-build path)."""
    ph = state.phase
    a = state.assignment
    rank_sel = np.zeros(ph.num_ranks, bool)
    rank_sel[ranks] = True
    same_rank = a[ph.comm_src] == a[ph.comm_dst]
    heavy = same_rank & (ph.comm_vol >= thresh)

    # union pairs: consecutive members of each (block, rank) group ...
    bt = np.nonzero(rank_sel[a] & (ph.task_block >= 0))[0]
    order = np.lexsort((bt, a[bt], ph.task_block[bt]))
    bts = bt[order]
    grp = ((ph.task_block[bts][1:] == ph.task_block[bts][:-1])
           & (a[bts][1:] == a[bts][:-1])) if bts.size else np.zeros(0, bool)
    # ... plus heavy same-rank comm edges on the selected ranks
    he = np.nonzero(heavy & rank_sel[a[ph.comm_src]])[0]
    u = np.concatenate([bts[:-1][grp], ph.comm_src[he]])
    v = np.concatenate([bts[1:][grp], ph.comm_dst[he]])
    lab = np.arange(ph.num_tasks, dtype=np.int64)
    return _propagate_min_labels(lab, u, v)


def _local_labels(state: CCMState, ranks: List[int], rank_tasks,
                  thresh: float):
    """Component labels restricted to the selected ranks' tasks — O(their
    tasks + their incident edges) instead of O(num_tasks + num_comms).

    Exactness: union pairs never cross ranks (block groups are per (block,
    rank); heavy edges require ``a[src] == a[dst]``), so restricting to the
    selected ranks' tasks and their incident edges keeps every qualifying
    pair.  Labels are component-min LOCAL indices into the globally-sorted
    selected-task array; within any single rank the local index is monotone
    in the global task id, so per-rank ``np.unique`` grouping and group
    ORDER are bitwise-identical to the global-label path.
    """
    ph = state.phase
    a = state.assignment
    segs = [rank_tasks(r) for r in ranks]
    tasks_sel = (np.sort(np.concatenate(segs)) if segs
                 else np.zeros(0, np.int64))
    lab = np.arange(tasks_sel.shape[0], dtype=np.int64)

    if tasks_sel.size:
        # block pairs: consecutive members of each (block, rank) group
        tb = ph.task_block[tasks_sel]
        bt = tasks_sel[tb >= 0]
        order = np.lexsort((bt, a[bt], ph.task_block[bt]))
        bts = bt[order]
        grp = ((ph.task_block[bts][1:] == ph.task_block[bts][:-1])
               & (a[bts][1:] == a[bts][:-1])) if bts.size \
            else np.zeros(0, bool)
        # heavy same-rank edges: every qualifying edge is incident to a
        # selected task (both endpoints share the — selected — rank).  The
        # gather lists an edge once per selected endpoint; duplicate union
        # pairs are harmless to min-label propagation, so no dedupe.
        eids = state.csr.task_edges.gather(tasks_sel)
        src, dst = ph.comm_src[eids], ph.comm_dst[eids]
        hm = (a[src] == a[dst]) & (ph.comm_vol[eids] >= thresh)
        u_g = np.concatenate([bts[:-1][grp], src[hm]])
        v_g = np.concatenate([bts[1:][grp], dst[hm]])
        lab = _propagate_min_labels(lab, np.searchsorted(tasks_sel, u_g),
                                    np.searchsorted(tasks_sel, v_g))

    def lab_of(tasks: np.ndarray) -> np.ndarray:
        return lab[np.searchsorted(tasks_sel, tasks)]

    return tasks_sel, lab, lab_of


def _split_by_load(tasks: np.ndarray, loads: np.ndarray,
                   cap: float) -> List[np.ndarray]:
    """Greedy first-fit split of a cluster into sub-clusters of load <= cap."""
    total = loads[tasks].sum()
    if total <= cap or tasks.size <= 1:
        return [tasks]
    order = tasks[np.argsort(-loads[tasks])]
    bins: List[List[int]] = []
    bin_loads: List[float] = []
    for t in order:
        lt = loads[t]
        placed = False
        for i in range(len(bins)):
            if bin_loads[i] + lt <= cap:
                bins[i].append(int(t))
                bin_loads[i] += lt
                placed = True
                break
        if not placed:
            bins.append([int(t)])
            bin_loads.append(float(lt))
    return [np.array(b, np.int64) for b in bins]


def _half_split(task_load: np.ndarray, cluster: np.ndarray) -> np.ndarray:
    """Deterministic near-balanced bipartition of a cluster's tasks:
    greedy descending-load placement into two bins (stable sort, so equal
    loads keep ascending task-id order), returning the LIGHTER bin — the
    travelling half of a replication split.  For ``len(cluster) >= 2``
    both bins are non-empty, so the split is always a strict sub-cluster
    move."""
    cluster = np.asarray(cluster, np.int64)
    order = np.argsort(-task_load[cluster], kind="stable")
    bins: Tuple[List[int], List[int]] = ([], [])
    tot = [0.0, 0.0]
    for t in cluster[order]:
        j = 0 if tot[0] <= tot[1] else 1
        bins[j].append(int(t))
        tot[j] += float(task_load[t])
    move = bins[0] if tot[0] <= tot[1] else bins[1]
    return np.asarray(sorted(move), np.int64)


def summarize_clusters(state: CCMState,
                       clusters: Dict[int, List[np.ndarray]],
                       eids: Optional[np.ndarray] = None,
                       replicate: bool = False
                       ) -> Dict[int, List[ClusterSummary]]:
    """Cluster inform payloads, with the intra/external comm volumes of ALL
    clusters computed in one labelled pass over the edge list (the seed
    rebuilt an O(num_tasks) membership mask per cluster).

    ``eids``: optional ascending unique edge-id subset to scan instead of
    the full edge list — the amortized prologue (core/quiesce.py)
    passes the edges incident to the dirty ranks' tasks.  Bitwise-exact
    for any ``clusters`` whose member tasks' incident edges are all in
    ``eids``: every edge contributing to a given cluster's bucket appears
    in the same relative order as in the full pass, so the bincount
    partial sums accumulate identically.

    ``replicate``: append one VIRTUAL summary per block-affine cluster
    (>= 2 tasks, all one block — the replication-split eligibility of
    ``memory_move_candidates``) describing its :func:`_half_split`
    travelling half, marked ``local_id=-1``.  Stage 1 scores whole
    clusters from these summaries, so without the virtual entries a rank
    whose only surplus is expressible as a half-split can never initiate
    a lock event and replication starves; with them, both the scalar
    ``approx_best_diff`` and the batched ``batch_peer_diffs`` see
    half-split granularity (identically — they read the same objects).
    Stage 2 re-derives the real candidates and evaluates them exactly,
    so the entries only ever gate WHICH events fire."""
    ph = state.phase
    flat: List[Tuple[int, int, np.ndarray]] = [
        (r, ci, tasks) for r, cls in clusters.items()
        for ci, tasks in enumerate(cls)]
    n = len(flat)
    gids = np.full(ph.num_tasks, -1, np.int64)
    for gid, (_, _, tasks) in enumerate(flat):
        gids[tasks] = gid
    if eids is None:
        e_src, e_dst, e_vol = ph.comm_src, ph.comm_dst, ph.comm_vol
        n_edges = ph.num_comms
    else:
        e_src, e_dst = ph.comm_src[eids], ph.comm_dst[eids]
        e_vol = ph.comm_vol[eids]
        n_edges = eids.shape[0]
    vol_intra = np.zeros(n)
    vol_ext = np.zeros(n)
    if n and n_edges:
        ls, ld = gids[e_src], gids[e_dst]
        intra = (ls == ld) & (ls >= 0)
        vol_intra = np.bincount(ls[intra], weights=e_vol[intra],
                                minlength=n)
        cut = ls != ld
        m = cut & (ls >= 0)
        vol_ext = np.bincount(ls[m], weights=e_vol[m], minlength=n)
        m = cut & (ld >= 0)
        vol_ext = vol_ext + np.bincount(ld[m], weights=e_vol[m],
                                        minlength=n)
    out: Dict[int, List[ClusterSummary]] = {r: [] for r in clusters}
    for gid, (r, ci, tasks) in enumerate(flat):
        blk = np.unique(ph.task_block[tasks])
        blk = blk[blk >= 0]
        out[r].append(ClusterSummary(
            rank=r,
            local_id=ci,
            load=float(ph.task_load[tasks].sum()),
            mem=float(ph.task_mem[tasks].sum()),
            overhead=float(ph.task_overhead[tasks].max()) if tasks.size else 0.0,
            block_ids=blk,
            block_bytes=float(ph.block_size[blk].sum()),
            vol_intra=float(vol_intra[gid]),
            vol_ext=float(vol_ext[gid]),
            size=int(tasks.size),
        ))
    if not replicate:
        return out
    # virtual half-split entries: a second labelled pass over the same
    # edge (sub)sequence, labelling only each travelling half — an edge
    # from the half to its kept sibling tasks correctly counts as
    # EXTERNAL (that is what it becomes once the split lands)
    vflat: List[Tuple[int, np.ndarray, int]] = []
    for r, cls in clusters.items():
        for tasks in cls:
            tasks = np.asarray(tasks, np.int64)
            if tasks.shape[0] < 2:
                continue
            blocks = ph.task_block[tasks]
            if blocks[0] < 0 or not (blocks == blocks[0]).all():
                continue
            vflat.append((r, _half_split(ph.task_load, tasks),
                          int(blocks[0])))
    if not vflat:
        return out
    vn = len(vflat)
    vgids = np.full(ph.num_tasks, -1, np.int64)
    for gid, (_, half, _) in enumerate(vflat):
        vgids[half] = gid
    v_intra = np.zeros(vn)
    v_ext = np.zeros(vn)
    if n_edges:
        ls, ld = vgids[e_src], vgids[e_dst]
        intra = (ls == ld) & (ls >= 0)
        v_intra = np.bincount(ls[intra], weights=e_vol[intra],
                              minlength=vn)
        cut = ls != ld
        m = cut & (ls >= 0)
        v_ext = np.bincount(ls[m], weights=e_vol[m], minlength=vn)
        m = cut & (ld >= 0)
        v_ext = v_ext + np.bincount(ld[m], weights=e_vol[m],
                                    minlength=vn)
    for gid, (r, half, b) in enumerate(vflat):
        out[r].append(ClusterSummary(
            rank=r,
            local_id=-1,            # virtual: stage-1 scoring only
            load=float(ph.task_load[half].sum()),
            mem=float(ph.task_mem[half].sum()),
            overhead=float(ph.task_overhead[half].max()),
            block_ids=np.array([b], np.int64),
            block_bytes=float(ph.block_size[b]),
            vol_intra=float(v_intra[gid]),
            vol_ext=float(v_ext[gid]),
            size=int(half.shape[0]),
        ))
    return out


@dataclasses.dataclass
class RankSummary:
    """Rank-level inform payload (§IV-A): loads + comm volumes + homing +
    baseline memory + cluster summaries."""

    rank: int
    load: float
    vol_on: float
    vol_off: float
    homing: float
    mem_used: float        # M_max(r)
    mem_cap: float
    speed: float
    clusters: List[ClusterSummary]


def summarize_rank(state: CCMState, r: int,
                   cluster_summaries: List[ClusterSummary]) -> RankSummary:
    return RankSummary(
        rank=r,
        load=float(state.load[r]),
        vol_on=state.on_rank_volume(r),
        vol_off=state.off_rank_volume(r),
        homing=state.homing_cost(r),
        mem_used=state.max_memory(r),
        mem_cap=float(state.phase.rank_mem_cap[r]),
        speed=float(state.phase.rank_speed[r]),
        clusters=cluster_summaries,
    )
