"""CCM work model (paper §III): per-rank work

    W(r) = alpha*L(r) + beta*Voff(r) + gamma*Von(r) + delta*M_H(r) + eps

with the memory-capacity barrier eps in {0, +inf} (eq. 9), plus the O(1)
update formulae (eq. 2, Thm III.1) used by the optimizer to evaluate task /
cluster transfers without recomputation.

``RankState`` carries, per rank: load, on-rank volume, per-peer in/out
volumes, block presence, memory components — everything needed so that moving
a set of tasks updates W in time proportional to the tasks' edges and blocks
(not to phase size).

Scalar-vs-vectorized contract: :func:`exchange_eval` here is the REFERENCE
evaluator — one candidate exchange per call, per-edge Python accumulation.
The production path is :class:`repro_torch.core.engine.PhaseEngine`, which
scores all candidates of a lock event in one pass over the CSR phase view
(``self.csr``, built once per state).

The port's own copy of ``repro/core/ccm.py`` (host numpy, identical
arithmetic).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.csr import PhaseCSR
from repro_torch.core.problem import CCMParams, Phase

TransferListener = Callable[[np.ndarray, int, int], None]

INF = float("inf")

# Relative memory-feasibility tolerance.  The old absolute ``+ 1e-6``
# slack was calibrated for nothing: on byte-scale phases (HBM budgets,
# ``balance/expert_placement``) it is immeasurable noise, while on
# normalized-unit phases it can admit placements a full 1e-6 units over
# the cap.  Scaling the slack by |cap| keeps it meaning "float
# accumulation noise" at every unit scale.
MEM_REL_TOL = 1e-9


def effective_mem_cap(cap, params: Optional[CCMParams] = None):
    """THE soft memory cap every feasibility comparison tests against.

    Single definition shared by the scalar reference (``memory_feasible``,
    ``exchange_eval``), the vectorized engine (``batch_peer_diffs`` and the
    SC scalar planes — caps are packed pre-scaled so the compiled combines
    compare plain ``<=``), and the stage-1 summary approximations — the
    paths cannot disagree about what "fits" means.

    ``params.mem_headroom`` (fraction in [0, 1)) shrinks the cap below the
    hard ``rank_mem_cap`` so the pressure policy starts migrating/evicting
    BEFORE the hard ceiling is touched; the default 0.0 skips the multiply
    entirely, keeping legacy configs bitwise-identical.  Works elementwise
    on arrays; ``inf`` caps stay ``inf``.
    """
    if params is not None and params.mem_headroom:
        cap = cap * (1.0 - params.mem_headroom)
    return cap + MEM_REL_TOL * np.abs(cap)


@dataclasses.dataclass
class CCMState:
    """Mutable evaluation state for a full assignment."""

    phase: Phase
    params: CCMParams
    assignment: np.ndarray              # (K,) task -> rank
    # derived, maintained incrementally:
    load: np.ndarray                    # (I,)
    vol: np.ndarray                     # (I, I) rank-to-rank volumes (4)
    block_count: np.ndarray             # (I, N) #tasks of block b on rank i
    mem_task: np.ndarray                # (I,) sum of task baseline memory
    mem_overhead_max: np.ndarray        # (I,) max task overhead (recomputed)

    # ------------------------------------------------------------------ build
    @staticmethod
    def build(phase: Phase, assignment: np.ndarray, params: CCMParams,
              csr: Optional[PhaseCSR] = None) -> "CCMState":
        """``csr``: a prebuilt :class:`PhaseCSR` for this phase's topology
        (task->edge / block->task adjacency).  Multi-phase pipelines pass the
        previous phase's bundle when the topology is unchanged, amortizing
        the build (see core/pipeline.py); the content is identical to a
        fresh build, so results cannot differ."""
        i_n = phase.num_ranks
        assignment = np.asarray(assignment, np.int64).copy()
        load = np.bincount(assignment, weights=phase.task_load, minlength=i_n)
        if phase.rank_speed is not None:
            load = load / 1.0  # speed applied at W() time (task loads raw)
        vol = np.zeros((i_n, i_n), np.float64)
        np.add.at(vol, (assignment[phase.comm_src], assignment[phase.comm_dst]),
                  phase.comm_vol)
        block_count = np.zeros((i_n, phase.num_blocks), np.int64)
        has_blk = phase.task_block >= 0
        np.add.at(block_count,
                  (assignment[has_blk], phase.task_block[has_blk]), 1)
        mem_task = np.bincount(assignment, weights=phase.task_mem,
                               minlength=i_n)
        mem_overhead_max = np.zeros(i_n, np.float64)
        for r in range(i_n):
            sel = assignment == r
            if sel.any():
                mem_overhead_max[r] = phase.task_overhead[sel].max()
        st = CCMState(phase, params, assignment, load, vol, block_count,
                      mem_task, mem_overhead_max)
        st._build_caches(csr)
        return st

    def _build_caches(self, csr: Optional[PhaseCSR] = None):
        """CSR phase view + per-rank homing/shared caches (exchange_eval hot
        path: O(all edges + all blocks) per call -> O(touched edges +
        blocks)).  The CSR bundle is phase-static and shared with the
        vectorized engine."""
        ph = self.phase
        self.csr = csr if csr is not None else PhaseCSR.from_phase(ph)
        # monotonically increasing mutation counter: bumped by every
        # apply_transfer, so derived-value caches (engine block terms, vol
        # row sums, incident-edge sets, per-rank work) can validate with
        # one int compare and recompute bitwise-identically on miss
        self.version = 0
        self._work_cache: Dict[int, Tuple[int, float]] = {}
        # transfer listeners: every mutation (apply_transfer/swap) is
        # reported AFTER the state is consistent, so long-lived observers
        # (PhaseEngine's incremental rank segments) can update in place
        # instead of re-deriving from the assignment.  Entries are
        # zero-arg resolvers returning the callback or None once its owner
        # was garbage-collected (see add_transfer_listener).
        self._transfer_listeners: List[Callable[
            [], Optional[TransferListener]]] = []
        # per-rank task counts: lets apply_transfer keep mem_overhead_max
        # exact without a full `assignment == r` scan per commit
        self.task_count = np.bincount(self.assignment,
                                      minlength=ph.num_ranks).astype(np.int64)
        present = self.block_count > 0                     # (I, N)
        off_home = present.copy()
        off_home[ph.block_home, np.arange(ph.num_blocks)] = False
        self.hom_cache = (off_home * ph.block_size[None, :]).sum(1)
        self.shared_cache = (present * ph.block_size[None, :]).sum(1)

    def add_transfer_listener(self, cb: TransferListener) -> None:
        """Register ``cb(tasks, r_from, r_to)`` to run after every
        :meth:`apply_transfer` (tasks is the moved id array, state already
        updated).

        Bound methods are held WEAKLY so a discarded observer (e.g. a
        throwaway ``PhaseEngine`` on a long-lived state) is detached by
        garbage collection instead of being pinned forever and spliced on
        every transfer; plain functions/lambdas are held strongly (a weak
        ref to an anonymous lambda would die immediately)."""
        if hasattr(cb, "__self__"):
            self._transfer_listeners.append(weakref.WeakMethod(cb))
        else:
            self._transfer_listeners.append(lambda _cb=cb: _cb)

    def remove_transfer_listener(self, cb: TransferListener) -> None:
        """Detach a listener previously registered with
        :meth:`add_transfer_listener`, matched by equality through the
        resolver entries.  Equality (not identity) because accessing a
        bound method creates a fresh object each time — ``obj.m is obj.m``
        is False while ``obj.m == obj.m`` compares the underlying
        (receiver, function) pair; plain functions compare by identity
        either way.  Unknown callbacks are a no-op; already-collected
        entries are pruned on the way through."""
        self._transfer_listeners = [
            e for e in self._transfer_listeners
            if e() is not None and e() != cb]

    def retarget(self, phase: Phase, params: CCMParams) -> None:
        """Re-bind this state to a NEW phase with the same adjacency
        topology (the ``same_topology`` predicate: identical comm endpoints
        and task->block map — callers check it; this method only asserts
        the counts), keeping the assignment.

        Multi-phase pipelines use this to carry a state+engine across
        phases whose loads/volumes/memory drift while the topology holds:
        the value-derived arrays (load, vol, mem_task, overhead maxima,
        homing/shared caches) are recomputed with the SAME operations a
        fresh ``build`` runs — bitwise-identical results, asserted by
        tests/test_torch_pipeline.py — while the topology-derived
        structures are carried: the frozen CSR bundle (the expensive part),
        the integer block counters (incrementally exact for the unchanged
        assignment), and the registered transfer listeners (a carried
        engine's segments depend only on the assignment, which is
        unchanged).  Bumps ``version`` so every version-validated
        downstream cache re-derives."""
        if (phase.num_tasks != self.phase.num_tasks
                or phase.num_ranks != self.phase.num_ranks
                or phase.num_blocks != self.phase.num_blocks):
            raise ValueError("retarget requires matching task/rank/block "
                             "counts (same_topology phases)")
        i_n = phase.num_ranks
        a = self.assignment
        self.phase = phase
        self.params = params
        self.version += 1
        self._work_cache.clear()
        # the heavy-edge threshold cache is keyed on quantile but derived
        # from phase.comm_vol — a drifted phase must not reuse it
        if getattr(self, "_quantile_cache", None) is not None:
            self._quantile_cache.clear()
        load = np.bincount(a, weights=phase.task_load, minlength=i_n)
        if phase.rank_speed is not None:
            load = load / 1.0  # mirror build(): speed applied at W() time
        self.load = load
        vol = np.zeros((i_n, i_n), np.float64)
        np.add.at(vol, (a[phase.comm_src], a[phase.comm_dst]),
                  phase.comm_vol)
        self.vol = vol
        self.mem_task = np.bincount(a, weights=phase.task_mem,
                                    minlength=i_n)
        self.mem_overhead_max = np.zeros(i_n, np.float64)
        for r in range(i_n):
            sel = a == r
            if sel.any():
                self.mem_overhead_max[r] = phase.task_overhead[sel].max()
        present = self.block_count > 0
        off_home = present.copy()
        off_home[phase.block_home, np.arange(phase.num_blocks)] = False
        self.hom_cache = (off_home * phase.block_size[None, :]).sum(1)
        self.shared_cache = (present * phase.block_size[None, :]).sum(1)

    def _touched_edges(self, tasks: np.ndarray) -> np.ndarray:
        """Unique ids of comm edges incident to ``tasks`` (CSR gather)."""
        if len(tasks) == 0:
            return np.zeros(0, np.int64)
        return np.unique(self.csr.task_edges.gather(np.asarray(tasks)))

    # ----------------------------------------------------------------- pieces
    def off_rank_volume(self, r: int) -> float:
        """V_notin(r): max(sent off-rank, received off-rank) (eq. 5)."""
        sent = self.vol[r].sum() - self.vol[r, r]
        recv = self.vol[:, r].sum() - self.vol[r, r]
        return float(max(sent, recv))

    def on_rank_volume(self, r: int) -> float:
        return float(self.vol[r, r])

    def homing_cost(self, r: int) -> float:
        """M_H(r): bytes of blocks present on r that are not homed at r (10)."""
        return float(self.hom_cache[r])

    def rank_shared_mem(self, r: int) -> float:
        return float(self.shared_cache[r])

    def max_memory(self, r: int) -> float:
        """M_max(r) (eq. 7): baseline + task memory (6) + shared blocks."""
        return (self.phase.rank_mem_base[r] + self.mem_task[r]
                + self.mem_overhead_max[r] + self.rank_shared_mem(r))

    def memory_feasible(self, r: int) -> bool:
        return self.max_memory(r) <= effective_mem_cap(
            self.phase.rank_mem_cap[r], self.params)

    def work(self, r: int) -> float:
        """W(r) (eq. 13).  Cached per state version: the hot path asks for
        the same rank's work several times between transfers (lock-event
        w_before, stage traces), and a hit returns the float the recompute
        produced — bitwise-neutral."""
        hit = self._work_cache.get(r)
        if hit is not None and hit[0] == self.version:
            return hit[1]
        p = self.params
        if p.memory_constraint and not self.memory_feasible(r):
            w = INF
        else:
            w = float(p.alpha * self.load[r] / self.phase.rank_speed[r]
                      + p.beta * self.off_rank_volume(r)
                      + p.gamma * self.on_rank_volume(r)
                      + p.delta * self.homing_cost(r))
        self._work_cache[r] = (self.version, w)
        return w

    def all_work(self) -> np.ndarray:
        return np.array([self.work(r) for r in range(self.phase.num_ranks)])

    def max_work(self) -> float:
        return float(self.all_work().max())

    def total_work(self) -> float:
        w = self.all_work()
        return float(w.sum())

    def imbalance(self) -> float:
        """I_L = max(L)/mean(L) - 1 (§II-A, on loads)."""
        mu = self.load.mean()
        return float(self.load.max() / mu - 1.0) if mu > 0 else 0.0

    # ------------------------------------------------------- transfer updates
    def apply_transfer(self, tasks: Sequence[int], r_from: int, r_to: int):
        """Mutate state: move tasks from r_from to r_to (update formulae)."""
        ph = self.phase
        self.version += 1
        tasks = np.asarray(list(tasks), np.int64)
        assert (self.assignment[tasks] == r_from).all()
        self.assignment[tasks] = r_to
        moved_load = ph.task_load[tasks].sum()
        self.load[r_from] -= moved_load          # eq. (2)
        self.load[r_to] += moved_load
        # communication volumes: edges incident to moved tasks change buckets
        moved = np.zeros(ph.num_tasks, bool)
        moved[tasks] = True
        eids = self._touched_edges(tasks)
        if eids.size:
            # assignment already updated; reconstruct old buckets
            src, dst = ph.comm_src[eids], ph.comm_dst[eids]
            s_new = self.assignment[src]
            d_new = self.assignment[dst]
            s_old = np.where(moved[src], r_from, s_new)
            d_old = np.where(moved[dst], r_from, d_new)
            v = ph.comm_vol[eids]
            np.subtract.at(self.vol, (s_old, d_old), v)
            np.add.at(self.vol, (s_new, d_new), v)
        # blocks (+ presence caches: homing / shared-memory transitions)
        blk = ph.task_block[tasks]
        for b in blk[blk >= 0]:
            size = ph.block_size[b]
            self.block_count[r_from, b] -= 1
            if self.block_count[r_from, b] == 0:
                self.shared_cache[r_from] -= size
                if ph.block_home[b] != r_from:
                    self.hom_cache[r_from] -= size
            if self.block_count[r_to, b] == 0:
                self.shared_cache[r_to] += size
                if ph.block_home[b] != r_to:
                    self.hom_cache[r_to] += size
            self.block_count[r_to, b] += 1
        # task memory
        moved_mem = ph.task_mem[tasks].sum()
        self.mem_task[r_from] -= moved_mem
        self.mem_task[r_to] += moved_mem
        # overhead maxima: exact incremental update.  The receiving max
        # only grows (toward the moved max); the sender needs a rescan
        # only when the departing set could have held its maximum —
        # float max has no rounding, so the rescan-on-demand value is
        # bitwise what the old full `assignment == r` scans computed.
        k = int(tasks.size)
        mo = float(ph.task_overhead[tasks].max()) if k else 0.0
        old_from = float(self.mem_overhead_max[r_from])
        if self.task_count[r_to] == 0:
            self.mem_overhead_max[r_to] = mo
        elif mo > self.mem_overhead_max[r_to]:
            self.mem_overhead_max[r_to] = mo
        self.task_count[r_from] -= k
        self.task_count[r_to] += k
        if self.task_count[r_from] == 0:
            self.mem_overhead_max[r_from] = 0.0
        elif k and mo >= old_from:
            self.mem_overhead_max[r_from] = \
                ph.task_overhead[self.assignment == r_from].max()
        if self._transfer_listeners:
            dead = False
            for entry in self._transfer_listeners:
                cb = entry()
                if cb is None:
                    dead = True
                else:
                    cb(tasks, r_from, r_to)
            if dead:    # prune collected observers
                self._transfer_listeners = [
                    e for e in self._transfer_listeners if e() is not None]

    def swap(self, tasks_a: Sequence[int], r_a: int, tasks_b: Sequence[int],
             r_b: int):
        if len(tasks_a):
            self.apply_transfer(tasks_a, r_a, r_b)
        if len(tasks_b):
            self.apply_transfer(tasks_b, r_b, r_a)


@dataclasses.dataclass
class ExchangeEval:
    """Work of the two endpoints after a candidate exchange (no mutation)."""

    work_a_after: float
    work_b_after: float
    feasible: bool

    @property
    def max_after(self) -> float:
        return max(self.work_a_after, self.work_b_after)


def exchange_eval(state: CCMState, tasks_ab: Sequence[int],
                  tasks_ba: Sequence[int], r_a: int, r_b: int) -> ExchangeEval:
    """Evaluate moving ``tasks_ab`` (a->b) and ``tasks_ba`` (b->a)
    simultaneously, via the update formulae — O(moved tasks + their edges +
    their blocks); does NOT mutate state.
    """
    ph = state.phase
    p = state.params
    tasks_ab = np.asarray(list(tasks_ab), np.int64)
    tasks_ba = np.asarray(list(tasks_ba), np.int64)
    load_ab = ph.task_load[tasks_ab].sum()
    load_ba = ph.task_load[tasks_ba].sum()
    load_a = state.load[r_a] - load_ab + load_ba
    load_b = state.load[r_b] + load_ab - load_ba

    # --- communication deltas ------------------------------------------------
    moved_all = np.concatenate([tasks_ab, tasks_ba])
    new_rank_map: Dict[int, int] = {}
    for t in tasks_ab:
        new_rank_map[int(t)] = r_b
    for t in tasks_ba:
        new_rank_map[int(t)] = r_a
    dvol: Dict[Tuple[int, int], float] = {}
    a = state.assignment
    for e in state._touched_edges(moved_all):
        ts, td = int(ph.comm_src[e]), int(ph.comm_dst[e])
        s, d = a[ts], a[td]
        s2 = new_rank_map.get(ts, s)
        d2 = new_rank_map.get(td, d)
        v = ph.comm_vol[e]
        dvol[(s, d)] = dvol.get((s, d), 0.0) - v
        dvol[(s2, d2)] = dvol.get((s2, d2), 0.0) + v

    def off_after(r: int) -> float:
        sent = state.vol[r].sum() - state.vol[r, r]
        recv = state.vol[:, r].sum() - state.vol[r, r]
        for (s, d), v in dvol.items():
            if s == r and d != r:
                sent += v
            if d == r and s != r:
                recv += v
        return max(sent, recv)

    def on_after(r: int) -> float:
        return state.vol[r, r] + dvol.get((r, r), 0.0)

    # --- homing / shared-block deltas (Thm III.1, both directions) ----------
    dcount: Dict[int, Tuple[int, int]] = {}  # block -> (delta on a, delta on b)
    for b in ph.task_block[tasks_ab]:
        if b >= 0:
            da, db = dcount.get(int(b), (0, 0))
            dcount[int(b)] = (da - 1, db + 1)
    for b in ph.task_block[tasks_ba]:
        if b >= 0:
            da, db = dcount.get(int(b), (0, 0))
            dcount[int(b)] = (da + 1, db - 1)

    hom = {r_a: state.homing_cost(r_a), r_b: state.homing_cost(r_b)}
    shared = {r_a: state.rank_shared_mem(r_a), r_b: state.rank_shared_mem(r_b)}
    for b, (da, db) in dcount.items():
        size = ph.block_size[b]
        for r, dc in ((r_a, da), (r_b, db)):
            before = state.block_count[r, b]
            after = before + dc
            if before > 0 and after == 0:
                shared[r] -= size
                if ph.block_home[b] != r:
                    hom[r] -= size
            elif before == 0 and after > 0:
                shared[r] += size
                if ph.block_home[b] != r:
                    hom[r] += size

    # --- memory feasibility ---------------------------------------------------
    mem_ab = ph.task_mem[tasks_ab].sum()
    mem_ba = ph.task_mem[tasks_ba].sum()
    over_ab = ph.task_overhead[tasks_ab].max() if len(tasks_ab) else 0.0
    over_ba = ph.task_overhead[tasks_ba].max() if len(tasks_ba) else 0.0
    mem_a = (ph.rank_mem_base[r_a] + state.mem_task[r_a] - mem_ab + mem_ba
             + shared[r_a] + max(state.mem_overhead_max[r_a], over_ba))
    mem_b = (ph.rank_mem_base[r_b] + state.mem_task[r_b] + mem_ab - mem_ba
             + shared[r_b] + max(state.mem_overhead_max[r_b], over_ab))
    feasible = True
    if p.memory_constraint:
        feasible = (mem_a <= effective_mem_cap(ph.rank_mem_cap[r_a], p)
                    and mem_b <= effective_mem_cap(ph.rank_mem_cap[r_b], p))

    def w(load, off, on, h, r):
        return (p.alpha * load / ph.rank_speed[r] + p.beta * off
                + p.gamma * on + p.delta * h)

    wa = w(load_a, off_after(r_a), on_after(r_a), hom[r_a], r_a)
    wb = w(load_b, off_after(r_b), on_after(r_b), hom[r_b], r_b)
    if not feasible:
        wa, wb = INF, INF
    return ExchangeEval(float(wa), float(wb), bool(feasible))
