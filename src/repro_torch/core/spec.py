"""Speculative lock-event scan: a window of stage-2 events a launch (the
port's counterpart of ``repro/core/spec.py``).

The synchronous round-robin driver's event sequence is DETERMINISTIC: every
lock request is granted and released within its turn, so deadlock-
avoidance yields and grant chains are unreachable, and the full ordered
list of (r, p) lock events of an iteration follows from the stage-1 work
lists alone (:func:`event_sequence`), before any event is scored.

:func:`run_spec` exploits that: it speculatively captures a *window* of
upcoming events from the CURRENT (pre-window) state — shortlists via
``shortlist_pairs`` and one float64 row each via ``PhaseEngine.spec_raw``
— and scores the whole window in ONE launch
(``kernels/ccm_scorer/launch.py::score_spec``: on the card the window
kernel builds each event's flow matrix, its features, the scorer tree,
the work combine and the selection rule; on the CPU its plain version
does).  The host then walks the window in event order and commits
winners, rolling back every event an earlier commit invalidated:

  * ``dirty`` = ranks touched by transfers committed in this window;
  * the first event whose ranks intersect ``dirty`` is rolled back — its
    speculative shortlist/scores/clusters are stale — and so is every
    LATER event of the same instance, even rank-disjoint ones.  The
    strict-prefix cut keeps the committed event order equal to the
    reference event order (committing a later disjoint event before the
    rolled-back one re-runs would permute the transfer log);
  * rolled-back events re-enter the queue front, in order, and are
    re-captured against the post-commit state in the next window — except
    that an event rolled back ONLY by the prefix cut (its ranks disjoint
    from every committed transfer's) keeps its capture and its score:
    nothing a transfer on other ranks mutates enters the capture.
    Validity is tracked per rank (version of the last transfer touching
    it); the reuse carries the same sub-ulp caveat as the batched driver's
    deferred events (a disjoint swap relabels third-rank vol entries
    without changing their true sums — see core/ccmlb.py).

The host control flow (sequence, capture, commit and rollback walk) stays
host numpy, as in the JAX package.  Committed prefixes replay the exact
reference event sequence.  Each committed event's inputs are what the host
engine driver computes at that point, up to the window scorer's summation
order (sequential slice sums on the card against numpy's pairwise sums on
the host; the flow matrix itself is the host's bit for bit), so the path
sits in the trajectory-identity tier: the same assignment and transfer log
as the host engine, asserted empirically (tests/test_torch_spec.py,
chip_smoke.py).  The first event of each instance in every window can
never be rolled back, so every window makes progress.

The same machinery batches across INSTANCES: ``run_spec`` accepts many
:class:`SpecInstance` objects and fills each window round-robin (one event
per live instance per sweep) — the fleet mode (``core/fleet.py``).  Dirty
sets, prefix cuts and commit order are all per instance, so an instance's
committed sequence is always exactly its solo event order.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from time import perf_counter
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.engine import ExchangeEvent, PhaseEngine
from repro_torch.core.transfer import shortlist_pairs
from repro_torch.kernels.ccm_scorer import launch
from repro_torch.kernels.ccm_scorer.layout import bucket_lanes, bucket_pairs

__all__ = ["SpecInstance", "event_sequence", "run_spec", "SPEC_FILLS"]

#: the speculation policies of :func:`run_spec`
SPEC_FILLS = ("disjoint", "greedy")


def event_sequence(num_ranks: int,
                   work_lists: Dict[int, deque]) -> List[Tuple[int, int]]:
    """The ordered (r, p) lock events the synchronous round-robin driver
    (``ccmlb._stage2``) executes for these work lists — derivable without
    scoring anything because on that driver every lock request is granted
    and every lock is released within its turn.  Mirrors the driver
    exactly, including the spin budget.  Consumes the deques."""
    active = deque(r for r in range(num_ranks) if work_lists[r])
    seq: List[Tuple[int, int]] = []
    spins = 0
    max_spins = 50 * num_ranks + 1000
    while active and spins < max_spins:
        spins += 1
        r = active.popleft()
        if not work_lists[r]:       # unreachable like the driver's branch,
            continue                # but mirrored so the spin budget agrees
        _diff, p = work_lists[r].popleft()
        seq.append((r, p))
        if work_lists[r]:
            active.append(r)
    return seq


@dataclasses.dataclass
class SpecInstance:
    """One balance problem's slice of a speculative scan.

    ``queue`` holds the instance's remaining (r, p) events in reference
    order; ``rebuild`` is the post-transfer local cluster rebuild closure
    (``ccmlb._rebuild_local`` bound to this instance's state/clusters);
    ``stats`` only needs ``transfers``/``spec_rollbacks``/``spec_windows``
    counters (``ccmlb.ProtocolStats`` provides them).  ``trace``, when a
    list, records (window, kind, r, p) tuples with kind in {"transfer",
    "commit", "noop", "rollback"}.  ``cache`` maps (r, p, state.version) to
    captured (shortlist, raw) preparations; pass a persistent dict ONLY
    when the cluster list objects are stable while the version is (the
    fleet driver guarantees this by reusing cluster lists across quiet
    iterations) — entries are value-exact because every cached quantity is
    a deterministic function of (state, clusters).
    """

    state: object
    engine: PhaseEngine
    clusters: Dict[int, list]
    stats: object
    rebuild: Callable[[int, int], None]
    queue: Deque[Tuple[int, int]]
    max_candidates: int = 12
    shortlist: int = 32
    trace: Optional[list] = None
    cache: Optional[dict] = None


def _prepare(inst: SpecInstance, r: int, p: int, a_lanes: int,
             b_lanes: int, p_n: int):
    """Speculatively capture event (r, p) from the instance's CURRENT
    state: the shortlist (identical to what the host driver's
    ``try_transfer`` would enumerate) and the ready-to-stack window row
    with the pre-exchange work bound baked into its w_before slot.
    Returns (capture, raw) with raw = (row, eb) — capture is None for
    events with no candidate pairs (both ranks clusterless: a structural
    no-op)."""
    key = (r, p, inst.state.version)
    if inst.cache is not None:
        hit = inst.cache.get(key)
        if hit is not None:
            return hit
    cand_a, cand_b, pairs, agg_a, agg_b = shortlist_pairs(
        inst.state, inst.clusters[r], inst.clusters[p], r, p,
        inst.max_candidates, inst.shortlist, engine=inst.engine)
    if pairs.shape[0] == 0:
        entry = (None, None)
    else:
        ev = ExchangeEvent(r, p, cand_a, cand_b, pairs, agg_a, agg_b)
        row, eb = inst.engine.spec_raw(ev, a_lanes, b_lanes, p_n)
        row[-2] = max(inst.state.work(r), inst.state.work(p))   # w_before
        entry = ((cand_a, cand_b, pairs), (row, eb))
    if inst.cache is not None:
        inst.cache[key] = entry
    return entry


def run_spec(instances: List[SpecInstance], *, window: int,
             mode: str = "scan", fill: str = "disjoint",
             timings: Optional[dict] = None) -> None:
    """Drain every instance's event queue through windowed launches with
    strict-prefix commit/rollback (module docstring).  Mutates the
    instances' states/clusters/stats in place.  The window rows bake their
    coefficient columns from each instance's ``state.params``; a window is
    scored where the first instance's engine scores (``engine.device``).

    ``fill`` picks the speculation policy:

      * ``"disjoint"`` (default) — stop taking events from an instance's
        queue at the first event whose ranks overlap an event already
        taken from that instance this window.  A commit then can never
        dirty a later window event, so rollback is structurally impossible
        and large windows amortize the launch without speculation waste
        (untaken events just stay queued).
      * ``"greedy"`` — fill blindly; overlapping speculations roll back
        through the strict-prefix cut.

    ``mode`` is the window scorer's (``launch.SPEC_MODES``).  ``timings``,
    when a dict with ``"score"`` and ``"commit"`` entries, accumulates the
    seconds of capture plus launch and of the commit walk.
    """
    if window < 1:
        raise ValueError("spec window must be >= 1")
    if fill not in SPEC_FILLS:
        raise ValueError("fill must be 'disjoint' or 'greedy'")
    if mode not in launch.SPEC_MODES:
        raise ValueError(f"unknown spec mode: {mode!r}")
    device = instances[0].engine.device
    a_lanes = b_lanes = bucket_lanes(
        max(i.max_candidates for i in instances) + 1)
    # the pair bucket pinned by the instances' knobs, so every window row
    # of the run shares one layout
    p_n = bucket_pairs(max(
        min(i.max_candidates * (i.max_candidates + 2), i.shortlist)
        for i in instances))
    # captures held across windows for cut-but-disjoint rollbacks:
    # (id(inst), r, p) -> (version at capture, cap, raw, result), valid
    # while no committed transfer has touched r or p since the capture
    # (tracked in ``touched``: (id(inst), rank) -> version of the last
    # commit there)
    held: Dict[Tuple[int, int, int], tuple] = {}
    touched: Dict[Tuple[int, int], int] = {}
    wid = 0
    while any(inst.queue for inst in instances):
        t0 = perf_counter() if timings is not None else 0.0
        # ---- fill: round-robin one event per live instance per sweep, so
        # a window shared by many instances interleaves them fairly
        # (sweeps repeat until the window is full or every queue is dry;
        # under fill="disjoint" an instance also stops contributing at its
        # first rank overlap, leaving the event queued for the next window)
        entries: List[list] = []    # [inst, r, p, capture, raw, result]
        taken: Dict[int, set] = {}
        blocked: set = set()
        while len(entries) < window:
            took = False
            for inst in instances:
                if len(entries) >= window:
                    break
                if id(inst) in blocked or not inst.queue:
                    continue
                r, p = inst.queue[0]
                t = taken.setdefault(id(inst), set())
                if fill == "disjoint" and (r in t or p in t):
                    blocked.add(id(inst))
                    continue
                inst.queue.popleft()
                t.update((r, p))
                entries.append([inst, r, p, None, None, None])
                took = True
            if not took:
                break
        # ---- speculate: capture every entry from the pre-window state;
        # a valid held capture skips the host prep, and a held SCORE (the
        # launch already ran before the rollback) skips the launch slot
        # too.  Under fill="disjoint" rollback is impossible, so nothing
        # is ever held.
        raws, scored = [], []
        for idx, ent in enumerate(entries):
            inst, r, p = ent[0], ent[1], ent[2]
            if fill == "disjoint":
                cap, raw = _prepare(inst, r, p, a_lanes, b_lanes, p_n)
                res = None
            else:
                hkey = (id(inst), r, p)
                h = held.pop(hkey, None)
                if (h is not None
                        and touched.get((id(inst), r), -1) <= h[0]
                        and touched.get((id(inst), p), -1) <= h[0]):
                    cap, raw, res = h[1], h[2], h[3]
                else:
                    cap, raw = _prepare(inst, r, p, a_lanes, b_lanes, p_n)
                    res = None
                held[hkey] = (inst.state.version, cap, raw, None)
            ent[3] = cap
            ent[4] = raw
            ent[5] = res
            if cap is not None and res is None:
                raws.append(raw)
                scored.append(idx)
        # ---- one launch over the whole window
        if raws:
            out = launch.score_spec(raws, a_lanes=a_lanes, b_lanes=b_lanes,
                                    p_n=p_n, mode=mode, device=device)
            for j, idx in enumerate(scored):
                entries[idx][5] = out[j]
        if timings is not None:
            t1 = perf_counter()
            timings["score"] += t1 - t0
            t0 = t1
        # ---- commit walk: strict per-instance prefix in window order
        dirty: Dict[int, set] = {}
        cut: Dict[int, bool] = {}
        deferred: Dict[int, List[Tuple[int, int]]] = {}
        seen: Dict[int, SpecInstance] = {}
        for ent in entries:
            inst, r, p, cap, raw, res = ent
            key = id(inst)
            seen.setdefault(key, inst)
            d = dirty.setdefault(key, set())
            if cut.get(key) or r in d or p in d:
                # an earlier commit invalidated this speculation (or an
                # earlier rollback cut the prefix): roll back, re-queue —
                # keeping the computed score with the held capture, so a
                # still-valid (rank-disjoint) speculation re-commits next
                # window without re-running prep or launch
                cut[key] = True
                deferred.setdefault(key, []).append((r, p))
                h = held.get((key, r, p))
                if h is not None and h[1] is cap:
                    held[(key, r, p)] = (h[0], cap, raw, res)
                inst.stats.spec_rollbacks += 1
                if inst.trace is not None:
                    inst.trace.append((wid, "rollback", r, p))
                continue
            if cap is None:
                if inst.trace is not None:
                    inst.trace.append((wid, "noop", r, p))
                continue
            # -inf is the scorer's no-op; +inf is a real move: a rank over
            # its memory cap carries infinite work (w_before = inf), and
            # the host engine's select_best takes such a feasibility-
            # restoring move.  (The JAX package's spec path tests
            # np.isfinite here and refuses it: ROADMAP.md, queue 3.)
            if res[1] != -np.inf:
                cand_a, cand_b, pairs = cap
                k = int(res[0])
                ia, ib = int(pairs[k, 0]), int(pairs[k, 1])
                inst.state.swap(cand_a[ia], r, cand_b[ib], p)
                inst.stats.transfers += 1
                inst.rebuild(r, p)
                d.update((r, p))
                touched[(key, r)] = touched[(key, p)] = inst.state.version
                if inst.trace is not None:
                    inst.trace.append((wid, "transfer", r, p))
            elif inst.trace is not None:
                inst.trace.append((wid, "commit", r, p))
        for key, dq in deferred.items():
            if dq:      # re-enter at the queue FRONT, preserving order
                seen[key].queue.extendleft(reversed(dq))
        for key in seen:
            seen[key].stats.spec_windows += 1
        if timings is not None:
            timings["commit"] += perf_counter() - t0
        wid += 1
