"""Asynchronous distributed event-loop simulator for CCM-LB (paper §IV-B).

The port's copy of ``repro/core/async_sim.py``: the same host event loop,
with every lock event that reaches the engine scored on ``device`` (the
pair kernel on the card, its plain torch version on the CPU).

Why this exists: the synchronous driver in :mod:`repro_torch.core.ccmlb`
runs
the lock/transfer stage as a round-robin loop in which every lock is
released within the turn that took it — lock conflicts, deadlock-avoidance
yields and grant chains are structurally unreachable there, so the §IV-B
protocol machinery was only ever exercised by direct unit tests.  This
module drives the SAME shared handlers (``lock_request`` / ``note_yield``
/ ``lock_release`` / ``execute_transfer`` — see "two drivers, one
protocol" in core/ccmlb.py) through a seeded discrete-event
simulation with per-rank mailboxes and a configurable message-latency
distribution, in the spirit of asynchronous diffusion-style balancers on
arbitrary networks (arXiv:1308.0148): concurrent lock requests collide,
``must_yield`` fires, queued requests drain through real grant chains,
and gossip arrives in latency-permuted (optionally deadline-dropped,
i.e. stale) order.

Event <-> paper mapping (§IV, Fig. 1)
-------------------------------------
  ``GOSSIP``    lines 24–30 (BuildPeerNetwork): a rank's accumulated
                ``info_known`` snapshot in flight to a fanout peer; the
                recipient merges it (dedupe: core/gossip.py) and,
                below ``k_rounds``, forwards to peers the message has not
                visited.  Same messages, same rng, same merge rule as the
                synchronous epidemic — only the delivery schedule differs.
  ``DECIDE``    line 41's while-loop head: the rank's local scheduler pops
                the best remaining peer off its stage-1 work list and
                issues a lock request.  Not a network message (priority
                class LOCAL, see below).
  ``LOCK_REQ``  line 42 (requestLock): arrives at the target's mailbox;
                a free target locks itself to the requester and answers
                with ``GRANT``; a busy target queues the request FIFO —
                one *lock conflict*.
  ``GRANT``     line 43: the lock is held from the moment the target
                granted it (REQ receipt or release handoff) until the
                holder's ``RELEASE`` arrives back.  A grant arriving at a
                rank that is itself locked by ``r_x <= target`` triggers
                the line-45 deadlock-avoidance *yield*: release unused,
                re-queue the attempt (bounded by ``max_retries``).
  transfer      lines 46–48 (recvUpdate / TryTransfer / sendUpdate): the
                holder evaluates exactly with fresh info at grant-receipt
                time and executes the best positive exchange.
  ``RELEASE``   line 49 (releaseLock): frees the target; a queued
                requester is granted next — consecutive handoffs on one
                target form a *grant chain* (lengths are accounted in
                ``ProtocolStats`` / ``CCMLBResult.max_grant_chain``).
  ``TIMEOUT``   fault-hardening only (local timer at the requester): a
                lock request unanswered for ``FaultSpec.req_timeout`` is
                aborted (a RELEASE closes whatever state it reached) and
                retried with exponential backoff, bounded by
                ``max_retries``.  Never scheduled on a fault-free run.
  ``FAIL``      a ``FaultSpec.kill`` firing: the rank dies mid-iteration.
                Its queued requests are purged, locks it held are
                force-released (granting to the next live requester), its
                own lock table is reclaimed, and after the stage the
                survivor set is warm-started (see "Fault injection").

Determinism and the zero-latency parity bar
-------------------------------------------
All scheduling runs through one binary heap keyed ``(time, class, seq)``:
``seq`` is a global creation counter, so ties at equal time break
deterministically in creation order, and message events (class 0) always
precede local DECIDE timers (class 1) at the same timestamp.  Latency
draws come from a dedicated seeded stream, gossip peer picks from the
same per-iteration stream the synchronous driver uses — the whole run is
a pure function of ``(phase, params, seed, latency, fault, ...)``.

With zero latency this schedule *serializes*: a DECIDE's entire
REQ→GRANT→transfer→RELEASE cascade lands at the same timestamp and class
0, so it drains before the next rank's DECIDE — exactly the synchronous
driver's round-robin turn order.  No lock then ever outlives a turn, no
conflict/yield/chain fires, and the trajectory (assignment, transfer
sequence, traces) is bitwise-identical to ``ccm_lb`` (asserted in
tests/test_torch_async.py).  Under nonzero latency the interleaving is
arbitrary-but-seeded; the port's runs equal the JAX package's event for
event on the same seeds.

Fault injection
---------------
``ccm_lb_async(fault=FaultSpec(...))`` degrades the network and the
ranks themselves, seeded and per-link:

  * ``drop`` / ``dup`` / ``reorder`` — per-message probabilities (float,
    ``{(src, dst): p}`` dict, or ``fn(src, dst) -> p``) applied to every
    network send, gossip included; a reordered or duplicated copy is
    delayed by an extra Exp(``reorder_scale``) draw;
  * ``pause`` — ``(rank, iteration, start, end)`` windows (sim-time
    relative to that iteration's stage-2 start) during which every event
    addressed to the rank is deferred to the window's end;
  * ``kill`` — ``(rank, iteration, offset)`` dies at stage-2 start +
    offset; ``(rank, iteration, offset, stage)`` with ``stage=1`` dies
    mid-epidemic, offset from the ITERATION (gossip) start.  Dead ranks
    stay dead: messages to them vanish, messages they sent before dying
    still deliver, and a root dying mid-flood neither wedges the
    epidemic (live ranks keep forwarding its already-spread summary)
    nor poisons the epoch-keyed quiesce replay (the tracker purges the
    dead rank from every cache family — see ``QuiesceTracker.
    purge_ranks``);
  * ``partition`` — ``(ranks_a, ranks_b, iteration, start, end)``
    link-level BIDIRECTIONAL outages: every message crossing between
    the two groups while the window (sim-time relative to that
    iteration's gossip start) is open is destroyed, at send or at
    delivery time, splitting the mesh into islands.  Islands keep
    making local progress: a rank deciding on a peer it cannot
    currently reach skips the doomed request outright instead of
    burning a ``req_timeout`` wait (counted ``partition_skips``,
    bounded by the same per-(rank, peer) retry budget as yields), so
    intra-island transfers proceed at full speed.  After the window
    heals, the next iteration's gossip re-merges the islands — fresh
    summaries flood globally, work lists span the whole mesh again —
    without ever having violated mutual exclusion or the transfer-log
    replay invariant (cross-island lock requests either never arrived
    or timed out and were aborted/reclaimed like any lost message);
  * ``corrupt`` — per-link probability of mutating a gossip payload in
    flight (a seeded choice of flipped load, truncated cluster list,
    or stale epoch stamp — always on a COPY; the shared payload object
    is never touched).  Receivers validate a checksum
    (``repro_torch.core.gossip.summary_checksum``) and an iteration stamp
    on
    every delivery and QUARANTINE mismatches — counted
    ``corrupt_quarantined``, no merge, no forward — so a corrupted
    summary can never enter a work list; the root's clean epidemic
    keeps spreading through other paths.

Membership is the inverse degradation: ``ccm_lb_async(membership=
(RankJoin(iteration=k, count=m), ...))`` grows the mesh mid-stream.
At iteration ``k`` the phase is expanded (``repro_torch.runtime.elastic.
expand_phase`` — fresh ranks default to median capacity/speed), the
state/engine are rebuilt on the wider rank set (the CSR bundle is
rank-independent and carries over), and the tracker is re-grown
(``QuiesceTracker.regrow``).  The joined ranks inherit gossip state
through the ordinary epidemic flood of their first iteration and,
starting empty, attract transfers like any underloaded rank — the
rebalance IS the protocol, no side channel.  Joined ranks are recorded
in ``CCMLBResult.joined_ranks``.

The protocol survives by construction, not by luck: every LOCK_REQ
carries a unique ``req_id`` token that travels REQ→GRANT→RELEASE, making
duplicate requests, stale grants and stale releases token-checked no-ops
(core/locks.py); unanswered requests time out, abort and retry
with bounded exponential backoff; locks wedged by dropped RELEASEs are
reclaimed at the stage-end barrier (safe: an open request always keeps a
TIMEOUT queued, so an empty heap means no live requester is waiting);
dead ranks' lock state is reclaimed at death and the survivor set is
re-warm-started through ``repro_torch.core.pipeline.warm_start_assignment``
over ``repro_torch.runtime.elastic.survivor_resize``'s renumbering — the
same elastic-resize framing a mesh shrink uses.  Killing every rank raises
:class:`repro_torch.runtime.fault.RankDeath` (a ``NodeFailure``), handing
the
problem to the checkpoint-restart layer where it belongs.

The parity bar under faults: a ``fault=None`` or all-inactive
``FaultSpec`` run is BITWISE-identical to the fault-free driver (no
extra events, no extra rng draws, same trace); an active fault changes
trajectories but never invariants — at most one live lock per rank,
transfers only under mutual exclusion and never to/from dead ranks,
transfer-log replay == final assignment, quiescent termination.
``quiesce_after`` respects pending
faults and joins: the quiet counter only advances while no partition or
pause window is open and no kill/join is still scheduled, so early
termination cannot race a scheduled perturbation.

Differences from the synchronous driver, by design:

  * a requester whose LOCK_REQ is queued WAITS for the eventual grant
    (the sync loop re-queues a halved-priority retry instead — it gets
    an immediate boolean answer, a message protocol does not);
  * a yield re-queues the attempt at most ``max_retries`` times, bounding
    total work (the sync loop re-queues unboundedly; its yield branch is
    unreachable so termination never depended on it).  Work items dropped
    at the cap are counted in ``retries_exhausted`` — never silently;
  * ``batch_lock_events`` stays a synchronous-driver knob: deferred
    disjoint-event scoring relies on the turn order being independent of
    scoring outcomes, which no longer holds once grants interleave.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from time import perf_counter
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.ccm import CCMState, effective_mem_cap
from repro_torch.core.ccmlb import (CCMLBResult, ProtocolStats,
                                    build_work_lists, ccm_lb,
                                    execute_transfer, lock_release,
                                    lock_request, note_yield)
from repro_torch.core.engine import PhaseEngine
from repro_torch.core.gossip import (gossip_deliver, gossip_root_key,
                                     pick_peers, summary_checksum)
from repro_torch.core.locks import LockManager
from repro_torch.core.pipeline import warm_start_assignment
from repro_torch.core.problem import CCMParams, Phase
from repro_torch.core.quiesce import QuiesceTracker
from repro_torch.kernels.ccm_scorer.launch import resolve_device
from repro_torch.runtime.elastic import (RankJoin, expand_phase,
                                         survivor_resize)
from repro_torch.runtime.fault import RankDeath

__all__ = ["ccm_lb_async", "run_ccm_lb", "make_latency", "EVENT_KINDS",
           "FaultSpec", "FaultStats", "LivelockError", "RankJoin",
           "RecoveryOOMError"]

# event kinds (values appear in traces; names in EVENT_KINDS).  TIMEOUT
# and FAIL only ever fire under an active FaultSpec — the first five
# values are pinned so fault-free traces stay bitwise-comparable across
# versions.
GOSSIP, LOCK_REQ, GRANT, RELEASE, DECIDE, TIMEOUT, FAIL = range(7)
EVENT_KINDS = ("GOSSIP", "LOCK_REQ", "GRANT", "RELEASE", "DECIDE",
               "TIMEOUT", "FAIL")

# priority classes: messages always beat same-time local DECIDE timers —
# this is what serializes the zero-latency schedule into sync turn order
_MSG, _LOCAL = 0, 1


class LivelockError(RuntimeError):
    """The event budget ran out before the protocol drained.

    Structured so fault sweeps can report WHY a config livelocked instead
    of losing all accumulated accounting: ``processed`` / ``queued`` /
    ``sim_time`` are set at raise time inside the event loop;
    :func:`ccm_lb_async` enriches the in-flight exception with the
    partial ``stats`` (:class:`~repro_torch.core.ccmlb.ProtocolStats`),
    ``fault_stats`` and the ``iteration`` it died in before re-raising.
    Subclasses ``RuntimeError`` with "events" in the message, so guards
    written against the old bare error keep matching.
    """

    def __init__(self, max_events: int, processed: int, queued: int,
                 sim_time: float):
        super().__init__(
            f"async sim exceeded {max_events} events — protocol liveness "
            f"bug or fault storm ({processed} processed, {queued} still "
            f"queued at sim time {sim_time:.3f})")
        self.max_events = max_events
        self.processed = processed
        self.queued = queued
        self.sim_time = sim_time
        self.stats: Optional[ProtocolStats] = None
        self.fault_stats: Optional["FaultStats"] = None
        self.iteration: Optional[int] = None


class RecoveryOOMError(RuntimeError):
    """Crash recovery found no survivor with memory room for a stranded
    task group.

    Raised by :func:`_recover_survivors` under an active memory
    constraint when every survivor's post-placement M_max (eq. 7) would
    exceed its (headroom-scaled) cap — the cluster genuinely cannot
    absorb the dead rank's working set and must shed load or restart
    from a checkpoint on more ranks.  Carries the stranded ``tasks``
    (tuple of task ids), the ``dead_rank`` they were on, and
    ``overflow_bytes``: the smallest cap excess across survivors, i.e.
    how much memory the least-bad placement still lacked.
    """

    def __init__(self, tasks, dead_rank: int, overflow_bytes: float):
        super().__init__(
            f"crash recovery OOM: no survivor can hold {len(tasks)} "
            f"task(s) stranded on dead rank {dead_rank} — best placement "
            f"still {overflow_bytes:.3e} bytes over its memory cap")
        self.tasks = tuple(int(t) for t in tasks)
        self.dead_rank = int(dead_rank)
        self.overflow_bytes = float(overflow_bytes)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Seeded fault model for the async driver (see module docstring).

    ``drop`` / ``dup`` / ``reorder`` / ``corrupt`` accept a float
    probability, a per-link ``{(src, dst): p}`` dict (unlisted links are
    fault-free), or a callable ``(src, dst) -> p``; ``corrupt`` applies
    to gossip payloads only (protocol messages carry tokens, not
    summaries).  ``pause`` entries are ``(rank, iteration, start, end)``,
    ``kill`` entries ``(rank, iteration, offset)`` (dies at stage-2
    start + offset) or ``(rank, iteration, offset, stage)`` with
    ``stage`` 1 (offset from the iteration's gossip start) or 2.
    ``partition`` entries are ``(ranks_a, ranks_b, iteration, start,
    end)``: two disjoint rank groups whose cross links are severed for
    the sim-time window (relative to that iteration's gossip start; the
    absolute window persists across stage — and iteration — boundaries
    until it closes).  ``req_timeout`` is the base lock-request timeout,
    multiplied by ``backoff ** attempt`` on each retry.  All fault
    randomness comes from a dedicated stream keyed on ``seed`` — a run
    with an inactive spec (everything zero/empty) draws nothing from it
    and is bitwise-identical to ``fault=None``.
    """

    drop: object = 0.0
    dup: object = 0.0
    reorder: object = 0.0
    reorder_scale: float = 1.0
    pause: tuple = ()
    kill: tuple = ()
    partition: tuple = ()
    corrupt: object = 0.0
    req_timeout: float = 4.0
    backoff: float = 2.0
    seed: int = 0

    def active(self) -> bool:
        def nonzero(p):
            if callable(p):
                return True
            if isinstance(p, dict):
                return any(float(v) != 0.0 for v in p.values())
            return float(p) != 0.0
        return (nonzero(self.drop) or nonzero(self.dup)
                or nonzero(self.reorder) or nonzero(self.corrupt)
                or bool(self.pause) or bool(self.kill)
                or bool(self.partition))

    def validate(self, n_ranks: int, n_iter: int) -> None:
        for name in ("drop", "dup", "reorder", "corrupt"):
            p = getattr(self, name)
            if callable(p):
                continue
            vals = p.values() if isinstance(p, dict) else [p]
            for v in vals:
                if not 0.0 <= float(v) <= 1.0:
                    raise ValueError(f"{name} probability {v!r} not in "
                                     "[0, 1]")
        if self.reorder_scale < 0:
            raise ValueError("reorder_scale must be >= 0")
        if self.req_timeout <= 0:
            raise ValueError("req_timeout must be > 0")
        if self.backoff < 1.0:
            raise ValueError("backoff must be >= 1")
        by_rank_it: Dict[tuple, list] = {}
        for entry in self.pause:
            r, it, start, end = entry
            if not (0 <= r < n_ranks and 0 <= it < n_iter
                    and 0 <= start <= end):
                raise ValueError(f"bad pause entry {entry!r}")
            by_rank_it.setdefault((int(r), int(it)), []).append(
                (float(start), float(end), entry))
        for (r, it), wins in by_rank_it.items():
            wins.sort()
            for (s0, e0, a), (s1, e1, b) in zip(wins, wins[1:]):
                if s1 < e0:
                    raise ValueError(
                        f"pause windows {a!r} and {b!r} overlap on rank "
                        f"{r} in iteration {it}: a rank cannot be paused "
                        "twice at once — merge them into one window")
        seen_kill: Dict[int, tuple] = {}
        for entry in self.kill:
            if len(entry) == 4:
                r, it, off, stage = entry
                if stage not in (1, 2):
                    raise ValueError(
                        f"bad kill entry {entry!r}: stage must be 1 "
                        "(gossip) or 2 (lock/transfer)")
            elif len(entry) == 3:
                r, it, off = entry
            else:
                raise ValueError(
                    f"bad kill entry {entry!r}: expected (rank, iteration,"
                    " offset) or (rank, iteration, offset, stage)")
            if not (0 <= r < n_ranks and 0 <= it < n_iter and off >= 0):
                raise ValueError(f"bad kill entry {entry!r}")
            if int(r) in seen_kill:
                raise ValueError(
                    f"duplicate kill entries {seen_kill[int(r)]!r} and "
                    f"{entry!r} for rank {r}: a rank dies once — drop "
                    "the later entry")
            seen_kill[int(r)] = entry
        for entry in self.partition:
            if len(entry) != 5:
                raise ValueError(
                    f"bad partition entry {entry!r}: expected (ranks_a, "
                    "ranks_b, iteration, start, end)")
            ra, rb, it, start, end = entry
            sa = {int(x) for x in ra}
            sb = {int(x) for x in rb}
            if not sa or not sb:
                raise ValueError(f"bad partition entry {entry!r}: both "
                                 "rank groups must be non-empty")
            if sa & sb:
                raise ValueError(
                    f"bad partition entry {entry!r}: groups share ranks "
                    f"{sorted(sa & sb)} — a rank cannot sit on both "
                    "sides of a split")
            bad = [x for x in sa | sb if not 0 <= x < n_ranks]
            if bad:
                raise ValueError(
                    f"bad partition entry {entry!r}: ranks {sorted(bad)} "
                    f"out of range [0, {n_ranks})")
            if not (0 <= it < n_iter and 0 <= start <= end):
                raise ValueError(f"bad partition entry {entry!r}: need "
                                 "0 <= iteration < n_iter and "
                                 "0 <= start <= end")


@dataclasses.dataclass
class FaultStats:
    """What the injector did and how the hardened protocol absorbed it."""

    # injector side
    dropped: int = 0            # messages destroyed in flight
    duplicated: int = 0         # extra delayed copies injected
    reordered: int = 0          # messages given an extra delay
    dead_dropped: int = 0       # messages addressed to a dead rank
    paused_deferrals: int = 0   # deliveries deferred past a pause window
    killed: int = 0             # ranks killed
    partitioned_dropped: int = 0  # messages destroyed crossing a severed link
    corrupted: int = 0          # gossip payloads mutated in flight
    # protocol side (each counter is one hardening mechanism firing)
    dup_requests: int = 0       # duplicate LOCK_REQ deliveries ignored
    regrants: int = 0           # GRANT retransmitted on a duplicate REQ
    stale_grants: int = 0       # grants for aborted/consumed requests
    stale_releases: int = 0     # releases whose grant epoch already closed
    aborted_dequeues: int = 0   # timed-out requests removed from a queue
    purged_requests: int = 0    # dead ranks' requests purged/refused
    reclaimed_locks: int = 0    # lock-table entries freed at rank death
    wedged_reclaimed: int = 0   # stage-end reclaims of wedged locks
    dead_peer_skips: int = 0    # decisions/transfers skipped on dead peers
    recovered_tasks: int = 0    # tasks migrated off dead ranks at recovery
    partition_skips: int = 0    # decisions skipped on unreachable peers
    corrupt_quarantined: int = 0  # corrupted gossip payloads caught + dropped
    recovery_spills: int = 0    # stranded groups redirected off an over-cap
                                # warm-start target at recovery


class _FaultCtx:
    """Live fault-injection state threaded through one async run."""

    def __init__(self, spec: FaultSpec, n_ranks: int):
        self.spec = spec
        # dedicated stream: fault draws must never perturb the latency
        # stream, or an inactive spec would change fault-free trajectories
        self.rng = np.random.default_rng([int(spec.seed), 0xFA01])
        self.stats = FaultStats()
        self.dead: Set[int] = set()
        self.recovered: Set[int] = set()
        self.n_ranks = n_ranks
        self._pauses: Dict[int, list] = {}
        self._partitions: List[tuple] = []   # (set_a, set_b, t0, t1) absolute
        # corruption draws are gated on this flag so legacy specs (no
        # corrupt field) keep their exact fault-stream draw sequences
        c = spec.corrupt
        self.corrupt_active = bool(
            callable(c) or (isinstance(c, dict)
                            and any(float(v) != 0.0 for v in c.values()))
            or (not isinstance(c, dict) and float(c) != 0.0))

    def register_gossip(self, it: int, sim: "_Sim") -> None:
        """Anchor this iteration's partition windows and stage-1 kill
        timers at the current sim time (= this iteration's gossip
        start).  Partition windows are absolute once anchored, so a long
        window stays severed across the stage boundary and into later
        iterations until it closes."""
        t0 = sim.now
        for ra, rb, pit, start, end in self.spec.partition:
            if pit == it:
                self._partitions.append(
                    (frozenset(int(x) for x in ra),
                     frozenset(int(x) for x in rb),
                     t0 + float(start), t0 + float(end)))
        for entry in self.spec.kill:
            if len(entry) == 4 and entry[3] == 1 and entry[1] == it:
                sim.push(t0 + float(entry[2]), _MSG, FAIL,
                         int(entry[0]), int(entry[0]))

    def register_iteration(self, it: int, sim: "_Sim") -> None:
        """Anchor this iteration's pause windows and stage-2 kill timers
        at the current sim time (= this iteration's stage-2 start)."""
        t0 = sim.now
        for r, kit, start, end in self.spec.pause:
            if kit == it:
                self._pauses.setdefault(int(r), []).append(
                    (t0 + float(start), t0 + float(end)))
        for entry in self.spec.kill:
            stage = entry[3] if len(entry) == 4 else 2
            if entry[1] == it and stage == 2:
                sim.push(t0 + float(entry[2]), _MSG, FAIL,
                         int(entry[0]), int(entry[0]))

    def pause_until(self, rank: int, time: float) -> Optional[float]:
        for s, e in self._pauses.get(rank, ()):
            if s <= time < e:
                return e
        return None

    def severed(self, a: int, b: int, time: float) -> bool:
        """True while an anchored partition window separates ``a`` from
        ``b`` at ``time`` (bidirectional: group order is irrelevant)."""
        for sa, sb, s, e in self._partitions:
            if s <= time < e and ((a in sa and b in sb)
                                  or (a in sb and b in sa)):
                return True
        return False

    def unsettled(self, it: int, now: float) -> bool:
        """True while this fault spec can still perturb the run: a kill,
        pause or partition scheduled for a LATER iteration, or an
        already-anchored pause/partition window that has not closed.
        ``quiesce_after`` consults this so early termination never races
        a scheduled fault."""
        if any(entry[1] > it for entry in self.spec.kill):
            return True
        if any(entry[1] > it for entry in self.spec.pause):
            return True
        if any(entry[2] > it for entry in self.spec.partition):
            return True
        if any(e > now for _, _, _, e in self._partitions):
            return True
        return any(e > now for wins in self._pauses.values()
                   for _, e in wins)

    def maybe_corrupt(self, src: int, dst: int, data):
        """Send-side gossip corruption: with probability ``corrupt(src,
        dst)`` return a mutated COPY of the in-flight gossip tuple
        ``(root, rnd, visited, stamp, checksum, payload)`` — the shared
        payload object is never touched.  Three seeded mutation modes:
        flipped load, truncated cluster list, stale epoch stamp (the
        last keeps payload and checksum valid so the stamp check is
        load-bearing too)."""
        if self.rng.random() >= self.prob(self.spec.corrupt, src, dst):
            return data
        root, rnd, visited, stamp, chk, payload = data
        self.stats.corrupted += 1
        mode = int(self.rng.integers(3))
        s = payload[root]
        if mode == 2:
            return (root, rnd, visited, stamp - 1, chk, payload)
        if mode == 1 and s.clusters:
            bad = dataclasses.replace(
                s, clusters=s.clusters[:len(s.clusters) // 2])
        else:
            # load flip doubles as the fallback when there is nothing to
            # truncate (an emptied empty list would checksum-match)
            bad = dataclasses.replace(s, load=-(s.load + 1.0))
        return (root, rnd, visited, stamp, chk, {root: bad})

    def prob(self, p, src: int, dst: int) -> float:
        if callable(p):
            return float(p(src, dst))
        if isinstance(p, dict):
            return float(p.get((src, dst), 0.0))
        return float(p)


def make_latency(spec) -> Callable:
    """Normalize a latency spec into ``fn(rng, src, dst) -> float``.

    Accepted specs: ``None``/``0``/``"zero"`` (the serialized schedule),
    a non-negative float (constant), ``("uniform", lo, hi)``,
    ``("exp", scale)``, or a callable ``(rng, src, dst) -> float``.
    """
    if spec is None or spec == "zero":
        return lambda rng, s, d: 0.0
    if callable(spec):
        return spec
    if isinstance(spec, (int, float)):
        v = float(spec)
        if v < 0:
            raise ValueError(f"latency must be >= 0, got {v}")
        return lambda rng, s, d: v
    if isinstance(spec, (tuple, list)) and spec:
        if spec[0] == "uniform" and len(spec) == 3:
            lo, hi = float(spec[1]), float(spec[2])
            if not 0 <= lo <= hi:
                raise ValueError(f"bad uniform latency bounds: {spec!r}")
            return lambda rng, s, d: float(rng.uniform(lo, hi))
        if spec[0] == "exp" and len(spec) == 2:
            scale = float(spec[1])
            if scale < 0:
                raise ValueError(f"bad exp latency scale: {spec!r}")
            return lambda rng, s, d: float(rng.exponential(scale))
    raise ValueError(f"unknown latency spec: {spec!r}")


class _Sim:
    """The event queue + clock: per-rank mailboxes collapse into one heap
    because an entry's ``dst`` IS the mailbox.  Latencies are drawn per
    message, so messages may overtake each other both across AND within a
    link — e.g. a rank's retry LOCK_REQ to ``p`` can arrive before its
    own earlier RELEASE of ``p``, in which case the requester queues
    behind itself and is later granted via its own release; the handlers
    tolerate this, and the protocol must stay safe under any such
    interleaving (the property suite's job).  Only constant latency gives
    per-link FIFO delivery (equal delays + ``(time, class, seq)``
    tie-break in send order).

    ``fault`` (a :class:`_FaultCtx`, or None) makes the network lossy:
    sends may be dropped, duplicated or extra-delayed; pops addressed to
    a dead rank vanish, pops addressed to a paused rank are re-queued at
    the pause's end — both signalled to the caller by ``pop`` returning
    ``None`` (nothing was delivered: not counted, not traced, no handler
    runs).  ``FAIL`` events are exempt from both gates (death fires even
    while paused, and a dead rank's FAIL is handled idempotently).
    """

    def __init__(self, latency_fn, rng, max_events: int,
                 trace: Optional[list], fault: Optional[_FaultCtx] = None):
        self.heap: list = []
        self.seq = 0
        self.now = 0.0
        self.messages = 0          # delivered network messages
        self.processed = 0
        self.max_events = max_events
        self.latency = latency_fn
        self.rng = rng
        self.trace = trace
        self.fault = fault

    def push(self, time: float, klass: int, kind: int, src: int, dst: int,
             data=None) -> None:
        heapq.heappush(self.heap, (time, klass, self.seq, kind, src, dst,
                                   data))
        self.seq += 1

    def send(self, kind: int, src: int, dst: int, data=None) -> None:
        """Network send: delivery at now + one seeded latency draw.  With
        an active fault context the message additionally runs the
        drop → reorder → dup gauntlet (fixed draw order from the
        dedicated fault stream, so runs stay deterministic)."""
        delay = self.latency(self.rng, src, dst)
        f = self.fault
        if f is not None:
            sp = f.spec
            if f._partitions and f.severed(src, dst, self.now):
                f.stats.partitioned_dropped += 1
                return
            if kind == GOSSIP and f.corrupt_active and len(data) == 6:
                data = f.maybe_corrupt(src, dst, data)
            if f.rng.random() < f.prob(sp.drop, src, dst):
                f.stats.dropped += 1
                return
            extra = 0.0
            if f.rng.random() < f.prob(sp.reorder, src, dst):
                extra = float(f.rng.exponential(sp.reorder_scale))
                f.stats.reordered += 1
            if f.rng.random() < f.prob(sp.dup, src, dst):
                f.stats.duplicated += 1
                self.push(self.now + delay
                          + float(f.rng.exponential(sp.reorder_scale)),
                          _MSG, kind, src, dst, data)
        else:
            extra = 0.0
        self.push(self.now + delay + extra, _MSG, kind, src, dst, data)

    def pop(self):
        """Deliver the next event, or return ``None`` when the fault
        gates swallowed it (dead destination) or deferred it (pause)."""
        time, klass, seq, kind, src, dst, data = heapq.heappop(self.heap)
        self.now = time
        self.processed += 1
        if self.processed > self.max_events:
            raise LivelockError(self.max_events, self.processed,
                                len(self.heap), self.now)
        f = self.fault
        if f is not None and kind != FAIL:
            if dst in f.dead:
                if klass == _MSG:
                    f.stats.dead_dropped += 1
                return None
            if (klass == _MSG and f._partitions
                    and f.severed(src, dst, time)):
                # severed at delivery time too: a message in flight when
                # the window opened is cut with the link
                f.stats.partitioned_dropped += 1
                return None
            until = f.pause_until(dst, time)
            if until is not None:
                f.stats.paused_deferrals += 1
                heapq.heappush(self.heap,
                               (until, klass, seq, kind, src, dst, data))
                return None
        if klass == _MSG:
            self.messages += 1
        if self.trace is not None:
            self.trace.append((time, seq, EVENT_KINDS[kind], src, dst))
        return time, kind, src, dst, data


def _run_gossip(sim: _Sim, summaries, info, *, k_rounds: int, fanout: int,
                seed=None, root_seeds: Optional[Dict[int, list]] = None,
                deadline: Optional[float],
                dead: frozenset = frozenset(),
                stats: Optional[dict] = None,
                fault: Optional[_FaultCtx] = None, it: int = 0) -> int:
    """Stage 1a: the per-root augmented-inform epidemics as latency-
    delayed messages.

    Each live root floods exactly ``{root: summaries[root]}``, drawing
    forward targets from its PRIVATE stream keyed ``root_seeds[root]``
    (default ``gossip_root_key(seed, root)``) — the same keys, message
    set and merge/dedupe rule as the synchronous ``build_peer_networks``.
    At zero latency the heap delivers each root's messages in creation
    order, which IS that root's synchronous BFS round order; roots never
    share a stream, so however the roots' deliveries interleave, each
    root's draws and dedupe decisions — and therefore the resulting
    ``info`` maps — are identical to the sync epidemic's.  (This per-root
    independence is also what lets the quiescence path replay a quiet
    root's cached reach: see core/gossip.py.)  Nonzero latency
    permutes delivery (and therefore the forward peer picks within each
    root's stream); a ``deadline`` drops deliveries that arrive too late
    to inform this iteration's scoring — stale gossip made observable.
    ``dead`` ranks neither seed, forward, nor receive (their deliveries
    vanish at the pop gate), so no dead rank's summary ever enters a
    live work list.  Returns the number of deadline-dropped deliveries.

    Under an active ``fault`` context (``it`` is the iteration index)
    the hardened path runs: every message carries an iteration stamp, a
    :func:`~repro_torch.core.gossip.summary_checksum` and the payload
    itself
    (so in-flight corruption can mutate a copy without touching the
    shared object), receivers validate stamp + checksum before merging
    and QUARANTINE mismatches (counted, no merge, no forward — a later
    clean copy still delivers), and ``FAIL`` events may fire mid-flood:
    the killed rank joins the live ``fault.dead`` set, so subsequent
    forwards exclude it and its queued deliveries vanish at the pop
    gate, while its already-spread summary keeps flooding through live
    ranks — a dying root cannot wedge the epidemic.  Fault-free runs
    take none of these branches and stay bitwise-identical.
    """
    n = len(summaries)
    rngs: Dict[int, np.random.Generator] = {}
    payloads: Dict[int, dict] = {}
    checks: Dict[int, int] = {}
    dead_live = fault.dead if fault is not None else set(dead)
    dropped = 0
    if k_rounds >= 1:
        for r in range(n):
            if r in dead_live:
                continue
            key = (root_seeds[r] if root_seeds is not None
                   else gossip_root_key(seed, r))
            rngs[r] = np.random.default_rng(key)
            payloads[r] = {r: summaries[r]}     # shared, read-only
            if fault is not None:
                checks[r] = summary_checksum(summaries[r])
            for p in pick_peers(rngs[r], n, r, fanout,
                                visited={r} | set(dead_live)):
                data = ((r, 1, frozenset([r, int(p)])) if fault is None
                        else (r, 1, frozenset([r, int(p)]), it, checks[r],
                              payloads[r]))
                sim.send(GOSSIP, r, int(p), data)
    while sim.heap:
        ev = sim.pop()
        if ev is None:
            continue
        time, kind, src, dst, data = ev
        if kind == FAIL:
            assert fault is not None, "FAIL event without a fault context"
            d = dst
            if d in fault.dead:
                continue        # duplicate kill — already dead
            fault.dead.add(d)
            fault.stats.killed += 1
            if len(fault.dead) >= n:
                raise RankDeath("all ranks dead — no survivor set left "
                                "to balance; restart from checkpoint")
            continue
        assert kind == GOSSIP
        root, rnd, visited = data[0], data[1], data[2]
        if deadline is not None and time > deadline:
            dropped += 1                # arrived stale: no merge, no forward
            continue
        if fault is not None:
            stamp, chk, payload = data[3], data[4], data[5]
            s = payload.get(root)
            if stamp != it or s is None or summary_checksum(s) != chk:
                fault.stats.corrupt_quarantined += 1
                continue                # quarantine: no merge, no forward
        else:
            payload = payloads[root]
        if not gossip_deliver(info[dst], payload, stats):
            continue                    # dedupe: no forward
        if rnd < k_rounds:
            for p in pick_peers(rngs[root], n, dst, fanout,
                                visited=set(visited) | set(dead_live)):
                fwd = ((root, rnd + 1, frozenset(visited) | {int(p)})
                       if fault is None
                       else (root, rnd + 1, frozenset(visited) | {int(p)},
                             it, checks[root], payloads[root]))
                sim.send(GOSSIP, dst, int(p), fwd)
    return dropped


def _run_stage2(sim: _Sim, phase, state, clusters, work_lists, engine,
                locks: LockManager, stats: ProtocolStats, *,
                max_candidates: int, max_clusters_per_rank,
                max_retries: int, on_event,
                fault: Optional[_FaultCtx] = None,
                replicate: bool = False) -> None:
    """Stage 2: the lock/transfer protocol as mailbox events (see the
    module docstring for the event <-> Fig. 1 mapping, and the "Fault
    injection" section for the TIMEOUT/FAIL hardening paths — none of
    which schedules an event or draws randomness when ``fault`` is
    None, keeping fault-free runs bitwise-identical)."""
    n = phase.num_ranks
    f = fault
    # open_req[r] = (req_id, diff, p): the single in-flight lock request
    # of rank r (a rank never has two — DECIDEs are only scheduled when
    # the slot clears)
    open_req: List[Optional[Tuple[int, float, int]]] = [None] * n
    retries: List[Dict[int, int]] = [dict() for _ in range(n)]
    req_ids = itertools.count()     # grant tokens, unique per stage
    # per-target sets of request tokens already seen (duplicate-REQ
    # idempotence; only consulted under an active fault)
    seen_req: List[Set[int]] = [set() for _ in range(n)]
    spins = 0
    max_spins = 50 * n + 1000    # mirrors the sync driver's turn cap

    for r in range(n):
        if work_lists[r] and (f is None or r not in f.dead):
            sim.push(sim.now, _LOCAL, DECIDE, r, r)

    while sim.heap:
        ev = sim.pop()
        if ev is None:
            continue
        time, kind, src, dst, data = ev
        if kind == DECIDE:
            r = dst
            if f is None:
                assert open_req[r] is None, \
                    f"rank {r} decided while awaiting a grant"
            elif open_req[r] is not None:
                # a deferred DECIDE can land after a retry re-opened a
                # request; deciding is idempotent — skip
                continue
            if spins >= max_spins or not work_lists[r]:
                continue
            spins += 1
            diff, p = work_lists[r].popleft()
            if f is not None and p in f.dead:
                f.stats.dead_peer_skips += 1
                if work_lists[r]:
                    sim.push(sim.now, _LOCAL, DECIDE, r, r)
                continue
            if (f is not None and f._partitions
                    and f.severed(r, p, sim.now)):
                # partition-aware timeout accounting: the REQ would be
                # destroyed on the severed link and the rank would idle a
                # full req_timeout before retrying — skip the doomed send
                # outright so the island keeps making local progress.
                # Bounded by the same per-(rank, peer) retry budget as
                # yields; the item re-queues at the back, so reachable
                # intra-island peers are tried first.
                f.stats.partition_skips += 1
                cnt = retries[r].get(p, 0)
                if cnt < max_retries:
                    retries[r][p] = cnt + 1
                    work_lists[r].append((diff, p))
                else:
                    stats.retries_exhausted += 1
                if work_lists[r]:
                    sim.push(sim.now, _LOCAL, DECIDE, r, r)
                continue
            rid = next(req_ids)
            open_req[r] = (rid, diff, p)
            sim.send(LOCK_REQ, r, p, rid)
            if f is not None:
                # the request might never be answered on a lossy network;
                # arm the abort timer (exponential backoff per retry)
                wait = (f.spec.req_timeout
                        * f.spec.backoff ** retries[r].get(p, 0))
                sim.push(sim.now + wait, _LOCAL, TIMEOUT, r, r,
                         (rid, diff, p))
        elif kind == LOCK_REQ:
            r, p = src, dst
            rid = data
            if f is not None:
                if r in f.dead:
                    # sent before the requester died — a dead rank must
                    # never be granted a lock
                    f.stats.purged_requests += 1
                    continue
                if rid in seen_req[p]:
                    f.stats.dup_requests += 1
                    if locks.holds_grant(r, p, rid):
                        # the original GRANT may have been dropped —
                        # retransmit (idempotent at the requester)
                        f.stats.regrants += 1
                        sim.send(GRANT, p, r, rid)
                    continue
                seen_req[p].add(rid)
            if lock_request(locks, stats, r, p, rid):
                sim.send(GRANT, p, r, rid)
            # else: queued FIFO at p — the grant arrives on a release
        elif kind == GRANT:
            p, r = src, dst
            rid = data
            if f is None:
                assert open_req[r] is not None, \
                    f"rank {r} granted without an open request"
            elif open_req[r] is None or open_req[r][0] != rid:
                # the request was aborted by its timeout, or this is a
                # duplicate of an already-consumed grant — hand the lock
                # straight back (token-checked no-op if it, too, is stale)
                f.stats.stale_grants += 1
                sim.send(RELEASE, r, p, rid)
                continue
            rid2, diff, p_req = open_req[r]
            open_req[r] = None
            assert p_req == p and rid2 == rid
            if f is not None and p in f.dead:
                # target died after granting; its lock table died with it
                # — nothing to use, nothing to release
                f.stats.dead_peer_skips += 1
                if work_lists[r]:
                    sim.push(sim.now, _LOCAL, DECIDE, r, r)
                continue
            if locks.must_yield(r, p):
                # Fig. 1 line 45: release unused, retry later (bounded —
                # unlike the sync driver's unbounded re-queue, so a yield
                # storm cannot stall termination)
                note_yield(stats)
                cnt = retries[r].get(p, 0)
                if cnt < max_retries:
                    retries[r][p] = cnt + 1
                    work_lists[r].append((diff, p))
                else:
                    stats.retries_exhausted += 1
            else:
                # mutation under mutual exclusion: r must hold p's lock
                # under exactly this grant token for the whole
                # (instantaneous) evaluation
                assert locks.holds_grant(r, p, rid)
                execute_transfer(state, clusters, engine, stats, r, p,
                                 max_candidates, max_clusters_per_rank,
                                 replicate=replicate)
            sim.send(RELEASE, r, p, rid)
            if work_lists[r]:
                sim.push(sim.now, _LOCAL, DECIDE, r, r)
        elif kind == RELEASE:
            r, p = src, dst
            rid = data
            if f is None:
                nxt = lock_release(locks, stats, r, p)
                if nxt is not None:
                    sim.send(GRANT, p, nxt, locks.grant_id[p])
            elif locks.holds_grant(r, p, rid):
                nxt = lock_release(locks, stats, r, p)
                while nxt is not None and nxt in f.dead:
                    # defensive: dead requesters are purged at death and
                    # their late REQs refused, so the queue should never
                    # surface one — but never hand a dead rank a lock
                    f.stats.purged_requests += 1
                    nxt = lock_release(locks, stats, nxt, p)
                if nxt is not None:
                    sim.send(GRANT, p, nxt, locks.grant_id[p])
            elif locks.dequeue(r, p, rid):
                # a timed-out request aborted while still queued
                f.stats.aborted_dequeues += 1
            else:
                # duplicate of a consumed release, or abort of a REQ
                # that never arrived — token mismatch makes it a no-op
                f.stats.stale_releases += 1
        elif kind == TIMEOUT:
            r = dst
            rid, diff, p = data
            if open_req[r] is None or open_req[r][0] != rid:
                continue        # answered (or aborted) before the timer
            stats.timeouts += 1
            open_req[r] = None
            # abort: frees the grant if it was granted (GRANT lost),
            # dequeues if still queued, no-ops if the REQ itself was lost
            sim.send(RELEASE, r, p, rid)
            cnt = retries[r].get(p, 0)
            if cnt < max_retries:
                retries[r][p] = cnt + 1
                work_lists[r].append((diff, p))
            else:
                stats.retries_exhausted += 1
            if work_lists[r]:
                sim.push(sim.now, _LOCAL, DECIDE, r, r)
        elif kind == FAIL:
            assert f is not None, "FAIL event without a fault context"
            d = dst
            if d in f.dead:
                continue        # duplicate kill entry — already dead
            f.dead.add(d)
            f.stats.killed += 1
            # a dead rank must never be granted a lock it can't release
            f.stats.purged_requests += locks.purge_requester(d)
            # locks d held on others would wedge them forever — force-
            # release, handing each to its next live queued requester
            for t in locks.held_by(d):
                nxt = lock_release(locks, stats, d, t)
                while nxt is not None and nxt in f.dead:
                    f.stats.purged_requests += 1
                    nxt = lock_release(locks, stats, nxt, t)
                if nxt is not None:
                    sim.send(GRANT, t, nxt, locks.grant_id[t])
            # d's own lock table (holder of record, queue) dies with it
            f.stats.reclaimed_locks += locks.reclaim(d)
            open_req[d] = None
            work_lists[d].clear()
            if len(f.dead) >= n:
                raise RankDeath("all ranks dead — no survivor set left "
                                "to balance; restart from checkpoint")
        else:  # pragma: no cover - defensive
            raise AssertionError(f"unknown event kind {kind}")
        if on_event is not None:
            on_event(time, kind, src, dst, locks, state)

    # liveness at termination: every request answered, every lock released
    if f is None:
        assert not any(o is not None for o in open_req), \
            "rank still awaiting a grant at termination"
        assert locks.quiescent(), "locks/queues not drained at termination"
    else:
        # an open request always keeps a TIMEOUT queued, so an empty heap
        # proves no live rank is still waiting...
        assert all(o is None for o in open_req), \
            "open request at stage end despite timeout timers"
        # ...which makes anything still held or queued a wedge left by a
        # dropped RELEASE (or an un-dequeued abort) — reclaim at the
        # barrier, where no requester can race us
        for t in range(n):
            if locks.locked_by[t] is not None or locks.queue[t]:
                f.stats.wedged_reclaimed += locks.reclaim(t)
        assert locks.quiescent(), \
            "locks/queues not drained after stage-end reclamation"


def _mem_after_add(state: CCMState, tasks: np.ndarray, r: int) -> float:
    """M_max(r) (eq. 7) after hypothetically adding ``tasks`` to rank r.

    Pure read — mirrors the accounting ``apply_transfer`` maintains
    incrementally (task-memory sum, running overhead max, shared bytes of
    blocks the rank does not already hold) without mutating the state, so
    recovery can test a placement before committing it.
    """
    ph = state.phase
    add_mem = float(ph.task_mem[tasks].sum())
    over = float(state.mem_overhead_max[r])
    if tasks.size:
        over = max(over, float(ph.task_overhead[tasks].max()))
    blocks = ph.task_block[tasks]
    blocks = np.unique(blocks[blocks >= 0])
    new_blocks = blocks[state.block_count[r, blocks] == 0]
    shared = float(state.shared_cache[r]) + float(
        ph.block_size[new_blocks].sum())
    return (float(ph.rank_mem_base[r]) + float(state.mem_task[r])
            + add_mem + over + shared)


def _recover_survivors(phase, state: CCMState, f: _FaultCtx,
                       recovery_log: list) -> None:
    """Post-crash warm start of the survivor set (elastic resize framing).

    The survivor set is renumbered contiguously (``survivor_resize``),
    the current assignment is mapped through it — dead ranks land OUT of
    the survivor range — and ``warm_start_assignment`` re-places exactly
    the stranded tasks via its rank clipping while every surviving task
    keeps its rank.  Migrations are applied through
    ``state.apply_transfer`` in the ORIGINAL rank numbering, so they flow
    through the transfer listener like protocol transfers and the
    transfer-log replay invariant keeps covering crash recovery.

    Under an active memory constraint each stranded group's warm-start
    target is checked against its (headroom-scaled) cap BEFORE the
    transfer commits; an over-cap target spills the group to the
    least-loaded survivor with room (ties broken by rank id, counted in
    ``FaultStats.recovery_spills``), and if no survivor has room the
    recovery raises :class:`RecoveryOOMError` instead of silently
    landing tasks over the cap.  With the constraint off, or when every
    warm-start target fits, the migration sequence is bitwise-identical
    to the unchecked path.
    """
    newly = sorted(f.dead - f.recovered)
    if not newly:
        return
    rs = survivor_resize(phase.num_ranks, f.dead)
    o2n = rs.old_to_new
    # the restricted phase only needs valid rank-indexed arrays; only the
    # round_robin fallback below ever reads it, and that reads none of
    # the block/comm structure
    bh = (np.minimum(o2n[phase.block_home], rs.n_new - 1)
          if phase.num_blocks > 0 else phase.block_home)
    surv_phase = Phase(
        task_load=phase.task_load, task_mem=phase.task_mem,
        task_overhead=phase.task_overhead, task_block=phase.task_block,
        block_size=phase.block_size, block_home=bh,
        comm_src=phase.comm_src, comm_dst=phase.comm_dst,
        comm_vol=phase.comm_vol,
        rank_mem_base=phase.rank_mem_base[rs.survivors],
        rank_mem_cap=phase.rank_mem_cap[rs.survivors],
        rank_speed=phase.rank_speed[rs.survivors])
    prev = o2n[state.assignment]            # dead ranks -> out of range
    warm, _ = warm_start_assignment(phase, prev, surv_phase,
                                    mode="round_robin")
    target = rs.survivors[warm]             # back to original numbering
    p = state.params
    for d in newly:
        stranded = np.nonzero(state.assignment == d)[0]
        for s in np.unique(target[stranded]):
            tasks = stranded[target[stranded] == s]
            dest = int(s)
            if p.memory_constraint:
                caps = effective_mem_cap(phase.rank_mem_cap, p)
                if _mem_after_add(state, tasks, dest) > caps[dest]:
                    # over-cap warm-start target: spill to the least-
                    # loaded survivor with room (the checks run against
                    # the live state, so earlier recovery transfers in
                    # this same pass are already accounted for)
                    spill_to = None
                    best_over = float("inf")
                    for _, c in sorted((float(state.load[c]), int(c))
                                       for c in rs.survivors):
                        m = _mem_after_add(state, tasks, c)
                        if m <= caps[c]:
                            spill_to = c
                            break
                        best_over = min(best_over, m - caps[c])
                    if spill_to is None:
                        raise RecoveryOOMError(tasks, d, best_over)
                    dest = spill_to
                    f.stats.recovery_spills += 1
            state.apply_transfer(tasks, d, dest)
            recovery_log.append((tuple(int(x) for x in tasks), d, dest))
            f.stats.recovered_tasks += int(tasks.size)
    f.recovered |= set(newly)


def ccm_lb_async(phase: Phase, assignment: np.ndarray, params: CCMParams, *,
                 n_iter: int = 4, k_rounds: int = 2, fanout: int = 4,
                 seed: int = 0, latency=0.0,
                 gossip_timeout: Optional[float] = None,
                 max_retries: int = 4, max_candidates: int = 12,
                 max_clusters_per_rank: Optional[int] = None,
                 use_engine: bool = True, device=None,
                 dtype: torch.dtype = torch.float64,
                 incremental: bool = True,
                 collect_trace: bool = False,
                 max_events: Optional[int] = None,
                 on_event=None,
                 fault: Optional[FaultSpec] = None,
                 membership: tuple = (),
                 quiesce_after: Optional[int] = None,
                 profile: bool = False,
                 replicate: bool = False) -> CCMLBResult:
    """CCM-LB through the asynchronous event-loop driver.

    Same optimization knobs as :func:`repro_torch.core.ccmlb.ccm_lb`
    (engine / device / dtype / incremental), plus the simulation
    knobs:

    ``latency``         message-latency spec (see :func:`make_latency`).
                        The default ``0.0`` is the serialized schedule —
                        bitwise-identical trajectories to ``ccm_lb``.
    ``gossip_timeout``  per-iteration gossip deadline in sim-time units;
                        deliveries past it are dropped (stale).  ``None``
                        drains the epidemic fully.
    ``max_retries``     per-(rank, peer) bound on yield/timeout re-queues;
                        items dropped at the cap are counted in
                        ``retries_exhausted``.
    ``collect_trace``   record the ``(time, seq, kind, src, dst)`` event
                        trace into ``CCMLBResult.events``.
    ``on_event``        optional hook ``(time, kind, src, dst, locks,
                        state)`` called after every stage-2 event — the
                        protocol-safety suite's invariant probe.
    ``fault``           a :class:`FaultSpec` degrading the network and
                        the ranks (module docstring, "Fault injection").
                        ``None`` or an inactive spec is bitwise-identical
                        to the fault-free driver.  Killing every rank
                        raises
                        :class:`repro_torch.runtime.fault.RankDeath`;
                        exceeding the event budget raises
                        :class:`LivelockError` carrying partial stats.
    ``membership``      :class:`~repro_torch.runtime.elastic.RankJoin`
                        events
                        (or plain ``(iteration, count)`` tuples): fresh
                        ranks join the mesh at the start of the named
                        iteration.  The phase is expanded in place
                        (median-default capacities, rank-independent CSR
                        carried over), the state/engine/tracker are
                        re-grown on the wider rank set, and the joiners
                        inherit gossip state through their first
                        iteration's epidemic and attract transfers as
                        ordinary underloaded ranks.  Joined rank ids land
                        in ``CCMLBResult.joined_ranks``; ``CCMLBResult.
                        state.phase`` is the final (expanded) phase.
    ``quiesce_after``   stop after this many consecutive zero-transfer
                        iterations (same early-termination knob as the
                        sync driver; ``None`` runs all ``n_iter``).  The
                        quiet counter only advances while no fault
                        window is open and no kill/join is still
                        scheduled, so early exit never races a pending
                        perturbation.
    ``profile``         record per-iteration host-side stage timings into
                        ``CCMLBResult.stage_timings`` (stage-2 scoring
                        and commit time accumulate under "score" /
                        "commit" as grants execute).
    ``replicate``       enable the memory-pressure move vocabulary
                        (block replication splits and de-replication
                        consolidations) in every grant's exchange search
                        — same semantics as the sync driver's knob (see
                        :func:`repro_torch.core.ccmlb.ccm_lb`).  Extra
                        candidates only win on strictly better eq. 4
                        scores, so runs where they never win are
                        bitwise-identical to ``replicate=False``.

    The same :class:`~repro_torch.core.quiesce.QuiesceTracker` that
    amortizes
    the sync driver runs here too: summaries are patched for dirty ranks
    only (``incremental=True``), per-root gossip streams are keyed by the
    tracker's epochs, and failed exact evaluations are memoized against
    the state version.  Work lists are always rebuilt in full — the async
    info maps are latency-dependent, so the sync driver's cached-list
    replay does not apply.

    Iterations stay globally synchronized (the paper's outer loop);
    asynchrony lives inside each iteration's gossip and lock/transfer
    stages.  ``CCMLBResult.lock_conflicts`` / ``yields`` /
    ``grant_chains`` / ``max_grant_chain`` are meaningful here, and
    ``transfer_log`` replays onto the initial assignment to the returned
    one exactly — crash-recovery migrations included (they are also
    listed separately in ``recovery_log``).
    """
    if quiesce_after is not None and quiesce_after < 1:
        raise ValueError("quiesce_after must be >= 1 (or None)")
    joins: List[RankJoin] = [
        j if isinstance(j, RankJoin) else RankJoin(*j) for j in membership]
    for j in joins:
        if not 0 <= j.iteration < n_iter:
            raise ValueError(f"membership event {j!r}: iteration out of "
                             f"range [0, {n_iter})")
    f: Optional[_FaultCtx] = None
    if fault is not None and fault.active():
        # fault entries address the INITIAL rank set; ranks that only
        # exist after a membership join cannot be named in a FaultSpec
        fault.validate(phase.num_ranks, n_iter)
        f = _FaultCtx(fault, phase.num_ranks)
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
    recovery_log: list = []

    def _log_transfer(t, a, b):
        transfer_log.append((tuple(int(x) for x in t), int(a), int(b)))

    state.add_transfer_listener(_log_transfer)
    state.add_transfer_listener(tracker.note_transfer)
    joined_ranks: List[int] = []

    latency_fn = make_latency(latency)
    rng_lat = np.random.default_rng([seed, 0x51D])   # latency-draw stream
    if max_events is None:
        # DECIDEs are spin-capped, each spawns <= 3 protocol messages;
        # each of the n per-root epidemics delivers <= fanout messages per
        # reached rank per round, geometric in fanout over k_rounds;
        # x8 headroom
        max_events = 8 * n_iter * (
            4 * (50 * phase.num_ranks + 1000)
            + phase.num_ranks * (1 + max(fanout, 1))
            * max(fanout, 1) ** max(k_rounds, 1))
        if f is not None:
            # timeout aborts, retries, duplicates and pause re-deliveries
            # legitimately need more than the polite-network budget
            max_events *= 4
    trace: Optional[list] = [] if collect_trace else None
    sim = _Sim(latency_fn, rng_lat, max_events, trace, fault=f)
    stats = ProtocolStats()
    stats.memo = tracker.memo if tracker.caching else None
    gossip_dropped = 0
    iter_transfers: List[int] = []
    stage_timings: List[dict] = []
    quiet = 0

    trace_max = [state.max_work()]
    trace_tot = [state.total_work()]
    trace_imb = [state.imbalance()]

    it = 0
    try:
        for it in range(n_iter):
            joins_now = [j for j in joins if j.iteration == it]
            if joins_now:
                old_n = phase.num_ranks
                for j in joins_now:
                    phase = expand_phase(phase, j.count,
                                         mem_base=j.mem_base,
                                         mem_cap=j.mem_cap, speed=j.speed)
                joined_ranks.extend(range(old_n, phase.num_ranks))
                # rebuild on the wider rank set; the CSR bundle is rank-
                # independent so it carries over, and the assignment is
                # already valid (joiners start empty by construction)
                state = CCMState.build(phase, state.assignment, params,
                                       csr=state.csr)
                engine = (PhaseEngine(state, device=device, dtype=dtype,
                                      incremental=incremental)
                          if use_engine else None)
                state.add_transfer_listener(_log_transfer)
                tracker.regrow(state, engine)
                state.add_transfer_listener(tracker.note_transfer)
            tm = None
            if profile:
                tm = {"clusters": 0.0, "gossip": 0.0, "work_lists": 0.0,
                      "score": 0.0, "commit": 0.0}
                stats.timings = tm
            tracker.begin_iteration(it)
            t0 = perf_counter() if profile else 0.0
            clusters, summaries = tracker.update_summaries()
            if profile:
                tm["clusters"] = perf_counter() - t0
                t0 = perf_counter()
            info = {r: {r: summaries[r]} for r in range(phase.num_ranks)}
            deadline = (None if gossip_timeout is None
                        else sim.now + gossip_timeout)
            if f is not None:
                f.register_gossip(it, sim)
            dead_now = frozenset(f.dead) if f is not None else frozenset()
            gossip_dropped += _run_gossip(
                sim, summaries, info, k_rounds=k_rounds, fanout=fanout,
                root_seeds={r: tracker.root_key(r)
                            for r in range(phase.num_ranks)},
                deadline=deadline, dead=dead_now, stats=tracker.counters,
                fault=f, it=it)
            if profile:
                tm["gossip"] = perf_counter() - t0
                t0 = perf_counter()
            work_lists = build_work_lists(phase, summaries, info, params,
                                          engine)
            if profile:
                tm["work_lists"] = perf_counter() - t0
            locks = LockManager(phase.num_ranks)
            if f is not None:
                f.register_iteration(it, sim)
            before = stats.transfers
            _run_stage2(sim, phase, state, clusters, work_lists, engine,
                        locks, stats, max_candidates=max_candidates,
                        max_clusters_per_rank=max_clusters_per_rank,
                        max_retries=max_retries, on_event=on_event,
                        fault=f, replicate=replicate)
            if f is not None and f.dead - f.recovered:
                newly_dead = sorted(f.dead - f.recovered)
                _recover_survivors(phase, state, f, recovery_log)
                # evict the dead ranks from every tracker cache family
                # and force-dirty everything that knew them, so the
                # epoch-keyed replay never serves their stale state and
                # quiescence stays absorbing
                tracker.purge_ranks(newly_dead)
            iter_transfers.append(stats.transfers - before)
            tracker.end_iteration()
            if profile:
                stage_timings.append(tm)

            trace_max.append(state.max_work())
            trace_tot.append(state.total_work())
            trace_imb.append(state.imbalance())
            if quiesce_after is not None:
                settled = ((f is None or not f.unsettled(it, sim.now))
                           and not any(j.iteration > it for j in joins))
                quiet = quiet + 1 if (iter_transfers[-1] == 0
                                      and settled) else 0
                if quiet >= quiesce_after:
                    break
    except LivelockError as e:
        # attach the partial accounting so sweeps can report WHY
        e.stats = stats
        e.fault_stats = f.stats if f is not None else None
        e.iteration = it
        raise
    finally:
        state.remove_transfer_listener(tracker.note_transfer)

    return CCMLBResult(state.assignment.copy(), state, trace_max, trace_tot,
                       trace_imb, stats.transfers, stats.conflicts,
                       engine_used=engine is not None, yields=stats.yields,
                       grant_chains=stats.grant_chains,
                       max_grant_chain=stats.max_grant_chain,
                       messages=sim.messages, sim_time=sim.now,
                       gossip_dropped=gossip_dropped, events=trace,
                       transfer_log=transfer_log,
                       timeouts=stats.timeouts,
                       retries_exhausted=stats.retries_exhausted,
                       fault_stats=f.stats if f is not None else None,
                       recovery_log=(recovery_log if f is not None
                                     else None),
                       dead_ranks=(sorted(f.dead) if f is not None
                                   else None),
                       joined_ranks=joined_ranks if joins else None,
                       iter_transfers=iter_transfers,
                       stage_timings=stage_timings if profile else None,
                       quiesce_counters=tracker.iter_counters,
                       memo_hits=stats.memo_hits,
                       gossip_noop_merges=tracker.counters.get(
                           "gossip_noop_merges", 0),
                       tracker=tracker)


def run_ccm_lb(phase, a0, params, *, async_mode: bool = False, latency=0.0,
               gossip_timeout=None, batch_lock_events: int = 1,
               spec_window: int = 1, spec_mode: str = "scan",
               fault: Optional[FaultSpec] = None,
               membership: tuple = (), **kw) -> CCMLBResult:
    """Dispatch one balancing run to the synchronous driver or — with
    ``async_mode=True`` — to this module's event-loop simulator, which
    models message latency and makes the §IV-B conflict/yield/chain
    counters on the returned ``CCMLBResult`` meaningful.  Used by the
    ``balance`` planners to expose the async knobs uniformly.
    ``batch_lock_events`` and ``spec_window`` are synchronous-driver knobs
    (the async turn order depends on grant interleavings, so neither the
    deferred disjoint-event batching nor the speculative scan — whose
    event sequence must be derivable up front — applies there); conversely
    ``latency`` / ``gossip_timeout`` / ``fault`` only exist under
    ``async_mode=True`` — either inconsistency raises instead of silently
    dropping the knob."""
    if not async_mode:
        if not (latency is None or latency == 0.0 or latency == "zero"):
            raise ValueError("latency is an async-driver knob; pass "
                             "async_mode=True to simulate message latency")
        if gossip_timeout is not None:
            raise ValueError("gossip_timeout is an async-driver knob; pass "
                             "async_mode=True")
        if fault is not None:
            raise ValueError("fault is an async-driver knob (the sync "
                             "round-robin loop has no network to degrade); "
                             "pass async_mode=True")
        if membership:
            raise ValueError("membership is an async-driver knob (mid-run "
                             "joins need the event loop; for inter-phase "
                             "joins use ccm_lb_pipeline(membership=...)); "
                             "pass async_mode=True")
        return ccm_lb(phase, a0, params, batch_lock_events=batch_lock_events,
                      spec_window=spec_window, spec_mode=spec_mode, **kw)
    if batch_lock_events != 1:
        raise ValueError("batch_lock_events is a synchronous-driver knob; "
                         "unsupported with async_mode=True")
    if spec_window != 1:
        raise ValueError("spec_window is a synchronous-driver knob (the "
                         "async event sequence is not derivable up front); "
                         "unsupported with async_mode=True")
    return ccm_lb_async(phase, a0, params, latency=latency,
                        gossip_timeout=gossip_timeout, fault=fault,
                        membership=membership, **kw)
