"""Deadlock-free lock protocol (paper §IV-B, Fig. 1 lines 42–49).

Semantics simulated faithfully:
  * each rank may be locked by at most one other rank; requests queue FIFO;
  * a rank may hold a lock while being locked itself (that is the deadlock
    setup) — cycles are broken by the priority rule: if rank r, locked by
    r_x, obtains a lock on r_2 and r_x <= r_2, r immediately releases r_2 and
    re-queues the attempt for later.

Grant tokens: every request may carry a ``req_id`` — a unique token minted
by the requester.  The token travels REQ -> GRANT -> RELEASE, and the
fault-tolerant surface below (:meth:`holds_grant` / :meth:`dequeue` /
:meth:`purge_requester` / :meth:`reclaim`) uses it to make the handlers
idempotent on a lossy, duplicating network: a RELEASE only frees the lock
whose exact grant it closes (a stale or duplicated RELEASE for an older
grant epoch is a no-op even when the same pair re-locked in between), a
timed-out queued request can be surgically dequeued, and a dead rank's
lock state can be reclaimed wholesale.  The synchronous driver and the
fault-free async driver pass ``req_id=None`` everywhere and never touch
the fault surface — their behavior is exactly the pre-token protocol.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Optional, Tuple


@dataclasses.dataclass
class LockManager:
    n_ranks: int

    def __post_init__(self):
        self.locked_by: Dict[int, Optional[int]] = {
            r: None for r in range(self.n_ranks)}
        # FIFO of (requester, req_id) pairs per target
        self.queue: Dict[int, Deque[Tuple[int, Optional[int]]]] = {
            r: deque() for r in range(self.n_ranks)}
        # token of the grant currently held on each target (None when free
        # or when the grant was token-less)
        self.grant_id: Dict[int, Optional[int]] = {
            r: None for r in range(self.n_ranks)}

    def request(self, requester: int, target: int,
                req_id: Optional[int] = None) -> bool:
        """Returns True if the lock is granted immediately; else queues."""
        if self.locked_by[target] is None:
            self.locked_by[target] = requester
            self.grant_id[target] = req_id
            return True
        self.queue[target].append((requester, req_id))
        return False

    def release(self, holder: int, target: int) -> Optional[int]:
        """Release target; grant to next queued requester (returned)."""
        if self.locked_by[target] != holder:
            raise RuntimeError(f"rank {holder} released {target}, which is "
                               f"held by {self.locked_by[target]}")
        self.locked_by[target] = None
        self.grant_id[target] = None
        if self.queue[target]:
            nxt, rid = self.queue[target].popleft()
            self.locked_by[target] = nxt
            self.grant_id[target] = rid
            return nxt
        return None

    def must_yield(self, holder: int, held: int) -> bool:
        """Fig. 1 line 45: holder is locked by r_x and r_x <= held."""
        r_x = self.locked_by[holder]
        return r_x is not None and r_x <= held

    def held_by(self, holder: int) -> list:
        """Targets currently locked by ``holder``.  The async protocol
        suite asserts through this after every event that a rank holds at
        most one lock net of in-flight releases (a rank only ever has one
        outstanding request; a released target keeps the old holder of
        record until the RELEASE message lands)."""
        return [t for t, h in self.locked_by.items() if h == holder]

    def quiescent(self) -> bool:
        """No lock held and no request queued — the stage-end liveness
        condition both drivers must reach (asserted by the async driver
        at every stage-2 termination)."""
        return (all(h is None for h in self.locked_by.values())
                and all(not q for q in self.queue.values()))

    # -------------------------------------------------- fault-tolerant surface
    # Used only by the async driver under an active FaultSpec
    # (core/async_sim.py); no synchronous code path reaches these.

    def holds_grant(self, holder: int, target: int,
                    req_id: Optional[int]) -> bool:
        """True iff ``holder`` holds ``target``'s lock under exactly this
        grant token — the idempotence predicate for RELEASE handling (a
        duplicated RELEASE whose grant epoch already closed must not free
        a newer lock, even between the same pair of ranks)."""
        return (self.locked_by[target] == holder
                and self.grant_id[target] == req_id)

    def dequeue(self, requester: int, target: int,
                req_id: Optional[int]) -> bool:
        """Remove one queued ``(requester, req_id)`` entry — a timed-out
        request's abort.  Returns True iff an entry was removed (False
        means the request was never delivered, already granted, or
        already dequeued — all no-ops by design)."""
        q = self.queue[target]
        for i, (r, rid) in enumerate(q):
            if r == requester and rid == req_id:
                del q[i]
                return True
        return False

    def purge_requester(self, requester: int) -> int:
        """Drop every queued request BY ``requester`` (rank death: a dead
        rank must never be granted a lock).  Returns the number removed."""
        removed = 0
        for t in range(self.n_ranks):
            q = self.queue[t]
            if any(r == requester for r, _ in q):
                kept = [(r, rid) for r, rid in q if r != requester]
                removed += len(q) - len(kept)
                q.clear()
                q.extend(kept)
        return removed

    def reclaim(self, target: int) -> int:
        """Forget all lock state ON ``target``: holder of record, grant
        token, queued requests.  Used when ``target`` dies (its lock table
        dies with it) and at the stage-end barrier to clear locks wedged
        by dropped RELEASE messages.  Returns the number of discarded
        entries (held lock + queue length)."""
        cleared = ((1 if self.locked_by[target] is not None else 0)
                   + len(self.queue[target]))
        self.locked_by[target] = None
        self.grant_id[target] = None
        self.queue[target].clear()
        return cleared
