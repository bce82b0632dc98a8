"""Deadlock-free lock protocol (paper §IV-B, Fig. 1 lines 42–49).

Semantics simulated faithfully:
  * each rank may be locked by at most one other rank; requests queue FIFO;
  * a rank may hold a lock while being locked itself (that is the deadlock
    setup) — cycles are broken by the priority rule: if rank r, locked by
    r_x, obtains a lock on r_2 and r_x <= r_2, r immediately releases r_2 and
    re-queues the attempt for later.

The port's copy of ``repro/core/locks.py`` without the grant tokens and
the fault-tolerant surface, which only the JAX package's async driver
uses (the synchronous driver never passes a token).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Optional


@dataclasses.dataclass
class LockManager:
    n_ranks: int

    def __post_init__(self):
        self.locked_by: Dict[int, Optional[int]] = {
            r: None for r in range(self.n_ranks)}
        # FIFO of requesters per target
        self.queue: Dict[int, Deque[int]] = {
            r: deque() for r in range(self.n_ranks)}

    def request(self, requester: int, target: int) -> bool:
        """Returns True if the lock is granted immediately; else queues."""
        if self.locked_by[target] is None:
            self.locked_by[target] = requester
            return True
        self.queue[target].append(requester)
        return False

    def release(self, holder: int, target: int) -> Optional[int]:
        """Release target; grant to next queued requester (returned)."""
        if self.locked_by[target] != holder:
            raise RuntimeError(f"rank {holder} released {target}, which is "
                               f"held by {self.locked_by[target]}")
        self.locked_by[target] = None
        if self.queue[target]:
            nxt = self.queue[target].popleft()
            self.locked_by[target] = nxt
            return nxt
        return None

    def must_yield(self, holder: int, held: int) -> bool:
        """Fig. 1 line 45: holder is locked by r_x and r_x <= held."""
        r_x = self.locked_by[holder]
        return r_x is not None and r_x <= held
