"""Fault tolerance: restart-from-checkpoint loop + deterministic fault
injection for tests.

``run_with_restarts`` wraps a training driver whose contract is: it restores
from the latest checkpoint on entry and raises on (injected or real) node
failure.  The loop restarts it up to ``max_restarts`` times; because the
data pipeline is a pure function of (seed, step) and checkpoints are atomic,
a restarted run is bit-identical to an uninterrupted one from the restored
step.  The port's copy of ``repro/runtime/fault.py`` (pure Python).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


class NodeFailure(RuntimeError):
    pass


class RankDeath(NodeFailure):
    """A balancer rank (or the whole survivor set) died mid-run.

    Raised by the async fault harness (core/async_sim.py) when a
    ``FaultSpec.kill`` leaves no live rank to continue on — the balancer
    cannot recover in-process and the caller's restart loop
    (:func:`run_with_restarts`) is the right layer to handle it, which is
    why this subclasses :class:`NodeFailure`: existing restart policies
    apply unchanged."""


@dataclasses.dataclass
class FaultInjector:
    """Deterministically raise NodeFailure at the given global steps."""

    fail_at_steps: tuple = ()
    _raised: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at_steps and step not in self._raised:
            self._raised.add(step)
            raise NodeFailure(f"injected node failure at step {step}")


@dataclasses.dataclass
class RestartStats:
    restarts: int
    wall_s: float
    completed: bool


def run_with_restarts(train_once: Callable[[], None], *,
                      max_restarts: int = 5,
                      backoff_s: float = 0.0) -> RestartStats:
    t0 = time.time()
    restarts = 0
    while True:
        try:
            train_once()
            return RestartStats(restarts, time.time() - t0, True)
        except NodeFailure:
            restarts += 1
            if restarts > max_restarts:
                return RestartStats(restarts, time.time() - t0, False)
            if backoff_s:
                time.sleep(backoff_s)
