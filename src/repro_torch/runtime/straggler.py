"""Straggler detection: EWMA of per-rank (per-host) step times -> relative
speed factors consumed by the CCM model (task_load / rank_speed), so both
CCM-LB applications (expert placement, sequence packing) shift work away
from slow hosts rather than just balancing nominal load.  The port's copy
of ``repro/runtime/straggler.py`` (numpy).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StragglerTracker:
    n_ranks: int
    alpha: float = 0.2           # EWMA weight of the newest sample
    floor: float = 0.25          # clamp: never assume a rank slower than 4x

    def __post_init__(self):
        self.ewma = np.zeros(self.n_ranks)
        self.count = 0

    def update(self, step_times: np.ndarray):
        step_times = np.asarray(step_times, np.float64)
        if self.count == 0:
            self.ewma = step_times.copy()
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * step_times
        self.count += 1

    def speed_factors(self) -> np.ndarray:
        """1.0 = median speed; <1 = slower (scales CCM load up)."""
        if self.count == 0:
            return np.ones(self.n_ranks)
        med = np.median(self.ewma)
        speed = med / np.maximum(self.ewma, 1e-12)
        return np.clip(speed, self.floor, 1.0 / self.floor)

    def stragglers(self, threshold: float = 0.8) -> np.ndarray:
        return np.nonzero(self.speed_factors() < threshold)[0]
