"""Standard scaler (paper §VI-D.1): zero mean / unit variance per feature.

The port's own copy of ``repro/costmodel/scaler.py`` (host numpy)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StandardScaler:
    mean: np.ndarray = None
    std: np.ndarray = None

    def fit(self, x: np.ndarray) -> "StandardScaler":
        self.mean = x.mean(0)
        self.std = x.std(0)
        self.std = np.where(self.std < 1e-12, 1.0, self.std)
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean) / self.std

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)
