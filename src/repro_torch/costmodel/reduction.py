"""Dynamic data-point reduction (paper Appendix B, Algorithm 1).

Short-duration tasks vastly outnumber long ones; the algorithm repeatedly
finds the fullest of ``n_bins`` histogram bins (over the target value) and
randomly drops ``theta`` of its rows until only ``n_target`` remain.
``theta=0.5`` is the paper's recommended trade-off.

The port's own copy of ``repro/costmodel/reduction.py`` (host numpy), with
the same ``np.random.default_rng(seed)`` draws.
"""
from __future__ import annotations

import numpy as np


def dynamic_data_reduce(values: np.ndarray, n_target: int, *,
                        n_bins: int = 32, theta: float = 0.5,
                        seed: int = 0) -> np.ndarray:
    """Returns indices of the rows to KEEP (<= n_target + rounding)."""
    assert 0.0 < theta < 1.0
    n_rows = values.shape[0]
    if n_rows <= n_target:
        return np.arange(n_rows)
    rng = np.random.default_rng(seed)
    edges = np.histogram_bin_edges(values, bins=n_bins)
    which = np.clip(np.digitize(values, edges[1:-1]), 0, n_bins - 1)
    bins = [list(np.nonzero(which == b)[0]) for b in range(n_bins)]
    n_drop = n_rows - n_target
    while n_drop > 0:
        b_max = int(np.argmax([len(b) for b in bins]))
        n_max = len(bins[b_max])
        if n_max == 0:
            break
        n = min(int(np.ceil(theta * n_max)), n_drop)
        drop = rng.choice(n_max, size=n, replace=False)
        keep_mask = np.ones(n_max, bool)
        keep_mask[drop] = False
        bins[b_max] = [t for t, k in zip(bins[b_max], keep_mask) if k]
        n_drop -= n
    kept = np.concatenate([np.array(b, np.int64) for b in bins if b])
    kept.sort()
    return kept
