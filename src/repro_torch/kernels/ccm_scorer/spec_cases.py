"""Window rows that stress the window kernel's scatter, made from real
captured rows (``PhaseEngine.spec_raw``), and random rows of any layout.

The tests (``tests/test_torch_spec.py``) hold the plain version's flow
matrix on these rows to ``np.bincount`` bit for bit, and on the card the
tests and ``chip_smoke.py`` hold the window kernel to its plain version
(``ref.score_spec_rows``) on them, bit for bit.  Each case keeps its
source row's tail (features, scalars, shortlist) and replaces its edges:

- ``one bin``: every edge slot in one bin (the pairwise entry x_ab of the
  row's first shortlisted pair), the row's volumes repeated: a chain of eb
  additions;
- ``distinct bins``: every edge slot in a bin of its own;
- ``straddle``: eb 512, one bin whose edges sit on both sides of the
  32-edge and 256-edge borders, the other slots in distinct bins;
- ``eb 512``, ``eb 1024``, ``eb 2048``: the row's edges repeated to fill
  512, 1024 and 2048 slots: 2, 4 and 8 staging chunks of 256 edges (the
  last refills the kernel's ring of four buffers);
- ``all pads``: every slot a pad edge (bin 0, volume 0);
- ``order``: 1e16, 1.0, 1.0 into x_ab's bin and 1.0, 1.0, 1e16 into
  x_ba's, in edge order: the sums differ when the order does.

Pure numpy; nothing here runs a kernel.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.kernels.ccm_scorer.layout import (SC, spec_groups,
                                                   spec_offsets)

Raw = Tuple[np.ndarray, int]
#: slots of the straddling bin in a row of 512 edge slots
STRADDLE_SLOTS = (0, 1, 30, 31, 32, 33, 63, 64, 254, 255, 256, 257, 287,
                  288, 510, 511)


def _with_edges(row: np.ndarray, eb: int, bins: np.ndarray,
               vols: np.ndarray) -> Raw:
    """``row`` (of edge bucket ``eb``) with its edges replaced by ``bins``
    and ``vols`` (one edge bucket, any size): ``(new row, new eb)``."""
    new_eb = len(bins)
    out = np.concatenate([np.asarray(bins, np.float64),
                          np.asarray(vols, np.float64), row[2 * eb:]])
    return out, new_eb


def _pair_bins(row: np.ndarray, eb: int, a_n: int, b_n: int,
               p_n: int) -> Tuple[int, int]:
    """The bins of x_ab and x_ba of the row's first pair on the candidate
    grid (ia, ib >= 1), or of lanes (1, 1)."""
    sa, sb, g_n = spec_groups(a_n, b_n)
    o_ia, o_ib = spec_offsets(eb, a_n, b_n, p_n)[5:7]
    ia, ib = 1, 1
    for p in range(p_n):
        if row[o_ia + p] >= 1 and row[o_ib + p] >= 1:
            ia, ib = int(row[o_ia + p]), int(row[o_ib + p])
            break
    fa, fb = sa - 1 + ia, sb - 1 + ib
    return fa * g_n + fb, fb * g_n + fa


def _volumes(row: np.ndarray, eb: int, n: int) -> np.ndarray:
    """The row's real volumes (or 1.0 if it has none) repeated to n."""
    real = row[eb:2 * eb][row[:eb] != 0]
    if real.size == 0:
        real = np.ones(1)
    return np.resize(real, n)


def scatter_cases(raws: Sequence[Raw], a_n: int, b_n: int, p_n: int,
                  seed: int = 0) -> List[Tuple[str, List[Raw]]]:
    """The module's cases, each a window of the rows of ``raws`` (real
    captured rows of lanes ``(a_n, b_n)`` and pair bucket ``p_n``) with
    their edges replaced: ``[(label, [(row, eb), ...]), ...]``."""
    rng = np.random.default_rng(seed)
    g_n = spec_groups(a_n, b_n)[2]
    cases = {name: [] for name in ("one bin", "distinct bins", "straddle",
                                   "eb 512", "eb 1024", "eb 2048",
                                   "all pads", "order")}
    for row, eb in raws:
        x_ab, x_ba = _pair_bins(row, eb, a_n, b_n, p_n)
        real = row[:eb] != 0
        cases["one bin"].append(_with_edges(
            row, eb, np.full(eb, x_ab), _volumes(row, eb, eb)))
        if eb < g_n * g_n:
            cases["distinct bins"].append(_with_edges(
                row, eb, rng.permutation(g_n * g_n - 1)[:eb] + 1,
                _volumes(row, eb, eb)))
        if 512 < g_n * g_n:
            bins = rng.permutation(g_n * g_n - 1)[:512] + 1
            bins[bins == x_ab] = bins[0]            # x_ab only in the slots
            bins[list(STRADDLE_SLOTS)] = x_ab
            cases["straddle"].append(_with_edges(
                row, eb, bins, rng.uniform(0.5, 2.0, 512)))
        for n in (512, 1024, 2048):
            cases[f"eb {n}"].append(_with_edges(
                row, eb, np.resize(row[:eb][real] if real.any()
                                   else np.array([x_ab]), n),
                _volumes(row, eb, n)))
        cases["all pads"].append(_with_edges(row, eb, np.zeros(eb),
                                            np.zeros(eb)))
        bins, vols = row[:eb].copy(), row[eb:2 * eb].copy()
        bins[-6:] = (x_ab, x_ab, x_ab, x_ba, x_ba, x_ba)
        vols[-6:] = (1e16, 1.0, 1.0, 1.0, 1.0, 1e16)
        cases["order"].append(_with_edges(row, eb, bins, vols))
    return [(name, rows) for name, rows in cases.items() if rows]


def random_rows(rng: np.random.Generator, w_n: int, eb: int, a_n: int,
                b_n: int, p_n: int) -> List[Raw]:
    """``w_n`` valid window rows of any layout, from ``rng``: random bins
    (a quarter of the slots pads), non-negative volumes and host features,
    unit speeds, finite caps, random shortlists and pair counts.  With a_n
    + b_n odd the row length is odd."""
    o_w, o_av, o_bv, o_pm, o_sc, o_ia, o_ib, o_ms, row_len = spec_offsets(
        eb, a_n, b_n, p_n)
    g_n = spec_groups(a_n, b_n)[2]
    rows = []
    for _ in range(w_n):
        row = np.zeros(row_len)
        bins = rng.integers(1, g_n * g_n, eb)
        bins[rng.random(eb) < 0.25] = 0
        row[:o_w] = bins
        row[o_w:o_av] = np.where(bins > 0, rng.uniform(0.0, 4.0, eb), 0.0)
        row[o_av:o_sc] = rng.uniform(0.0, 2.0, o_sc - o_av)
        row[o_sc:o_ia] = rng.uniform(0.0, 8.0, o_ia - o_sc)
        row[o_sc + SC.na] = a_n - 1
        row[o_sc + SC.nb] = b_n - 1
        row[o_sc + SC.speed_a] = row[o_sc + SC.speed_b] = 1.0
        row[o_sc + SC.mem_cap_a] = row[o_sc + SC.mem_cap_b] = 64.0
        row[o_ia:o_ib] = rng.integers(0, a_n, p_n)
        row[o_ib:o_ms] = rng.integers(0, b_n, p_n)
        row[o_ms:o_ms + 4] = (1.0, 0.5, 0.25, 1e-3)
        row[o_ms + 4] = rng.uniform(10.0, 40.0)
        row[o_ms + 5] = rng.integers(0, p_n + 1)
        rows.append((row, eb))
    return rows
