"""The event launcher: pack a batch of lock events, score it on the device,
combine on the host.

The counterpart of ``repro/kernels/ccm_scorer/jit.py``'s ``score_events``
(its tile backends).  The JAX launcher padded tiles into shape buckets so
that ``jax.jit`` would not retrace, and to the TPU's (8, 128) tiling; the
CUDA kernel is compiled once for every shape and runs one thread per lane,
so the port pads a batch only to its largest event (A = max(na)+1, B =
max(nb)+1).  Padding stays invariant all the same: a padded lane never
changes a live one (every operation of the scorer is elementwise over the
tile).  There is no interpret fallback: a tile is scored on the device the
caller names, and a CUDA failure raises.

Per scorer call the host packs all events' tiles into ONE flat buffer of
the scoring dtype, copies it to the device in one transfer, launches the
kernel once (``kernel.score_tiles`` on views of that buffer) and copies the
(E, N_OUT, A, B) result back in one transfer; the work combine runs in
float64 numpy (``ops.combine_work*``), shared by every device and dtype.
:data:`STATS` counts the calls, their host seconds and the (E, A, B) shapes
they launched.
"""
from __future__ import annotations

from collections import Counter
from time import perf_counter
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.ccm_scorer import kernel, ops
from repro_torch.kernels.ccm_scorer.layout import N_AV, N_PM, N_SC

__all__ = ["resolve_device", "check_dtype", "score_events", "STATS",
           "reset_stats"]

#: scorer calls, their host seconds (pack, copies, scorer) and a histogram
#: of the launched (E, A, B) tile shapes
STATS = {"calls": 0, "seconds": 0.0, "shapes": Counter()}

_NP_DTYPES = {torch.float64: np.float64, torch.float32: np.float32}


def reset_stats() -> None:
    STATS["calls"] = 0
    STATS["seconds"] = 0.0
    STATS["shapes"] = Counter()


def resolve_device(device=None) -> torch.device:
    """The device of an entry point (the balancer's scorer, task timing,
    cost-model training): ``None`` means ``"cuda"``, which raises when no
    card is present; ``"cpu"`` only when asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and "
                "torch.cuda.is_available() is false; pass device='cpu' to "
                "run the plain torch versions on the host")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_dtype(dtype) -> torch.dtype:
    if dtype not in _NP_DTYPES:
        raise ValueError(f"dtype must be torch.float64 or torch.float32, "
                         f"not {dtype}")
    return dtype


def _score(feats: Sequence[Tuple], device: torch.device,
           dtype: torch.dtype) -> np.ndarray:
    """(E, N_OUT, A, B) float64 work components of ``feats``' tiles, zero-
    padded to the batch's largest event, scored on ``device`` in
    ``dtype`` (float32 results are upcast exactly)."""
    e_n = len(feats)
    a_n = max(f[0].shape[1] for f in feats)
    b_n = max(f[1].shape[1] for f in feats)
    sizes = (e_n * N_AV * a_n, e_n * N_AV * b_n, e_n * N_PM * a_n * b_n,
             e_n * N_SC)
    ends = np.cumsum(sizes)
    buf = np.zeros(int(ends[-1]), _NP_DTYPES[dtype])
    av = buf[:ends[0]].reshape(e_n, N_AV, a_n)
    bv = buf[ends[0]:ends[1]].reshape(e_n, N_AV, b_n)
    pm = buf[ends[1]:ends[2]].reshape(e_n, N_PM, a_n, b_n)
    sc = buf[ends[2]:].reshape(e_n, N_SC)
    for k, (av_k, bv_k, pm_k, sc_k) in enumerate(feats):
        av[k, :, :av_k.shape[1]] = av_k
        bv[k, :, :bv_k.shape[1]] = bv_k
        pm[k, :, :pm_k.shape[1], :pm_k.shape[2]] = pm_k
        sc[k] = sc_k
    t = torch.from_numpy(buf).to(device)
    out = kernel.score_tiles(
        t[:ends[0]].view(e_n, N_AV, a_n),
        t[ends[0]:ends[1]].view(e_n, N_AV, b_n),
        t[ends[1]:ends[2]].view(e_n, N_PM, a_n, b_n),
        t[ends[2]:].view(e_n, N_SC))
    STATS["shapes"][(e_n, a_n, b_n)] += 1
    return out.cpu().numpy().astype(np.float64, copy=False)


def score_events(feats: Sequence[Tuple], pairs_list: Sequence[np.ndarray],
                 params, *, device: torch.device, dtype: torch.dtype,
                 ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Score a batch of lock events through one scorer launch.

    ``feats``: per-event unpadded feature tuples ``(av, bv, pm, sc)`` as
    built by ``PhaseEngine._event_features`` (av: (N_AV, na+1), ...);
    ``pairs_list``: per-event (P, 2) int64 shortlists.  Returns per-event
    ``(w_a, w_b, feasible)`` aligned with each event's pairs.  Events with
    an empty shortlist are answered without scoring; a batch with none
    left makes no call.
    """
    e_n = len(feats)
    results: List[Optional[Tuple]] = [None] * e_n
    live = [k for k in range(e_n) if pairs_list[k].shape[0]]
    for k in range(e_n):
        if pairs_list[k].shape[0] == 0:
            z = np.zeros(0)
            results[k] = (z, z, np.zeros(0, bool))
    if not live:
        return results

    lf = [feats[k] for k in live]
    t0 = perf_counter()
    out = _score(lf, device, dtype)
    STATS["calls"] += 1
    STATS["seconds"] += perf_counter() - t0

    if len(live) == 1:
        # solo event: combine only the gathered shortlist lanes
        p = pairs_list[live[0]]
        outp = out[0][:, p[:, 0], p[:, 1]]              # (N_OUT, P)
        results[live[0]] = ops.combine_work_pairs(outp, lf[0][3], params)
        return results
    # batched flush: ONE full-tile combine for all events (combine-then-
    # gather is bitwise-identical per pair to gather-then-combine)
    sc = np.stack([f[3] for f in lf])
    w_a, w_b, feas = ops.combine_work(out, sc, params)
    for j, k in enumerate(live):
        p = pairs_list[k]
        ia, ib = p[:, 0], p[:, 1]
        results[k] = (w_a[j, ia, ib], w_b[j, ia, ib], feas[j, ia, ib])
    return results
