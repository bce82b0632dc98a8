"""Tile layout and the host work combine for the CCM scorer.

The port's counterpart of ``repro/kernels/ccm_scorer/ops.py``.  The
balancer no longer calls these combines: its launcher scores and combines
the shortlisted pairs in one fused step (the CUDA pair kernel on the card,
``ref.score_pairs_packed`` on the CPU).  ``combine_work*`` remain the host
oracle, the exact float64 numpy expressions of the JAX package's combine,
that the plain version and the tests hold the kernel to.

Tile / mask layout
------------------
A *lock event* is one (rank a, rank b) exchange negotiation; scoring it
means evaluating every candidate cluster pair ``(A_ia a->b, B_ib b->a)``
with ``ia in 0..na``, ``ib in 0..nb`` (index 0 = the empty cluster, i.e.
one-sided gives).  A *batched* lock event packs E such events — with
pairwise-disjoint rank sets — into tiles:

  av  (E, N_AV, A)     per-a-candidate feature planes (layout.AV rows)
  bv  (E, N_AV, B)     per-b-candidate feature planes (same row meanings)
  pm  (E, N_PM, A, B)  pairwise planes: counter-flow volumes x_ab/x_ba and
                       the shared-block corrections cs/ch (layout.PM)
  sc  (E, N_SC)        per-event scalars: current rank-to-rank flows,
                       CCMState volume bases, load/mem/homing bases, the
                       mask bounds na/nb, and the combine-only scalars
                       speed/mem-cap (layout.SC)

``A``/``B`` are max(na)+1 / max(nb)+1 over the batch (launch.py pads no
further).  Candidate slots past an event's ``na``/``nb`` are the *masked
tail*: feature planes are zero-padded, and the scorer forces tail outputs
to 0 (flow/load/homing planes) or +inf (memory planes, so tail pairs can
never appear feasible).

The scorer (ref.score_tiles / kernel.score_tiles) produces the ten *work
components* per pair (layout.OUT).  It contains no multiplications; the
CCM coefficients are applied after it, in float64 — the exact expression
the scalar reference evaluates, here in numpy:

  ``combine_work``: W = alpha*L/speed + beta*Voff + gamma*Von + delta*M_H,
  feasibility from the memory planes vs the per-event caps (eq. 9), and
  infeasible pairs forced to +inf, on whole tiles (``combine_work``), on
  the (N_OUT, P) planes gathered at one event's shortlist
  (``combine_work_pairs``), or from pre-scaled terms (``combine_terms``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.kernels.ccm_scorer.layout import OUT, SC

__all__ = ["combine_work", "combine_work_pairs", "combine_terms"]

INF = float("inf")


def combine_work(out: np.ndarray, sc: np.ndarray, params,
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Shared affine combine: work components -> (w_a, w_b, feas).

    Mirrors ``CCMState.work`` / the scalar ``exchange_eval`` tail exactly
    (same expression tree as the JAX package's combine, so the float64
    engine stays bitwise-compatible with ``backend="numpy"``).
    """
    speed_a = sc[:, SC.speed_a, None, None]
    speed_b = sc[:, SC.speed_b, None, None]
    # the SC cap slots are packed pre-scaled through
    # repro_torch.core.ccm.effective_mem_cap (relative tolerance + optional
    # pressure headroom), so the combines compare plain <=
    if params.memory_constraint:
        feas = ((out[:, OUT.mem_a] <= sc[:, SC.mem_cap_a, None, None])
                & (out[:, OUT.mem_b] <= sc[:, SC.mem_cap_b, None, None]))
    else:
        feas = np.ones(out.shape[0:1] + out.shape[2:], bool)
    w_a = (params.alpha * out[:, OUT.load_a] / speed_a
           + params.beta * out[:, OUT.off_a]
           + params.gamma * out[:, OUT.on_a]
           + params.delta * out[:, OUT.hom_a])
    w_b = (params.alpha * out[:, OUT.load_b] / speed_b
           + params.beta * out[:, OUT.off_b]
           + params.gamma * out[:, OUT.on_b]
           + params.delta * out[:, OUT.hom_b])
    w_a = np.where(feas, w_a, INF)
    w_b = np.where(feas, w_b, INF)
    return w_a, w_b, feas


def combine_terms(terms: np.ndarray, sc_row: np.ndarray, params,
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host tail of the combine when the products were computed elsewhere:
    ``terms`` is (10, P) — the eight coefficient-scaled work terms (a:
    load/off/on/hom, then b) followed by the two memory planes.  Only ADDS
    happen here, in the exact association order of ``combine_work``, so
    the results are bitwise-identical to the all-host combine."""
    if params.memory_constraint:
        feas = ((terms[8] <= sc_row[SC.mem_cap_a])
                & (terms[9] <= sc_row[SC.mem_cap_b]))
    else:
        feas = np.ones(terms.shape[1], bool)
    w_a = terms[0] + terms[1] + terms[2] + terms[3]
    w_b = terms[4] + terms[5] + terms[6] + terms[7]
    w_a = np.where(feas, w_a, INF)
    w_b = np.where(feas, w_b, INF)
    return w_a, w_b, feas


def combine_work_pairs(outp: np.ndarray, sc_row: np.ndarray, params,
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Work combine on (N_OUT, P) planes already gathered at one event's
    shortlisted pairs.  Elementwise ops commute with the gather, so this is
    bitwise-identical per pair to ``combine_work`` on the full tile followed
    by the gather — the hot path just skips combining lanes it will never
    read.  ``sc_row`` is the event's (N_SC,) scalar row."""
    if params.memory_constraint:
        feas = ((outp[OUT.mem_a] <= sc_row[SC.mem_cap_a])
                & (outp[OUT.mem_b] <= sc_row[SC.mem_cap_b]))
    else:
        feas = np.ones(outp.shape[1], bool)
    w_a = (params.alpha * outp[OUT.load_a] / sc_row[SC.speed_a]
           + params.beta * outp[OUT.off_a]
           + params.gamma * outp[OUT.on_a]
           + params.delta * outp[OUT.hom_a])
    w_b = (params.alpha * outp[OUT.load_b] / sc_row[SC.speed_b]
           + params.beta * outp[OUT.off_b]
           + params.gamma * outp[OUT.on_b]
           + params.delta * outp[OUT.hom_b])
    w_a = np.where(feas, w_a, INF)
    w_b = np.where(feas, w_b, INF)
    return w_a, w_b, feas
