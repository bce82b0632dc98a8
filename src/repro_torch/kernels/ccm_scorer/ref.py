"""Plain PyTorch version of the CCM stage-2 scorer tiles.

The counterpart of ``repro/kernels/ccm_scorer/ref.py`` and the oracle the
CUDA kernel (``csrc/ccm_scorer.cu``) is held bitwise-equal to.  Both compute
the identical expression tree over the packed feature tiles (see ops.py for
the layout), using only additions, subtractions, maxima and selects — no
multiply means no FMA contraction, no divide means no reciprocal rewrite —
so every lane is exact IEEE arithmetic in a fixed order: this function on
the CPU, this function on the card, the kernel and the JAX package's
``ref.score_tiles`` / Pallas kernel agree bit for bit in float64, and the
float32 versions agree with each other.

Eager torch runs each operation below as its own elementwise kernel, so
nothing re-associates or contracts the tree.  Every expression mirrors the
JAX package's ``ref.score_planes`` term for term, re-rooted at the packed
event axis: ``col(i) = av[:, i, :, None]`` broadcasts a per-a-candidate row
down the tile, ``row(i) = bv[:, i, None, :]`` along it, and scalars enter
as ``sc[:, i, None, None]``.  ``torch.maximum`` propagates NaN like
``np.maximum``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ccm_scorer.layout import AV, N_OUT, OUT, PM, SC


def score_planes(col, row, scal, pmp):
    """The scorer expression tree, abstracted over index helpers.

    ``col(i)``/``row(i)`` read per-a-/per-b-candidate feature rows,
    ``scal(i)`` a per-event scalar, ``pmp(i)`` a pairwise plane — each
    returning tensors that broadcast against one another.  Returns the
    N_OUT planes in ``layout.OUT`` order, *before* tail masking.
    """
    x_ab, x_ba = pmp(PM.x_ab), pmp(PM.x_ba)
    cs_a, ch_a = pmp(PM.cs_a), pmp(PM.ch_a)
    cs_b, ch_b = pmp(PM.cs_b), pmp(PM.ch_b)

    # --- flows after the exchange (same expression tree as the engine) ---
    sent_a = (x_ba + (row(AV.out_own) - row(AV.intra) + row(AV.out_other))
              + (col(AV.in_own) - col(AV.intra))
              + (scal(SC.f_ab) - col(AV.out_peer) - row(AV.in_peer) + x_ab)
              + (scal(SC.f_ao) - col(AV.out_other)))
    recv_a = (x_ab + (row(AV.in_own) - row(AV.intra) + row(AV.in_other))
              + (col(AV.out_own) - col(AV.intra))
              + (scal(SC.f_ba) - row(AV.out_peer) - col(AV.in_peer) + x_ba)
              + (scal(SC.f_oa) - col(AV.in_other)))
    on_a = (row(AV.intra) + (row(AV.out_peer) - x_ba)
            + (row(AV.in_peer) - x_ab)
            + (scal(SC.f_aa) - (col(AV.out_own) + col(AV.in_own)
                                - col(AV.intra))))
    sent_b = (x_ab + (col(AV.out_own) - col(AV.intra) + col(AV.out_other))
              + (row(AV.in_own) - row(AV.intra))
              + (scal(SC.f_ba) - row(AV.out_peer) - col(AV.in_peer) + x_ba)
              + (scal(SC.f_bo) - row(AV.out_other)))
    recv_b = (x_ba + (col(AV.in_own) - col(AV.intra) + col(AV.in_other))
              + (row(AV.out_own) - row(AV.intra))
              + (scal(SC.f_ab) - col(AV.out_peer) - row(AV.in_peer) + x_ab)
              + (scal(SC.f_ob) - row(AV.in_other)))
    on_b = (col(AV.intra) + (col(AV.out_peer) - x_ab)
            + (col(AV.in_peer) - x_ba)
            + (scal(SC.f_bb) - (row(AV.out_own) + row(AV.in_own)
                                - row(AV.intra))))

    off_a = torch.maximum(
        scal(SC.base_sent_a) + (sent_a - (scal(SC.f_ab) + scal(SC.f_ao))),
        scal(SC.base_recv_a) + (recv_a - (scal(SC.f_ba) + scal(SC.f_oa))))
    off_b = torch.maximum(
        scal(SC.base_sent_b) + (sent_b - (scal(SC.f_ba) + scal(SC.f_bo))),
        scal(SC.base_recv_b) + (recv_b - (scal(SC.f_ab) + scal(SC.f_ob))))
    on_a = scal(SC.vol_aa) + (on_a - scal(SC.f_aa))
    on_b = scal(SC.vol_bb) + (on_b - scal(SC.f_bb))

    load_a = scal(SC.load_a) - col(AV.load) + row(AV.load)
    load_b = scal(SC.load_b) + col(AV.load) - row(AV.load)

    # --- homing / shared-memory transitions -----------------------------
    shared_a = (scal(SC.shared_a) - col(AV.s_rm) + row(AV.s_add_peer) + cs_a)
    shared_b = (scal(SC.shared_b) - row(AV.s_rm) + col(AV.s_add_peer) + cs_b)
    hom_a = scal(SC.hom_a) - col(AV.h_rm) + row(AV.h_add_peer) + ch_a
    hom_b = scal(SC.hom_b) - row(AV.h_rm) + col(AV.h_add_peer) + ch_b

    # --- memory (eq. 9 inputs) ------------------------------------------
    mem_a = (scal(SC.mem_base_a) + scal(SC.mem_task_a) - col(AV.mem)
             + row(AV.mem) + shared_a
             + torch.maximum(scal(SC.ovh_a), row(AV.ovh)))
    mem_b = (scal(SC.mem_base_b) + scal(SC.mem_task_b) + col(AV.mem)
             - row(AV.mem) + shared_b
             + torch.maximum(scal(SC.ovh_b), col(AV.ovh)))

    planes = [None] * N_OUT
    planes[OUT.load_a] = load_a
    planes[OUT.load_b] = load_b
    planes[OUT.off_a] = off_a
    planes[OUT.off_b] = off_b
    planes[OUT.on_a] = on_a
    planes[OUT.on_b] = on_b
    planes[OUT.hom_a] = hom_a
    planes[OUT.hom_b] = hom_b
    planes[OUT.mem_a] = mem_a
    planes[OUT.mem_b] = mem_b
    return planes


def score_tiles(av: torch.Tensor, bv: torch.Tensor, pm: torch.Tensor,
                sc: torch.Tensor) -> torch.Tensor:
    """Score packed exchange tiles with plain torch operations.

    av: (E, N_AV, A) per-a-candidate features, bv: (E, N_AV, B),
    pm: (E, N_PM, A, B) pairwise features, sc: (E, N_SC) scalars, all of
    one dtype on one device.  Returns (E, N_OUT, A, B); the tail beyond
    (na+1, nb+1) is masked to 0 (flow/load/homing planes) or +inf (memory
    planes).  Output lane (ia, ib) depends only on ``av[:, :, ia]``,
    ``bv[:, :, ib]``, ``pm[:, :, ia, ib]`` and ``sc``, so padding never
    perturbs live lanes.
    """
    a_n, b_n = av.shape[2], bv.shape[2]
    planes = score_planes(
        col=lambda i: av[:, i, :, None],
        row=lambda i: bv[:, i, None, :],
        scal=lambda i: sc[:, i, None, None],
        pmp=lambda i: pm[:, i])
    dt, dev = av.dtype, av.device
    ia = torch.arange(a_n, dtype=dt, device=dev)[None, :, None]
    ib = torch.arange(b_n, dtype=dt, device=dev)[None, None, :]
    mask = (ia <= sc[:, SC.na, None, None]) & (ib <= sc[:, SC.nb, None, None])
    zero = torch.zeros((), dtype=dt, device=dev)
    inf = torch.full((), float("inf"), dtype=dt, device=dev)
    out = [torch.where(mask, p, inf if i in (OUT.mem_a, OUT.mem_b) else zero)
           for i, p in enumerate(planes)]
    return torch.stack(out, dim=1)
