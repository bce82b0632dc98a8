"""Plain PyTorch version of the CCM stage-2 scorer: full tiles, and the
shortlisted pairs with the work combine.

The counterpart of ``repro/kernels/ccm_scorer/ref.py`` and the oracle the
CUDA kernel (``csrc/ccm_scorer.cu``) is held bitwise-equal to.  Both compute
the identical expression tree over the packed feature tiles (see ops.py for
the layout), using only additions, subtractions, maxima and selects — no
multiply means no FMA contraction, no divide means no reciprocal rewrite —
so every lane is exact IEEE arithmetic in a fixed order: this function on
the CPU, this function on the card, the kernel and the JAX package's
``ref.score_tiles`` / Pallas kernel agree bit for bit in float64, and the
float32 versions agree with each other.

The pair scorer's combine (:func:`combine_pairs`) multiplies and divides:
each product, quotient and sum is its own eager float64 operation, rounded
once, in the association of ``ops.combine_work_pairs``, so it too is
bitwise-equal to the numpy combine and to the CUDA pair kernel (which
rounds each step with the ``_rn`` intrinsics).

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

from repro_torch.kernels.ccm_scorer.layout import (AV, CF, N_AV, N_OUT, OUT,
                                                   PM, SC, spec_edge_bucket,
                                                   spec_groups, spec_offsets)


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


def _mask_planes(planes, mask):
    """Masked tail: flow/load/homing planes -> 0, memory planes -> +inf
    (so padded pairs can never look feasible).  Plane order = layout.OUT;
    the planes are stacked along dim 1."""
    p0 = planes[0]
    zero = torch.zeros((), dtype=p0.dtype, device=p0.device)
    inf = torch.full((), float("inf"), dtype=p0.dtype, device=p0.device)
    out = [torch.where(mask, p, inf if i in (OUT.mem_a, OUT.mem_b) else zero)
           for i, p in enumerate(planes)]
    return torch.stack(out, dim=1)


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
    return _mask_planes(planes, mask)


def score_pairs(avp: torch.Tensor, bvp: torch.Tensor, pmp: torch.Tensor,
                sc: torch.Tensor, iaf: torch.Tensor, ibf: torch.Tensor,
                ) -> torch.Tensor:
    """Pair-gathered layout: score only a shortlist of candidate pairs (the
    JAX package's ``ref.score_pairs_xp``).

    ``avp``/``bvp``: (E, N_AV, P) feature rows gathered at the pairs' a-/
    b-candidate indices, ``pmp``: (E, N_PM, P) pairwise planes gathered at
    the pairs, ``iaf``/``ibf``: (E, P) pair indices in the scoring dtype
    (mask bound compare only).  Returns (E, N_OUT, P), bitwise-equal to
    full-tile scoring followed by the same gather.
    """
    planes = score_planes(
        col=lambda i: avp[:, i],
        row=lambda i: bvp[:, i],
        scal=lambda i: sc[:, i, None],
        pmp=lambda i: pmp[:, i])
    mask = (iaf <= sc[:, SC.na, None]) & (ibf <= sc[:, SC.nb, None])
    return _mask_planes(planes, mask)


def combine_pairs(out: torch.Tensor, cf: torch.Tensor,
                  memory_constraint: bool) -> torch.Tensor:
    """The work combine of ``ops.combine_work_pairs`` in float64 torch:
    ``out`` (N_OUT, P) planes (widened exactly to float64 first), ``cf``
    (P, N_CF) float64 combine rows, one per pair.  Returns (3, P) float64:
    w_a, w_b and feasible as 0.0 / 1.0, with w = +inf where infeasible."""
    out = out.to(torch.float64)
    if memory_constraint:
        feas = ((out[OUT.mem_a] <= cf[:, CF.mem_cap_a])
                & (out[OUT.mem_b] <= cf[:, CF.mem_cap_b]))
    else:
        feas = torch.ones(out.shape[1], dtype=torch.bool, device=out.device)
    w_a = (cf[:, CF.alpha] * out[OUT.load_a] / cf[:, CF.speed_a]
           + cf[:, CF.beta] * out[OUT.off_a]
           + cf[:, CF.gamma] * out[OUT.on_a]
           + cf[:, CF.delta] * out[OUT.hom_a])
    w_b = (cf[:, CF.alpha] * out[OUT.load_b] / cf[:, CF.speed_b]
           + cf[:, CF.beta] * out[OUT.off_b]
           + cf[:, CF.gamma] * out[OUT.on_b]
           + cf[:, CF.delta] * out[OUT.hom_b])
    inf = torch.full((), float("inf"), dtype=torch.float64, device=out.device)
    return torch.stack([torch.where(feas, w_a, inf),
                        torch.where(feas, w_b, inf), feas.to(torch.float64)])


def score_pairs_packed(av: torch.Tensor, bv: torch.Tensor, pm: torch.Tensor,
                       sc: torch.Tensor, cf: torch.Tensor, offs: torch.Tensor,
                       pairs: torch.Tensor, memory_constraint: bool,
                       ) -> torch.Tensor:
    """The plain version of the fused pair scorer, on the kernel's inputs:
    the packed tiles ``av``, ``bv``, ``pm``, ``sc`` (ops.py's layout, one
    dtype), ``cf`` (E, N_CF) float64 combine rows, ``offs`` (E + 1,) int32
    pair offsets and ``pairs`` (P, 2) int32 (ia, ib) of every event, back to
    back.  Returns (3, P) float64: w_a, w_b, feasible (0.0 / 1.0).

    Each pair is scored as an event of one pair (its gathered columns, its
    event's scalars), which is elementwise the same as
    :func:`score_pairs` on the whole shortlist; the planes are then
    combined in float64 (:func:`combine_pairs`)."""
    e_n, dev = av.shape[0], av.device
    counts = (offs[1:] - offs[:-1]).to(torch.int64)
    ev = torch.repeat_interleave(torch.arange(e_n, device=dev), counts)
    ia, ib = pairs[:, 0].to(torch.int64), pairs[:, 1].to(torch.int64)
    out = score_pairs(av[ev, :, ia][:, :, None], bv[ev, :, ib][:, :, None],
                      pm[ev, :, ia, ib][:, :, None], sc[ev],
                      ia.to(av.dtype)[:, None], ib.to(av.dtype)[:, None])
    return combine_pairs(out[:, :, 0].T, cf[ev], memory_constraint)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis one addition at a time, in ascending index,
    from 0.0: the order the window kernel repeats."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def spec_flow(buf: torch.Tensor, a_lanes: int, b_lanes: int,
              p_n: int) -> torch.Tensor:
    """The (W, G, G) flow matrices of window rows ``buf`` (W, row_len):
    each bin sums its edges in edge order from 0.0, as ``np.bincount``
    does (one edge slot of every row per step; distinct rows never share
    an index, so the step is exact on any device)."""
    w_n, row_len = buf.shape
    eb = spec_edge_bucket(row_len, a_lanes, b_lanes, p_n)
    g_n = spec_groups(a_lanes, b_lanes)[2]
    rows = torch.arange(w_n, device=buf.device)
    bins = buf[:, :eb].to(torch.int64)
    wgt = buf[:, eb:2 * eb]
    flat = torch.zeros((w_n, g_n * g_n), dtype=buf.dtype, device=buf.device)
    for k in range(eb):
        idx = bins[:, k]
        flat[rows, idx] = flat[rows, idx] + wgt[:, k]
    return flat.view(w_n, g_n, g_n)


def score_spec_rows(buf: torch.Tensor, a_lanes: int, b_lanes: int,
                    p_n: int) -> torch.Tensor:
    """The plain version of the window scorer: ``buf`` (W, row_len) float64
    window rows in the ``layout.spec_offsets(eb, a_lanes, b_lanes, p_n)``
    layout (``PhaseEngine.spec_raw``).  Returns (W, 4) float64 ``[slot,
    score, w_a, w_b]`` per row: the shortlist slot of the selected pair,
    its work improvement (``-inf`` when no valid, feasible pair improves by
    more than 1e-12: a no-op event; slot 0 then), and its works after the
    exchange.

    Computes what the JAX package's ``kind="spec"`` body computes per row
    (``repro/kernels/ccm_scorer/jit.py:271-358``), in one fixed order that
    the CUDA kernel repeats bit for bit:

    - the flow matrix F (:func:`spec_flow`): each bin sums its edges in
      edge order from 0.0, as ``np.bincount`` does;
    - slice sums sequential in ascending index, added to the direct entry
      (``F[:, 1] + (F[:, sa] + F[:, sa+1] + ...)``), for the feature rows
      and the eight flow scalars alike;
    - the scorer tree and the tail mask of :func:`score_pairs`, and the
      combine rounded step by step (``ops.combine_work_pairs``);
    - feasibility ``mem <= cap`` (caps pre-scaled, ``inf`` when the memory
      constraint is off), slots past the row's pair count invalid, the
      first maximum of the masked diffs.

    A pad row (zeros with unit speeds, pair count 0) selects slot 0 with
    score ``-inf``.
    """
    w_n, row_len = buf.shape
    eb = spec_edge_bucket(row_len, a_lanes, b_lanes, p_n)
    _, o_av, o_bv, o_pm, o_sc, o_ia, o_ib, o_ms, _ = spec_offsets(
        eb, a_lanes, b_lanes, p_n)
    sa, sb, g_n = spec_groups(a_lanes, b_lanes)
    dt, dev = buf.dtype, buf.device
    F = spec_flow(buf, a_lanes, b_lanes, p_n)
    flat = F.view(w_n, g_n * g_n)

    row_to_a = F[:, :, 1] + _seq_sum(F[:, :, sa:sb])        # v(g -> a)
    row_to_b = F[:, :, 2] + _seq_sum(F[:, :, sb:])
    col_from_a = F[:, 1, :] + _seq_sum(F[:, sa:sb, :].transpose(1, 2))
    col_from_b = F[:, 2, :] + _seq_sum(F[:, sb:, :].transpose(1, 2))

    def side(n, lo, hi, own_row, own_col, peer_row, peer_col, host):
        g = torch.arange(lo, hi, device=dev)
        v = torch.zeros((w_n, N_AV, n), dtype=dt, device=dev)
        v[:, AV.intra, 1:] = F[:, g, g]
        v[:, AV.out_own, 1:] = own_row[:, lo:hi]
        v[:, AV.in_own, 1:] = own_col[:, lo:hi]
        v[:, AV.out_peer, 1:] = peer_row[:, lo:hi]
        v[:, AV.in_peer, 1:] = peer_col[:, lo:hi]
        v[:, AV.out_other, 1:] = F[:, lo:hi, 0]
        v[:, AV.in_other, 1:] = F[:, 0, lo:hi]
        v[:, AV.load:] = host.reshape(w_n, 7, n)
        return v

    av = side(a_lanes, sa, sb, row_to_a, col_from_a, row_to_b, col_from_b,
              buf[:, o_av:o_bv])
    bv = side(b_lanes, sb, g_n, row_to_b, col_from_b, row_to_a, col_from_a,
              buf[:, o_bv:o_pm])
    sc = buf[:, o_sc:o_ia].clone()
    sc[:, SC.f_ab] = row_to_b[:, 1] + _seq_sum(row_to_b[:, sa:sb])
    sc[:, SC.f_ba] = row_to_a[:, 2] + _seq_sum(row_to_a[:, sb:])
    sc[:, SC.f_aa] = row_to_a[:, 1] + _seq_sum(row_to_a[:, sa:sb])
    sc[:, SC.f_bb] = row_to_b[:, 2] + _seq_sum(row_to_b[:, sb:])
    sc[:, SC.f_ao] = F[:, 1, 0] + _seq_sum(F[:, sa:sb, 0])
    sc[:, SC.f_oa] = F[:, 0, 1] + _seq_sum(F[:, 0, sa:sb])
    sc[:, SC.f_bo] = F[:, 2, 0] + _seq_sum(F[:, sb:, 0])
    sc[:, SC.f_ob] = F[:, 0, 2] + _seq_sum(F[:, 0, sb:])

    ia = buf[:, o_ia:o_ib].to(torch.int64)
    ib = buf[:, o_ib:o_ms].to(torch.int64)
    avp = torch.gather(av, 2, ia[:, None, :].expand(-1, N_AV, -1))
    bvp = torch.gather(bv, 2, ib[:, None, :].expand(-1, N_AV, -1))
    on = (ia >= 1) & (ib >= 1)
    fa, fb = sa - 1 + ia, sb - 1 + ib
    x_ab = torch.where(on, flat.gather(1, fa * g_n + fb), 0.0)
    x_ba = torch.where(on, flat.gather(1, fb * g_n + fa), 0.0)
    pmp = torch.cat([torch.stack([x_ab, x_ba], 1),
                     buf[:, o_pm:o_sc].reshape(w_n, 4, p_n)], 1)
    out = score_pairs(avp, bvp, pmp, sc, ia.to(dt), ib.to(dt))

    ms = buf[:, o_ms:]
    al, be, ga, de = (ms[:, k, None] for k in range(4))
    w_a = (al * out[:, OUT.load_a] / sc[:, SC.speed_a, None]
           + be * out[:, OUT.off_a] + ga * out[:, OUT.on_a]
           + de * out[:, OUT.hom_a])
    w_b = (al * out[:, OUT.load_b] / sc[:, SC.speed_b, None]
           + be * out[:, OUT.off_b] + ga * out[:, OUT.on_b]
           + de * out[:, OUT.hom_b])
    feas = ((out[:, OUT.mem_a] <= sc[:, SC.mem_cap_a, None])
            & (out[:, OUT.mem_b] <= sc[:, SC.mem_cap_b, None]))
    valid = torch.arange(p_n, dtype=dt, device=dev) < ms[:, 5, None]
    diff = ms[:, 4, None] - torch.maximum(w_a, w_b)
    score = torch.where(valid & feas & (diff > 1e-12), diff,
                        float("-inf"))
    j = torch.argmax(score, dim=1, keepdim=True)    # the first maximum
    return torch.cat([j.to(dt), score.gather(1, j), w_a.gather(1, j),
                      w_b.gather(1, j)], 1)
