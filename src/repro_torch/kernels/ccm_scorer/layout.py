"""Feature-plane indices shared by the plain torch scorer (ref.py), the
CUDA kernel (csrc/ccm_scorer.cu) and the engine's packing.  A copy of
``repro/kernels/ccm_scorer/layout.py``; the constants are asserted equal to
the JAX package's.  ops.py documents the full packed-tile layout.
"""
from __future__ import annotations


class AV:
    """Per-candidate feature planes, index into av (E, N_AV, A) — the same
    row meanings apply to bv (E, N_AV, B).  ``*_peer`` rows describe what the
    candidate does to the OTHER endpoint (e.g. ``s_add_peer`` on an
    a-candidate = shared bytes arriving at rank b)."""

    intra = 0        # v(C -> C) intra-cluster volume
    out_own = 1      # v(C -> own rank)
    in_own = 2       # v(own rank -> C)
    out_peer = 3     # v(C -> peer rank)
    in_peer = 4      # v(peer rank -> C)
    out_other = 5    # v(C -> any third rank)
    in_other = 6     # v(any third rank -> C)
    load = 7         # sum of task loads
    mem = 8          # sum of task memory
    ovh = 9          # max task overhead
    s_rm = 10        # shared bytes leaving the own rank if C moves
    h_rm = 11        # homing bytes leaving the own rank if C moves
    s_add_peer = 12  # shared bytes arriving at the peer rank if C moves
    h_add_peer = 13  # homing bytes arriving at the peer rank if C moves


N_AV = 14


class PM:
    """Pairwise feature planes, index into pm (E, N_PM, A, B)."""

    x_ab = 0   # v(A_i -> B_j)
    x_ba = 1   # v(B_j -> A_i)
    cs_a = 2   # shared-bytes correction on rank a for blocks in both A_i, B_j
    ch_a = 3   # homing correction on rank a
    cs_b = 4   # shared-bytes correction on rank b
    ch_b = 5   # homing correction on rank b


N_PM = 6


class SC:
    """Per-event scalars, index into sc (E, N_SC).  ``f_xy`` are current
    rank-to-rank flows (a = rank a, b = rank b, o = all other ranks);
    ``base_*`` are the incrementally-maintained CCMState volume bases the
    flow deltas are applied to.  ``speed_*`` and ``mem_cap_*`` are consumed
    by the work combine only (ops.combine_work*, and the pair scorer through
    the float64 CF row), not by the planes."""

    f_ab = 0
    f_ba = 1
    f_aa = 2
    f_bb = 3
    f_ao = 4
    f_oa = 5
    f_bo = 6
    f_ob = 7
    base_sent_a = 8
    base_recv_a = 9
    base_sent_b = 10
    base_recv_b = 11
    vol_aa = 12
    vol_bb = 13
    load_a = 14
    load_b = 15
    shared_a = 16
    shared_b = 17
    hom_a = 18
    hom_b = 19
    mem_base_a = 20
    mem_task_a = 21
    ovh_a = 22
    mem_base_b = 23
    mem_task_b = 24
    ovh_b = 25
    na = 26          # true candidate count on a (mask bound, as float)
    nb = 27          # true candidate count on b
    speed_a = 28     # combine only (copied into the CF row)
    speed_b = 29
    mem_cap_a = 30   # packed pre-scaled via repro_torch.core.ccm.effective_mem_cap
    mem_cap_b = 31   # (relative tolerance + pressure headroom baked in)


N_SC = 32


class OUT:
    """Output planes, index into out (E, N_OUT, A, B)."""

    load_a = 0
    load_b = 1
    off_a = 2
    off_b = 3
    on_a = 4
    on_b = 5
    hom_a = 6
    hom_b = 7
    mem_a = 8
    mem_b = 9


N_OUT = 10


class CF:
    """The port's float64 combine row of an event, index into cf (E, N_CF)
    of the pair scorer (``ref.score_pairs_packed``, the CUDA pair kernel):
    the CCM coefficients and the event's speeds and (pre-scaled) memory
    caps, copied from its float64 SC row, so that the float32 tier combines
    against the float64 values as the host combine does."""

    alpha = 0
    beta = 1
    gamma = 2
    delta = 3
    speed_a = 4
    speed_b = 5
    mem_cap_a = 6
    mem_cap_b = 7


N_CF = 8
#: the SC slots a CF row copies, in CF order from ``CF.speed_a`` on
CF_FROM_SC = (SC.speed_a, SC.speed_b, SC.mem_cap_a, SC.mem_cap_b)


# ------------------------------------------ the speculative window's rows
# The port's copies of the JAX package's bucket grid
# (``repro/kernels/ccm_scorer/jit.py:110-143``) and spec row layout
# (``jit.py:183-202``).  Nothing in the port compiles per shape: the grid
# fixes the window rows' layout (the lane buckets fix the flow matrix's
# group labels, the edge bucket the length of its scatter inputs), and it
# keeps the set of launched (W, eb) shapes small.
LANE_CAP = 128      # lane buckets stop doubling here
LANE_FLOOR = 8      # the smallest lane bucket


def bucket_lanes(n: int, *, floor: int = LANE_FLOOR,
                 cap: int = LANE_CAP) -> int:
    """Round a lane count up to the bucket grid: powers of two in
    [floor, cap], multiples of ``cap`` beyond it."""
    n = max(int(n), 1)
    if n <= floor:
        return floor
    if n >= cap:
        return -(-n // cap) * cap
    return 1 << (n - 1).bit_length()


def bucket_events(e: int) -> int:
    """Event (window-row) bucket: the next power of two."""
    e = max(int(e), 1)
    return 1 << (e - 1).bit_length()


def bucket_pairs(p: int) -> int:
    """Shortlist bucket: powers of two with a floor of 32 (the default
    shortlist cap)."""
    p = max(int(p), 1)
    return max(32, 1 << (p - 1).bit_length())


def bucket_edges(n: int) -> int:
    """Edge bucket of a window row: powers of two with a floor of 32."""
    n = max(int(n), 1)
    return max(32, 1 << (n - 1).bit_length())


#: per-row scalars after the pair indices: alpha, beta, gamma, delta,
#: w_before, p_count
N_MISC = 6


def spec_offsets(eb: int, a_n: int, b_n: int, p_n: int) -> tuple:
    """Cumulative offsets of
    ``[bins | w | avh | bvh | pmh | sch | iaf | ibf | misc]`` in one flat
    float64 window row: ``(o_w, o_av, o_bv, o_pm, o_sc, o_ia, o_ib, o_ms,
    row_len)``.  ``bins``/``w`` are the flow-matrix scatter inputs (``eb``
    edge slots each), ``avh``/``bvh`` the seven host-side candidate feature
    rows (``AV.load`` .. ``AV.h_add_peer``, a_n and b_n lanes), ``pmh`` the
    four host-side pairwise correction planes at the shortlist (``p_n``
    slots), ``sch`` the scalar row with the eight flow slots left zero,
    ``iaf``/``ibf`` the pair indices and ``misc`` the ``N_MISC`` scalars."""
    o_w = eb
    o_av = o_w + eb
    o_bv = o_av + 7 * a_n
    o_pm = o_bv + 7 * b_n
    o_sc = o_pm + 4 * p_n
    o_ia = o_sc + N_SC
    o_ib = o_ia + p_n
    o_ms = o_ib + p_n
    return o_w, o_av, o_bv, o_pm, o_sc, o_ia, o_ib, o_ms, o_ms + N_MISC


def spec_groups(a_n: int, b_n: int) -> tuple:
    """The window row's fixed group-label layout: ``(sa, sb, g_n)`` — group
    0 = other ranks, 1 = stays on a, 2 = stays on b, a-candidate i (1-based)
    at ``sa + i - 1``, b-candidate j at ``sb + j - 1``; ``g_n`` groups."""
    sa = 3
    sb = sa + (a_n - 1)
    return sa, sb, sb + (b_n - 1)


def spec_edge_bucket(row_len: int, a_n: int, b_n: int, p_n: int) -> int:
    """The edge bucket ``eb`` of a window row of ``row_len`` values."""
    tail = spec_offsets(0, a_n, b_n, p_n)[-1]
    eb, odd = divmod(row_len - tail, 2)
    if odd or eb < 0:
        raise ValueError(f"a window row of {row_len} values does not fit "
                         f"the layout of lanes ({a_n}, {b_n}), pairs {p_n}")
    return eb
