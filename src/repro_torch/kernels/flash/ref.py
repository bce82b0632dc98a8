"""Plain torch version of the flash-attention forward pass, written after
the JAX package's ``kernels/flash/ref.py::reference_attention``.  The CPU
tests use it, the entry point takes it for CPU tensors, and ``chip_smoke.py``
holds the CUDA kernel (``csrc/flash_attention.cu``) against it on the card;
``reference_attention_bf16_p`` models the bf16 kernel's rounding of p
against each row's final max, ``reference_attention_bf16_tiles`` as the
kernel rounds it (against the running max of its walk over 64-key tiles),
``row_lse`` its LSE instance's output, and ``attention_bwd`` the backward
kernels' formula (with ``bf16_products``, the tensor-core kernels'
rounding).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
#: the bf16 kernel's kv tile (keys a step of its online softmax)
KV_TILE = 64
LOG2E = 1.4426950408889634
#: how near (relatively) to a bf16 rounding midpoint a p of the model may
#: lie and the kernel's p round the other way: four times the farthest
#: such p read on an H100 (under 2^-22: kernel_probe.py --steps flash_p,
#: 12 inputs at gemma2-27b's global layer, hd 128), for hd 256's longer
#: sums
P_SLACK = 2.0 ** -20


def _scores(q, k, v, causal, window, softcap):
    """The float32 scores (soft-capped, masked to -1e30), the (Sq, Skv)
    mask and v repeated to q's heads."""
    bhq, sq, hd = q.shape
    bhkv, skv, _ = k.shape
    group = bhq // bhkv
    k = torch.repeat_interleave(k, group, dim=0)
    v = torch.repeat_interleave(v, group, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(hd)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return torch.where(mask[None], s, NEG_INF), mask, v


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q: (BHq, Sq, hd); k, v: (BHkv, Skv, hd), BHq = BHkv * group, q rows
    ``bh`` reading kv rows ``bh // group``.  Returns (BHq, Sq, hd) in
    ``q.dtype``; all arithmetic in float32.  Positions are row indices from
    0 for both q and k; a row that sees no key comes out 0."""
    s, mask, v = _scores(q, k, v, causal, window, softcap)
    p = torch.softmax(s, dim=-1)
    # fully-masked rows: softmax of all -1e30 is uniform; zero them like the
    # kernel does (l == 0 guard)
    any_valid = mask.any(dim=-1)[None, :, None]
    out = torch.einsum("bqk,bkd->bqd", p, v.to(torch.float32))
    return torch.where(any_valid, out, 0.0).to(q.dtype)


def reference_attention_bf16_p(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               window: int = 0,
                               softcap: float = 0.0) -> torch.Tensor:
    """The bf16 CUDA kernel's arithmetic in plain torch: float32 scores,
    p = exp(s - row max) rounded to bf16 before p . v (accumulated in
    float32), divided by the float32 sum of the unrounded p (0 for a row
    that sees no key).  Same layout as :func:`reference_attention`; returns
    float32, not rounded to q's type, so that a check can tell the rounding
    of p from the output's own.  For tests and ``chip_smoke.py``; no path
    of the port calls it."""
    s, mask, v = _scores(q, k, v, causal, window, softcap)
    p = torch.where(mask[None], torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bqk,bkd->bqd", p.to(torch.bfloat16).to(torch.float32),
                       v.to(torch.float32))
    return out / torch.where(l == 0.0, 1.0, l)


def reference_attention_bf16_tiles(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, *, causal: bool = True,
                                   window: int = 0, softcap: float = 0.0,
                                   slack: bool = False):
    """The bf16 CUDA kernel's online softmax in plain torch, step for step:
    the keys in its 64-key tiles, in order; each tile's float32 scores in
    log2 units (s times 1 / sqrt(hd) times log2(e), or under the soft-cap
    cap tanh(s / (sqrt(hd) cap)) log2(e)), -1e30 where masked; the row's
    running max m' = max(m, the tile's max), p = 2^(s - m') rounded to
    bf16 before p . v, o and the float32 sum l of the unrounded p rescaled
    by 2^(m - m') (m taken as 0 while the row has seen no key, so its p
    are 0); out = o / l (0 for a row that sees no key).  Unlike
    :func:`reference_attention_bf16_p`, which rounds p against the row's
    final max, a p here is rounded where the kernel rounds it, so the two
    differ only by float32 sums taken in another order.  Such a difference
    flips the bf16 rounding of a p that lies within ``P_SLACK`` of the
    midpoint between two bf16 values (or on it, where the two round a tie
    to even and the kernel's p is an ulp off), which moves the output by
    up to one bf16 ulp of p times |v| / l: in a row that sees few keys
    that is more than any fixed tolerance of the rest.
    ``slack``: also return, per output element, the most that such flips
    can move it (0 where no p of its row lies that near a midpoint), so
    that a check can allow exactly them.  Same layout as
    :func:`reference_attention`; returns float32 (with ``slack``, the pair
    (out, slack)).  For tests and ``chip_smoke.py``; no path of the port
    calls it."""
    bhq, sq, hd = q.shape
    bhkv, skv, _ = k.shape
    group = bhq // bhkv
    qf = q.to(torch.float32)
    kf = torch.repeat_interleave(k.to(torch.float32), group, dim=0)
    vf = torch.repeat_interleave(v.to(torch.float32), group, dim=0)
    # the kernel's float32 constants: sm_scale as the launcher passes it,
    # then its product with log2(e)
    sm_scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    scale2 = sm_scale * torch.tensor(LOG2E, dtype=torch.float32)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((bhq, sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((bhq, sq, 1), dtype=torch.float32, device=q.device)
    o = torch.zeros((bhq, sq, v.shape[-1]), dtype=torch.float32,
                    device=q.device)
    flips = torch.zeros_like(o)
    for k0 in range(0, skv, KV_TILE):
        k1 = min(k0 + KV_TILE, skv)
        s = torch.einsum("bqd,bkd->bqk", qf, kf[:, k0:k1])
        if softcap > 0.0:
            s = softcap * torch.tanh(s * sm_scale.item() / softcap) * LOG2E
        else:
            s = s * scale2.item()
        k_pos = torch.arange(k0, k1, device=q.device)[None, :]
        mask = torch.ones((sq, k1 - k0), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos <= q_pos
        if window > 0:
            mask &= k_pos > q_pos - window
        s = torch.where(mask[None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(m_new == NEG_INF, 0.0, m_new)
        corr = torch.exp2(m - m_use)
        p = torch.exp2(s - m_use)
        l = corr * l + p.sum(-1, keepdim=True)
        o = o * corr + torch.einsum("bqk,bkd->bqd", _bf16(p), vf[:, k0:k1])
        if slack:
            # the other bf16 neighbour of a p that near a midpoint
            near = _bf16(p)
            other = torch.maximum((_bf16(p * (1.0 + P_SLACK)) - near).abs(),
                                  (_bf16(p * (1.0 - P_SLACK)) - near).abs())
            flips = flips * corr + torch.einsum("bqk,bkd->bqd", other,
                                                vf[:, k0:k1].abs())
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    return (o / l, flips / l) if slack else o / l


def row_lse(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
            window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """What the forward's LSE instance writes, in plain torch: each q row's
    log-sum-exp of its visible scores (scaled by 1 / sqrt(hd), soft-capped)
    in log2 units, (BHq, Sq) float32; 0 for a row that sees no key.  Same
    layout as :func:`reference_attention`.  For tests and ``chip_smoke.py``;
    no path of the port calls it."""
    s, mask, _ = _scores(q, k, k, causal, window, softcap)
    lse = torch.logsumexp(torch.where(mask[None], s, -math.inf), dim=-1)
    return torch.where(mask.any(-1)[None], lse * (1.0 / math.log(2.0)), 0.0)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, d_out: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0, lse: torch.Tensor = None,
                  bf16_products: bool = False, out_dtype=None):
    """The backward kernel's arithmetic in plain torch (a model of
    ``csrc/flash_attention_bwd.cu``, not autograd): D = rowsum(dO o out),
    P = exp(s - lse) where visible, lse the row log-sum-exp over the visible
    keys (the float32-core kernels: exp(s - m) / l, m the row max and l the
    sum of exp(s - m)), dS = P o (dP - D) (times 1 - (s / cap)^2 under the
    soft-cap), dq = dS . k / sqrt(hd), dk = dS^T . q / sqrt(hd) summed over
    each kv head's q heads, dv = P^T . dO likewise.  ``lse``: the rows'
    log-sum-exp in log2 units, (BHq, Sq) or wider (the forward's LSE output,
    :func:`row_lse`), P = 2^(s log2(e) - lse), as the tensor-core kernels
    compute it; computed here when None.  ``bf16_products``: P and dS
    rounded to bf16 before the products that take them, the sums in float32
    (the tensor-core kernels' arithmetic).  Same layout as
    :func:`reference_attention`; returns (dq, dk, dv) in ``out_dtype``
    (q's dtype when None), computed in float32.  For tests and
    ``chip_smoke.py``; no path of the port calls it."""
    bhq, sq, hd = q.shape
    bhkv, skv, _ = k.shape
    group = bhq // bhkv
    qf, of, dof = (t.to(torch.float32) for t in (q, out, d_out))
    kf = torch.repeat_interleave(k.to(torch.float32), group, dim=0)
    vf = torch.repeat_interleave(v.to(torch.float32), group, dim=0)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    if lse is None:
        lse = torch.logsumexp(torch.where(mask[None], s, -math.inf), dim=-1)
        p = torch.where(mask[None], torch.exp(s - lse[..., None]), 0.0)
    else:
        log2e = 1.0 / math.log(2.0)
        p = torch.where(mask[None], torch.exp2(
            s * log2e - lse[:, :sq, None].to(torch.float32)), 0.0)
    d = (dof * of).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bqd,bkd->bqk", dof, vf) - d)
    if softcap > 0.0:
        ds = ds * (1.0 - (s / softcap) ** 2)
    if bf16_products:
        p, ds = _bf16(p), _bf16(ds)
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, qf) * scale
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dk = dk.reshape(bhkv, group, skv, hd).sum(1)
    dv = dv.reshape(bhkv, group, skv, hd).sum(1)
    dtypes = ((q.dtype, k.dtype, v.dtype) if out_dtype is None
              else (out_dtype,) * 3)
    return tuple(t.to(dt) for t, dt in zip((dq, dk, dv), dtypes))
