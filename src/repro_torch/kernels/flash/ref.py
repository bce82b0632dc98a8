"""Plain torch version of the flash-attention forward pass, written after
the JAX package's ``kernels/flash/ref.py::reference_attention``.  The CPU
tests use it, the entry point takes it for CPU tensors, and ``chip_smoke.py``
holds the CUDA kernel (``csrc/flash_attention.cu``) against it on the card;
``reference_attention_bf16_p`` models the bf16 kernel's rounding of p.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


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
