"""Plain torch version of the RG-LRU scan, written after the JAX package's
``kernels/rglru/ref.py::reference_rglru``, and of its gradient
(:func:`rglru_backward`).  The CPU tests use them, the entry point takes
the scan for CPU tensors (autograd differentiates it), and ``chip_smoke.py``
holds the CUDA kernels (``csrc/rglru.cu``) against them on the card.
:func:`rglru_chunked` is the chunked forward kernel's arithmetic, for the
tests.
"""
from __future__ import annotations

import torch


def reference_rglru(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log_a, b: (B, S, W) -> h (B, S, W) in b's dtype, with
    h_t = exp(log_a_t) h_{t-1} + b_t from h_0 = 0, step by step in
    float32."""
    a = torch.exp(log_a.to(torch.float32))
    bf = b.to(torch.float32)
    h = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32,
                    device=b.device)
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(b.dtype)


def rglru_chunked(log_a: torch.Tensor, b: torch.Tensor, chunks: int,
                  steps: int, segments: int = 8) -> torch.Tensor:
    """The chunked forward kernel's arithmetic in plain torch: time in
    ``chunks`` chunks of ``steps`` steps, each in ``segments`` segments;
    each segment walked from h = 0 for its end state e and the product A
    of its a (a = exp(log_a), float32, step by step); a chunk's summary its
    segments' folded in order (e = A_v e + e_v, A = A_v A); the carry into
    chunk k the chunks before it folded in order, into a segment the
    chunk's carry with the segments before it folded on; then each segment
    walked again from its carry, as :func:`reference_rglru` walks.  Same
    arguments and result as :func:`reference_rglru`; the first segment is
    its bits.  For tests; no path of the port calls it."""
    a = torch.exp(log_a.to(torch.float32))
    bf = b.to(torch.float32)
    bsz, s, w = a.shape
    seg = steps // segments
    zero = torch.zeros((bsz, w), dtype=torch.float32, device=b.device)

    def fold(h, prod, e):
        return prod * h + e

    parts = []  # [chunk][segment] (A, e)
    for k in range(chunks):
        row = []
        for v in range(segments):
            e, prod = zero.clone(), torch.ones_like(zero)
            for t in range(k * steps + v * seg,
                           min(s, k * steps + (v + 1) * seg)):
                e = fold(e, a[:, t], bf[:, t])
                prod = a[:, t] * prod
            row.append((prod, e))
        parts.append(row)
    summaries = []
    for row in parts[:-1]:
        e, prod = zero.clone(), torch.ones_like(zero)
        for pa, pe in row:
            e = fold(e, pa, pe)
            prod = pa * prod
        summaries.append((prod, e))
    hs = []
    for k in range(chunks):
        carry = zero.clone()
        for pa, pe in summaries[:k]:
            carry = fold(carry, pa, pe)
        for v in range(segments):
            h = carry.clone()
            for pa, pe in parts[k][:v]:
                h = fold(h, pa, pe)
            for t in range(k * steps + v * seg,
                           min(s, k * steps + (v + 1) * seg)):
                h = fold(h, a[:, t], bf[:, t])
                hs.append(h)
    return torch.stack(hs, dim=1).to(b.dtype)


def rglru_backward(log_a: torch.Tensor, h: torch.Tensor,
                   dh: torch.Tensor):
    """The gradient of :func:`reference_rglru` from its output h: log_a, h,
    dh (B, S, W) -> (dlog_a, db) float32, with ``g_t = dh_t + a_{t+1}
    g_{t+1}`` walked from the end, ``db_t = g_t`` and ``dlog_a_t = g_t a_t
    h_{t-1}`` (h_{-1} = 0), step by step in float32 in the kernel's
    order."""
    a = torch.exp(log_a.to(torch.float32))
    hf, dhf = h.to(torch.float32), dh.to(torch.float32)
    g = torch.zeros_like(hf[:, 0])
    a_next = torch.zeros_like(g)
    db = torch.empty_like(hf)
    dla = torch.empty_like(hf)
    for t in reversed(range(hf.shape[1])):
        g = dhf[:, t] + a_next * g
        db[:, t] = g
        prev = hf[:, t - 1] if t > 0 else torch.zeros_like(g)
        dla[:, t] = g * a[:, t] * prev
        a_next = a[:, t]
    return dla, db
