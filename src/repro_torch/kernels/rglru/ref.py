"""Plain torch version of the RG-LRU scan, written after the JAX package's
``kernels/rglru/ref.py::reference_rglru``, and of its gradient
(:func:`rglru_backward`).  The CPU tests use them, the entry point takes
the scan for CPU tensors (autograd differentiates it), and ``chip_smoke.py``
holds the CUDA kernels (``csrc/rglru.cu``) against them on the card.
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
