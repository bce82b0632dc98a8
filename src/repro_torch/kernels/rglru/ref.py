"""Plain torch version of the RG-LRU scan, written after the JAX package's
``kernels/rglru/ref.py::reference_rglru``.  The CPU tests use it, the entry
point takes it for CPU tensors, and ``chip_smoke.py`` holds the CUDA kernel
(``csrc/rglru.cu``) against it on the card.
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
