"""Plain torch version of the capacity-batched expert GEMM, written after the
JAX package's ``kernels/moe_gemm/ref.py::reference_expert_gemm``.  The CPU
tests use it, the entry point takes it for CPU tensors, and ``chip_smoke.py``
holds the CUDA kernel (``csrc/moe_gemm.cu``) against it on the card.
"""
from __future__ import annotations

import torch


def reference_expert_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d), w: (E, d, f) -> (E, C, f) in x's dtype, computed in
    float32 and rounded once."""
    return torch.einsum("ecd,edf->ecf", x.to(torch.float32),
                        w.to(torch.float32)).to(x.dtype)
