"""Entry point of the expert GEMM: the plain torch version on CPU tensors, the
CUDA kernel on CUDA tensors (the counterpart of the JAX package's
``kernels/moe_gemm/ops.py``; the kernel picks its own tiles, so there are no
block arguments)."""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_gemm import kernel, ref


def expert_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d), w: (E, d, f) -> (E, C, f) in x's dtype, accumulated in
    float32.  Tensors that are both on the CPU take the plain version;
    otherwise the kernel launches, or raises."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return ref.reference_expert_gemm(x, w)
    return kernel.expert_gemm_fwd(x.contiguous(), w.contiguous())
