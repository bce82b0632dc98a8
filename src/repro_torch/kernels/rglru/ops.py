"""Entry point of the RG-LRU scan: the plain torch version on CPU tensors,
the CUDA kernel on CUDA tensors (the counterpart of the JAX package's
``kernels/rglru/ops.py``; the kernel walks the sequence one step at a time,
so there are no chunk or block arguments)."""
from __future__ import annotations

import torch

from repro_torch.kernels.rglru import kernel, ref


def rglru_scan_op(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log_a, b: (B, S, W) -> h (B, S, W) in b's dtype, with
    h_t = exp(log_a_t) h_{t-1} + b_t from h_0 = 0.  Tensors that are both
    on the CPU take the plain version (autograd differentiates it);
    otherwise the kernel launches, or raises.  The kernel has no backward
    yet: on the card, a call that autograd would record raises rather than
    return a tensor whose gradient is silently dropped."""
    if log_a.device.type == "cpu" and b.device.type == "cpu":
        return ref.reference_rglru(log_a, b)
    if torch.is_grad_enabled() and (log_a.requires_grad or b.requires_grad):
        raise RuntimeError(
            "rglru_scan_op: the CUDA kernel has no backward yet (ROADMAP "
            "queue 2, F14); train recurrentgemma on the CPU, or run under "
            "torch.no_grad()")
    return kernel.rglru_fwd(log_a.to(torch.float32).contiguous(),
                            b.contiguous())
