"""Entry point of the expert GEMM: the plain torch version on CPU tensors
(differentiated by autograd), the CUDA kernel on CUDA tensors (the
counterpart of the JAX package's ``kernels/moe_gemm/ops.py``; the kernel
picks its own tiles, so there are no block arguments).  Under autograd the
card runs :class:`ExpertGemm`, whose gradient is two more launches of the
same kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_gemm import kernel, ref


class ExpertGemm(torch.autograd.Function):
    """y = x . w per expert, differentiable: dX = dY . W^T and dW = X^T . dY
    by ``kernel.expert_gemm_bwd`` (the forward kernel on transposed copies
    of its operands)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return kernel.expert_gemm_fwd(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return kernel.expert_gemm_bwd(x, w, dy.to(x.dtype).contiguous(),
                                      *ctx.needs_input_grad[:2])


def expert_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d), w: (E, d, f) -> (E, C, f) in x's dtype, accumulated in
    float32.  Tensors that are both on the CPU take the plain version (its
    gradient is autograd's); otherwise the kernel launches, or raises, and
    where a gradient is wanted it launches twice more in the backward."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return ref.reference_expert_gemm(x, w)
    x, w = x.contiguous(), w.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return ExpertGemm.apply(x, w)
    return kernel.expert_gemm_fwd(x, w)
