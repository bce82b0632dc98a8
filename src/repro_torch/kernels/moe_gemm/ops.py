"""Entry point of the expert GEMM: the plain torch version on CPU tensors
(differentiated by autograd), the CUDA kernel on CUDA tensors (the
counterpart of the JAX package's ``kernels/moe_gemm/ops.py``; the kernel
picks its own tiles, so there are no block arguments).  Under autograd the
card runs :class:`ExpertGemm`, whose gradient is two more launches of the
kernel (its transpose-bit variants on the operands where they lie, for bf16
with d and f multiples of 8).  On ``meta`` tensors (the dry-run) nothing
runs: an empty output, and the kernels' FLOPs and bytes added to the
active count (``roofline.add_kernel``)."""
from __future__ import annotations

import torch

from repro_torch import roofline
from repro_torch.kernels.moe_gemm import kernel, ref


def cost(x, w, backward: bool = False):
    """(FLOPs, bytes) of the forward (backward: dX and dW) launches: 2
    (4) E C d f operations; x and w read and y written (and dY read, dX
    and dW written) once."""
    e, c, d = x.shape
    f = w.shape[2]
    elem = x.element_size()
    if backward:
        return 4 * e * c * d * f, elem * (2 * x.numel() + 2 * w.numel()
                                          + e * c * f)
    return 2 * e * c * d * f, elem * (x.numel() + w.numel() + e * c * f)


class _MetaGemm(torch.autograd.Function):
    """The kernels on ``meta``: shapes, and the kernels' work counted."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.args = (x, w)
        roofline.add_kernel("expert_gemm_fwd", *cost(x, w))
        return x.new_empty((x.shape[0], x.shape[1], w.shape[2]))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.args
        roofline.add_kernel("expert_gemm_bwd", *cost(x, w, True))
        return torch.empty_like(x), torch.empty_like(w)


class ExpertGemm(torch.autograd.Function):
    """y = x . w per expert, differentiable: dX = dY . W^T and dW = X^T . dY
    by ``kernel.expert_gemm_bwd``, one launch each (as
    ``kernel.plan_bwd`` lays them out)."""

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
    if x.is_meta:
        return _MetaGemm.apply(x, w)
    x, w = x.contiguous(), w.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return ExpertGemm.apply(x, w)
    return kernel.expert_gemm_fwd(x, w)
