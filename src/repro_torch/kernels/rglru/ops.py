"""Entry point of the RG-LRU scan: the plain torch version on CPU tensors
(differentiated by autograd), the CUDA kernels on CUDA tensors (the
counterpart of the JAX package's ``kernels/rglru/ops.py``; the kernels
take their launches from the shape, ``kernel.fwd_geometry`` and
``kernel.bwd_geometry``, so there are no chunk or block arguments).
Under autograd the card runs :class:`RgLruScan`: the forward kernel, and
the backward kernel for its gradient.  On ``meta`` tensors
(the dry-run) nothing runs: an empty output, and the kernels' FLOPs and
bytes added to the active count (``roofline.add_kernel``)."""
from __future__ import annotations

import torch

from repro_torch import roofline
from repro_torch.kernels.rglru import kernel, ref


def cost(log_a, backward: bool = False):
    """(FLOPs, bytes) of the forward: exp, multiply and add an element;
    log_a and b read and h written once, float32.  Of the backward: a
    multiply and an add for g, an exp and two multiplies for dlog_a;
    log_a, h and dh read, dlog_a and db written once."""
    if backward:
        return 5 * log_a.numel(), 5 * 4 * log_a.numel()
    return 3 * log_a.numel(), 3 * 4 * log_a.numel()


class _MetaRgLru(torch.autograd.Function):
    """The kernels on ``meta``: shapes, and the kernels' work counted."""

    @staticmethod
    def forward(ctx, log_a, b):
        ctx.log_a = log_a
        roofline.add_kernel("rglru", *cost(log_a))
        return torch.empty_like(b)

    @staticmethod
    def backward(ctx, dh):
        roofline.add_kernel("rglru_bwd", *cost(ctx.log_a, True))
        return torch.empty_like(ctx.log_a), torch.empty_like(dh)


class RgLruScan(torch.autograd.Function):
    """The kernels as one differentiable function of (log_a float32, b),
    contiguous: the forward kernel's h, and dlog_a, db from the backward
    kernel on log_a, the saved h and dh."""

    @staticmethod
    def forward(ctx, log_a, b):
        h = kernel.rglru_fwd(log_a, b)
        ctx.save_for_backward(log_a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        log_a, h = ctx.saved_tensors
        return kernel.rglru_bwd(log_a, h, dh.to(h.dtype).contiguous())


def rglru_scan_op(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log_a, b: (B, S, W) -> h (B, S, W) in b's dtype, with
    h_t = exp(log_a_t) h_{t-1} + b_t from h_0 = 0.  Tensors that are both
    on the CPU take the plain version (autograd differentiates it);
    otherwise the kernel launches, or raises, and where a gradient is
    wanted the backward kernel computes it."""
    if log_a.device.type == "cpu" and b.device.type == "cpu":
        return ref.reference_rglru(log_a, b)
    if log_a.is_meta:
        return _MetaRgLru.apply(log_a, b)
    log_a, b = log_a.to(torch.float32).contiguous(), b.contiguous()
    if torch.is_grad_enabled() and (log_a.requires_grad or b.requires_grad):
        return RgLruScan.apply(log_a, b)
    return kernel.rglru_fwd(log_a, b)
