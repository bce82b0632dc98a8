"""Entry point of WKV6 in the model's layout: the plain chunked torch version
on CPU tensors (differentiated by autograd), the CUDA kernels on CUDA
tensors (the counterpart of the JAX package's ``kernels/rwkv6/ops.py``).
Under autograd the card runs :class:`Wkv6`: the forward kernel, and the
backward kernel for its gradient.  On ``meta`` tensors (the dry-run)
nothing runs: empty outputs, and the kernels' FLOPs and bytes added to the
active count (``roofline.add_kernel``)."""
from __future__ import annotations

import torch

from repro_torch import roofline
from repro_torch.kernels.rwkv6 import kernel, ref


def cost(r, log_w, u, backward: bool = False):
    """(FLOPs, bytes) of the forward (backward) kernel: 4 (12) hd^2
    float32 operations a token and head; r, k, v read and y written (and
    dy read, dr, dk, dv written) in r's dtype, log_w, u and the final
    state (and dlog_w, du) float32, each once."""
    b, s, h, hd = r.shape
    if backward:
        return (12 * hd * hd * b * s * h,
                7 * r.numel() * r.element_size() + 8 * log_w.numel()
                + 8 * u.numel())
    return (4 * hd * hd * b * s * h,
            4 * r.numel() * r.element_size() + 4 * log_w.numel()
            + 4 * u.numel() + 4 * b * h * hd * hd)


class _MetaWkv6(torch.autograd.Function):
    """The kernels on ``meta``: shapes, and the kernels' work counted."""

    @staticmethod
    def forward(ctx, r, k, v, log_w, u):
        ctx.args = (r, log_w, u)
        roofline.add_kernel("wkv6", *cost(r, log_w, u))
        b, s, h, hd = r.shape
        return (torch.empty_like(r),
                r.new_empty((b, h, hd, hd), dtype=torch.float32))

    @staticmethod
    def backward(ctx, dy, d_state):
        r, log_w, u = ctx.args
        roofline.add_kernel("wkv6_bwd", *cost(r, log_w, u, True))
        return (torch.empty_like(r), torch.empty_like(r),
                torch.empty_like(r), torch.empty_like(log_w),
                torch.empty_like(u))


class Wkv6(torch.autograd.Function):
    """The kernels as one differentiable function of (r, k, v, log_w, u),
    contiguous, log_w and u float32: the forward kernel's y and final
    state, and dr, dk, dv, dlog_w, du from the backward kernel
    (``csrc/wkv6_bwd.cu``) on the saved inputs, dy and the final state's
    gradient (None where the state is unused)."""

    @staticmethod
    def forward(ctx, r, k, v, log_w, u):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, log_w, u)
        return kernel.wkv6_fwd(r, k, v, log_w, u)

    @staticmethod
    def backward(ctx, dy, d_state):
        r, k, v, log_w, u = ctx.saved_tensors
        dy = torch.zeros_like(r) if dy is None \
            else dy.to(r.dtype).contiguous()
        if d_state is not None:
            d_state = d_state.to(torch.float32).contiguous()
        return kernel.wkv6_bwd(r, k, v, log_w, u, dy, d_state)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         log_w: torch.Tensor, u: torch.Tensor, *, chunk: int = 16):
    """r, k, v, log_w: (B, S, H, hd); u: (H, hd).  Returns y (B, S, H, hd)
    in r's dtype and the final state (B, H, hd, hd) float32.

    Tensors that are all on the CPU take the plain chunked version
    (``chunk`` tokens a step, ``ref.wkv6_chunked``; autograd differentiates
    it); otherwise the kernel launches (it walks the tokens one by one, so
    ``chunk`` is not read), or raises, and where a gradient is wanted the
    backward kernel computes it."""
    if all(t.device.type == "cpu" for t in (r, k, v, log_w, u)):
        y, state = ref.wkv6_chunked(r, k, v, log_w, u, chunk=chunk)
        return y.to(r.dtype), state
    if r.is_meta:
        return _MetaWkv6.apply(r, k, v, log_w, u)
    args = (r.contiguous(), k.contiguous(), v.contiguous(),
            log_w.to(torch.float32).contiguous(),
            u.to(torch.float32).contiguous())
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return Wkv6.apply(*args)
    return kernel.wkv6_fwd(*args)
