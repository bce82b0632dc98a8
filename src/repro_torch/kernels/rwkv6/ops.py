"""Entry point of WKV6 in the model's layout: the plain chunked torch version
on CPU tensors, the CUDA kernel on CUDA tensors (the counterpart of the JAX
package's ``kernels/rwkv6/ops.py``).  On ``meta`` tensors (the dry-run)
nothing runs: empty outputs, and the kernel's FLOPs and bytes added to the
active count (``roofline.add_kernel``)."""
from __future__ import annotations

import torch

from repro_torch import roofline
from repro_torch.kernels.rwkv6 import kernel, ref


def cost(r, log_w, u):
    """(FLOPs, bytes): 4 hd^2 float32 operations a token and head; r, k,
    v read and y written in r's dtype, log_w, u and the final state
    float32, each once."""
    b, s, h, hd = r.shape
    return (4 * hd * hd * b * s * h,
            4 * r.numel() * r.element_size() + 4 * log_w.numel()
            + 4 * u.numel() + 4 * b * h * hd * hd)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         log_w: torch.Tensor, u: torch.Tensor, *, chunk: int = 16):
    """r, k, v, log_w: (B, S, H, hd); u: (H, hd).  Returns y (B, S, H, hd)
    in r's dtype and the final state (B, H, hd, hd) float32.

    Tensors that are all on the CPU take the plain chunked version
    (``chunk`` tokens a step, ``ref.wkv6_chunked``; autograd differentiates
    it); otherwise the kernel launches (it walks the tokens one by one, so
    ``chunk`` is not read), or raises.  The kernel has no backward yet: on
    the card, a call that autograd would record raises rather than return
    a tensor whose gradient is silently dropped."""
    if all(t.device.type == "cpu" for t in (r, k, v, log_w, u)):
        y, state = ref.wkv6_chunked(r, k, v, log_w, u, chunk=chunk)
        return y.to(r.dtype), state
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (r, k, v, log_w, u)):
        raise RuntimeError(
            "wkv6: the CUDA kernel has no backward yet (ROADMAP queue 2, "
            "F14); train rwkv6 on the CPU, or run under torch.no_grad()")
    if r.is_meta:
        roofline.add_kernel("wkv6", *cost(r, log_w, u))
        b, s, h, hd = r.shape
        return (torch.empty_like(r),
                r.new_empty((b, h, hd, hd), dtype=torch.float32))
    return kernel.wkv6_fwd(r.contiguous(), k.contiguous(), v.contiguous(),
                           log_w.to(torch.float32).contiguous(),
                           u.to(torch.float32).contiguous())
