"""Entry point of flash attention in the model's layout: the plain torch
version on CPU tensors (differentiated by autograd), the CUDA kernels on CUDA
tensors (the counterpart of the JAX package's ``kernels/flash/ops.py``).
Under autograd the card runs :class:`FlashAttention`: the forward kernel,
and the backward kernel for its gradient.  On ``meta`` tensors (the
dry-run, ``launch/dryrun.py``) nothing runs: an empty output of the right
shape, and the kernels' FLOPs and bytes added to the active count
(``roofline.add_kernel``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import roofline
from repro_torch.kernels.flash import kernel, ref


def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """The (q, k) pairs that a head's rows attend to: row i sees keys
    0..i (causal), the last ``window`` of them (a window), or all."""
    if not causal:
        return sq * skv
    seen = np.minimum(np.arange(1, sq + 1, dtype=np.int64), skv)
    if window:
        seen = np.minimum(seen, window)
    return int(seen.sum())


def cost(q, k, causal: bool, window: int, backward: bool = False):
    """(FLOPs, bytes) of the forward (backward) kernel in the folded
    layout: 4 (10) hd operations a visible pair; q, k, v read and the
    output written (and dO read, dq, dk, dv written) once."""
    pairs = q.shape[0] * visible_pairs(q.shape[1], k.shape[1], causal,
                                       window)
    elem = q.element_size()
    if backward:
        return 10 * pairs * q.shape[2], elem * (4 * q.numel()
                                                + 4 * k.numel())
    return 4 * pairs * q.shape[2], elem * (2 * q.numel() + 2 * k.numel())


class _MetaFlash(torch.autograd.Function):
    """The kernels on ``meta``: shapes, and the kernels' work counted."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.args = (q, k, causal, window)
        roofline.add_kernel("flash_fwd", *cost(q, k, causal, window))
        return torch.empty_like(q)

    @staticmethod
    def backward(ctx, d_out):
        q, k, causal, window = ctx.args
        roofline.add_kernel("flash_bwd", *cost(q, k, causal, window, True))
        return (torch.empty_like(q), torch.empty_like(k),
                torch.empty_like(k), None, None)


class FlashAttention(torch.autograd.Function):
    """The kernels in the folded layout, q (BHq, Sq, hd), k and v (BHkv,
    Skv, hd), as one differentiable function: the forward kernel's output,
    and dq, dk, dv from the backward kernel (``csrc/flash_attention_bwd.cu``)
    on q, k, v, that output and its gradient.  Where the backward runs on
    the tensor cores (``kernel.tc_backward``) the forward launches its LSE
    instance (the same output) and keeps the row statistics for it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, block_q, block_k):
        lse = None
        if kernel.tc_backward(q.dtype, q.shape[-1]):
            out, lse = kernel.flash_attention_fwd(
                q, k, v, causal=causal, window=window, softcap=softcap,
                block_q=block_q, block_k=block_k, with_lse=True)
        else:
            out = kernel.flash_attention_fwd(
                q, k, v, causal=causal, window=window, softcap=softcap,
                block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap = ctx.mask
        dq, dk, dv = kernel.flash_attention_bwd(
            q, k, v, out, d_out.to(q.dtype).contiguous(), lse=lse,
            causal=causal, window=window, softcap=softcap)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, block_q: int = kernel.TILE,
                    block_k: int = kernel.TILE) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd).

    GQA layout contract: q heads are grouped so that head h uses kv head
    h // (Hq // Hkv), as ``models.attention`` groups them.  Heads fold
    kv-major into (B * Hkv * group, S, hd), so the kernel's ``bh // group``
    lands on the right kv head.  ``block_q`` x ``block_k`` is the float32
    kernel's tile (at most 64 x 64); the bf16 kernel's is fixed and takes
    only the default.  Tensors that are all on the CPU take the plain
    version (its gradient is autograd's); otherwise the kernel launches, or
    raises, and where a gradient is wanted the backward kernel computes
    it."""
    b, sq, hq, hd = q.shape
    _, skv, hkv, _ = k.shape
    group = hq // hkv
    qt = q.transpose(1, 2).reshape(b, hkv, group, sq, hd)
    qt = qt.reshape(b * hkv * group, sq, hd).contiguous()
    kt = k.transpose(1, 2).reshape(b * hkv, skv, hd).contiguous()
    vt = v.transpose(1, 2).reshape(b * hkv, skv, hd).contiguous()
    if all(t.device.type == "cpu" for t in (q, k, v)):
        out = ref.reference_attention(qt, kt, vt, causal=causal,
                                      window=window, softcap=softcap)
    elif q.is_meta:
        out = _MetaFlash.apply(qt, kt, vt, causal, window)
    elif torch.is_grad_enabled() and any(t.requires_grad
                                         for t in (qt, kt, vt)):
        out = FlashAttention.apply(qt, kt, vt, causal, window, softcap,
                                   block_q, block_k)
    else:
        out = kernel.flash_attention_fwd(qt, kt, vt, causal=causal,
                                         window=window, softcap=softcap,
                                         block_q=block_q, block_k=block_k)
    return out.reshape(b, hq, sq, hd).transpose(1, 2)
