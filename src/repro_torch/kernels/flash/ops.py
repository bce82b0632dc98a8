"""Entry point of flash attention in the model's layout: the plain torch
version on CPU tensors, the CUDA kernel on CUDA tensors (the counterpart of
the JAX package's ``kernels/flash/ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash import kernel, ref


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
    version; otherwise the kernel launches, or raises."""
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
    else:
        out = kernel.flash_attention_fwd(qt, kt, vt, causal=causal,
                                         window=window, softcap=softcap,
                                         block_q=block_q, block_k=block_k)
    return out.reshape(b, hq, sq, hd).transpose(1, 2)
