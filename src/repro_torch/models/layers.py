"""Shared layer primitives, after the JAX package's ``models/layers.py``.

Every function keeps the reference's numerics: norms, RoPE and the soft-cap
run in float32 and cast back to the input's dtype; matrix products run in
the working dtype (bf16 products accumulate in float32 on both devices).
Parameters are plain tensors in dicts, PyTorch's idiom; the logical axes
that the reference's ``LP`` leaves carry are a parallel tree of tuples
(``*_axes`` next to each ``init_*``, gathered by
``models.model.param_axes``), which ``sharding.spec_for`` resolves on a
mesh.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F


# --------------------------------------------------------------------- init
def dense_init(gen: Optional[torch.Generator], shape: Sequence[int],
               in_axis: Union[int, Sequence[int]] = 0, scale: float = 1.0,
               dtype=torch.bfloat16, device="cuda") -> torch.Tensor:
    """Truncated-normal fan-in init: ``scale / sqrt(fan_in)`` times a
    standard normal cut to [-2, 2], drawn in float32 from ``gen`` and cast
    to ``dtype``.  On the ``meta`` device only the shape is made (``gen`` is
    not read)."""
    fan_in = int(np.prod([shape[i] for i in np.atleast_1d(in_axis)]))
    std = scale / math.sqrt(max(fan_in, 1))
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if w.is_meta:
        return w.to(dtype)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


# --------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             offset: float = 1.0) -> torch.Tensor:
    """RMSNorm in f32 (gemma convention: weight is a delta around 1)."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (offset + weight.to(torch.float32))).to(x.dtype)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the last dim in f32 (the RWKV6 output norm); the
    variance is the biased one, as ``jnp.var``'s."""
    *lead, d = x.shape
    xf = x.to(torch.float32).reshape(*lead, num_groups, d // num_groups)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    normed = ((xf - mu) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (normed * weight.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------- activations
def _silu(x):
    # jax.nn.silu's formula, so that bf16 rounds where the reference does
    return x * torch.sigmoid(x)


def activation(name: str):
    return {
        "silu": _silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "relu2": lambda x: torch.square(F.relu(x)),
    }[name]


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return cap * torch.tanh(x / cap)
    return x


# --------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, device=x.device)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..., S, hd/2)
    angles = angles[..., None, :]  # broadcast over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- gated MLP
def init_mlp(gen, d_model: int, d_ff: int, dtype=torch.bfloat16,
             device="cuda"):
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype=dtype, device=device),
        "w_up": dense_init(gen, (d_model, d_ff), dtype=dtype, device=device),
        "w_down": dense_init(gen, (d_ff, d_model), dtype=dtype, device=device),
    }


def mlp_axes():
    return {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed")}


def mlp_forward(params, x: torch.Tensor, act_name: str,
                tp=None) -> torch.Tensor:
    """The gated MLP.  With ``tp`` (a ``sharding.ModelAxis``) the params
    hold the rank's hidden columns: gate and up are column-parallel,
    ``w_down`` row-parallel, its partial output summed over the axis."""
    act = activation(act_name)
    if tp is not None:
        x = tp.enter(x)
    gate = act(torch.einsum("bsd,df->bsf", x, params["w_gate"]))
    up = torch.einsum("bsd,df->bsf", x, params["w_up"])
    y = torch.einsum("bsf,fd->bsd", gate * up, params["w_down"])
    return y if tp is None else tp.sum(y)
