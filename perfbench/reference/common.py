"""Layers both families share: RMS norm (the weight a delta around 1),
rotary embeddings (the halves rotated), activations; and the weights'
float32 copy."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1 + w)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd) at positions 0..S-1: each half-pair (x1, x2) rotated
    by position / theta ** (2 i / hd)."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def as_float32(tree):
    """A copy of a tree of tensors (dicts and lists) in float32."""
    if isinstance(tree, dict):
        return {k: as_float32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [as_float32(v) for v in tree]
    return tree.detach().to(torch.float32).clone()
