"""Task-duration prediction FNN (paper §VI-D.2) as a ``torch.nn.Module``.

Architecture per the paper: feed-forward, 4 hidden layers x 200 neurons,
batch normalization on hidden layers, dropout, LeakyReLU (eq. 31) activation.
Trained with AdamW (``repro_torch.optim``) on mini-batches.

The port of ``repro/costmodel/network.py``.  Batch norm is written out
rather than taken from ``torch.nn.BatchNorm1d``: the reference updates the
running variance with the *biased* batch variance and normalises with
``(h - mean) * rsqrt(var + eps)``, while ``BatchNorm1d`` keeps the unbiased
one.  A training forward updates the running statistics in place (the
reference returns them as a new state).  Initialisation and dropout draw
from an explicit ``torch.Generator``, so their numbers differ from the
reference's JAX keys; parity is shown with weights carried across
(``repro_torch.convert.fnn_from_reference``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class FNNConfig:
    in_dim: int
    hidden: Tuple[int, ...] = (200, 200, 200, 200)
    dropout: float = 0.1
    leaky_slope: float = 0.01
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """Eq. (31): f(x) = x * 1_{R+}(x) + 0.01 x * 1_{R-*}(x)."""
    return torch.where(x >= 0, x, slope * x)


def dropout(h: torch.Tensor, p: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Keep each entry with probability ``1 - p``, scaled by ``1/(1-p)``."""
    keep = torch.rand(h.shape, generator=generator, device=h.device) < 1 - p
    return torch.where(keep, h / (1 - p), 0.0)


class _Layer(nn.Module):
    """One hidden layer: affine, batch norm (scale, bias and running
    statistics), in the reference's parameter order b, bn_bias, bn_scale, w
    (its sorted pytree keys)."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        d_out, kw = w.shape[1], dict(dtype=torch.float32, device=w.device)
        self.b = nn.Parameter(torch.zeros(d_out, **kw))
        self.bn_bias = nn.Parameter(torch.zeros(d_out, **kw))
        self.bn_scale = nn.Parameter(torch.ones(d_out, **kw))
        self.w = nn.Parameter(w)
        self.register_buffer("mean", torch.zeros(d_out, **kw))
        self.register_buffer("var", torch.ones(d_out, **kw))


class FNN(nn.Module):
    def __init__(self, cfg: FNNConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        dims = (cfg.in_dim,) + tuple(cfg.hidden)

        def normal(shape, var):
            return (torch.randn(shape, generator=generator, device=device,
                                dtype=torch.float32) * math.sqrt(var))

        self.layers = nn.ModuleList(
            _Layer(normal((d_in, d_out), 2.0 / d_in))
            for d_in, d_out in zip(dims[:-1], dims[1:]))
        out_w = normal((dims[-1], 1), 1.0 / dims[-1])
        self.out_b = nn.Parameter(torch.zeros(1, dtype=torch.float32,
                                              device=out_w.device))
        self.out_w = nn.Parameter(out_w)

    def forward(self, x: torch.Tensor, *, train: bool,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, in_dim) -> (B,) predictions.  ``train`` uses batch statistics
        (and updates the running ones) and dropout drawn from
        ``generator``; otherwise the running statistics, no dropout."""
        cfg = self.cfg
        h = x
        for layer in self.layers:
            h = h @ layer.w + layer.b
            if train:
                mu = h.mean(0)
                var = h.var(0, unbiased=False)
                with torch.no_grad():
                    layer.mean.copy_(cfg.bn_momentum * layer.mean
                                     + (1 - cfg.bn_momentum) * mu)
                    layer.var.copy_(cfg.bn_momentum * layer.var
                                    + (1 - cfg.bn_momentum) * var)
            else:
                mu, var = layer.mean, layer.var
            h = (h - mu) * torch.rsqrt(var + cfg.bn_eps)
            h = h * layer.bn_scale + layer.bn_bias
            h = leaky_relu(h, cfg.leaky_slope)
            if train and cfg.dropout > 0:
                h = dropout(h, cfg.dropout, generator)
        out = h @ self.out_w + self.out_b
        return out[:, 0]
