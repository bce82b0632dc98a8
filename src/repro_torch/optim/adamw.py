"""AdamW as the JAX package writes it (``repro/optim/adamw.py``), used by
the cost-model FNN (§VI-D cites AdamW [36] for better generalization and
convergence).

It is not ``torch.optim.AdamW`` with its defaults: ``b2 = 0.95``; the
gradients are clipped by their global norm with scale ``min(1, clip_norm /
max(gnorm, 1e-9))`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the
norm instead); and the weight decay is added to the step, ``delta + wd *
p``, before the learning rate multiplies it.  Moments are float32; one step
counter serves every parameter, as the reference's state does.
"""
from __future__ import annotations

import numpy as np
import torch


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                          for t in tensors))


class AdamW(torch.optim.Optimizer):
    def __init__(self, params, lr: float, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0, clip_norm: float = 1.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        self.clip_norm = clip_norm
        self.steps = 0

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        self.steps += 1
        grads = {p: torch.zeros_like(p) if p.grad is None else p.grad
                 for g in self.param_groups for p in g["params"]}
        scale = 1.0
        if self.clip_norm:
            gnorm = global_norm(grads.values())
            scale = torch.clamp(self.clip_norm
                                / torch.clamp_min(gnorm, 1e-9), max=1.0)
        step = np.float32(self.steps)
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            bc1 = float(np.float32(1) - np.float32(b1) ** step)
            bc2 = float(np.float32(1) - np.float32(b2) ** step)
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st["m"] = torch.zeros_like(p, dtype=torch.float32)
                    st["v"] = torch.zeros_like(p, dtype=torch.float32)
                g = grads[p].to(torch.float32) * scale
                m2 = b1 * st["m"] + (1 - b1) * g
                v2 = b2 * st["v"] + (1 - b2) * torch.square(g)
                delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
                if group["weight_decay"]:
                    delta = delta + group["weight_decay"] * p.to(torch.float32)
                p.copy_(p.to(torch.float32) - group["lr"] * delta)
                st["m"], st["v"] = m2, v2
