"""AdamW as the JAX package writes it (``repro/optim/adamw.py``), used by
the cost-model FNN (§VI-D cites AdamW [36] for better generalization and
convergence).

It is not ``torch.optim.AdamW`` with its defaults: ``b2 = 0.95``; the
gradients are clipped by their global norm with scale ``min(1, clip_norm /
max(gnorm, 1e-9))`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the
norm instead); and the weight decay is added to the step, ``delta + wd *
p``, before the learning rate multiplies it.  Moments are float32; one step
counter serves every parameter, as the reference's state does.

``lr`` is a float or a schedule (``step -> lr``, e.g.
``optim.schedule.warmup_cosine``), read at the update's step counted from 1,
as the reference reads it.  :meth:`AdamW.state_leaves` and
:meth:`AdamW.load_state_leaves` give and take the state, the reference's
``AdamWState(step, m, v)``, as flat lists in the order of the parameters the
optimizer was given: the LM trainer checkpoints it that way and permutes
the moments of re-placed experts with the experts.  On a mesh each rank
updates its shards (every step but the clipping is elementwise), and
``norm_reduce`` sums each leaf's squares over the mesh axes it is sharded
on, so that the clipping norm is the whole model's.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Union

import numpy as np
import torch


def global_norm(tensors, reduce=None) -> torch.Tensor:
    """The L2 norm of all ``tensors``; ``reduce(i, s)``, when given, maps
    tensor i's sum of squares to the whole leaf's (a mesh rank's shard
    summed over the axes it is sharded on)."""
    if reduce is None:
        return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                              for t in tensors))
    return torch.sqrt(sum(reduce(i, torch.sum(torch.square(
        t.to(torch.float32)))) for i, t in enumerate(tensors)))


class AdamW(torch.optim.Optimizer):
    def __init__(self, params, lr: Union[float, Callable[[int], float]], *,
                 b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0, clip_norm: float = 1.0,
                 norm_reduce=None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        self.clip_norm = clip_norm
        self.norm_reduce = norm_reduce
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
            gnorm = global_norm(grads.values(), self.norm_reduce)
            scale = torch.clamp(self.clip_norm
                                / torch.clamp_min(gnorm, 1e-9), max=1.0)
        step = np.float32(self.steps)
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            lr = group["lr"](self.steps) if callable(group["lr"]) \
                else group["lr"]
            bc1 = float(np.float32(1) - np.float32(b1) ** step)
            bc2 = float(np.float32(1) - np.float32(b2) ** step)
            for p in group["params"]:
                # the reference's expressions, op for op, in place where
                # a temporary would be thrown away (the same roundings)
                st = self.moments(p)
                m, v = st["m"], st["v"]
                g = grads[p].to(torch.float32) * scale
                m.mul_(b1).add_(g * (1 - b1))
                v.mul_(b2).add_(g.square_().mul_(1 - b2))
                delta = (m / bc1).div_(v.div(bc2).sqrt_().add_(eps))
                if group["weight_decay"]:
                    delta.add_(p.to(torch.float32) * group["weight_decay"])
                p.copy_(p.to(torch.float32) - delta.mul_(lr))

    def moments(self, p: torch.Tensor) -> dict:
        """The state of ``p``, with zero float32 moments before its first
        update."""
        st = self.state[p]
        if not st:
            st["m"] = torch.zeros_like(p, dtype=torch.float32)
            st["v"] = torch.zeros_like(p, dtype=torch.float32)
        return st

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]]

    def state_leaves(self) -> List[torch.Tensor]:
        """``[steps (int32 scalar tensor), m..., v...]``, m and v in the order
        of the parameters; the moments themselves, not copies."""
        ps = self._params()
        return ([torch.tensor(self.steps, dtype=torch.int32)]
                + [self.moments(p)["m"] for p in ps]
                + [self.moments(p)["v"] for p in ps])

    def load_state_leaves(self, leaves: Sequence[torch.Tensor]) -> None:
        """Set the state from a list laid out as :meth:`state_leaves`
        gives it (copied onto each parameter's device); raises on a count,
        shape or dtype that does not fit."""
        ps = self._params()
        if len(leaves) != 1 + 2 * len(ps):
            raise ValueError(f"AdamW state: {len(leaves)} leaves for "
                             f"{len(ps)} parameters")
        for i, p in enumerate(ps):
            st = self.state[p]
            for key, t in (("m", leaves[1 + i]),
                           ("v", leaves[1 + len(ps) + i])):
                if tuple(t.shape) != tuple(p.shape) \
                        or t.dtype != torch.float32:
                    raise ValueError(f"AdamW state: {key} of parameter {i} "
                                     f"is {tuple(t.shape)} {t.dtype}, the "
                                     f"parameter {tuple(p.shape)}")
                st[key] = t.to(p.device, copy=True)
        self.steps = int(leaves[0])
