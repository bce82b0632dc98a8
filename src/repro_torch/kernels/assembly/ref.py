"""Plain torch version of the assembly tile, written after the JAX package's
``kernels/assembly/ref.py::reference_tile`` and ``assembly/execute.py::
tile_kernel`` (the application path).  The CPU tests use it, the entry
point takes it for CPU tensors, and ``chip_smoke.py`` holds the CUDA kernel
(``csrc/assembly_tile.cu``) against it on the card.

Order of operations, which the kernel repeats: ``r_q``, ``w_q`` and
``0.05 * r_q`` are Python doubles that torch rounds once to float32 where
they meet a float32 tensor (as JAX's weak types do), ``3 * d * r_q`` runs
left to right in float32, the squares are summed x, y, z in that order,
and the ladder accumulates q = 0 .. Q-1.
"""
from __future__ import annotations

import torch

WAVENUMBER = 3.0


def reference_tile(pr: torch.Tensor, pc: torch.Tensor, couple: torch.Tensor,
                   quad_order: int, *,
                   mxu_distance: bool = False) -> torch.Tensor:
    """pr: (nr, 3), pc: (nc, 3), couple: bool (nr, nc) -> (nr, nc) float32.

    ``mxu_distance`` builds the squared distance as ``max((|x|^2 + |y|^2) -
    2<x, y>, 0)``, the expansion the TPU kernel ran on its matrix unit: it
    loses accuracy to cancellation at near-coincident pairs."""
    pr = pr[:, :3].to(torch.float32)
    pc = pc[:, :3].to(torch.float32)
    if mxu_distance:
        xx = (pr[:, 0] * pr[:, 0] + pr[:, 1] * pr[:, 1]) + pr[:, 2] * pr[:, 2]
        yy = (pc[:, 0] * pc[:, 0] + pc[:, 1] * pc[:, 1]) + pc[:, 2] * pc[:, 2]
        xy = ((pr[:, None, 0] * pc[None, :, 0]
               + pr[:, None, 1] * pc[None, :, 1])
              + pr[:, None, 2] * pc[None, :, 2])
        sq = torch.clamp_min((xx[:, None] + yy[None, :]) - 2.0 * xy, 0.0)
    else:
        diff = pr[:, None, :] - pc[None, :, :]
        sq = ((diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
              + diff[..., 2] * diff[..., 2])
    d = torch.sqrt(sq + 1e-12)
    kd = WAVENUMBER * d
    w_q = 1.0 / quad_order
    acc = torch.zeros_like(d)
    for q in range(quad_order):
        r_q = (q + 0.5) / quad_order
        acc = acc + w_q * torch.cos(kd * r_q) / (d + 0.05 * r_q + 1e-3)
    return torch.where(couple.to(torch.bool), acc, 0.0)
