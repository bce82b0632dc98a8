"""Entry point of the assembly tile: the plain torch version on CPU tensors,
the CUDA kernel on CUDA tensors (the counterpart of the JAX package's
``kernels/assembly/ops.py``, without its 8-lane padding, which was the
TPU's layout)."""
from __future__ import annotations

import torch

from repro_torch.kernels.assembly import kernel, ref


def assembly_tile(pr: torch.Tensor, pc: torch.Tensor, couple: torch.Tensor,
                  *, quad_order: int, block_r: int = 128, block_c: int = 128,
                  mxu_distance: bool = False) -> torch.Tensor:
    """pr: (nr, 3), pc: (nc, 3), couple: bool (nr, nc) -> (nr, nc) float32.

    ``block_r`` x ``block_c`` bounds the kernel's tile (a CUDA block owns
    at most that many entries; ``kernel.launch_geometry``); it does not
    change the result.  Tensors that are all on the CPU take the plain
    version; otherwise the kernel launches, or raises."""
    if all(t.device.type == "cpu" for t in (pr, pc, couple)):
        return ref.reference_tile(pr, pc, couple, quad_order,
                                  mxu_distance=mxu_distance)
    return kernel.assembly_tile_fwd(
        pr.to(torch.float32).contiguous(), pc.to(torch.float32).contiguous(),
        couple.to(torch.bool).contiguous(), quad_order=quad_order,
        block_r=block_r, block_c=block_c, mxu_distance=mxu_distance)
