"""The CUDA assembly-tile kernel (``csrc/assembly_tile.cu``): build, bind and
launch.

Replaces the Pallas TPU kernel ``repro/kernels/assembly/kernel.py:25``
(``_tile_kernel`` / ``assembly_tile_fwd``).  Built and bound like the scorer
(``kernels/_build.py``); a failed build or launch raises, nothing falls back.
:func:`assembly_tile_fwd` launches it on CUDA tensors only, on the current
stream, and counts the launch in :data:`LAUNCHES`; ``ops.assembly_tile`` is
the entry point that also takes CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "assembly_tile.cu"

#: kernel launches, counted where the kernel is launched only
LAUNCHES = {"float32": 0}

#: threads of a block, and lanes of one entry's ladder, at most
MAX_THREADS, MAX_LANES = 256, 16
#: quadrature steps whose terms a block holds in shared memory at a time
SEGMENT = 256
_lib = None


class Geometry(NamedTuple):
    """One launch of ``csrc/assembly_tile.cu``: ``grid`` (x over columns, y
    over rows) of blocks of ``threads``, each owning a ``tile`` (rows,
    cols) of entries with ``lanes`` threads an entry, the terms of
    ``segment`` quadrature steps at a time in ``smem_bytes`` of shared
    memory."""
    grid: Tuple[int, int]
    threads: int
    lanes: int
    tile: Tuple[int, int]
    segment: int
    smem_bytes: int


@functools.lru_cache(maxsize=4096)
def launch_geometry(nr: int, nc: int, quad_order: int, block_r: int = 128,
                    block_c: int = 128) -> Geometry:
    """The launch for an (nr, nc) tile at ``quad_order`` (all >= 1).  Lanes
    an entry: the largest power of two up to sqrt(Q) and ``MAX_LANES``
    (measured fastest on an H100 at the application's Q 4, 16, 64 and 192:
    2, 4, 8 and 8 lanes); a block's tile: the caller's ``block_r`` x
    ``block_c`` cut to the ``MAX_THREADS // lanes`` entries a block holds,
    rows first.  The output does not depend on the geometry."""
    lanes = min(1 << (math.isqrt(quad_order).bit_length() - 1), MAX_LANES)
    entries = MAX_THREADS // lanes
    tile_c = min(block_c, nc, entries)
    tile_r = min(block_r, nr, entries // tile_c)
    slots = tile_r * tile_c
    segment = min(quad_order, SEGMENT)
    smem = 4 * (3 * (tile_r + tile_c) + 2 * quad_order
                + slots * (segment | 1)) + slots
    return Geometry(grid=(-(-nc // tile_c), -(-nr // tile_r)),
                    threads=-(-slots * lanes // 32) * 32, lanes=lanes,
                    tile=(tile_r, tile_c), segment=segment, smem_bytes=smem)


def reset_launches() -> None:
    LAUNCHES["float32"] = 0


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/assembly_tile.cu`` (once per process, and not at all
    when a build of the same source and flags exists) and load it.  Returns
    the library's path.  ``verbose`` prints nvcc's ``-Xptxas -v`` report."""
    global _lib
    if _lib is not None:
        return Path(_lib._name)
    lib = _build.load(SOURCE, verbose)
    lib.assembly_tile_f32.argtypes = [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    lib.assembly_tile_f32.restype = ctypes.c_int
    lib.assembly_tile_error_string.argtypes = [ctypes.c_int]
    lib.assembly_tile_error_string.restype = ctypes.c_char_p
    _lib = lib
    return Path(lib._name)


def _check(pr, pc, couple, quad_order, block_r, block_c) -> Geometry:
    tensors = (pr, pc, couple)
    dev = pr.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("assembly_tile: pr, pc, couple must all be on one "
                         "CUDA device (got "
                         f"{[str(t.device) for t in tensors]})")
    if pr.dtype != torch.float32 or pc.dtype != torch.float32 \
            or couple.dtype not in (torch.bool, torch.uint8):
        raise ValueError("assembly_tile: float32 coordinates and a bool or "
                         f"uint8 mask (got {[str(t.dtype) for t in tensors]})")
    nr, nc = pr.shape[0], pc.shape[0]
    if (pr.dim() != 2 or pc.dim() != 2 or pr.shape[1] != 3
            or pc.shape[1] != 3 or tuple(couple.shape) != (nr, nc)):
        raise ValueError("assembly_tile: expected pr (nr, 3), pc (nc, 3), "
                         "couple (nr, nc), got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("assembly_tile: inputs must be contiguous")
    geo = (launch_geometry(max(nr, 1), max(nc, 1), quad_order, block_r,
                           block_c)
           if min(quad_order, block_r, block_c) >= 1 else None)
    if (geo is None or geo.smem_bytes > _build.MAX_SMEM_BYTES
            or nr * nc >= 2 ** 31 or geo.grid[1] > 65535):
        raise ValueError(f"assembly_tile: unsupported quad_order={quad_order}"
                         f", blocks ({block_r}, {block_c}) or shape "
                         f"({nr}, {nc})")
    return geo


def assembly_tile_fwd(pr: torch.Tensor, pc: torch.Tensor,
                      couple: torch.Tensor, *, quad_order: int,
                      block_r: int = 128, block_c: int = 128,
                      mxu_distance: bool = False) -> torch.Tensor:
    """Launch the kernel: pr (nr, 3), pc (nc, 3) float32, couple (nr, nc)
    bool or uint8, all contiguous on one CUDA device -> (nr, nc) float32."""
    geo = _check(pr, pc, couple, quad_order, block_r, block_c)
    nr, nc = pr.shape[0], pc.shape[0]
    out = torch.empty((nr, nc), dtype=torch.float32, device=pr.device)
    if out.numel() == 0:
        return out
    build()
    with torch.cuda.device(pr.device):
        stream = torch.cuda.current_stream(pr.device).cuda_stream
        rc = _lib.assembly_tile_f32(
            pr.data_ptr(), pc.data_ptr(), couple.data_ptr(), out.data_ptr(),
            nr, nc, quad_order, *geo.tile, geo.lanes, geo.segment,
            geo.threads, geo.smem_bytes, int(mxu_distance), stream)
    if rc != 0:
        raise RuntimeError("assembly_tile kernel launch failed: "
                           + _lib.assembly_tile_error_string(rc).decode())
    LAUNCHES["float32"] += 1
    return out
