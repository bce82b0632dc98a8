"""The CUDA expert-GEMM kernel (``csrc/moe_gemm.cu``): build, bind and launch.

Replaces the Pallas TPU kernel ``repro/kernels/moe_gemm/kernel.py:40``
(``expert_gemm_fwd`` → ``_gemm_kernel``).  Built and bound like the port's
other kernels (``kernels/_build.py``); a failed build or launch raises,
nothing falls back.  :func:`expert_gemm_fwd` launches it on CUDA tensors
only, on the current stream, and counts the launch in :data:`LAUNCHES`;
``ops.expert_gemm`` is the entry point that also takes CPU tensors.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "moe_gemm.cu"

#: kernel launches per dtype, counted where the kernel is launched only
LAUNCHES = {"bfloat16": 0, "float32": 0}

_DTYPES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
_MIN_C_TILE = 16            # the smallest C tile (grid.y = ceil(C / tile))
_MAX_GRID_YZ = 65535
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/moe_gemm.cu`` (once per process, and not at all when a
    build of the same source and flags exists) and load it.  Returns the
    library's path.  ``verbose`` prints nvcc's ``-Xptxas -v`` report."""
    global _lib
    if _lib is not None:
        return Path(_lib._name)
    lib = _build.load(SOURCE, verbose)
    for name in ("expert_gemm_bf16", "expert_gemm_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.expert_gemm_error_string.argtypes = [ctypes.c_int]
    lib.expert_gemm_error_string.restype = ctypes.c_char_p
    _lib = lib
    return Path(lib._name)


def _check(x, w) -> None:
    dev = x.device
    if dev.type != "cuda" or w.device != dev:
        raise ValueError("expert_gemm: x and w must be on one CUDA device "
                         f"(got {x.device}, {w.device})")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError("expert_gemm: one dtype, bfloat16 or float32 (got "
                         f"{x.dtype}, {w.dtype})")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError("expert_gemm: expected x (E, C, d), w (E, d, f), "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("expert_gemm: inputs must be contiguous")
    e, c, d = x.shape
    f = w.shape[2]
    if (e > _MAX_GRID_YZ or -(-c // _MIN_C_TILE) > _MAX_GRID_YZ
            or max(c, d, f) >= 2 ** 31):
        raise ValueError(f"expert_gemm: unsupported shape {tuple(x.shape)} x "
                         f"{tuple(w.shape)}")


def expert_gemm_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: x (E, C, d), w (E, d, f), one dtype (bfloat16 or
    float32), contiguous on one CUDA device -> (E, C, f) in x's dtype.  In
    bfloat16 the kernel is chosen by the shape: the TMA / wgmma design where
    d and f are multiples of 8 (16-byte rows), the wmma one otherwise."""
    _check(x, w)
    e, c, d = x.shape
    f = w.shape[2]
    if x.dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0:
        # TMA reads from 16-byte aligned bases; a contiguous view at an odd
        # offset is the only tensor that needs the copy
        x, w = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, w))
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    build()
    fn = (_lib.expert_gemm_bf16 if x.dtype == torch.bfloat16
          else _lib.expert_gemm_f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f,
                stream)
    if rc != 0:
        raise RuntimeError(f"expert_gemm kernel launch failed ({rc}): "
                           + _lib.expert_gemm_error_string(rc).decode())
    LAUNCHES[_DTYPES[x.dtype]] += 1
    return out
