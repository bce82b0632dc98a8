"""The CUDA expert-GEMM kernel (``csrc/moe_gemm.cu``): build, bind and launch.

Replaces the Pallas TPU kernel ``repro/kernels/moe_gemm/kernel.py:40``
(``expert_gemm_fwd`` → ``_gemm_kernel``).  Built and bound like the port's
other kernels (``kernels/_build.py``); a failed build or launch raises,
nothing falls back.  :func:`expert_gemm_fwd` launches it on CUDA tensors
only, on the current stream, and counts the launch in :data:`LAUNCHES`;
:func:`expert_gemm_bwd` launches the same kernel for the two products of
the gradient and counts them in :data:`BWD_LAUNCHES`; ``ops.expert_gemm`` is
the entry point that also takes CPU tensors.

The backward's two products (dX = dY . W^T, dW = X^T . dY) are laid out by
:func:`plan_bwd`, which runs on any device: for bf16 with d and f multiples
of 8 (every config) it hands the TMA kernel's transpose-bit variants x, w
and dY where they lie, with no copy; float32 and the ragged bf16 shapes
(the wmma kernel) launch the forward kernel on contiguous transposed
copies.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path
from typing import List, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "moe_gemm.cu"

#: kernel launches per dtype, counted where the kernel is launched only
LAUNCHES = {"bfloat16": 0, "float32": 0}
#: launches for the gradient's products (dX and dW), per dtype
BWD_LAUNCHES = {"bfloat16": 0, "float32": 0}

_DTYPES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
_MIN_C_TILE = 16            # the smallest C tile (grid.y = ceil(C / tile))
_MAX_GRID_YZ = 65535
_lib = None


def reset_launches() -> None:
    for counts in (LAUNCHES, BWD_LAUNCHES):
        for k in counts:
            counts[k] = 0


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
    lib.expert_gemm_tma_bf16.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.expert_gemm_tma_bf16.restype = ctypes.c_int
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
    out = _launch(x, w)
    LAUNCHES[_DTYPES[x.dtype]] += 1
    return out


@dataclass(frozen=True)
class BwdLaunch:
    """One launch of the backward: ``out`` (E, n, m) with out[e, n, m] =
    sum_k A[e, m, k] B[e, k, n], where A[e, m, k] is element
    ``a_strides . (e, m, k)`` of ``a``'s storage from its first element
    and B[e, k, n] element ``b_strides . (e, k, n)`` of ``b``'s.  ``ta``
    and ``tb`` are the transpose bits the kernel is given (0: K is the
    contiguous axis, K-major; 1: M, or N, is, MN-major).  ``copies`` names
    the operands (of ``x``, ``w``, ``dy``) copied into a new layout before
    the launch; empty when the kernel reads them where they lie, and then
    ``a`` and ``b`` are the caller's tensors themselves."""
    out: str
    a: torch.Tensor
    a_strides: Tuple[int, int, int]
    b: torch.Tensor
    b_strides: Tuple[int, int, int]
    e: int
    m: int
    n: int
    k: int
    ta: int
    tb: int
    copies: Tuple[str, ...]


def in_place(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor) -> bool:
    """Whether the backward reads x (E, C, d), w (E, d, f) and dy (E, C, f)
    where they lie: bf16, d and f multiples of 8 (TMA's 16-byte rows),
    16-byte aligned bases, contiguous."""
    d, f = w.shape[1], w.shape[2]
    return (x.dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0
            and all(t.is_contiguous() and t.data_ptr() % 16 == 0
                    for t in (x, w, dy)))


def plan_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
             need_dx: bool = True,
             need_dw: bool = True) -> List[BwdLaunch]:
    """The launches of the gradient of ``y = x . w`` (x (E, C, d), w (E, d,
    f), dy (E, C, f), contiguous), on any device (it reads shapes and
    pointers, and copies where a copy is made).  Where :func:`in_place`:
    dX^T[e] = W[e] . dY[e]^T (A = w read K-major, B = dy K-major, (ta, tb)
    = (0, 0)) and dW^T[e] = dY[e]^T . X[e] (A = dy MN-major, B = x
    MN-major, (1, 1)), so the kernel's (N, M) output is dX (E, C, d) and
    dW (E, d, f) as they are stored.  Otherwise the forward kernel
    (out = x' . w', (ta, tb) = (1, 0)) on dy and a contiguous W^T, and on a
    contiguous X^T and dy."""
    e, c, d = x.shape
    f = w.shape[2]
    out = []
    if in_place(x, w, dy):
        if need_dx:
            out.append(BwdLaunch("dx", w, (d * f, f, 1), dy, (c * f, 1, f),
                                 e, d, c, f, 0, 0, ()))
        if need_dw:
            out.append(BwdLaunch("dw", dy, (c * f, 1, f), x, (c * d, d, 1),
                                 e, f, d, c, 1, 1, ()))
        return out
    if need_dx:
        wt = w.transpose(1, 2).contiguous()          # (E, f, d)
        out.append(BwdLaunch("dx", wt, (f * d, 1, d), dy, (c * f, 1, f),
                             e, d, c, f, 1, 0, ("w",)))
    if need_dw:
        xt = x.transpose(1, 2).contiguous()          # (E, d, C)
        out.append(BwdLaunch("dw", dy, (c * f, 1, f), xt, (d * c, 1, c),
                             e, f, d, c, 1, 0, ("x",)))
    return out


def expert_gemm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                    need_dx: bool = True, need_dw: bool = True):
    """The gradient of ``y = expert_gemm_fwd(x, w)`` for ``dy`` (E, C, f):
    dX = dY . W^T and dW = X^T . dY, one launch each, as
    :func:`plan_bwd` lays them out (bf16 with d and f multiples of 8: the
    TMA kernel's transpose-bit variants on x, w and dy where they lie, no
    copy, one persistent block a streaming multiprocessor; otherwise the
    forward kernel on transposed copies).  Returns (dX or None, dW or
    None)."""
    if dy.shape != (x.shape[0], x.shape[1], w.shape[2]) \
            or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError("expert_gemm_bwd: dy must be (E, C, f) "
                         f"{(x.shape[0], x.shape[1], w.shape[2])} in "
                         f"{x.dtype}, contiguous; got {tuple(dy.shape)} "
                         f"{dy.dtype}")
    _check(x, w)
    grads = {"dx": None, "dw": None}
    for run in plan_bwd(x, w, dy, need_dx, need_dw):
        if run.copies:
            # the forward kernel: x' = B (E, n, k) stored, w' = A (E, k, m)
            grads[run.out] = _launch(run.b, run.a)
        else:
            grads[run.out] = _launch_tma(run)
        BWD_LAUNCHES[_DTYPES[x.dtype]] += 1
    return grads["dx"], grads["dw"]


def _launch_tma(run: BwdLaunch, blocks: int = -1) -> torch.Tensor:
    """One launch of a backward variant, uncounted.  ``blocks`` persistent
    blocks walk the tiles: -1 (the path's), one a streaming multiprocessor,
    which beat one block a tile (0) on an H100 at the training shapes, by a
    fifth for the pair (``kernel_probe.py --steps bwd`` times both)."""
    out = torch.empty((run.e, run.n, run.m), dtype=run.a.dtype,
                      device=run.a.device)
    if out.numel() == 0:
        return out
    if blocks < 0:
        blocks = torch.cuda.get_device_properties(
            run.a.device).multi_processor_count
    build()
    with torch.cuda.device(run.a.device):
        stream = torch.cuda.current_stream(run.a.device).cuda_stream
        rc = _lib.expert_gemm_tma_bf16(
            run.a.data_ptr(), run.b.data_ptr(), out.data_ptr(), run.e, run.m,
            run.n, run.k, run.ta, run.tb, blocks, stream)
    if rc != 0:
        raise RuntimeError(f"expert_gemm backward launch failed ({rc}): "
                           + _lib.expert_gemm_error_string(rc).decode())
    return out


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel, uncounted (the callers count it)."""
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
    return out
