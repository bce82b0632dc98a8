"""The CUDA RG-LRU scan kernels (``csrc/rglru.cu``): build, bind and launch.

The forward replaces the Pallas TPU kernel ``repro/kernels/rglru/
kernel.py:55`` (``rglru_fwd`` → ``_rglru_kernel``); the backward is its
gradient, which the JAX package leaves to autodiff.  Built and bound like
the port's other kernels (``kernels/_build.py``); a failed build or launch
raises, nothing falls back.  :func:`rglru_fwd` and :func:`rglru_bwd` launch
them on CUDA tensors only, on the current stream, and count each launch in
:data:`LAUNCHES` and :data:`BWD_LAUNCHES`; ``ops.rglru_scan_op`` is the
entry point that also takes CPU tensors, and the autograd function that
joins the two.  The forward cuts time into chunks, each walked twice (for its
summary, then from its carry); :func:`fwd_geometry` gives its launch.  The
backward's launch (a TMA ring where rows are
whole 16-byte pieces, plain loads elsewhere) is :func:`bwd_geometry`'s.
The C side checks both.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "rglru.cu"

#: kernel launches per dtype of b, counted where the kernel is launched only
LAUNCHES = {"bfloat16": 0, "float32": 0}
#: backward launches per dtype of b
BWD_LAUNCHES = {"bfloat16": 0, "float32": 0}

_DTYPES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
_MAX_GRID_Y = 65535
#: the forward's warps a block (32 channels, a segment of a chunk a warp),
#: steps a warp holds in registers, and the most chunks before a warp's
#: segment grows (a chunk's carry folds the chunks before it; csrc/rglru.cu)
SCAN_WARPS, SCAN_STEPS, MAX_CHUNKS = 16, 16, 16
#: the backward's channels a block (a thread each), steps a box, stages of
#: its TMA ring and output tiles (csrc/rglru.cu)
BWD_CHANNELS, BWD_STEPS, BWD_STAGES, BWD_OUTS = 32, 32, 4, 3
_lib = None


class BwdGeometry(NamedTuple):
    """One launch of the backward (``rglru_bwd_*``): ``grid_x`` blocks of
    ``threads`` channels for each batch row; ``tma``: boxes of ``steps``
    steps through a ring of ``stages`` stages in ``smem_bytes`` of shared
    memory, else (rows not 16-byte aligned) plain loads, no ring, none."""
    grid_x: int
    threads: int
    steps: int
    stages: int
    smem_bytes: int
    tma: bool


class FwdGeometry(NamedTuple):
    """One launch of the forward (``rglru_*``): ``chunks`` chunks of
    ``steps`` steps, blocks of ``threads`` threads (``SCAN_WARPS`` warps
    over 32 channels), ``grid`` blocks in all, and ``scratch_bytes`` of
    global scratch (the chunks' summaries, flags and ticket)."""
    grid: int
    threads: int
    chunks: int
    steps: int
    scratch_bytes: int


def fwd_geometry(bsz: int, s: int, w: int) -> FwdGeometry:
    """The forward for (B, S, W): chunks of ``SCAN_WARPS`` segments, a
    segment ``SCAN_STEPS`` steps (a chunk 256) or, where S needs more than
    ``MAX_CHUNKS`` such chunks, the smallest whole number of
    ``SCAN_STEPS`` loads that keeps within them."""
    per_chunk = SCAN_WARPS * SCAN_STEPS
    steps = per_chunk * max(1, -(-s // (per_chunk * MAX_CHUNKS)))
    chunks = max(1, -(-s // steps))
    groups = bsz * -(-w // 32)
    return FwdGeometry(grid=chunks * groups, threads=SCAN_WARPS * 32,
                       chunks=chunks, steps=steps,
                       scratch_bytes=8 * chunks * bsz * w
                       + 4 * (chunks * groups + 1))


def bwd_geometry(w: int, dtype: torch.dtype,
                 aligned: bool = True) -> BwdGeometry:
    """The backward for (B, S, w) with h, dh, db in ``dtype``: the TMA ring
    where a row of w elements (and of log_a's float32) is a whole number of
    16 bytes and the tensors' addresses are 16-byte aligned (``aligned``);
    a stage holds a box of log_a, h and dh, an output tile one of dlog_a
    and db, and 128 bytes align the ring."""
    size = 2 if dtype == torch.bfloat16 else 4
    tma = aligned and (w * size) % 16 == 0 and w % 4 == 0
    tile = BWD_CHANNELS * BWD_STEPS
    smem = (128 + BWD_STAGES * tile * (4 + 2 * size)
            + BWD_OUTS * tile * (4 + size) + 8 * BWD_STAGES) if tma else 0
    return BwdGeometry(grid_x=-(-w // BWD_CHANNELS), threads=BWD_CHANNELS,
                       steps=BWD_STEPS, stages=BWD_STAGES if tma else 0,
                       smem_bytes=smem, tma=tma)


def reset_launches() -> None:
    for counts in (LAUNCHES, BWD_LAUNCHES):
        for k in counts:
            counts[k] = 0


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/rglru.cu`` (once per process, and not at all when a
    build of the same source and flags exists) and load it.  Returns the
    library's path.  ``verbose`` prints nvcc's ``-Xptxas -v`` report."""
    global _lib
    if _lib is not None:
        return Path(_lib._name)
    lib = _build.load(SOURCE, verbose)
    for name in ("rglru_bf16", "rglru_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    for name in ("rglru_bwd_bf16", "rglru_bwd_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.rglru_error_string.argtypes = [ctypes.c_int]
    lib.rglru_error_string.restype = ctypes.c_char_p
    _lib = lib
    return Path(lib._name)


def _check(log_a, b) -> None:
    if b.device.type != "cuda" or log_a.device != b.device:
        raise ValueError("rglru: log_a and b must be on one CUDA device (got "
                         f"{log_a.device}, {b.device})")
    if log_a.dtype != torch.float32 or b.dtype not in _DTYPES:
        raise ValueError("rglru: log_a float32, b bfloat16 or float32 (got "
                         f"{log_a.dtype}, {b.dtype})")
    if b.dim() != 3 or log_a.shape != b.shape:
        raise ValueError("rglru: expected log_a and b (B, S, W), got "
                         f"{tuple(log_a.shape)}, {tuple(b.shape)}")
    if not (log_a.is_contiguous() and b.is_contiguous()):
        raise ValueError("rglru: inputs must be contiguous")
    bsz, s, w = b.shape
    if bsz > _MAX_GRID_Y or max(s, w) >= 2 ** 31 or b.numel() >= 2 ** 62:
        raise ValueError(f"rglru: unsupported shape {tuple(b.shape)}")


def rglru_fwd(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: log_a (B, S, W) float32, b (B, S, W) bfloat16 or
    float32, contiguous on one CUDA device -> h (B, S, W) in b's dtype, in
    :func:`fwd_geometry`'s launch."""
    _check(log_a, b)
    bsz, s, w = b.shape
    out = torch.empty_like(b)
    if out.numel() == 0:
        return out
    build()
    geo = fwd_geometry(bsz, s, w)
    scratch = torch.empty(geo.scratch_bytes, dtype=torch.uint8,
                          device=b.device)
    fn = _lib.rglru_bf16 if b.dtype == torch.bfloat16 else _lib.rglru_f32
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        rc = fn(log_a.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, s, w,
                geo.threads, geo.chunks, geo.steps, scratch.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError("rglru kernel launch failed: "
                           + _lib.rglru_error_string(rc).decode())
    LAUNCHES[_DTYPES[b.dtype]] += 1
    return out


def rglru_bwd(log_a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor):
    """Launch the backward: log_a (B, S, W) float32, the forward's output h
    and its gradient dh (B, S, W) in one dtype (bfloat16 or float32),
    contiguous on one CUDA device -> (dlog_a float32, db in h's dtype)."""
    _check(log_a, h)
    if dh.device != h.device or dh.dtype != h.dtype or dh.shape != h.shape \
            or not dh.is_contiguous():
        raise ValueError("rglru backward: dh must be contiguous and of h's "
                         f"device, dtype and shape (got {dh.device}, "
                         f"{dh.dtype}, {tuple(dh.shape)})")
    bsz, s, w = h.shape
    dlog_a = torch.empty_like(log_a)
    db = torch.empty_like(h)
    if db.numel() == 0:
        return dlog_a, db
    build()
    tensors = (log_a, h, dh, dlog_a, db)
    geo = bwd_geometry(w, h.dtype,
                       all(t.data_ptr() % 16 == 0 for t in tensors))
    fn = _lib.rglru_bwd_bf16 if h.dtype == torch.bfloat16 \
        else _lib.rglru_bwd_f32
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in tensors), bsz, s, w, geo.threads,
                geo.stages, geo.smem_bytes, stream)
    if rc != 0:
        raise RuntimeError("rglru backward kernel launch failed: "
                           + _lib.rglru_error_string(rc).decode())
    BWD_LAUNCHES[_DTYPES[h.dtype]] += 1
    return dlog_a, db
