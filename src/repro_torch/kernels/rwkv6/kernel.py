"""The CUDA WKV6 kernels (``csrc/wkv6.cu``, ``csrc/wkv6_bwd.cu``): build,
bind and launch.

The forward replaces the Pallas TPU kernel ``repro/kernels/rwkv6/
kernel.py:66`` (``wkv6_fwd`` → ``_wkv6_kernel``); the backward is its
gradient, which the JAX package leaves to autodiff of its jnp form.  Built
and bound like the port's other kernels (``kernels/_build.py``); a failed
build or launch raises, nothing falls back.  :func:`wkv6_fwd` and
:func:`wkv6_bwd` launch them on CUDA tensors only, on the current stream,
and count each call in :data:`LAUNCHES` and :data:`BWD_LAUNCHES`;
``ops.wkv6`` is the entry point that also takes CPU tensors, and the
autograd function that joins the two.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "wkv6.cu"
BWD_SOURCE = _build.CSRC / "wkv6_bwd.cu"

#: kernel launches per dtype of r, k, v, counted where the kernel is
#: launched only
LAUNCHES = {"bfloat16": 0, "float32": 0}
#: backward calls (one C call, two kernels: the walks and the sums) per
#: dtype of r, k, v
BWD_LAUNCHES = {"bfloat16": 0, "float32": 0}

_DTYPES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
MAX_HEAD_DIM = 128
#: tokens staged at a time, and row groups of a head's state (csrc/wkv6.cu)
TOKENS, ROW_GROUPS = 16, 8
#: the backward's groups of the index each walk sums over, and its per-token
#: scalars' slots (csrc/wkv6_bwd.cu)
BWD_GROUPS, BWD_SCALARS = 8, 36
_lib = None
_bwd_lib = None


class Geometry(NamedTuple):
    """One launch of ``csrc/wkv6.cu``: ``grid`` blocks (one per batch and
    head) of ``threads``, the head dim padded to ``head_pad``, the state
    spread over ``row_groups`` groups of rows, two columns a thread, in
    ``smem_bytes`` of shared memory."""
    grid: int
    threads: int
    head_pad: int
    row_groups: int
    smem_bytes: int


def launch_geometry(b: int, h: int, hd: int, dtype: torch.dtype) -> Geometry:
    """The launch for r of shape (b, S, h, hd) in ``dtype`` (any S): the
    kernel's own layout, which it checks; at the served (4, S, 64, 64)
    256 blocks of 256 threads."""
    pad = 32 if hd <= 32 else 64 if hd <= 64 else 128
    tile = TOKENS * pad
    size = 2 if dtype == torch.bfloat16 else 4
    # raw log_w (x2), float32 r, k, v, w, r u k, partial y (x row groups),
    # u, the tokens' bonus; raw r, k, v (x2 each)
    smem = 4 * ((2 + 5 + ROW_GROUPS) * tile + pad + TOKENS) + size * 6 * tile
    return Geometry(grid=b * h, threads=ROW_GROUPS * pad // 2, head_pad=pad,
                    row_groups=ROW_GROUPS, smem_bytes=smem)


class BwdGeometry(NamedTuple):
    """The walks' launch of ``csrc/wkv6_bwd.cu``: ``grid`` blocks (a batch
    and head in each of three roles) of ``threads``, the head dim padded to
    ``head_pad``, the index a walk sums over spread over ``groups`` groups,
    two lane indices a thread, in ``smem_bytes`` of shared memory."""
    grid: int
    threads: int
    head_pad: int
    groups: int
    smem_bytes: int


def bwd_geometry(b: int, h: int, hd: int, dtype: torch.dtype) -> BwdGeometry:
    """The backward's walks for r of shape (b, S, h, hd) in ``dtype`` (any
    S): a window of ``TOKENS`` + 1 tokens double-buffered raw (log_w
    float32, r, k, v, dy in ``dtype``), three float32 arrays of it, the
    walks' partial sums (``BWD_GROUPS`` a token and lane index), u and the
    per-token scalars."""
    pad = 32 if hd <= 32 else 64 if hd <= 64 else 128
    row = (TOKENS + 1) * pad
    size = 2 if dtype == torch.bfloat16 else 4
    smem = 4 * ((2 + 3) * row + TOKENS * BWD_GROUPS * pad + pad
                + BWD_SCALARS) + size * 8 * row
    return BwdGeometry(grid=3 * b * h, threads=BWD_GROUPS * pad // 2,
                       head_pad=pad, groups=BWD_GROUPS, smem_bytes=smem)


def reset_launches() -> None:
    for counts in (LAUNCHES, BWD_LAUNCHES):
        for k in counts:
            counts[k] = 0


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/wkv6.cu`` and ``csrc/wkv6_bwd.cu`` (once per
    process, and not at all when a build of the same source and flags
    exists) and load them.  Returns the forward library's path.
    ``verbose`` prints nvcc's ``-Xptxas -v`` report."""
    global _lib, _bwd_lib
    if _lib is not None:
        return Path(_lib._name)
    for out in _build.compile_sources([SOURCE, BWD_SOURCE], verbose).values():
        if verbose:
            print(out, flush=True)
    lib = ctypes.CDLL(str(_build.library_path(SOURCE)))
    for name in ("wkv6_bf16", "wkv6_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.wkv6_error_string.argtypes = [ctypes.c_int]
    lib.wkv6_error_string.restype = ctypes.c_char_p
    bwd = ctypes.CDLL(str(_build.library_path(BWD_SOURCE)))
    for name in ("wkv6_bwd_bf16", "wkv6_bwd_f32"):
        fn = getattr(bwd, name)
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    bwd.wkv6_bwd_error_string.argtypes = [ctypes.c_int]
    bwd.wkv6_bwd_error_string.restype = ctypes.c_char_p
    _lib, _bwd_lib = lib, bwd
    return Path(lib._name)


def _check(r, k, v, log_w, u) -> None:
    tensors = (r, k, v, log_w, u)
    dev = r.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("wkv6: r, k, v, log_w, u must all be on one CUDA "
                         f"device (got {[str(t.device) for t in tensors]})")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype \
            or log_w.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError("wkv6: r, k, v of one dtype (bfloat16 or float32), "
                         "log_w and u float32 (got "
                         f"{[str(t.dtype) for t in tensors]})")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, log_w)) \
            or u.shape != r.shape[2:]:
        raise ValueError("wkv6: expected r, k, v, log_w (B, S, H, hd) and u "
                         f"(H, hd), got {[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("wkv6: inputs must be contiguous")
    b, s, h, hd = r.shape
    if not 1 <= hd <= MAX_HEAD_DIM or r.numel() >= 2 ** 62 \
            or b * h >= 2 ** 31 or s >= 2 ** 31:
        raise ValueError(f"wkv6: unsupported head dim {hd} (at most "
                         f"{MAX_HEAD_DIM}) or shape {tuple(r.shape)}")


def wkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_w: torch.Tensor, u: torch.Tensor):
    """Launch the kernel: r, k, v (B, S, H, hd) of one dtype (bfloat16 or
    float32), log_w (B, S, H, hd) and u (H, hd) float32, contiguous on one
    CUDA device -> (y (B, S, H, hd) in r's dtype, final state
    (B, H, hd, hd) float32)."""
    _check(r, k, v, log_w, u)
    b, s, h, hd = r.shape
    y = torch.empty_like(r)
    state = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
    if state.numel() == 0:
        return y, state
    build()
    geo = launch_geometry(b, h, hd, r.dtype)
    fn = _lib.wkv6_bf16 if r.dtype == torch.bfloat16 else _lib.wkv6_f32
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
                u.data_ptr(), y.data_ptr(), state.data_ptr(), b, s, h, hd,
                geo.threads, geo.smem_bytes, stream)
    if rc != 0:
        raise RuntimeError("wkv6 kernel launch failed: "
                           + _lib.wkv6_error_string(rc).decode())
    LAUNCHES[_DTYPES[r.dtype]] += 1
    return y, state


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
             d_state=None):
    """Launch the backward on the forward's inputs (as :func:`wkv6_fwd`
    takes them), dy (B, S, H, hd) in r's dtype and the final state's
    gradient (B, H, hd, hd) float32 (None: zero), contiguous on r's device
    -> (dr, dk, dv in r's dtype, dlog_w (B, S, H, hd) and du (H, hd)
    float32)."""
    _check(r, k, v, log_w, u)
    if dy.device != r.device or dy.dtype != r.dtype \
            or dy.shape != r.shape or not dy.is_contiguous():
        raise ValueError("wkv6 backward: dy must be contiguous and of r's "
                         f"device, dtype and shape (got {dy.device}, "
                         f"{dy.dtype}, {tuple(dy.shape)})")
    b, s, h, hd = r.shape
    if d_state is not None and (
            d_state.device != r.device or d_state.dtype != torch.float32
            or d_state.shape != (b, h, hd, hd)
            or not d_state.is_contiguous()):
        raise ValueError("wkv6 backward: d_state must be contiguous float32 "
                         f"(B, H, hd, hd) on r's device (got "
                         f"{d_state.device}, {d_state.dtype}, "
                         f"{tuple(d_state.shape)})")
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dlog_w = torch.empty_like(log_w)
    du = torch.zeros_like(u)
    if r.numel() == 0:
        return dr, dk, dv, dlog_w, du
    build()
    geo = bwd_geometry(b, h, hd, r.dtype)
    scratch = torch.empty(r.numel() + 2 * b * h * hd, dtype=torch.float32,
                          device=r.device)
    fn = _bwd_lib.wkv6_bwd_bf16 if r.dtype == torch.bfloat16 \
        else _bwd_lib.wkv6_bwd_f32
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
                u.data_ptr(), dy.data_ptr(),
                None if d_state is None else d_state.data_ptr(),
                dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                dlog_w.data_ptr(), du.data_ptr(), scratch.data_ptr(), b, s,
                h, hd, geo.threads, geo.smem_bytes, stream)
    if rc != 0:
        raise RuntimeError("wkv6 backward kernel launch failed: "
                           + _bwd_lib.wkv6_bwd_error_string(rc).decode())
    BWD_LAUNCHES[_DTYPES[r.dtype]] += 1
    return dr, dk, dv, dlog_w, du
