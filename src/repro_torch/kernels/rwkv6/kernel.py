"""The CUDA WKV6 kernel (``csrc/wkv6.cu``): build, bind and launch.

Replaces the Pallas TPU kernel ``repro/kernels/rwkv6/kernel.py:66``
(``wkv6_fwd`` → ``_wkv6_kernel``).  Built and bound like the port's other
kernels (``kernels/_build.py``); a failed build or launch raises, nothing
falls back.  :func:`wkv6_fwd` launches it on CUDA tensors only, on the
current stream, and counts the launch in :data:`LAUNCHES`; ``ops.wkv6`` is
the entry point that also takes CPU tensors.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "wkv6.cu"

#: kernel launches per dtype of r, k, v, counted where the kernel is
#: launched only
LAUNCHES = {"bfloat16": 0, "float32": 0}

_DTYPES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
MAX_HEAD_DIM = 128
#: tokens staged at a time, and row groups of a head's state (csrc/wkv6.cu)
TOKENS, ROW_GROUPS = 16, 8
_lib = None


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


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/wkv6.cu`` (once per process, and not at all when a
    build of the same source and flags exists) and load it.  Returns the
    library's path.  ``verbose`` prints nvcc's ``-Xptxas -v`` report."""
    global _lib
    if _lib is not None:
        return Path(_lib._name)
    lib = _build.load(SOURCE, verbose)
    for name in ("wkv6_bf16", "wkv6_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.wkv6_error_string.argtypes = [ctypes.c_int]
    lib.wkv6_error_string.restype = ctypes.c_char_p
    _lib = lib
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
