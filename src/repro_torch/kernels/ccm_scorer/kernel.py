"""The CUDA scorer kernel (``csrc/ccm_scorer.cu``): build, bind and launch.

Replaces the Pallas TPU kernel ``repro/kernels/ccm_scorer/kernel.py:35``
(``_scorer_kernel`` / ``score_tiles_fwd``).  The source is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false`` at first use and
bound with ctypes (``kernels/_build.py``).  A failed build or launch raises;
nothing falls back.

:func:`score_tiles` takes the packed tiles (ops.py documents the layout):
on CPU tensors it is the plain torch version (:func:`ref.score_tiles`); on
CUDA tensors it launches the kernel, one thread per (event, ia, ib) lane,
on the current stream, and counts the launch in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ccm_scorer import ref
from repro_torch.kernels.ccm_scorer.layout import N_AV, N_OUT, N_PM, N_SC

SOURCE = _build.CSRC / "ccm_scorer.cu"

#: kernel launches per dtype, counted where the kernel is launched only
LAUNCHES = {"float64": 0, "float32": 0}

_DTYPES = {torch.float64: "float64", torch.float32: "float32"}
_MAX_EVENTS = 65535         # grid.y
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/ccm_scorer.cu`` (once per process, and not at all when
    a build of the same source and flags exists) and load it.  Returns the
    library's path.  ``verbose`` prints nvcc's ``-Xptxas -v`` report."""
    global _lib
    if _lib is not None:
        return Path(_lib._name)
    lib = _build.load(SOURCE, verbose)
    for name in ("ccm_scorer_f64", "ccm_scorer_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.ccm_scorer_error_string.argtypes = [ctypes.c_int]
    lib.ccm_scorer_error_string.restype = ctypes.c_char_p
    _lib = lib
    return Path(lib._name)


def _check(av, bv, pm, sc) -> None:
    tensors = (av, bv, pm, sc)
    dev = av.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("ccm_scorer: av, bv, pm, sc must all be on one "
                         f"device (got {[str(t.device) for t in tensors]})")
    if av.dtype not in _DTYPES or any(t.dtype != av.dtype for t in tensors):
        raise ValueError("ccm_scorer: one dtype, float64 or float32 (got "
                         f"{[str(t.dtype) for t in tensors]})")
    if av.dim() != 3 or bv.dim() != 3 or pm.dim() != 4 or sc.dim() != 2:
        raise ValueError("ccm_scorer: expected av (E, N_AV, A), bv (E, N_AV,"
                         " B), pm (E, N_PM, A, B), sc (E, N_SC)")
    e_n, a_n, b_n = av.shape[0], av.shape[2], bv.shape[2]
    if (tuple(av.shape) != (e_n, N_AV, a_n)
            or tuple(bv.shape) != (e_n, N_AV, b_n)
            or tuple(pm.shape) != (e_n, N_PM, a_n, b_n)
            or tuple(sc.shape) != (e_n, N_SC)):
        raise ValueError("ccm_scorer: inconsistent shapes "
                         f"{[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ccm_scorer: tiles must be contiguous")
    if e_n > _MAX_EVENTS or a_n * b_n >= 2 ** 31:
        raise ValueError(f"ccm_scorer: tile too large (E={e_n}, A={a_n}, "
                         f"B={b_n})")


def score_tiles(av: torch.Tensor, bv: torch.Tensor, pm: torch.Tensor,
                sc: torch.Tensor) -> torch.Tensor:
    """(E, N_OUT, A, B) work components of the packed tiles: the plain torch
    version on CPU tensors, the CUDA kernel on CUDA tensors."""
    if all(t.device.type == "cpu" for t in (av, bv, pm, sc)):
        return ref.score_tiles(av, bv, pm, sc)
    _check(av, bv, pm, sc)
    e_n, a_n, b_n = av.shape[0], av.shape[2], bv.shape[2]
    out = torch.empty((e_n, N_OUT, a_n, b_n), dtype=av.dtype,
                      device=av.device)
    if out.numel() == 0:
        return out
    build()
    fn = (_lib.ccm_scorer_f64 if av.dtype == torch.float64
          else _lib.ccm_scorer_f32)
    with torch.cuda.device(av.device):
        stream = torch.cuda.current_stream(av.device).cuda_stream
        rc = fn(av.data_ptr(), bv.data_ptr(), pm.data_ptr(), sc.data_ptr(),
                out.data_ptr(), e_n, a_n, b_n, stream)
    if rc != 0:
        raise RuntimeError("ccm_scorer kernel launch failed: "
                           + _lib.ccm_scorer_error_string(rc).decode())
    LAUNCHES[_DTYPES[av.dtype]] += 1
    return out
