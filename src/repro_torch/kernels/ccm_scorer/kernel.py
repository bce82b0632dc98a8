"""The CUDA scorer kernel (``csrc/ccm_scorer.cu``): build, bind and launch.

Replaces the Pallas TPU kernel ``repro/kernels/ccm_scorer/kernel.py:35``
(``_scorer_kernel`` / ``score_tiles_fwd``).  The source is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false`` into a shared
library with a plain C interface at first use, under ``build/kernels/`` at
the root of the checkout (named by a hash of the source and the flags, so a
stale build is never loaded), and bound with ctypes.  A failed build or
launch raises; nothing falls back.

:func:`score_tiles` takes the packed tiles (ops.py documents the layout):
on CPU tensors it is the plain torch version (:func:`ref.score_tiles`); on
CUDA tensors it launches the kernel, one thread per (event, ia, ib) lane,
on the current stream, and counts the launch in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels.ccm_scorer import ref
from repro_torch.kernels.ccm_scorer.layout import N_AV, N_OUT, N_PM, N_SC

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "ccm_scorer.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

#: kernel launches per dtype, counted where the kernel is launched only
LAUNCHES = {"float64": 0, "float32": 0}

_DTYPES = {torch.float64: "float64", torch.float32: "float32"}
_MAX_EVENTS = 65535         # grid.y
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = cand if os.path.isfile(cand) else None
    if found is None:
        raise RuntimeError("nvcc not found (PATH or CUDA_HOME): the CUDA "
                           "toolkit is needed to build the ccm_scorer kernel")
    return found


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/ccm_scorer.cu`` (once per process, and not at all when
    a build of the same source and flags exists) and load it.  Returns the
    library's path.  ``verbose`` prints nvcc's ``-Xptxas -v`` report."""
    global _lib
    if _lib is not None:
        return Path(_lib._name)
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"libccm_scorer-{tag}.so"
    if not path.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr, flush=True)
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    for name in ("ccm_scorer_f64", "ccm_scorer_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.ccm_scorer_error_string.argtypes = [ctypes.c_int]
    lib.ccm_scorer_error_string.restype = ctypes.c_char_p
    _lib = lib
    return path


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
