"""Build the port's CUDA sources (``csrc/*.cu``) with nvcc and load them.

Every kernel is compiled with the same flags into a shared library with a
plain C interface, under ``build/kernels/`` at the root of the checkout,
named by a hash of its source, every local header it includes and the
flags (so a stale build is never loaded), and bound with ctypes.  A failed build raises; nothing falls back.
:func:`compile_sources` starts one nvcc per source, all at once, so a
process that needs several kernels waits for the slowest build only.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
#: shared memory one block can opt in to on sm_90 (H100)
MAX_SMEM_BYTES = 232448
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = cand if os.path.isfile(cand) else None
    if found is None:
        raise RuntimeError("nvcc not found (PATH or CUDA_HOME): the CUDA "
                           "toolkit is needed to build the port's kernels")
    return found


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def local_sources(source: Path) -> List[Path]:
    """``source`` and every file it includes with ``#include "..."``,
    recursively, each found beside the file that includes it; in the order
    first met."""
    found, todo = [], [Path(source)]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for name in _LOCAL_INCLUDE.findall(path.read_bytes()):
            dep = path.parent / name.decode()
            if dep.is_file():
                todo.append(dep)
    return found


def library_path(source: Path) -> Path:
    digest = hashlib.sha256()
    for path in local_sources(source):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def compile_sources(sources: Sequence[Path],
                    verbose: bool = False) -> Dict[Path, str]:
    """Compile every source whose library is missing, one nvcc each, all
    started together.  Returns nvcc's output per compiled source (the
    ``-Xptxas -v`` report when ``verbose``); raises if any build fails."""
    procs = {}
    for source in sources:
        path = library_path(source)
        if path.is_file():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(source)]
        procs[source] = (cmd, tmp, path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    reports, failed = {}, []
    for source, (cmd, tmp, path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
            continue
        os.replace(tmp, path)
        reports[source] = out
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(source: Path, verbose: bool = False) -> ctypes.CDLL:
    """The loaded library of ``source``, compiled first if needed
    (``verbose`` prints nvcc's ``-Xptxas -v`` report)."""
    for out in compile_sources([source], verbose).values():
        if verbose:
            print(out, flush=True)
    return ctypes.CDLL(str(library_path(source)))
