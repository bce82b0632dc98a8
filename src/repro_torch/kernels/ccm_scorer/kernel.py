"""The CUDA scorer kernel (``csrc/ccm_scorer.cu``): build, bind and launch.

Replaces the Pallas TPU kernel ``repro/kernels/ccm_scorer/kernel.py:35``
(``_scorer_kernel`` / ``score_tiles_fwd``).  The source is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false`` at first use and
bound with ctypes (``kernels/_build.py``).  A failed build or launch raises;
nothing falls back.

:func:`score_tiles` takes the packed tiles (ops.py documents the layout):
on CPU tensors it is the plain torch version (:func:`ref.score_tiles`); on
CUDA tensors it launches the full-tile kernel, one thread per (event, ia,
ib) lane, on the current stream, and counts the launch in
:data:`LAUNCHES`.

:func:`score_pairs` is the fused pair scorer the balancer runs: the same
tiles plus float64 combine rows, int32 pair offsets and pairs, returning
(3, P) float64 (w_a, w_b, feasible): on CPU tensors the plain version
(:func:`ref.score_pairs_packed`), on CUDA tensors one launch of the pair
kernel (:func:`launch_pairs`), counted in :data:`PAIR_LAUNCHES`.  The
launcher calls :func:`launch_pairs` directly on device pointers into its
staging buffer, having checked the shapes on the integers it packed.

:func:`score_spec_rows` is the speculative window scorer (it replaces the
JAX package's XLA-compiled ``kind="spec"`` body,
``repro/kernels/ccm_scorer/jit.py:253``): (W, row_len) float64 window rows
(``PhaseEngine.spec_raw``) in, (W, 4) float64 ``[slot, score, w_a, w_b]``
out; on CPU tensors the plain version (:func:`ref.score_spec_rows`), on
CUDA tensors one launch of ``ccm_scorer_spec_f64`` (:func:`launch_spec`,
one block a row, the row staged by bulk copies), counted in
:data:`SPEC_LAUNCHES`.  The flow matrix lives in shared memory where it
fits (:func:`spec_f_in_smem`) and in a global scratch slab beyond;
float64 only.  The bulk copies move 16-byte granules, so the kernel takes
rows at an even stride (:func:`spec_stride`), from a 16-byte aligned
buffer, with an even edge bucket.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ccm_scorer import ref
from repro_torch.kernels.ccm_scorer.layout import (N_AV, N_CF, N_OUT, N_PM,
                                                   N_SC, spec_edge_bucket,
                                                   spec_groups, spec_offsets)

SOURCE = _build.CSRC / "ccm_scorer.cu"

#: full-tile kernel launches per dtype, counted where the kernel is
#: launched only
LAUNCHES = {"float64": 0, "float32": 0}
#: pair kernel launches per dtype, counted where the kernel is launched only
PAIR_LAUNCHES = {"float64": 0, "float32": 0}
#: window kernel launches (float64 only), counted where the kernel is
#: launched only
SPEC_LAUNCHES = {"float64": 0}

_DTYPES = {torch.float64: "float64", torch.float32: "float32"}
_MAX_EVENTS = 65535         # grid.y
_BAD_PAIR = -1              # the C launches' code for an index off its tile
#: the window kernel's block, its edge staging chunk and ring of staging
#: buffers (csrc/ccm_scorer.cu)
SPEC_THREADS = 256
SPEC_WARPS = SPEC_THREADS // 32
SPEC_CHUNK = 256
SPEC_STAGES = 4
#: the kernel's mbarriers (the tail's and one a staging buffer), in bytes
_SPEC_BARS_BYTES = -(-8 * (1 + SPEC_STAGES) // 16) * 16
_lib = None


def reset_launches() -> None:
    for counts in (LAUNCHES, PAIR_LAUNCHES, SPEC_LAUNCHES):
        for k in counts:
            counts[k] = 0


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
    for name in ("ccm_scorer_pairs_f64", "ccm_scorer_pairs_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    lib.ccm_scorer_spec_f64.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    lib.ccm_scorer_spec_f64.restype = ctypes.c_int
    lib.ccm_scorer_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_longlong, ctypes.c_void_p]
    lib.ccm_scorer_copy.restype = ctypes.c_int
    lib.ccm_scorer_sync.argtypes = [ctypes.c_void_p]
    lib.ccm_scorer_sync.restype = ctypes.c_int
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


def launch_pairs(dtype: torch.dtype, av: int, bv: int, pm: int, sc: int,
                 cf: int, offs: int, pairs: int, out: int, e_n: int,
                 a_n: int, b_n: int, p_total: int, memory_constraint: bool,
                 stream: int, host_pairs: int = 0) -> None:
    """One launch of the pair kernel on device pointers (ints) laid out as
    :func:`score_pairs` documents, on ``stream``; counted in
    :data:`PAIR_LAUNCHES`.  The caller has checked the shapes and, unless
    it passes ``host_pairs`` (a host copy of the pairs, which the C side
    then checks before it launches), the pairs; a bad pair raises
    IndexError (after waiting for ``stream``), a refused launch
    RuntimeError."""
    if _lib is None:
        build()
    fn = (_lib.ccm_scorer_pairs_f64 if dtype == torch.float64
          else _lib.ccm_scorer_pairs_f32)
    # bool(): the params may hold a numpy bool (seqpack's np.isfinite),
    # which ctypes does not take as an int
    rc = fn(av, bv, pm, sc, cf, offs, pairs, out, e_n, a_n, b_n, p_total,
            bool(memory_constraint), host_pairs, stream)
    if rc == _BAD_PAIR:
        synchronize(stream)
        raise IndexError(f"ccm_scorer: a shortlisted pair lies outside its "
                         f"tile (A={a_n}, B={b_n})")
    if rc != 0:
        _raise(rc, "pair kernel launch")
    PAIR_LAUNCHES[_DTYPES[dtype]] += 1


def _raise(rc: int, what: str) -> None:
    raise RuntimeError(f"ccm_scorer {what} failed: "
                       + _lib.ccm_scorer_error_string(rc).decode())


def copy_async(dst: int, src: int, nbytes: int, stream: int) -> None:
    """``cudaMemcpyAsync`` of ``nbytes`` from ``src`` to ``dst`` (device or
    pinned host pointers, as ints) on ``stream``; raises on an error."""
    rc = _lib.ccm_scorer_copy(dst, src, nbytes, stream)
    if rc != 0:
        _raise(rc, "copy")


def synchronize(stream: int) -> None:
    """Wait for ``stream``; raises on an error of its work."""
    rc = _lib.ccm_scorer_sync(stream)
    if rc != 0:
        _raise(rc, "stream")


def check_pair_shapes(e_n: int, a_n: int, b_n: int, p_total: int) -> None:
    """The limits of the pair kernel's indexing (int offsets and pairs, one
    block per event)."""
    if e_n < 1 or a_n < 1 or b_n < 1 or p_total < 0:
        raise ValueError(f"ccm_scorer pairs: empty tile (E={e_n}, A={a_n}, "
                         f"B={b_n}, P={p_total})")
    if a_n * b_n >= 2 ** 31 or p_total >= 2 ** 30 or e_n >= 2 ** 31 - 1:
        raise ValueError(f"ccm_scorer pairs: too large (E={e_n}, A={a_n}, "
                         f"B={b_n}, P={p_total})")


def _check_pairs(pairs: torch.Tensor, a_n: int, b_n: int) -> None:
    if pairs.numel() and not bool(((pairs >= 0).all()
                                   & (pairs[:, 0] < a_n).all()
                                   & (pairs[:, 1] < b_n).all()).item()):
        raise IndexError(f"ccm_scorer: a shortlisted pair lies outside its "
                         f"tile (A={a_n}, B={b_n})")


def score_pairs(av: torch.Tensor, bv: torch.Tensor, pm: torch.Tensor,
                sc: torch.Tensor, cf: torch.Tensor, offs: torch.Tensor,
                pairs: torch.Tensor, memory_constraint: bool,
                ) -> torch.Tensor:
    """(3, P) float64 w_a, w_b, feasible of every event's pairs: ``av``
    (E, N_AV, A), ``bv`` (E, N_AV, B), ``pm`` (E, N_PM, A, B), ``sc``
    (E, N_SC) of one scoring dtype, ``cf`` (E, N_CF) float64, ``offs``
    (E + 1,) int32 (``offs[0] == 0``, non-decreasing) and ``pairs`` (P, 2)
    int32 with ``0 <= ia < A``, ``0 <= ib < B``.  The plain torch version on
    CPU tensors, the CUDA pair kernel on CUDA tensors."""
    tensors = (av, bv, pm, sc, cf, offs, pairs)
    if all(t.device.type == "cpu" for t in tensors):
        _check_pairs(pairs, av.shape[2], bv.shape[2])
        return ref.score_pairs_packed(*tensors, memory_constraint)
    _check(av, bv, pm, sc)
    dev = av.device
    if any(t.device != dev for t in (cf, offs, pairs)):
        raise ValueError("ccm_scorer pairs: all inputs on one device (got "
                         f"{[str(t.device) for t in tensors]})")
    e_n, a_n, b_n = av.shape[0], av.shape[2], bv.shape[2]
    p_total = pairs.shape[0] if pairs.dim() == 2 else -1
    if (cf.dtype != torch.float64 or tuple(cf.shape) != (e_n, N_CF)
            or offs.dtype != torch.int32 or tuple(offs.shape) != (e_n + 1,)
            or pairs.dtype != torch.int32 or pairs.dim() != 2
            or pairs.shape[1] != 2
            or not all(t.is_contiguous() for t in (cf, offs, pairs))
            or pairs.data_ptr() % 8):
        raise ValueError("ccm_scorer pairs: expected contiguous cf (E, N_CF) "
                         "float64, offs (E+1,) int32, pairs (P, 2) int32 "
                         "(8-byte aligned)")
    check_pair_shapes(e_n, a_n, b_n, p_total)
    o = offs.tolist()
    if o[0] != 0 or o[-1] != p_total or any(x > y for x, y in zip(o, o[1:])):
        raise ValueError(f"ccm_scorer pairs: bad offsets {o} for P={p_total}")
    _check_pairs(pairs, a_n, b_n)
    out = torch.empty((3, p_total), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        launch_pairs(av.dtype, av.data_ptr(), bv.data_ptr(), pm.data_ptr(),
                     sc.data_ptr(), cf.data_ptr(), offs.data_ptr(),
                     pairs.data_ptr(), out.data_ptr(), e_n, a_n, b_n,
                     p_total, memory_constraint,
                     torch.cuda.current_stream(dev).cuda_stream)
    return out


# ------------------------------------------------- the speculative window
def spec_stride(row_len: int) -> int:
    """The row stride (float64 values) the window kernel takes for rows of
    ``row_len``: rounded up to even, so that every row starts on a 16-byte
    granule and the rounded copy of its tail stays inside it."""
    return row_len + (row_len & 1)


def spec_smem_bytes(a_n: int, b_n: int, p_n: int, f_in_smem: bool) -> int:
    """Dynamic shared memory of one window-kernel block, in bytes: its
    mbarriers, the row's tail (everything after the edges, rounded up to
    even), the ring of edge staging buffers (bins and volumes), the flow
    matrix (when it lives there), the four slice sums, the warps' winners,
    each warp's list of its edges (volumes, int bins) and run buffer, and
    the split's counts (``spec_smem_bytes`` in csrc/ccm_scorer.cu)."""
    g_n = spec_groups(a_n, b_n)[2]
    tail = spec_stride(spec_offsets(0, a_n, b_n, p_n)[-1])
    doubles = (tail + 2 * SPEC_STAGES * SPEC_CHUNK
               + (g_n * g_n if f_in_smem else 0) + 4 * g_n + 4 * SPEC_WARPS
               + SPEC_WARPS * (SPEC_CHUNK + 32))
    return (_SPEC_BARS_BYTES + 8 * doubles
            + 4 * SPEC_WARPS * (SPEC_CHUNK + SPEC_WARPS + 1))


def spec_f_in_smem(a_n: int, b_n: int, p_n: int) -> bool:
    """Whether the window kernel keeps the flow matrix in shared memory (up
    to A = B = 64) rather than in a global scratch slab."""
    return spec_smem_bytes(a_n, b_n, p_n, True) <= _build.MAX_SMEM_BYTES


def check_spec_shapes(w_n: int, eb: int, a_n: int, b_n: int, p_n: int,
                      f_in_smem: bool) -> None:
    """The window kernel's limits: at least one row, edge slot, lane and
    pair slot; an even edge bucket (the edge regions are copied in 16-byte
    granules); int indexing; one block's shared memory."""
    if min(w_n, eb, a_n, b_n, p_n) < 1:
        raise ValueError(f"ccm_scorer spec: empty window (W={w_n}, eb={eb}, "
                         f"A={a_n}, B={b_n}, P={p_n})")
    if eb % 2:
        raise ValueError(f"ccm_scorer spec: odd edge bucket {eb}")
    g_n = spec_groups(a_n, b_n)[2]
    if (w_n >= 2 ** 31 or g_n * g_n >= 2 ** 31
            or spec_offsets(eb, a_n, b_n, p_n)[-1] >= 2 ** 31):
        raise ValueError(f"ccm_scorer spec: too large (W={w_n}, eb={eb}, "
                         f"A={a_n}, B={b_n}, P={p_n})")
    smem = spec_smem_bytes(a_n, b_n, p_n, f_in_smem)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"ccm_scorer spec: {smem} bytes of shared memory a "
                         f"block (A={a_n}, B={b_n}, P={p_n}, F in shared "
                         f"memory: {f_in_smem}) exceed the card's "
                         f"{_build.MAX_SMEM_BYTES}")


def launch_spec(buf: int, out: int, scratch: int, w_n: int, eb: int,
                a_n: int, b_n: int, p_n: int, stride: int, stream: int,
                host_buf: int = 0) -> None:
    """One launch of the window kernel on device pointers (ints): ``buf``
    (W, stride) float64 rows (each ``row_len`` values, then padding), 16-
    byte aligned, ``stride`` even and at least ``spec_stride(row_len)``,
    ``out`` (W, 4) float64, ``scratch`` a (W, G, G) float64 slab for the
    flow matrices or 0 (in shared memory), on ``stream``; counted in
    :data:`SPEC_LAUNCHES`.  The caller has checked the shapes
    (:func:`check_spec_shapes`) and, unless it passes ``host_buf`` (a host
    copy of the rows at the same stride, which the C side then checks
    before it launches), every bin and pair; an index off its tile raises
    IndexError, a refused launch (the C side also refuses a stride or
    alignment the bulk copies cannot take) RuntimeError."""
    if _lib is None:
        build()
    rc = _lib.ccm_scorer_spec_f64(buf, out, scratch, w_n, eb, a_n, b_n, p_n,
                                  stride, host_buf, stream)
    if rc == _BAD_PAIR:
        raise IndexError(f"ccm_scorer spec: a bin or pair lies outside its "
                         f"tile (A={a_n}, B={b_n})")
    if rc != 0:
        _raise(rc, "window kernel launch")
    SPEC_LAUNCHES["float64"] += 1


def _check_spec_indices(buf: torch.Tensor, eb: int, a_n: int, b_n: int,
                        p_n: int) -> None:
    o_ia, o_ib, o_ms = spec_offsets(eb, a_n, b_n, p_n)[5:8]
    g_n = spec_groups(a_n, b_n)[2]
    bins, ia, ib = buf[:, :eb], buf[:, o_ia:o_ib], buf[:, o_ib:o_ms]
    if not bool(((bins >= 0).all() & (bins < g_n * g_n).all()
                 & (ia >= 0).all() & (ia < a_n).all()
                 & (ib >= 0).all() & (ib < b_n).all()).item()):
        raise IndexError(f"ccm_scorer spec: a bin or pair lies outside its "
                         f"tile (A={a_n}, B={b_n})")


def score_spec_rows(buf: torch.Tensor, a_lanes: int, b_lanes: int,
                    p_n: int, f_global: Optional[bool] = None
                    ) -> torch.Tensor:
    """(W, 4) float64 ``[slot, score, w_a, w_b]`` of the window rows
    ``buf`` (W, row_len) float64: the plain torch version on a CPU tensor,
    the CUDA window kernel on a CUDA tensor.  ``f_global`` places the flow
    matrices in a global scratch slab (True) or in shared memory (False);
    None (default) picks shared memory where it fits.  Rows the kernel
    cannot take as they lie (an odd length or stride, an unaligned start)
    are first copied to a fresh buffer at :func:`spec_stride`."""
    if buf.dim() != 2 or buf.dtype != torch.float64:
        raise ValueError("ccm_scorer spec: expected (W, row_len) float64 "
                         f"rows (got {tuple(buf.shape)} {buf.dtype})")
    w_n, row_len = buf.shape
    eb = spec_edge_bucket(row_len, a_lanes, b_lanes, p_n)
    _check_spec_indices(buf, eb, a_lanes, b_lanes, p_n)
    if buf.device.type == "cpu":
        return ref.score_spec_rows(buf, a_lanes, b_lanes, p_n)
    if buf.device.type != "cuda":
        raise ValueError("ccm_scorer spec: rows must be a CPU or CUDA tensor")
    in_smem = (spec_f_in_smem(a_lanes, b_lanes, p_n) if f_global is None
               else not f_global)
    check_spec_shapes(w_n, eb, a_lanes, b_lanes, p_n, in_smem)
    stride = buf.stride(0)
    if (buf.stride(1) != 1 or stride % 2 or row_len % 2 or stride < row_len
            or buf.data_ptr() % 16):
        stride = spec_stride(row_len)
        padded = torch.zeros((w_n, stride), dtype=buf.dtype,
                             device=buf.device)
        padded[:, :row_len] = buf
        buf = padded
    out = torch.empty((w_n, 4), dtype=torch.float64, device=buf.device)
    g_n = spec_groups(a_lanes, b_lanes)[2]
    scratch = (None if in_smem else
               torch.empty(w_n * g_n * g_n, dtype=torch.float64,
                           device=buf.device))
    with torch.cuda.device(buf.device):
        launch_spec(buf.data_ptr(), out.data_ptr(),
                    0 if scratch is None else scratch.data_ptr(), w_n, eb,
                    a_lanes, b_lanes, p_n, stride,
                    torch.cuda.current_stream(buf.device).cuda_stream)
    return out
