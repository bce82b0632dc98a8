"""The CUDA flash-attention kernels: build, bind and launch.

The forward (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash/kernel.py:89`` (``flash_attention_fwd`` →
``_flash_kernel``).  The backward (``csrc/flash_attention_bwd.cu``)
replaces no TPU kernel: the JAX package differentiates its jnp attention,
while the port's forward runs a kernel whose gradient must be a kernel too.
Built and bound like the port's other kernels (``kernels/_build.py``); a
failed build or launch raises, nothing falls back.  The backward's design is
chosen by the shape alone (:func:`tc_backward`): bf16 at hd 64, 128 or
256 runs on the tensor cores and reads each row's log-sum-exp from the
forward's LSE instance (``flash_attention_fwd(..., with_lse=True)``); at hd
256 a kv head's q heads are split over :func:`dkdv_splits` blocks whose
float32 partial sums of dK and dV a last kernel adds in order.  float32
and the other bf16 head dims run the float32-core kernels, which rebuild
the row statistics themselves.
:func:`flash_attention_fwd` and :func:`flash_attention_bwd` launch them on
CUDA tensors only, on the current stream, and count the launches in
:data:`LAUNCHES` and :data:`BWD_LAUNCHES`; ``ops.flash_attention`` is the
entry point that also takes CPU tensors, and the autograd function that
joins the two.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "flash_attention.cu"
BWD_SOURCE = _build.CSRC / "flash_attention_bwd.cu"

#: kernel launches per dtype, counted where the kernel is launched only
LAUNCHES = {"bfloat16": 0, "float32": 0}
#: backward launches per dtype (one C call: the prep, dK/dV and dQ kernels)
BWD_LAUNCHES = {"bfloat16": 0, "float32": 0}

_DTYPES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
TILE = 64            # the kernel's largest q and kv tile (rows)
MAX_HEAD_DIM = 256
_MAX_GRID_Y = 65535
#: streaming multiprocessors of an H100 SXM (the default of dkdv_splits)
SMS = 132
_lib = None
_bwd_lib = None


def reset_launches() -> None:
    for counts in (LAUNCHES, BWD_LAUNCHES):
        for k in counts:
            counts[k] = 0


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``
    (once per process, and not at all when a build of the same source and
    flags exists) and load them.  Returns the forward library's path.
    ``verbose`` prints nvcc's ``-Xptxas -v`` reports."""
    global _lib, _bwd_lib
    if _lib is not None:
        return Path(_lib._name)
    for out in _build.compile_sources([SOURCE, BWD_SOURCE], verbose).values():
        if verbose:
            print(out, flush=True)
    lib = ctypes.CDLL(str(_build.library_path(SOURCE)))
    for name in ("flash_attention_bf16", "flash_attention_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.flash_attention_bf16_lse.argtypes = [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_float,
                                ctypes.c_void_p]
    lib.flash_attention_bf16_lse.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    bwd = ctypes.CDLL(str(_build.library_path(BWD_SOURCE)))
    for name in ("flash_attention_bwd_bf16", "flash_attention_bwd_f32"):
        fn = getattr(bwd, name)
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 \
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    bwd.flash_attention_bwd_bf16_tc.argtypes = [ctypes.c_void_p] * 10 \
        + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_float,
                                ctypes.c_void_p]
    bwd.flash_attention_bwd_bf16_tc.restype = ctypes.c_int
    bwd.flash_attention_bwd_bf16_tc256.argtypes = [ctypes.c_void_p] * 11 \
        + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_float,
                                ctypes.c_void_p]
    bwd.flash_attention_bwd_bf16_tc256.restype = ctypes.c_int
    bwd.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    bwd.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    _lib, _bwd_lib = lib, bwd
    return Path(lib._name)


def tc_backward(dtype: torch.dtype, hd: int) -> bool:
    """Whether the backward of this shape runs on the tensor cores (bf16,
    hd 64, 128 or 256: wgmma fed by TMA, the row statistics from the
    forward's LSE instance); otherwise the float32-core kernels.  Decided
    by the shape alone, before any launch."""
    return dtype == torch.bfloat16 and hd in (64, 128, 256)


def dkdv_splits(bhq: int, bhkv: int, skv: int, sms: int = SMS) -> int:
    """The hd 256 backward's splits of a kv head's q heads over dK/dV
    blocks: the fewest (a divisor of the group BHq / BHkv) that give at
    least two blocks of (64-row kv tile, kv head, split) a streaming
    multiprocessor, else one a q head.  Each split's blocks write float32
    partial sums of dK and dV, added in split order after them."""
    group = bhq // bhkv
    blocks = -(-skv // TILE) * bhkv
    for splits in range(1, group + 1):
        if group % splits == 0 and blocks * splits >= 2 * sms:
            return splits
    return group


def lse_rows(sq: int) -> int:
    """The row stride of the forward's LSE output and the backward's D
    scratch: Sq rounded up to a multiple of 64 (16-byte aligned rows for
    the backward's bulk copies)."""
    return -(-sq // TILE) * TILE


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it whose base is 16-byte aligned (TMA's rule; a
    contiguous view at an odd offset is the only tensor that needs one)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(q, k, v, block_q, block_k) -> None:
    tensors = (q, k, v)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("flash_attention: q, k, v must all be on one CUDA "
                         f"device (got {[str(t.device) for t in tensors]})")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError("flash_attention: one dtype, bfloat16 or float32 "
                         f"(got {[str(t.dtype) for t in tensors]})")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError("flash_attention: expected q (BHq, Sq, hd), k and v "
                         f"(BHkv, Skv, hd), got "
                         f"{[tuple(t.shape) for t in tensors]}")
    bhq, sq, hd = q.shape
    bhkv, skv, hd_k = k.shape
    if hd_k != hd or bhkv == 0 or bhq % bhkv != 0:
        raise ValueError("flash_attention: head dims differ or BHq is not a "
                         f"multiple of BHkv ({tuple(q.shape)}, "
                         f"{tuple(k.shape)})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention: inputs must be contiguous")
    if q.dtype == torch.bfloat16 and hd % 8 != 0:
        raise ValueError("flash_attention: the bf16 kernel's TMA loads need "
                         "a head dim that is a multiple of 8, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    if (not 1 <= hd <= MAX_HEAD_DIM or not 1 <= block_q <= TILE
            or not 1 <= block_k <= TILE or bhq > _MAX_GRID_Y
            or max(bhq * sq, bhkv * skv) * hd >= 2 ** 31):
        raise ValueError(f"flash_attention: unsupported head dim {hd}, "
                         f"blocks ({block_q}, {block_k}) or shape "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0, block_q: int = TILE,
                        block_k: int = TILE, with_lse: bool = False):
    """Launch the kernel: q (BHq, Sq, hd), k, v (BHkv, Skv, hd), one dtype
    (bfloat16 or float32), contiguous on one CUDA device -> (BHq, Sq, hd)
    in q's dtype.  float32: ``block_q`` x ``block_k`` (at most 64 each) is
    the tile; it changes only the order of float32 sums.  bfloat16: the
    tiles are fixed by the tensor-core design (64 q rows a warpgroup, two a
    block, and 64 kv rows a stage), so only the default 64 x 64 is taken
    and another value raises; hd must be a multiple of 8.  ``with_lse``
    (only where :func:`tc_backward`; another shape raises) launches the
    instance that also writes each row's log-sum-exp in log2 units and
    returns (out, lse), lse (BHq, :func:`lse_rows`) float32 (0 for a row
    that sees no key, the rows past Sq unset); its out is the plain
    instance's, bit for bit."""
    bhq, sq, hd = q.shape
    bhkv, skv, _ = k.shape
    if q.dtype == torch.bfloat16 and (block_q, block_k) != (TILE, TILE):
        raise ValueError("flash_attention: the bf16 kernel's tiles are "
                         f"fixed at ({TILE}, {TILE}); got ({block_q}, "
                         f"{block_k})")
    if with_lse and not tc_backward(q.dtype, hd):
        raise ValueError("flash_attention: the LSE instance is for the "
                         "tensor-core backward's shapes (bf16, hd 64, 128 "
                         f"or 256); got {q.dtype}, hd {hd}")
    block_q, block_k = min(block_q, max(sq, 1)), min(block_k, max(skv, 1))
    _check(q, k, v, block_q, block_k)
    if q.dtype == torch.bfloat16:
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    lse = (torch.empty((bhq, lse_rows(sq)), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    build()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        scale = 1.0 / (hd ** 0.5)
        if with_lse:
            rc = _lib.flash_attention_bf16_lse(
                *ptrs, lse.data_ptr(), bhq, bhkv, sq, skv, hd, int(causal),
                int(window), scale, float(softcap), stream)
        else:
            fn = (_lib.flash_attention_bf16 if q.dtype == torch.bfloat16
                  else _lib.flash_attention_f32)
            rc = fn(*ptrs, bhq, bhkv, sq, skv, hd, block_q, block_k,
                    int(causal), int(window), scale, float(softcap), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({rc}): "
                           + _lib.flash_attention_error_string(rc).decode())
    LAUNCHES[_DTYPES[q.dtype]] += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, d_out: torch.Tensor, *,
                        lse: torch.Tensor = None, causal: bool = True,
                        window: int = 0, softcap: float = 0.0):
    """Launch the backward kernels: q, ``out`` (the forward's output) and
    ``d_out`` (BHq, Sq, hd), k and v (BHkv, Skv, hd), one dtype (bfloat16 or
    float32), contiguous on one CUDA device -> (dq, dk, dv) in that dtype,
    accumulated in float32 and rounded once.  Where :func:`tc_backward`
    (bf16, hd 64, 128 or 256) the tensor-core kernels run on ``lse``, the
    forward's LSE output (required there), with rowsum(dO o O) as float32
    scratch of this call (at hd 256 also the dK/dV blocks' partial sums,
    2 x :func:`dkdv_splits` x BHkv x Skv x 256); elsewhere the float32-core
    kernels, whose scratch also holds each row's softmax max and
    reciprocal sum (2, BHq, Sq)."""
    _check(q, k, v, TILE, TILE)
    for name, t in (("out", out), ("d_out", d_out)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"flash_attention_bwd: {name} must be like q "
                             f"{tuple(q.shape)} {q.dtype}, contiguous; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    bhq, sq, hd = q.shape
    bhkv, skv, _ = k.shape
    tc = tc_backward(q.dtype, hd)
    if tc and (lse is None or lse.shape != (bhq, lse_rows(sq))
               or lse.dtype != torch.float32 or lse.device != q.device
               or not lse.is_contiguous()):
        raise ValueError("flash_attention_bwd: the tensor-core backward "
                         "needs the forward's lse (BHq, "
                         f"{lse_rows(sq)}) float32 (flash_attention_fwd(..., "
                         "with_lse=True))")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if sq == 0 or skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    build()
    scale = 1.0 / (hd ** 0.5)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if tc:
            q, k, v, out, d_out = (_aligned(t) for t in (q, k, v, out, d_out))
            delta = torch.empty((bhq, lse_rows(sq)), dtype=torch.float32,
                                device=q.device)
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    d_out.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), delta.data_ptr())
            if hd == 256:
                sms = torch.cuda.get_device_properties(
                    q.device).multi_processor_count
                splits = dkdv_splits(bhq, bhkv, skv, sms)
                part = torch.empty((2, splits, bhkv, skv, hd),
                                   dtype=torch.float32, device=q.device)
                rc = _bwd_lib.flash_attention_bwd_bf16_tc256(
                    *ptrs, part.data_ptr(), bhq, bhkv, sq, skv, splits,
                    int(causal), int(window), scale, float(softcap), stream)
            else:
                rc = _bwd_lib.flash_attention_bwd_bf16_tc(
                    *ptrs, bhq, bhkv, sq, skv, hd, int(causal), int(window),
                    scale, float(softcap), stream)
        else:
            stats = torch.empty((2, bhq, sq), dtype=torch.float32,
                                device=q.device)
            delta = torch.empty((bhq, sq), dtype=torch.float32,
                                device=q.device)
            fn = (_bwd_lib.flash_attention_bwd_bf16
                  if q.dtype == torch.bfloat16
                  else _bwd_lib.flash_attention_bwd_f32)
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    d_out.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), stats.data_ptr(), delta.data_ptr(), bhq,
                    bhkv, sq, skv, hd, int(causal), int(window), scale,
                    float(softcap), stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_bwd kernel launch failed ({rc}): "
            + _bwd_lib.flash_attention_bwd_error_string(rc).decode())
    BWD_LAUNCHES[_DTYPES[q.dtype]] += 1
    return dq, dk, dv
