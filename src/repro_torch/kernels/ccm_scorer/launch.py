"""The event launcher: pack a batch of lock events and score their
shortlisted pairs, combine included, in one launch.

The counterpart of ``repro/kernels/ccm_scorer/jit.py``'s ``score_events``.
Like its ``kind="pairs"`` path (``jit.py:213``) it scores only the
shortlist, so the host gets back O(P) values, not O(A*B) tiles.  The JAX
launcher padded tiles into shape buckets so that ``jax.jit`` would not
retrace, and to the TPU's (8, 128) tiling; the CUDA kernel is compiled once
for every shape, so the port pads a batch only to its largest event (A =
max(na)+1, B = max(nb)+1).  Padding stays invariant all the same: a padded
lane never changes a live one (every operation of the scorer is elementwise
over the tile).  There is no interpret fallback: a batch is scored on the
device the caller names, and a CUDA failure raises.

Per scorer call the host packs every live event's tiles (as they were
packed for the full-tile scorer, padded to the batch), one float64 combine
row per event (``layout.CF``), the int32 pair offsets and the int32 pairs
into ONE flat byte buffer (:func:`pack`).  Where the work combine runs:

- on the card, the buffer is pinned and reused (one per device and
  dtype); one asynchronous copy moves it into a reused device buffer, one
  launch of the pair kernel (``kernel.launch_pairs``) scores the pairs and
  applies the combine and eq. 9's feasibility, one asynchronous copy
  brings the (3, P) float64 result into a pinned output buffer, and one
  wait follows: four C calls on the current stream, no torch call (every
  Python step of a call costs microseconds of host time between the
  engine's numpy);
- on the CPU, the same buffer (ordinary memory) goes through the plain
  version of the same function (``ref.score_pairs_packed``).

The host's float64 combines (``ops.combine_work*``) are the oracle both
are held to.  :data:`STATS` counts the calls, their host seconds and how
those split over the steps, and the launched shapes.

:func:`score_spec` is the speculative driver's launcher (``core/spec.py``;
the counterpart of ``jit.py``'s ``score_spec``): a window of captured lock
events, each one float64 row built by ``PhaseEngine.spec_raw``, stacked
into the same reused staging buffer and scored in ONE launch of the window
kernel (``kernel.launch_spec``: flow matrix, features, scores, combine and
selection on the card), with (W, 4) copied back; on the CPU the same rows
go through ``ref.score_spec_rows``.  ``STATS["spec"]`` counts its calls.
"""
from __future__ import annotations

from collections import Counter
from time import perf_counter
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.ccm_scorer import kernel
from repro_torch.kernels.ccm_scorer.layout import (CF, CF_FROM_SC, N_AV,
                                                   N_CF, N_PM, N_SC, SC,
                                                   bucket_events, spec_groups,
                                                   spec_offsets)

__all__ = ["resolve_device", "check_dtype", "score_events", "score_spec",
           "stack_spec", "STATS", "reset_stats", "pack", "Packed", "Staging",
           "staging", "SPEC_MODES"]


def _spec_record() -> dict:
    """A fresh ``STATS["spec"]``, the window scorer's: calls, events
    scored (rows before padding), host seconds, their split (``pack`` =
    stacking the rows into the staging buffer, then as above; on the CPU
    the plain version's work is in ``launch``) and a histogram of the
    launched (W, eb) shapes."""
    return {"calls": 0, "rows": 0, "seconds": 0.0,
            "split": dict.fromkeys(("pack", "h2d", "launch", "d2h"), 0.0),
            "shapes": Counter()}


#: scorer calls; their host seconds (the sum of the split); the split by
#: step: ``pack`` (into the staging buffer), ``h2d`` (queue the copy in),
#: ``launch``, ``d2h`` (queue the copy out and wait for it, the kernel
#: included) and ``combine`` (the per-event results out of the (3, P)
#: block; on the CPU the plain version's work is in ``launch``); a
#: histogram of the launched (E, A, B) shapes, and of (E, A, B, P);
#: ``spec``, the window scorer's record (:func:`_spec_record`)
STATS = {"calls": 0, "seconds": 0.0, "shapes": Counter(),
         "pair_shapes": Counter(),
         "split": dict.fromkeys(("pack", "h2d", "launch", "d2h", "combine"),
                                0.0),
         "spec": _spec_record()}
#: the window scorer's modes: the JAX package's ``lax.scan`` and
#: ``jax.vmap`` wrappers of one per-row body.  Its rows are independent
#: (the scan carries a dummy state), so one launch with a block a row
#: computes both
SPEC_MODES = ("scan", "vmap")

_NP_DTYPES = {torch.float64: np.float64, torch.float32: np.float32}
_ALIGN = 16                 # bytes, the start of every packed region
_CF_FROM_SC = np.array(CF_FROM_SC)
_MAX_LAYOUTS = 4096         # call shapes whose views a Staging keeps
_REGIONS = ("av", "bv", "pm", "sc", "cf", "offs", "pairs")


def reset_stats() -> None:
    STATS["calls"] = 0
    STATS["seconds"] = 0.0
    STATS["shapes"] = Counter()
    STATS["pair_shapes"] = Counter()
    STATS["split"] = dict.fromkeys(STATS["split"], 0.0)
    STATS["spec"] = _spec_record()


def resolve_device(device=None) -> torch.device:
    """The device of an entry point (the balancer's scorer, task timing,
    cost-model training): ``None`` means ``"cuda"``, which raises when no
    card is present; ``"cpu"`` only when asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and "
                "torch.cuda.is_available() is false; pass device='cpu' to "
                "run the plain torch versions on the host")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_dtype(dtype) -> torch.dtype:
    if dtype not in _NP_DTYPES:
        raise ValueError(f"dtype must be torch.float64 or torch.float32, "
                         f"not {dtype}")
    return dtype


class Packed(NamedTuple):
    """One packed scorer call: its shape and the byte offset of each region
    in the buffer (``av``, ``bv``, ``pm``, ``sc`` in the scoring dtype,
    ``cf`` float64, ``offs`` and ``pairs`` int32), and its length."""
    e_n: int
    a_n: int
    b_n: int
    p_total: int
    offsets: Dict[str, int]
    nbytes: int


def _layout(e_n: int, a_n: int, b_n: int, p_total: int,
            itemsize: int) -> Packed:
    sizes = (("cf", e_n * N_CF * 8), ("av", e_n * N_AV * a_n * itemsize),
             ("bv", e_n * N_AV * b_n * itemsize),
             ("pm", e_n * N_PM * a_n * b_n * itemsize),
             ("sc", e_n * N_SC * itemsize), ("offs", (e_n + 1) * 4),
             ("pairs", p_total * 8))
    offsets, end = {}, 0
    for name, size in sizes:
        offsets[name] = end
        end += -(-size // _ALIGN) * _ALIGN
    return Packed(e_n, a_n, b_n, p_total, offsets, end)


def _views(buf: np.ndarray, packed: Packed, dtype) -> tuple:
    """The regions of ``buf`` (a flat uint8 array holding ``packed``) as
    numpy arrays of their shapes: av, bv, pm, sc, cf, offs, pairs."""
    e_n, a_n, b_n, p_n, o, _ = packed
    shapes = ((e_n, N_AV, a_n), (e_n, N_AV, b_n), (e_n, N_PM, a_n, b_n),
              (e_n, N_SC), (e_n, N_CF), (e_n + 1,), (p_n, 2))
    types = (_NP_DTYPES[dtype],) * 4 + (np.float64, np.int32, np.int32)
    return tuple(np.ndarray(shape, dt, buf, o[name])
                 for name, shape, dt in zip(_REGIONS, shapes, types))


def pack(feats: Sequence[Tuple], pairs_list: Sequence[np.ndarray], params,
         st: "Staging") -> tuple:
    """Pack a batch of events into ``st``'s host input buffer: their
    feature tiles (padded to the batch's largest event, zeros in the
    padding), float64 combine rows (the CCM coefficients and the float64
    SC row's speeds and caps), int32 pair offsets and pairs.  Returns
    ``st.layout`` of the call: its layout, the regions' numpy views
    (:func:`_views`) and their device addresses.  The pairs are
    checked where they are read: by ``kernel.score_pairs`` on tensors, by
    the C launch on the card's route."""
    e_n = len(feats)
    a_n = b_n = p_total = 0
    for (av_k, bv_k, _, _), pr_k in zip(feats, pairs_list):
        a_n = max(a_n, av_k.shape[1])
        b_n = max(b_n, bv_k.shape[1])
        p_total += len(pr_k)
    hit = st.layout(e_n, a_n, b_n, p_total)
    packed, (av, bv, pm, sc, cf, offs, pr), _ = hit
    if e_n > 1 and any(f[0].shape[1] != a_n or f[1].shape[1] != b_n
                       for f in feats):
        o = packed.offsets
        st.host_in_np[o["av"]:o["sc"]] = 0
    cf[0, :CF.speed_a] = (params.alpha, params.beta, params.gamma,
                          params.delta)
    end = offs[0] = 0
    for k, (av_k, bv_k, pm_k, sc_k) in enumerate(feats):
        av[k, :, :av_k.shape[1]] = av_k
        bv[k, :, :bv_k.shape[1]] = bv_k
        pm[k, :, :pm_k.shape[1], :pm_k.shape[2]] = pm_k
        sc[k] = sc_k
        cf[k, CF.speed_a:] = sc_k[_CF_FROM_SC]
        start, end = end, end + len(pairs_list[k])
        pr[start:end] = pairs_list[k]
        offs[k + 1] = end
    if e_n > 1:
        cf[1:, :CF.speed_a] = cf[0, :CF.speed_a]
    return hit


class Staging:
    """The reused buffers of one (device, dtype): a host buffer the packer
    writes (pinned on the card), its device copy, and a pinned host and a
    device buffer for the (3, P) result; each grown geometrically on
    demand, never shrunk (a grown buffer replaces the old one only between
    calls).  On the CPU only the host input buffer exists (pinning needs
    CUDA).  :meth:`layout` caches each call shape's layout and views.  One
    call at a time: the launcher is not for concurrent threads."""

    def __init__(self, device: torch.device, dtype: torch.dtype):
        self.device, self.dtype = device, dtype
        self.itemsize = _NP_DTYPES[dtype]().itemsize
        self.pin = device.type == "cuda"
        self.host_in = self.host_out = self.dev_scratch = None
        self._layouts: Dict[tuple, tuple] = {}
        if self.pin:
            kernel.build()
            self.index = (torch.cuda.current_device() if device.index is None
                          else device.index)

    @staticmethod
    def _size(have, need: int) -> int:
        return max(need, 2 * have.numel() if have is not None else 0, 4096)

    def layout(self, e_n: int, a_n: int, b_n: int, p_total: int) -> tuple:
        """The layout of a call of this shape, its regions as views into
        the host input buffer (grown to hold it) and, on the card, their
        addresses in the device input buffer (else None)."""
        key = (e_n, a_n, b_n, p_total)
        hit = self._layouts.get(key)
        if hit is None:
            kernel.check_pair_shapes(e_n, a_n, b_n, p_total)
            packed = _layout(e_n, a_n, b_n, p_total, self.itemsize)
            self._input(packed.nbytes)
            if len(self._layouts) >= _MAX_LAYOUTS:
                self._layouts.clear()
            ptrs = (tuple(self.dev_in_ptr + packed.offsets[name]
                          for name in _REGIONS) if self.pin else None)
            hit = self._layouts[key] = (
                packed, _views(self.host_in_np, packed, self.dtype), ptrs)
        return hit

    def _input(self, nbytes: int) -> None:
        if self.host_in is not None and self.host_in.numel() >= nbytes:
            return
        size = self._size(self.host_in, nbytes)
        self.host_in = torch.empty(size, dtype=torch.uint8,
                                   pin_memory=self.pin)
        self.host_in_np = self.host_in.numpy()
        self.host_in_ptr = self.host_in.data_ptr()
        self._layouts.clear()           # their views are of the old buffer
        if self.pin:
            self.dev_in = torch.empty(size, dtype=torch.uint8,
                                      device=self.index)
            self.dev_in_ptr = self.dev_in.data_ptr()

    def window(self, w_n: int, row_len: int) -> np.ndarray:
        """A (w_n, row_len) float64 view of the host input buffer (grown
        to hold it), for a window of spec rows, at the window kernel's row
        stride (``kernel.spec_stride``: row_len rounded up to even, so each
        row starts on a 16-byte granule; a pad value is never used)."""
        stride = kernel.spec_stride(row_len)
        nbytes = 8 * w_n * stride
        self._input(nbytes)
        return self.host_in_np[:nbytes].view(np.float64).reshape(
            w_n, stride)[:, :row_len]

    def scratch(self, n: int) -> int:
        """The address of a device scratch buffer of at least ``n`` float64
        values (the window kernel's flow matrices in global memory)."""
        have = self.dev_scratch
        if have is None or have.numel() < n:
            self.dev_scratch = torch.empty(self._size(have, n),
                                           dtype=torch.float64,
                                           device=self.index)
        return self.dev_scratch.data_ptr()

    def output(self, n: int) -> None:
        if self.host_out is None or self.host_out.numel() < n:
            size = self._size(self.host_out, n)
            self.host_out = torch.empty(size, dtype=torch.float64,
                                        pin_memory=True)
            self.host_out_np = self.host_out.numpy()
            self.host_out_ptr = self.host_out.data_ptr()
            self.dev_out = torch.empty(size, dtype=torch.float64,
                                       device=self.index)
            self.dev_out_ptr = self.dev_out.data_ptr()


_STAGING: Dict[tuple, Staging] = {}


def staging(device: torch.device, dtype: torch.dtype) -> Staging:
    """The launcher's reused :class:`Staging` of ``(device, dtype)``."""
    key = (device.type, device.index, dtype)
    st = _STAGING.get(key)
    if st is None:
        st = _STAGING[key] = Staging(device, dtype)
    return st


def _score_cuda(st: Staging, packed: Packed, dev_ptrs: Tuple[int, ...],
                memory_constraint: bool) -> np.ndarray:
    """Copy the packed buffer in, launch the pair kernel, copy (3, P) out
    and wait, each one C call on the current stream.  Reusing the staging
    buffers across calls is safe only because this waits for the result
    before it returns (and before it raises): no copy of one call is in
    flight when the next call packs or reads them."""
    if torch.cuda.current_device() != st.index:
        with torch.cuda.device(st.index):
            return _score_cuda(st, packed, dev_ptrs, memory_constraint)
    split = STATS["split"]
    t0 = perf_counter()
    n_out = 3 * packed.p_total
    st.output(n_out)
    # the raw handle of torch.cuda.current_stream(), without building a
    # Stream object on every call
    stream = torch._C._cuda_getCurrentRawStream(st.index)
    kernel.copy_async(st.dev_in_ptr, st.host_in_ptr, packed.nbytes, stream)
    t1 = perf_counter()
    kernel.launch_pairs(st.dtype, *dev_ptrs, st.dev_out_ptr, packed.e_n,
                        packed.a_n, packed.b_n, packed.p_total,
                        memory_constraint, stream, host_pairs=dev_ptrs[-1]
                        - st.dev_in_ptr + st.host_in_ptr)
    t2 = perf_counter()
    kernel.copy_async(st.host_out_ptr, st.dev_out_ptr, 8 * n_out, stream)
    kernel.synchronize(stream)
    t3 = perf_counter()
    split["h2d"] += t1 - t0
    split["launch"] += t2 - t1
    split["d2h"] += t3 - t2
    return st.host_out_np[:n_out].reshape(3, packed.p_total)


def score_events(feats: Sequence[Tuple], pairs_list: Sequence[np.ndarray],
                 params, *, device: torch.device, dtype: torch.dtype,
                 ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Score a batch of lock events through one scorer launch.

    ``feats``: per-event unpadded feature tuples ``(av, bv, pm, sc)`` as
    built by ``PhaseEngine._event_features`` (av: (N_AV, na+1), ...; sc
    float64); ``pairs_list``: per-event (P, 2) int64 shortlists.  Returns
    per-event ``(w_a, w_b, feasible)`` aligned with each event's pairs.
    Events with an empty shortlist are answered without scoring; a batch
    with none left makes no call.
    """
    e_n = len(feats)
    results: List[Optional[Tuple]] = [None] * e_n
    live = [k for k in range(e_n) if pairs_list[k].shape[0]]
    for k in range(e_n):
        if pairs_list[k].shape[0] == 0:
            z = np.zeros(0)
            results[k] = (z, z, np.zeros(0, bool))
    if not live:
        return results

    split = STATS["split"]
    t0 = perf_counter()
    st = staging(device, dtype)
    lp = [pairs_list[k] for k in live]
    packed, regions, dev_ptrs = pack([feats[k] for k in live], lp, params,
                                     st)
    t1 = perf_counter()
    split["pack"] += t1 - t0
    if st.pin:
        out = _score_cuda(st, packed, dev_ptrs, params.memory_constraint)
    else:
        out = kernel.score_pairs(*map(torch.from_numpy, regions),
                                 params.memory_constraint).numpy()
    t2 = perf_counter()
    w_a, w_b = out[0].copy(), out[1].copy()
    feas = out[2] != 0.0
    end = 0
    for k, p in zip(live, lp):
        start, end = end, end + p.shape[0]
        results[k] = (w_a[start:end], w_b[start:end], feas[start:end])
    t3 = perf_counter()
    if not st.pin:
        split["launch"] += t2 - t1
    split["combine"] += t3 - t2
    STATS["calls"] += 1
    STATS["seconds"] += t3 - t0
    STATS["shapes"][(packed.e_n, packed.a_n, packed.b_n)] += 1
    STATS["pair_shapes"][(packed.e_n, packed.a_n, packed.b_n,
                          packed.p_total)] += 1
    return results


# ------------------------------------------------- the speculative window
def stack_spec(raws: Sequence[Tuple[np.ndarray, int]], buf: np.ndarray,
               eb: int, o_sc: int) -> None:
    """Stack ``raws`` (``(row, eb_k)`` from ``PhaseEngine.spec_raw``) into
    ``buf`` (w_n, row_len), a window whose edge bucket ``eb`` is the largest
    of theirs: a row of that bucket lands verbatim, a smaller one with its
    ``bins``, ``w`` and eb-independent tail copied into place and its
    remaining edge slots zero (bin 0, volume 0).  Rows past the events are
    pad rows: zero, with unit speeds (``o_sc`` is the row's scalar offset)
    so the combine cannot divide 0 by 0; their pair count 0 masks every
    slot."""
    n = len(raws)
    for k, (row, e_k) in enumerate(raws):
        if e_k == eb:
            buf[k] = row
        else:
            buf[k, :2 * eb] = 0.0
            buf[k, :e_k] = row[:e_k]
            buf[k, eb:eb + e_k] = row[e_k:2 * e_k]
            buf[k, 2 * eb:] = row[2 * e_k:]
    buf[n:] = 0.0
    buf[n:, o_sc + SC.speed_a] = 1.0
    buf[n:, o_sc + SC.speed_b] = 1.0


def score_spec(raws: Sequence[Tuple[np.ndarray, int]], *, a_lanes: int,
               b_lanes: int, p_n: int, mode: str = "scan",
               device=None) -> np.ndarray:
    """Score a window of speculative lock events in ONE launch.

    ``raws``: per-event ``(row, eb)`` as ``PhaseEngine.spec_raw`` builds
    them (``w_before`` baked in), all of lanes ``(a_lanes, b_lanes)`` and
    pair bucket ``p_n``.  The window is padded to the next power of two of
    rows (``layout.bucket_events``) with pad rows, and its edge bucket is
    the largest of the rows' (:func:`stack_spec`).  Returns ``(len(raws),
    4)`` float64 ``[slot, score, w_a, w_b]`` (``ref.score_spec_rows``).

    On the card the rows are stacked into the pinned staging buffer of
    (device, float64) at the kernel's even row stride, copied in, scored
    by one launch of the window kernel and (W, 4) copied back, each step
    one C call on the current stream; on the CPU the same buffer (the same
    stride) goes through the plain version.  ``mode`` is
    ``"scan"`` or ``"vmap"`` (:data:`SPEC_MODES`), which run the same
    kernel.  ``device`` None means CUDA."""
    if mode not in SPEC_MODES:
        raise ValueError(f"unknown spec mode: {mode!r} (expected one of "
                         f"{SPEC_MODES})")
    n = len(raws)
    if n == 0:
        return np.zeros((0, 4))
    dev = resolve_device(device)
    rec = STATS["spec"]
    split = rec["split"]
    t0 = perf_counter()
    w_n = bucket_events(n)
    eb = max(r[1] for r in raws)
    offs = spec_offsets(eb, a_lanes, b_lanes, p_n)
    st = staging(dev, torch.float64)
    buf = st.window(w_n, offs[-1])
    stack_spec(raws, buf, eb, offs[4])
    t1 = perf_counter()
    split["pack"] += t1 - t0
    if st.pin:
        out = _score_spec_cuda(st, w_n, eb, offs[-1], a_lanes, b_lanes, p_n,
                               split)
    else:
        out = kernel.score_spec_rows(torch.from_numpy(buf), a_lanes, b_lanes,
                                     p_n).numpy()
        split["launch"] += perf_counter() - t1
    res = out[:n].copy()
    rec["calls"] += 1
    rec["rows"] += n
    rec["seconds"] += perf_counter() - t0
    rec["shapes"][(w_n, eb)] += 1
    return res


def _score_spec_cuda(st: Staging, w_n: int, eb: int, row_len: int,
                     a_n: int, b_n: int, p_n: int,
                     split: dict) -> np.ndarray:
    """Copy the stacked window in, launch the window kernel, copy (W, 4)
    out and wait, each one C call on the current stream (the staging reuse
    is safe for the reason :func:`_score_cuda` gives)."""
    if torch.cuda.current_device() != st.index:
        with torch.cuda.device(st.index):
            return _score_spec_cuda(st, w_n, eb, row_len, a_n, b_n, p_n,
                                    split)
    t0 = perf_counter()
    in_smem = kernel.spec_f_in_smem(a_n, b_n, p_n)
    kernel.check_spec_shapes(w_n, eb, a_n, b_n, p_n, in_smem)
    g_n = spec_groups(a_n, b_n)[2]
    scratch = 0 if in_smem else st.scratch(w_n * g_n * g_n)
    stride = kernel.spec_stride(row_len)
    nbytes = 8 * w_n * stride
    st.output(4 * w_n)
    stream = torch._C._cuda_getCurrentRawStream(st.index)
    kernel.copy_async(st.dev_in_ptr, st.host_in_ptr, nbytes, stream)
    t1 = perf_counter()
    kernel.launch_spec(st.dev_in_ptr, st.dev_out_ptr, scratch, w_n, eb, a_n,
                       b_n, p_n, stride, stream, host_buf=st.host_in_ptr)
    t2 = perf_counter()
    kernel.copy_async(st.host_out_ptr, st.dev_out_ptr, 8 * 4 * w_n, stream)
    kernel.synchronize(stream)
    t3 = perf_counter()
    split["h2d"] += t1 - t0
    split["launch"] += t2 - t1
    split["d2h"] += t3 - t2
    return st.host_out_np[:4 * w_n].reshape(w_n, 4)
