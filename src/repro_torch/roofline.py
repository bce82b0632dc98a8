"""Roofline terms of a step, counted on the host, after the JAX package's
``roofline.py``.

Three terms per (arch x shape x mesh), in seconds, against one NVIDIA H100
SXM5 80GB's data-sheet figures (the card this port runs on):

  compute    = FLOPs_per_device / peak        (989e12 dense bf16 FLOP/s)
  memory     = bytes_per_device / HBM rate    (3.35e12 B/s)
  collective = collective_bytes_per_device / link (450e9 B/s each way,
                                                    NVLink 4)

The reference reads FLOPs and bytes from XLA's ``cost_analysis`` of the
compiled SPMD module and parses collectives out of its HLO text
(``collective_bytes_from_hlo``); the port has no HLO, so :class:`Counter`
runs the step once, eagerly, on ``meta`` tensors (``launch/steps.py``) and
counts what it dispatches: FLOPs by ``torch.utils.flop_counter``'s
formulas (matrix products), bytes as the operand and result bytes of every
op that moves memory (which is what eager execution moves; views and
``empty`` move none), and collectives by kind from the ``c10d`` ops, their
operand bytes summed.  A hand-written kernel is no aten op: each kernel's
``ops.py`` meta branch adds its own FLOPs and bytes (:func:`add_kernel`),
the arithmetic of PERF.md's bound column.  The mesh's collectives
(``sharding.py``) also report the axis they run over
(:func:`add_axis_bytes`), so that a count splits its collective bytes by
axis and kind (``collective_bytes_by_axis``): the FSDP gathers on
"data", the tensor-parallel sums and the experts' on "model".
"""
from __future__ import annotations

import collections
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12          # bf16 dense, per H100 SXM5
HBM_BW = 3.35e12             # bytes/s per H100 SXM5 (HBM3)
LINK_BW = 450e9              # bytes/s each way per H100 (NVLink 4, 18 links)

COLLECTIVE_OPS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# c10d / functional-collective op name -> the reference's HLO kind
_KINDS = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_base_": "all-to-all", "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}

# ops whose operand is their second argument (the first is the output)
_OPERAND_SECOND = {"_allgather_base_", "_reduce_scatter_base_", "allgather_",
                   "reduce_scatter_"}

_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "_local_scalar_dense"}

_ACTIVE: list = []


def add_kernel(name: str, flops: float, nbytes: float) -> None:
    """A hand-written kernel's work, added to every active
    :class:`Counter` (a kernel's meta branch calls it)."""
    for c in _ACTIVE:
        c.flops += flops
        c.bytes += nbytes
        c.kernels[name] += 1


def add_axis_bytes(kind: str, axis: str, operand) -> None:
    """A collective of ``kind`` over the mesh axis ``axis`` on
    ``operand``, its bytes added to every active :class:`Counter`'s
    by-axis split (``sharding.py``'s collectives call it)."""
    for c in _ACTIVE:
        c.axis_bytes[axis][kind] += _nbytes(operand)


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


class Counter(TorchDispatchMode):
    """Counts a run's FLOPs, bytes and collectives (see the module's
    docstring); ``stats()`` gives them under the reference's keys."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_bytes = {k: 0 for k in COLLECTIVE_OPS}
        self.coll_counts = {k: 0 for k in COLLECTIVE_OPS}
        self.kernels: Dict[str, int] = collections.Counter()
        self.axis_bytes = collections.defaultdict(collections.Counter)
        self.ops = 0

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        name = func._schema.name
        ns, _, op = name.partition("::")
        if ns in ("c10d", "_c10d_functional", "_c10d_functional_autograd"):
            kind = _KINDS.get(op)
            if kind is not None:
                self.coll_counts[kind] += 1
                operand = args[1] if op in _OPERAND_SECOND else args[0]
                self.coll_bytes[kind] += sum(_nbytes(t)
                                             for t in _tensors(operand))
            return out
        packet = func._overloadpacket
        if packet in self._registry:
            self.flops += float(self._registry[packet](*args, **kwargs,
                                                       out_val=out))
        if func.is_view or op in _FREE:
            return out
        self.bytes += sum(_nbytes(t) for t in _tensors(args)) \
            + sum(_nbytes(t) for t in _tensors(kwargs)) \
            + sum(_nbytes(t) for t in _tensors(out))
        return out

    def stats(self) -> dict:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes,
            "collective_bytes": dict(self.coll_bytes),
            "collective_counts": dict(self.coll_counts),
            "collective_bytes_total": int(sum(self.coll_bytes.values())),
            "collective_bytes_by_axis": {a: dict(k) for a, k in
                                         sorted(self.axis_bytes.items())},
            "kernel_calls": dict(self.kernels),
            "ops": self.ops,
        }


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); decode: D=new tokens."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        if cfg.arch_type == "encdec":
            # encoder fwd+bwd over frames (no 2x lm head) + decoder over labels
            from repro_torch.models.encdec import decoder_len
            tokens = shape.global_batch * (shape.seq_len + decoder_len(cfg, shape.seq_len))
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def roofline_terms(stats: dict, cfg, shape, n_chips: int,
                   peak: float = PEAK_FLOPS, hbm: float = HBM_BW,
                   link: float = LINK_BW) -> dict:
    """The three terms, the dominant one and the useful-FLOPs ratios of a
    step's per-device ``stats``, against ``peak`` FLOP/s, ``hbm`` B/s and
    ``link`` B/s (the H100's unless given)."""
    flops = stats.get("flops", 0.0)
    byts = stats.get("bytes_accessed", 0.0)
    coll = stats.get("collective_bytes_total", 0)
    t_comp = flops / peak
    t_mem = byts / hbm
    t_coll = coll / link
    dominant = max((("compute", t_comp), ("memory", t_mem),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, shape)
    hlo_total = flops * n_chips
    return {
        "compute_s": t_comp,
        "memory_s": t_mem,
        "collective_s": t_coll,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_total": hlo_total,
        "useful_flops_ratio": (mf / hlo_total) if hlo_total else 0.0,
        "bound_step_s": max(t_comp, t_mem, t_coll),
        "roofline_fraction": (mf / n_chips / peak) /
                             max(t_comp, t_mem, t_coll, 1e-30),
    }


def count(fn, *args, **kwargs):
    """Run ``fn`` once under a :class:`Counter`; returns (its result, the
    counter's stats)."""
    with Counter() as c:
        out = fn(*args, **kwargs)
    return out, c.stats()
