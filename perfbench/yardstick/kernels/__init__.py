"""The work of each hand-written kernel family, one module a family found by
its name (``flash``, ``moe_gemm``, ``wkv6``; :func:`families` lists them).

Each module gives:

- ``NAMES``: the substrings by which its kernels are known in a device
  trace;
- ``COUNTERS``: for each pass (``"fwd"``, ``"bwd"``), where the program
  counts the family's launches, as ``"<module>:<dict>"`` (read by name by
  the harness; nothing here imports the program);
- ``PEAK_FLOPS``: the peak its operations run at (the tensor cores' bf16
  rate, or float32 outside them);
- ``work(launch) -> (flops, bytes)`` of one launch described by a dict of
  its shapes (``launch["pass"]`` names the pass);
- ``launches(m, work, counts) -> [(n, launch)]``: the launches that the
  window's ``work`` implies for a configuration's ``model`` table ``m``,
  held against ``counts``, the window's launches by pass.  It raises
  :class:`Mismatch` where the counts are not those the work implies.

FLOPs count what the inputs need (the causal half; the tokens each expert
keeps, not its capacity padding); bytes count each input read once and
each output written once, whatever the kernel reads again.

The window's ``work`` is a list of the calls a driver made, each a dict:

- ``{"phase": "prefill", "batch", "seq"}``: a forward pass over ``seq``
  tokens of ``batch`` sequences, no gradient;
- ``{"phase": "decode", "batch", "pos", "steps"}``: ``steps`` one-token
  steps after ``pos`` positions;
- ``{"phase": "train", "batch", "seq"}``: a training step, forward and
  backward (and, under remat, the forward again); a mixture of experts'
  step adds ``"kept"``, the tokens that each layer's experts keep
  together, a list a layer."""
from __future__ import annotations

import importlib
import pkgutil
from typing import Dict, List


class Mismatch(ValueError):
    """The window's launches are not those its work implies."""


def families() -> List[str]:
    return sorted(m.name for m in pkgutil.iter_modules(__path__))


def family(name: str):
    return importlib.import_module(f"perfbench.yardstick.kernels.{name}")


def layers(m, kinds) -> int:
    """The layers of ``m`` whose block kind is one of ``kinds``."""
    pattern = m["block_pattern"]
    return sum(pattern[i % len(pattern)] in kinds
               for i in range(m["num_layers"]))


def phases(work, phase: str) -> list:
    return [w for w in work if w["phase"] == phase]


def passes_per_call(n: int, per_call: int, what: str) -> int:
    """How many times each call launched a kernel, from ``n`` launches over
    ``per_call`` (a layer a call) units; raises where it does not divide."""
    if per_call == 0 or n % per_call:
        raise Mismatch(f"{what}: {n} launches for {per_call} layer calls")
    return n // per_call


def check(counts: Dict[str, int], want: Dict[str, int], family_name: str):
    for p, n in want.items():
        if counts.get(p, 0) != n:
            raise Mismatch(f"{family_name} {p}: {counts.get(p, 0)} launches "
                           f"counted, {n} implied by the window's work")
