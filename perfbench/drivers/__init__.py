"""One driver a traffic kind (``drivers/<kind>.py``, found by the traffic
file's ``kind``).  A driver gives ``setup(cell) -> state`` (inputs and
weights from the seed, the program built and warmed),
``measure(state, cell, tracer) -> outcome`` (the window; its ``record``
holds the spans, the counters, the ``work`` of the calls it made, as
``yardstick/kernels`` describes it, and every kernel family's launches over
the window, :func:`launch_counts`), ``judge(state, cell) -> numbers`` (the
program's state freed, the plain reference run, the compared numbers) and
``control(state, cell) -> numbers`` (the same numbers with the reference
one precision lower in the program's place)."""
from __future__ import annotations

import dataclasses
import gc
import importlib
import time
from typing import Dict


@dataclasses.dataclass
class Cell:
    name: str
    config: dict          # the configuration file
    traffic: dict         # the traffic file
    cfg: object           # the program's configuration built from it
    seed: int
    seconds: float
    trace: bool
    device: str
    chips: int = 1
    #: the host clock at the start of the run (``setup_s`` counts from it)
    start: float = dataclasses.field(default_factory=time.perf_counter)

    @property
    def model(self) -> dict:
        return self.config["model"]


def free_cuda() -> None:
    """Return what the program's freed objects held to the card."""
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_peak(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device) -> int:
    import torch
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated()
    return 0


def timed_calls(obj, attr: str, sink: list, device) -> None:
    """Wrap ``obj.<attr>`` (a callable attribute) so that each call is
    bracketed by CUDA events appended to ``sink`` as pairs (on the CPU,
    host-clock pairs)."""
    import torch
    inner = getattr(obj, attr)
    on_card = torch.device(device).type == "cuda"

    def wrapped(*args, **kwargs):
        if on_card:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = inner(*args, **kwargs)
            e1.record()
            sink.append((e0, e1))
        else:
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            sink.append((t0, time.perf_counter()))
        return out

    setattr(obj, attr, wrapped)


def elapsed_s(pairs) -> list:
    """Seconds of each pair that :func:`timed_calls` recorded."""
    out = []
    for a, b in pairs:
        out.append(a.elapsed_time(b) / 1e3 if hasattr(a, "elapsed_time")
                   else b - a)
    return out


def phase_done(cell: Cell, phase: str) -> None:
    """Print the seconds since the run started at the end of a phase of
    set-up."""
    print(f"{cell.name} set-up: {phase} done at "
          f"{time.perf_counter() - cell.start} s", flush=True)


def launch_counts() -> Dict[str, Dict[str, int]]:
    """Every kernel family's launches so far, by pass, read from the
    program's counters that ``yardstick/kernels/<family>.py`` names."""
    from perfbench.yardstick import kernels
    out = {}
    for name in kernels.families():
        out[name] = {}
        for pass_, where in kernels.family(name).COUNTERS.items():
            module, attr = where.split(":")
            counts = getattr(importlib.import_module(module), attr)
            out[name][pass_] = sum(counts.values())
    return out


def launches_since(before: Dict[str, Dict[str, int]]
                   ) -> Dict[str, Dict[str, int]]:
    """Each family's launches by pass since ``before`` was read."""
    now = launch_counts()
    return {f: {p: n - before[f][p] for p, n in by_pass.items()}
            for f, by_pass in now.items()}
