"""The device trace of a run's measured window (``--trace 1``).

``torch.profiler`` records the host's operations and the card's kernels,
copies and sets over the window; the benchmark marks its own spans (the
window, each step, each re-placement, each batch) as ``bench.<name>``
ranges.  From the trace: the seconds in which anything ran on the card
(the union of the device events' intervals, so that overlapping events
count once), the window's length, each kernel's launches and device
seconds by name, the ten device operations that took most time, and the
ten longest gaps in which the card was idle, each named by the benchmark
span and the host operation that were running at its middle."""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

PREFIX = "bench."
TOP = 10
NAME_CHARS = 160


class Tracer:
    """Spans always; the profiler only when ``on``."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        with self.prof:
            with torch.profiler.record_function(PREFIX + "window"):
                yield

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(PREFIX + name)

    def summary(self) -> dict:
        # the profiler's raw events: building its per-operation objects
        # (``prof.events()``) takes minutes for a window of a million
        # events
        return summarize([Event(e) for e in
                          self.prof.profiler.kineto_results.events()])


class Event:
    """A raw profiler event: its name, where it ran, its interval in us."""
    __slots__ = ("name", "on_device", "annotation", "lo", "hi")

    def __init__(self, e):
        self.name = e.name()
        self.on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        self.annotation = e.is_user_annotation()
        self.lo = e.start_ns() / 1e3
        self.hi = e.end_ns() / 1e3


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def _innermost(events, t: float, keep) -> str:
    best = None
    for e in events:
        if e.lo <= t <= e.hi and keep(e.name) and (
                best is None or e.hi - e.lo < best[1] - best[0]):
            best = (e.lo, e.hi, e.name)
    return best[2] if best else "no torch operation"


def summarize(events) -> dict:
    """The window's numbers from its :class:`Event` list."""
    win = [e for e in events if e.name == PREFIX + "window"
           and not e.on_device]
    if not win:
        raise RuntimeError("trace: the window's range was not recorded")
    w_lo, w_hi = win[0].lo, win[0].hi
    # a range annotated on the host (a record_function, such as the
    # optimizer's "Optimizer.step#...") is mirrored on the device's
    # timeline; it runs nothing there
    host_names = {e.name for e in events if not e.on_device}
    dev, host = [], []
    for e in events:
        if e.hi < w_lo or e.lo > w_hi:
            continue
        if e.on_device:
            if not (e.annotation or e.name in host_names):
                dev.append((max(e.lo, w_lo), min(e.hi, w_hi), e.name))
        else:
            host.append(e)
    busy = _union([(lo, hi) for lo, hi, _ in dev])
    busy_us = sum(hi - lo for lo, hi in busy)
    kernels: Dict[str, Dict[str, float]] = {}
    for lo, hi, name in dev:
        row = kernels.setdefault(name, {"count": 0, "seconds": 0.0})
        row["count"] += 1
        row["seconds"] += (hi - lo) / 1e6
    ops = sorted(kernels.items(), key=lambda kv: -kv[1]["seconds"])[:TOP]
    edges = [w_lo] + [x for iv in busy for x in iv] + [w_hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:TOP]
    idle = []
    for length, lo in gaps:
        mid = lo + length / 2
        span = _innermost(host, mid, lambda n: n.startswith(PREFIX))
        op = _innermost(host, mid, lambda n: not n.startswith(PREFIX))
        idle.append([f"{span} / {op}"[:NAME_CHARS], length / 1e6])
    return {
        "window_s": (w_hi - w_lo) / 1e6,
        "busy_s": busy_us / 1e6,
        "kernels": kernels,
        "breakdown": {
            "device_ops": [[name[:NAME_CHARS], row["seconds"]]
                           for name, row in ops],
            "idle_gaps": idle,
        },
    }
