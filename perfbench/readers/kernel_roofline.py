"""A kernel family's share of its roofline over the window, in %: the
least time the card could take for the work of every launch of the family
(``yardstick/kernels/<family>.py``: FLOPs at the family's peak or bytes at
the HBM rate, whichever is longer, a launch at a time; the launches that
the window's work implies, held against the program's launch counters)
over the device seconds of the family's kernels in the trace (matched by
name).  Nothing to read where the cell launches none of the family's
kernels, where the counters do not match the work (said on standard
error), or where the trace holds none of the family's kernels."""
import sys

from perfbench.yardstick import kernels, peaks


def read(record, params):
    name = params["family"]
    fam = kernels.family(name)
    try:
        launched = fam.launches(record["model"], record["work"],
                                record["launch_counts"][name])
    except kernels.Mismatch as exc:
        print(f"kernel_roofline: {exc}", file=sys.stderr, flush=True)
        return None
    bound = sum(n * peaks.bound_s(*fam.work(x), peak_flops=fam.PEAK_FLOPS)
                for n, x in launched)
    seconds = sum(row["seconds"] for k, row in record["kernels"].items()
                  if any(s in k for s in fam.NAMES))
    if seconds <= 0 or bound <= 0:
        return None
    return 100.0 * bound / seconds
