"""Run one cell of the benchmark on the card and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``'s
``workloads``; its configuration, traffic mix, driver, metrics and limits
are found by name under ``perfbench/``.  The run makes its inputs and
weights from ``--seed``, sets up and warms the program (``setup_s``, from
the start of this process), measures for ``--seconds``, then checks what
the window produced against the plain reference.  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics read from the device trace of the
window), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``: each compared number beside its limit, which also end standard
error.  The run exits with another code than 0, and prints no result, when
no card (or fewer than the cell asks for) is visible, when a per-layer
metric of the cell reads nothing in a traced run, or when a JAX module was
loaded."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_v, "4")


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def per_layer_entries(bench: dict, cell: str) -> list:
    """The cell's per-layer metrics: those that list it, and those without
    a list whose end-to-end metric the cell reports."""
    reported = {e["name"] for e in bench["end_to_end"] if applies(e, cell)}
    return [e for e in bench["per_layer"]
            if cell in e.get("workloads", ())
            or ("workloads" not in e and e["moves"] in reported)]


class Unread(RuntimeError):
    """A traced run in which a per-layer metric of the cell read nothing."""


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float = None) -> dict:
    """Run cell ``name`` on ``device`` and return its result object (the
    checks last); prints the lines before it."""
    from perfbench import harness, judge
    from perfbench.drivers import Cell
    from perfbench.trace import Tracer
    t_start = T_START if t_start is None else t_start
    wl = harness.workload(bench, name)
    config = harness.config_doc(wl["config"])
    traffic = harness.traffic_doc(wl["traffic"])
    for line in harness.card_lines() if device == "cuda" else ["card: cpu"]:
        print(line, flush=True)
    cell = Cell(name=name, config=config, traffic=traffic,
                cfg=harness.program_config(config), seed=seed,
                seconds=seconds, trace=trace, device=device,
                chips=int(wl["chips"]), start=t_start)
    drv = harness.driver(traffic["kind"])
    tracer = Tracer(trace)
    state = drv.setup(cell)
    setup_s = time.perf_counter() - t_start
    out = drv.measure(state, cell, tracer)
    for line in harness.card_lines() if device == "cuda" else []:
        print(f"after the window: {line}", flush=True)
    record = dict(out["record"])
    summary = None
    if trace:
        summary = tracer.summary()
        record.update(window_s=summary["window_s"], busy_s=summary["busy_s"],
                      kernels=summary["kernels"])
    print("read by the per-layer metrics: " + json.dumps(
        {"spans": {k: len(v) for k, v in record["spans"].items()},
         "counters": record["counters"],
         "work": {p: sum(w["phase"] == p for w in record["work"])
                  for p in sorted({w["phase"] for w in record["work"]})},
         "launches": record["launch_counts"]}), flush=True)
    metrics = {}
    if trace:
        unread = []
        for e in per_layer_entries(bench, name):
            doc = harness.metric_doc(e["name"])
            reader = harness.reader(doc["reader"])
            if device != "cuda" and e["source"] == "device_trace":
                # the CPU has no device trace and launches no kernel
                print(f"not read on the {device}: {e['name']}",
                      file=sys.stderr, flush=True)
                continue
            value = reader.read(record, doc["params"])
            if value is None:
                unread.append(e["name"])
            else:
                metrics[e["name"]] = {"value": value, "unit": e["unit"]}
        if unread:
            raise Unread(f"{name}: the per-layer metrics {unread} read "
                         f"nothing in the traced window")
    else:
        values = dict(out["end_to_end"], setup_s=(setup_s, "s"))
        for e in bench["end_to_end"]:
            if applies(e, name):
                value, unit = values[e["name"]]
                metrics[e["name"]] = {"value": value, "unit": e["unit"]}
    checks = judge.Checks(judge.load_limits(harness.BENCH_DIR, name))
    for key, value in drv.judge(state, cell).items():
        checks.add(key, value)
    result = {"correct": checks.correct and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics,
              "device": harness.device_entry(device, cell.chips,
                                             out["peak_bytes"], summary)}
    if summary is not None:
        result["breakdown"] = summary["breakdown"]
    result["checks"] = checks.rows
    checks.print(sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness
    bench = harness.manifest()
    wl = harness.workload(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA card is visible; nothing was run",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(wl["chips"]):
        print(f"perfbench: {args.workload} needs {wl['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        result = run_cell(bench, args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda")
    except Unread as exc:
        print(f"perfbench: {exc}; no result", file=sys.stderr)
        return 4
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"perfbench: the run loaded {loaded}; no result",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
