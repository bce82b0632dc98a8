"""Read the numbers that the limits are set from, on the card, in one
process: the program's on many seeds, the control's (the reference one
precision lower in the program's place) and each planted fault's on a few.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--fault altered_token --fault-seeds 7,8,9] \\
        [--seconds 1] [--dtype float32] [--out calibrate.jsonl]

Each seed builds the cell anew at its own size and runs a short window (one
cycle of the traffic) before it is judged.  One JSON line a reading is
printed and appended to ``--out``.

    python3 perfbench/calibrate.py --workload <cell> --limits READINGS.jsonl

sets the cell's limits from such readings and writes
``perfbench/limits/<cell>.json``: for each number the lower reading (the
largest the program gave), the upper one (the smallest the control gave,
where that is three times the lower or more), and the limit between them,
lower^(1/3) upper^(2/3) (the lower taken as at least a hundredth of the
upper): a third of the way from the upper to the lower on a log scale, so
that the more room lies above the lower, where fresh seeds read.  A number
with no upper reading gets no limit, and fails."""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def _seeds(text: str):
    return [int(x) for x in text.split(",") if x]


def reading(cell_name: str, seed: int, seconds: float, kind: str,
            dtype: str = None) -> dict:
    from perfbench import faults, harness
    from perfbench.drivers import Cell
    from perfbench.trace import Tracer
    bench = harness.manifest()
    wl = harness.workload(bench, cell_name)
    config = harness.config_doc(wl["config"])
    traffic = harness.traffic_doc(wl["traffic"])
    if dtype:
        config["program"]["dtype"] = dtype
    cell = Cell(name=cell_name, config=config, traffic=traffic,
                cfg=harness.program_config(config), seed=seed,
                seconds=seconds, trace=False, device="cuda")
    drv = harness.driver(traffic["kind"])
    remove = faults.plant(kind) if kind in faults.FAULTS else None
    try:
        t0 = time.perf_counter()
        state = drv.setup(cell)
        out = drv.measure(state, cell, Tracer(False))
        t1 = time.perf_counter()
        numbers = (drv.control(state, cell) if kind == "control"
                   else drv.judge(state, cell))
        t2 = time.perf_counter()
    finally:
        if remove:
            remove()
    return {"cell": cell_name, "kind": kind, "seed": seed,
            "dtype": config["program"]["dtype"], "numbers": numbers,
            "setup_and_window_s": t1 - t0, "judge_s": t2 - t1,
            "attempted": out["attempted"], "failed": out["failed"]}


def set_limits(rows: list) -> dict:
    """The limits of one cell from its readings (``reading`` rows)."""
    kinds, seeds = {}, {}
    for r in rows:
        kinds.setdefault(r["kind"], []).append(r["numbers"])
        seeds.setdefault(r["kind"], []).append(r["seed"])
    out = {"seeds": seeds}
    names = sorted({k for n in kinds["program"] for k in n})
    for name in names:
        seen = [n[name] for n in kinds["program"] if name in n]
        lower = max(seen)
        row = {"lower": lower, "program": seen}
        for kind, numbers in kinds.items():
            if kind != "program":
                row[kind] = [n[name] for n in numbers if name in n]
        control = row.get("control") or []
        if control and min(control) >= 3 * lower:
            upper = min(control)
            row.update(upper=upper, limit=max(lower, upper / 100) ** (1 / 3)
                       * upper ** (2 / 3))
        else:
            row.update(upper=None, limit=None)
        out[name] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--dtype", default=None,
                    help="run the program in this dtype instead of the "
                    "configuration's (a second witness)")
    ap.add_argument("--out", default="calibrate.jsonl")
    ap.add_argument("--limits", default=None, metavar="READINGS",
                    help="set the cell's limits from these readings")
    args = ap.parse_args(argv)
    if args.limits:
        from perfbench import harness
        rows = [json.loads(line) for line in Path(args.limits).read_text()
                .splitlines() if line.strip()]
        rows = [r for r in rows if r["cell"] == args.workload
                and r.get("dtype") in (None, harness.config_doc(
                    harness.workload(harness.manifest(), args.workload)
                    ["config"])["program"]["dtype"])]
        limits = set_limits(rows)
        path = harness.BENCH_DIR / "limits" / f"{args.workload}.json"
        path.write_text(json.dumps(limits, indent=1) + "\n")
        print(json.dumps(limits))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card is visible", file=sys.stderr)
        return 2
    runs = ([("program", s) for s in _seeds(args.seeds)]
            + [("control", s) for s in _seeds(args.control_seeds)]
            + [(args.fault, s) for s in _seeds(args.fault_seeds)])
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for kind, seed in runs:
        row = reading(args.workload, seed, args.seconds, kind, args.dtype)
        line = json.dumps(row)
        print(line, flush=True)
        with out.open("a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
