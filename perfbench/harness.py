"""What every run shares: the manifest and the files found by name in it,
the program's configuration built from a configuration file, the card's
description, and the check that no JAX module was loaded."""
from __future__ import annotations

import dataclasses
import importlib
import json
import subprocess
import sys
from pathlib import Path
from typing import Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

#: top-level modules that the program's process may never load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def manifest(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                   f"{[w['name'] for w in bench['workloads']]}")


def config_doc(name: str) -> dict:
    return read_json(BENCH_DIR / "configs" / f"{name}.json")


def traffic_doc(name: str) -> dict:
    return read_json(BENCH_DIR / "traffic" / f"{name}.json")


def metric_doc(name: str) -> dict:
    return read_json(BENCH_DIR / "metrics" / f"{name}.json")


def driver(kind: str):
    return importlib.import_module(f"perfbench.drivers.{kind}")


def reader(name: str):
    return importlib.import_module(f"perfbench.readers.{name}")


def reference(config: dict):
    """The plain reference of a configuration's family, the module its
    file names (``perfbench/reference/<reference>.py``)."""
    return importlib.import_module(f"perfbench.reference.{config['reference']}")


def program_config(doc: dict):
    """The program's configuration of ``doc``: the architecture the program
    knows by ``doc["program"]["arch"]``, with every field of the file's
    ``model`` table that the program's configuration has set to the file's
    value (the file is what runs)."""
    from repro_torch import configs
    base = configs.get_config(doc["program"]["arch"])
    names = {f.name for f in dataclasses.fields(base)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in doc["model"].items() if k in names}
    return dataclasses.replace(base, **kw)


def forbidden_modules(names=None) -> list:
    """The forbidden top-level modules among ``names`` (default: those
    loaded), each name's part before the first dot compared whole."""
    names = sys.modules if names is None else names
    return sorted({name.split(".")[0] for name in names
                   if name.split(".")[0] in FORBIDDEN})


def card_lines() -> list:
    """The card's name, power limit, clocks and temperature as
    ``nvidia-smi`` reads them, or why it could not."""
    query = "name,power.limit,power.draw,clocks.sm,clocks.max.sm," \
        "clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return [f"nvidia-smi unavailable: {exc}"]
    return [f"card ({query}): {line}" for line in out.stdout.splitlines()]


def device_entry(device, count: int, peak_bytes: int,
                 trace: Optional[dict]) -> dict:
    import torch
    entry = {"platform": "gpu" if torch.device(device).type == "cuda"
             else torch.device(device).type,
             "kind": torch.cuda.get_device_name(0)
             if torch.device(device).type == "cuda" else "cpu",
             "count": count, "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        entry["busy_s"] = trace["busy_s"]
        entry["window_s"] = trace["window_s"]
    return entry
