"""The comparison that decides ``correct``: the numbers a driver compares
between what the timed path produced and the plain reference, each against
the limit that ``limits/<cell>.json`` sets for it.

A run is correct when every number is finite and at most its limit.  A
number with no limit in the file fails: an unmeasured limit is no limit."""
from __future__ import annotations

import json
import math
import sys
from pathlib import Path
from typing import Dict


class Checks:
    """The numbers a run compared, each with its limit."""

    def __init__(self, limits: Dict[str, dict]):
        self.limits = limits
        self.rows: Dict[str, Dict[str, float]] = {}

    def add(self, name: str, value: float) -> None:
        limit = self.limits.get(name, {}).get("limit")
        self.rows[name] = {"value": float(value),
                           "limit": None if limit is None else float(limit)}

    @property
    def correct(self) -> bool:
        return bool(self.rows) and all(
            r["limit"] is not None and math.isfinite(r["value"])
            and r["value"] <= r["limit"] for r in self.rows.values())

    def print(self, file=None) -> None:
        file = file or sys.stderr
        for name, r in self.rows.items():
            print(f"check {name} {r['value']!r} limit {r['limit']!r}",
                  file=file, flush=True)


def load_limits(bench_dir: Path, cell: str) -> Dict[str, dict]:
    """The limits of ``cell``'s numbers (the file's other entries, such as
    the seeds its readings came from, left out)."""
    path = bench_dir / "limits" / f"{cell}.json"
    rows = json.loads(path.read_text()) if path.is_file() else {}
    return {k: v for k, v in rows.items()
            if isinstance(v, dict) and "limit" in v}
