"""The manifest and the files it names: the contract's shape of
``BENCHMARK.json``, every name found as a file of its own, and no module
of the benchmark importing JAX or the JAX package."""
from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from perfbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}
CELLS = {w["name"]: w for w in BENCH["workloads"]}
CONFIG_NAMES = {c["name"] for c in BENCH["configs"]}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_configs_have_their_files():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"])
        assert _line(c["source"]) and c["source"].startswith("https://")
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        doc = harness.config_doc(c["name"])
        assert doc["name"] == c["name"]
        assert sorted(doc["reduced"]) == sorted(c["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
        assert harness.reference(doc).__name__.startswith(
            "perfbench.reference.")


def test_cells_name_files_that_exist():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and _line(w["why"]) and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = harness.traffic_doc(w["traffic"])
        assert traffic["name"] == w["traffic"]
        harness.driver(traffic["kind"])


@pytest.mark.parametrize("entry", BENCH["end_to_end"],
                         ids=lambda e: e["name"])
def test_end_to_end_metric(entry):
    assert set(entry) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    assert entry["source"] in SOURCES_E2E
    assert 0.01 <= entry["bound"] <= 0.25
    assert set(entry.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("entry", BENCH["per_layer"], ids=lambda e: e["name"])
def test_per_layer_metric_has_a_reader(entry):
    assert set(entry) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert entry["source"] in SOURCES and _line(entry["layer"])
    moved = [e for e in BENCH["end_to_end"] if e["name"] == entry["moves"]]
    assert moved
    for cell in entry["workloads"]:
        assert cell in moved[0].get("workloads", CELLS)
    if entry["name"].endswith("_roofline") or "_roofline." in entry["name"]:
        assert entry["unit"] == "%"
    doc = harness.metric_doc(entry["name"])
    assert callable(harness.reader(doc["reader"]).read)


def test_every_cell_reports_what_the_contract_asks():
    for cell in CELLS:
        e2e = [e["name"] for e in BENCH["end_to_end"]
               if cell in e.get("workloads", CELLS)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell in e["workloads"] for e in BENCH["per_layer"])


def test_every_cell_has_limits():
    from perfbench import judge
    for cell in CELLS:
        limits = judge.load_limits(harness.BENCH_DIR, cell)
        compared = [row for row in limits.values()
                    if row.get("compared", True)]
        assert compared and all(row["limit"] is not None
                                for row in compared)


def test_config_files_hold_the_published_widths():
    """The model table's widths are the published ones, but for the LoRA
    ranks that the program fixes (listed as its departure); only depth is
    cut, as ``reduced`` says."""
    r = harness.config_doc("rwkv6-7b.l8")
    p, m = r["published"], r["model"]
    assert (m["d_model"], m["head_dim"], m["d_ff"], m["vocab_size"],
            m["norm_eps"]) == (p["hidden_size"], p["head_size"],
                               p["intermediate_size"], p["vocab_size"],
                               p["layer_norm_epsilon"])
    assert r["reduced"]["num_hidden_layers"]["here"] == m["num_layers"]
    assert (m["mix_lora"], m["decay_lora"]) != (
        p["time_mix_extra_dim"], p["time_decay_extra_dim"])
    assert any("LoRA ranks" in d for d in r["departures"])


@pytest.mark.parametrize("name", sorted(CONFIG_NAMES))
def test_program_config_is_the_file(name):
    import dataclasses
    doc = harness.config_doc(name)
    cfg = harness.program_config(doc)
    fields = {f.name for f in dataclasses.fields(cfg)}
    for key, value in doc["model"].items():
        if key in fields:
            want = tuple(value) if isinstance(value, list) else value
            assert getattr(cfg, key) == want, key


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


SOURCES_PY = sorted(harness.BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES_PY,
                         ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks"}


@pytest.mark.parametrize(
    "path", sorted((harness.BENCH_DIR / "reference").rglob("*.py"))
    + sorted((harness.BENCH_DIR / "yardstick").rglob("*.py")),
    ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_reference_and_yardstick_import_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert tops <= {"__future__", "math", "importlib", "pkgutil", "typing",
                    "torch", "numpy", "perfbench"}
    assert not {n for n in _imports(path)
                if n.startswith("perfbench.") and not n.startswith(
                    ("perfbench.reference", "perfbench.yardstick"))}


def test_top_level_names_are_compared_whole():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.models",
                                      "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["repro.core", "jax.numpy", "flax",
                                      "jaxlib.xla"]) == ["flax", "jax",
                                                         "jaxlib", "repro"]
