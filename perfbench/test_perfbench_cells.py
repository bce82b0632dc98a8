"""The harness end to end on the CPU: tiny cells added as files to a copy of
the benchmark run without editing any file there, against the plain
reference; a per-layer metric added as its manifest and entry alone is read
(on the card: the test marked ``cuda``), and one that reads nothing fails
the traced run; and the command refuses to run without a card."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from perfbench import harness, testing

SRC = harness.ROOT / "src"


def _run_in_copy(root, cell: str, trace: int, device: str = "cpu"):
    """``run.run_cell`` of the copy at ``root`` on ``device``, in a process
    of its own whose ``perfbench`` is the copy's; returns the process."""
    code = ("import json, sys\n"
            f"sys.path[:0] = [{str(root)!r}, {str(SRC)!r}]\n"
            "from perfbench import harness, run\n"
            f"assert harness.BENCH_DIR == __import__('pathlib').Path("
            f"{str(root / 'perfbench')!r})\n"
            f"r = run.run_cell(harness.manifest(), {cell!r}, {testing.SEED},"
            f" 0.5, {bool(trace)}, {device!r})\n"
            "print(json.dumps(r))\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=root, env=env)


def _result(out) -> dict:
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell,trace", [("tiny-serve", 0), ("tiny-serve", 1),
                                        ("tiny-attn-serve", 1)])
def test_a_cell_added_as_files_runs(tmp_path, cell, trace):
    root = testing.write_copy(tmp_path)
    result = _result(_run_in_copy(root, cell, trace))
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"served_gap", "logit_gap"}
    assert result["attempted"] > 0 and result["failed"] == 0
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if trace:
        assert "breakdown" in result
        assert "prefill_ms" in result["metrics"]
        assert "decode_step_ms" in result["metrics"]
    else:
        e2e = {e["name"] for e in bench["end_to_end"]
               if cell in e.get("workloads", [cell])}
        assert set(result["metrics"]) == e2e
    for row in result["checks"].values():
        assert row["value"] <= row["limit"]


#: flash's share of its roofline in serving, added as data alone: a
#: manifest naming the reader and the family, and an entry
FLASH_SERVE = {"flash_roofline.serve": (
    {"reader": "kernel_roofline", "params": {"family": "flash"}},
    {"name": "flash_roofline.serve", "unit": "%", "better": "higher",
     "source": "device_trace", "layer": "flash attention kernels",
     "moves": "serve_tokens_per_s", "workloads": ["tiny-attn-serve"]})}


def test_a_per_layer_metric_added_as_files_is_found(tmp_path):
    root = testing.write_copy(tmp_path, FLASH_SERVE)
    out = _run_in_copy(root, "tiny-attn-serve", 1)
    result = _result(out)
    assert result["correct"]
    # the CPU launches no kernel and has no device trace to read
    assert "not read on the cpu: flash_roofline.serve" in out.stderr


def test_a_per_layer_metric_that_reads_nothing_fails_the_run(tmp_path):
    nothing = {"span_ms.nothing": (
        {"reader": "span_mean", "params": {"span": "nothing", "scale": 1000}},
        {"name": "span_ms.nothing", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "nothing",
         "moves": "serve_tokens_per_s", "workloads": ["tiny-serve"]})}
    root = testing.write_copy(tmp_path, nothing)
    out = _run_in_copy(root, "tiny-serve", 1)
    assert out.returncode != 0
    assert "span_ms.nothing" in out.stderr
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_a_per_layer_metric_added_as_files_reads_on_the_card(card, tmp_path):
    root = testing.write_copy(tmp_path, FLASH_SERVE)
    result = _result(_run_in_copy(root, "tiny-attn-serve", 1, "cuda"))
    assert result["correct"], result["checks"]
    assert 0 < result["metrics"]["flash_roofline.serve"]["value"] <= 105
    assert result["device"]["busy_s"] > 0


def _no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the command would run the cell")


def test_the_command_refuses_without_a_card():
    _no_card()
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "rwkv6-serve-longdoc", "--seed", str(2 ** 31 + 11), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=harness.ROOT)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]


def test_the_command_fails_beside_only_its_own_files(tmp_path):
    """In a directory holding only ``BENCHMARK.json`` and ``perfbench/``
    there is no program to run: the command exits non-zero and prints no
    result."""
    import shutil
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "rwkv6-serve-longdoc", "--seed", "7", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env=env)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
