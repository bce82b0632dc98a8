"""Tiny cells for the tests: the RWKV6 configuration and a dense attention
model cut to smoke widths, a serving mix sized for the CPU, and limits for
them, written as files into a copy of the benchmark, exactly as a later
change would add a cell; and, as a later change would add a per-layer
metric, its manifest and entry."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from perfbench import harness

TINY_RWKV = {"num_layers": 2, "d_model": 64, "num_heads": 4,
             "num_kv_heads": 4, "head_dim": 16, "rwkv_head_dim": 16,
             "d_ff": 128, "vocab_size": 256}
#: a llama-like decoder (the program's ``attn`` block), at smoke widths
TINY_ATTN = {
    "name": "tiny-llama", "source": "a smoke-width llama-like decoder",
    "reduced": {}, "reference": "attn_lm",
    "program": {"arch": "tinyllama-1.1b", "dtype": "bfloat16"},
    "model": {"block_pattern": ["attn"], "num_layers": 2, "d_model": 64,
              "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
              "d_ff": 128, "vocab_size": 256, "rope_theta": 10000.0,
              "norm_eps": 1e-5, "act": "silu", "tie_embeddings": False},
}
#: limits of the tiny cells, between what the program reads on the CPU and
#: what the control reads there, at seeds 3, 4, 5: RWKV6 served gap 0.029,
#: 0, 0 against 0.27, 0.22, 0.54, logit gap 0.098, 0.075, 0.082 against
#: 0.91, 1.11, 0.85; attention served gap 0, 0, 0 against 0.0014, 0.42,
#: 0.37 (the control fails the logit gap there), logit gap 0.050, 0.060,
#: 0.044 against 0.51, 1.44, 0.72
TINY_LIMITS = {
    "tiny-serve": {"served_gap": {"limit": 0.1}, "logit_gap": {"limit": 0.3}},
    "tiny-attn-serve": {"served_gap": {"limit": 0.1},
                        "logit_gap": {"limit": 0.25}},
}
#: the cells' pairs (configuration, traffic mix)
TINY_CELLS = {"tiny-serve": ("tiny-rwkv6", "tiny-serve"),
              "tiny-attn-serve": ("tiny-llama", "tiny-serve")}
#: the per-layer metrics of ``BENCHMARK.json`` that each tiny cell reads
#: beside the real cell it stands for (an attention model runs no WKV6)
STANDS_FOR = {"tiny-serve": ("rwkv6-serve-longdoc", ()),
              "tiny-attn-serve": ("rwkv6-serve-longdoc",
                                  ("wkv6_roofline.serve",))}
SEED = 3


def docs():
    """(configs, traffic mixes, workloads) of the tiny cells."""
    rwkv = copy.deepcopy(harness.config_doc("rwkv6-7b.l8"))
    rwkv["name"] = "tiny-rwkv6"
    rwkv["model"].update(TINY_RWKV)
    serve = harness.traffic_doc("serve-longdoc")
    serve.update(name="tiny-serve", batch=2, prompt_lens=[40, 24, 56],
                 pool_cycles=2, max_new=4, checked_requests=5)
    cells = [{"name": name, "config": config, "traffic": traffic,
              "chips": 1, "why": "test"}
             for name, (config, traffic) in TINY_CELLS.items()]
    return [rwkv, copy.deepcopy(TINY_ATTN)], [serve], cells


def bench_with_tiny_cells(per_layer=()) -> dict:
    """``BENCHMARK.json`` with the tiny cells added to it, each listed by
    the metrics that list the cell it stands for, and the per-layer entries
    ``per_layer`` added."""
    bench = copy.deepcopy(harness.manifest())
    _, _, cells = docs()
    bench["workloads"] += cells
    for cell, (real, skip) in STANDS_FOR.items():
        for e in bench["end_to_end"] + bench["per_layer"]:
            if real in e.get("workloads", ()) and e["name"] not in skip:
                e["workloads"].append(cell)
    bench["per_layer"] += [copy.deepcopy(e) for e in per_layer]
    return bench


def write_copy(dest: Path, metrics=None) -> Path:
    """A copy of the benchmark under ``dest`` with the tiny cells added as
    files (configurations, traffic mixes, limits) and entries, and each
    per-layer metric of ``metrics`` (name -> (manifest, entry)) as its
    manifest file and entry; returns the root of the copy."""
    shutil.copytree(harness.BENCH_DIR, dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    configs, traffic, _ = docs()
    for doc in configs:
        (dest / "perfbench" / "configs" / f"{doc['name']}.json").write_text(
            json.dumps(doc))
    for doc in traffic:
        (dest / "perfbench" / "traffic" / f"{doc['name']}.json").write_text(
            json.dumps(doc))
    for cell, limits in TINY_LIMITS.items():
        (dest / "perfbench" / "limits" / f"{cell}.json").write_text(
            json.dumps(limits))
    metrics = metrics or {}
    for name, (manifest, _) in metrics.items():
        (dest / "perfbench" / "metrics" / f"{name}.json").write_text(
            json.dumps(manifest))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench_with_tiny_cells(
        [entry for _, entry in metrics.values()])))
    return dest
