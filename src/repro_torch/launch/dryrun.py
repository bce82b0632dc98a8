"""Dry-run: count every (arch x shape) cell's step on a mesh and read it
against the H100's roofline (after the JAX package's ``launch/dryrun.py``).

Meshes (``--mesh``): ``h100`` is one device (a 1 x 1 mesh, no process
group); ``single`` and ``multi`` are the production meshes, (16, 16) and
(2, 16, 16), on torch's ``fake`` process-group backend in this one process
(rank 0 of 256 or 512; its collectives move nothing), as the reference
lowers them on 512 placeholder devices.  Each cell's step (a train step:
loss, backward and AdamW; a prefill; one decode step over a full cache)
runs once on ``meta`` tensors of rank 0's shapes (``launch.steps.
lower_cell``) under ``roofline.Counter``.  The reference's ``--unroll``
has no counterpart: eager counting sees every layer.  Its
``--attn-chunk`` neither: the port has no chunked-XLA attention (the flash
kernel does that work).  Every kernel counts its backward in a train
cell (flash, the expert GEMM, WKV6, the RG-LRU scan).

Each record holds FLOPs, bytes, collective bytes and counts by kind (and
bytes by mesh axis and kind), the
kernels' calls, rank 0's bytes of parameters, their gradients (train),
AdamW state, caches and batch, whether they fit the card's 80 GB (the
activations and the weights gathered at use are not counted, so a cell
that does not fit cannot run, and one that fits may not), and the
roofline terms.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-moe-30b-a3b \\
      --shape train_4k --mesh h100
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
Results accumulate in ``dryrun_out/dryrun.json`` (git-ignored) unless
``--out`` says otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

from repro_torch import configs, roofline, sharding

OUT = Path(__file__).resolve().parents[3] / "dryrun_out" / "dryrun.json"
H100_HBM_BYTES = 80e9          # per H100 SXM5 80GB
LABELS = {"h100": "h100", "single": "16x16", "multi": "2x16x16"}


def mesh_label(name: str) -> str:
    return LABELS[name]


def fake_world(n: int) -> None:
    """A world of ``n`` ranks on torch's ``fake`` backend, this process
    rank 0 (re-initialised when its size changes): its collectives move
    nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized() and dist.get_world_size() != n:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)


def make_mesh(name: str):
    """``h100``: one device, an abstract 1 x 1 mesh (no process group);
    ``single`` / ``multi``: ``launch.mesh.make_production_mesh`` over a
    fake world of 256 / 512 ranks."""
    if name == "h100":
        return sharding.AbstractMesh((("data", 1), ("model", 1)))
    from repro_torch.launch.mesh import make_production_mesh
    multi = name == "multi"
    fake_world(512 if multi else 256)
    return make_production_mesh(multi_pod=multi, device_type="cpu")


def run_cell(arch: str, shape_name: str, mesh_name: str,
             overrides: dict = None, variant: str = "") -> dict:
    """One cell's record."""
    from repro_torch.launch.steps import lower_cell
    cfg = configs.get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = configs.get_shape(shape_name)
    mesh = make_mesh(mesh_name)
    n_chips = mesh.size() if mesh_name != "h100" else 1
    t0 = time.perf_counter()
    lowered = lower_cell(cfg, shape, mesh)
    t1 = time.perf_counter()
    stats = lowered.analyze()
    t2 = time.perf_counter()
    memory = dict(lowered.memory)
    memory["total"] = sum(memory.values())
    return {
        "arch": arch, "shape": shape_name,
        "mesh": mesh_label(mesh_name) + (f"-{variant}" if variant else ""),
        "kind": shape.kind, "overrides": overrides or {},
        "build_s": t1 - t0, "count_s": t2 - t1,
        "stats": stats, "memory_per_device": memory,
        "fits_80gb": memory["total"] <= H100_HBM_BYTES,
        "roofline": roofline.roofline_terms(stats, cfg, shape, n_chips),
        "ok": True,
    }


def save(record: dict, out: Path):
    out.parent.mkdir(parents=True, exist_ok=True)
    existing = {}
    if out.exists():
        existing = json.loads(out.read_text())
    key = f"{record['arch']}|{record['shape']}|{record['mesh']}"
    existing[key] = record
    out.write_text(json.dumps(existing, indent=1))


def already_done(arch, shape_name, mesh_name, out: Path) -> bool:
    if not out.exists():
        return False
    data = json.loads(out.read_text())
    rec = data.get(f"{arch}|{shape_name}|{mesh_name}")
    return bool(rec and rec.get("ok"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["h100", "single", "multi", "both"],
                    default="h100")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--archs", default=None,
                    help="with --all: only these archs (comma-separated)")
    ap.add_argument("--variant", default="",
                    help="label for a variant (stored in the key)")
    ap.add_argument("--ce-chunk", type=int, default=None)
    ap.add_argument("--remat-policy", default=None)
    ap.add_argument("--window-cache", action="store_true", default=None)
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--no-shard-rnn", action="store_true")
    ap.add_argument("--budget-s", type=float, default=None,
                    help="start no cell after this many seconds; the rest "
                    "are recorded as not run")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    out = Path(args.out)

    if args.all:
        cells = list(configs.cells())
        if args.archs:                         # in the order given
            cells = [c for a in args.archs.split(",") for c in cells
                     if c[0] == a]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    meshes = {"both": ["single", "multi"]}.get(args.mesh, [args.mesh])
    overrides = {}
    if args.ce_chunk is not None:
        overrides["ce_chunk"] = args.ce_chunk
    if args.remat_policy is not None:
        overrides["remat_policy"] = args.remat_policy
    if args.window_cache:
        overrides["window_kv_cache"] = True
    if args.capacity_factor is not None:
        overrides["capacity_factor"] = args.capacity_factor
    if args.no_shard_rnn:
        overrides["shard_rnn"] = False

    failures = 0
    t_start = time.perf_counter()
    for mesh_name in meshes:
        for arch, shape_name in cells:
            key_mesh = mesh_label(mesh_name) + (
                f"-{args.variant}" if args.variant else "")
            if not args.force and already_done(arch, shape_name, key_mesh,
                                               out):
                print(f"[skip] {arch} {shape_name} {key_mesh} (cached)")
                continue
            label = f"{arch} {shape_name} {key_mesh}"
            if args.budget_s is not None \
                    and time.perf_counter() - t_start > args.budget_s:
                save({"arch": arch, "shape": shape_name, "mesh": key_mesh,
                      "ok": False, "not_run": True}, out)
                print(f"[late] {label}: not run (past {args.budget_s} s)",
                      flush=True)
                continue
            print(f"[run ] {label}", flush=True)
            try:
                rec = run_cell(arch, shape_name, mesh_name,
                               overrides=overrides, variant=args.variant)
                save(rec, out)
                r, m = rec["roofline"], rec["memory_per_device"]
                print(f"[ ok ] {label}: count={rec['count_s']:.2f}s "
                      f"flops={rec['stats']['flops']:.4e} "
                      f"bytes={rec['stats']['bytes_accessed']:.4e} "
                      f"coll={rec['stats']['collective_bytes_total']:.4e} "
                      f"dominant={r['dominant']} "
                      f"t_comp={r['compute_s']:.2e}s t_mem={r['memory_s']:.2e}s "
                      f"t_coll={r['collective_s']:.2e}s "
                      f"per_device_GB={m['total'] / 1e9:.2f} "
                      f"fits={rec['fits_80gb']}", flush=True)
            except Exception:
                failures += 1
                err = traceback.format_exc()
                save({"arch": arch, "shape": shape_name, "mesh": key_mesh,
                      "ok": False, "error": err[-4000:]}, out)
                print(f"[FAIL] {label}\n{err[-2000:]}", flush=True)
    print(f"done; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
