"""Training launcher, after the JAX package's ``launch/train.py``.

Runs any --arch the port serves, the encoder-decoder and the vision front
end included (smoke configs on the CPU; full configs that fit on the card,
or cut in depth), with checkpoint/restart
fault tolerance and — for MoE archs — periodic CCM-LB expert re-placement
applied as function-preserving slot permutations of the live parameters
and of AdamW's moments.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b \\
      --smoke --device cpu --steps 50 --rebalance-every 20 --expert-ranks 4

runs on the card unless ``--device cpu``.  On a mesh (``--mesh D,M`` under
``torchrun --nproc-per-node D*M``, or ``--production-mesh``, the
reference's 16 x 16, which needs a world of 256) the weights, their AdamW
moments and the batch are laid out as ``models.model`` says, checkpoints
hold whole leaves (gathered one at a time; rank 0 writes them) and a
restart restores onto whatever mesh it runs on
(``runtime.elastic.resume_on_mesh``).  The number
of expert ranks of a re-placement is the mesh's model axis, as in the
reference; ``expert_ranks`` overrides it (``chip_smoke.py`` plans on 16 on
one card).  On a model axis larger than 1 the permutation moves expert
slices, and their moments, between model-axis ranks: each leaf is gathered
over the model group and every rank keeps its new slots.  The plan runs
under the H100's HBM size and FLOP rate (``balance.pipeline_stages``), not
the reference's TPU figures.  Deviation from the reference, on purpose: a
re-placement permutes AdamW's m and v with the experts; the reference
permutes the parameters only, so after a re-placement it updates each
expert with another expert's moments (ROADMAP queue 3).  On the card
every kernel the step runs has a backward kernel: flash attention, the
expert GEMM, WKV6 (rwkv6) and the RG-LRU scan (recurrentgemma).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, sharding
from repro_torch.balance.expert_placement import plan_expert_placement
from repro_torch.balance.pipeline_stages import H100_HBM_BYTES
from repro_torch.checkpoint import CheckpointManager, tree_leaves
from repro_torch.configs.base import BLOCK_MOE
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels.ccm_scorer import kernel as scorer_kernel
from repro_torch.kernels.flash import kernel as flash_kernel
from repro_torch.kernels.moe_gemm import kernel as gemm_kernel
from repro_torch.kernels.rglru import kernel as rglru_kernel
from repro_torch.kernels.rwkv6 import kernel as wkv6_kernel
from repro_torch.launch.steps import (make_optimizer, make_train_step,
                                     tree_leaves_specs)
from repro_torch.models.model import build_model
from repro_torch.optim import AdamW
from repro_torch.runtime.elastic import resume_on_mesh
from repro_torch.runtime.fault import FaultInjector, run_with_restarts


@dataclasses.dataclass
class TrainLog:
    """What a :func:`train_loop` run measured, appended to as it runs:
    per step its index, seconds (CUDA events on the card, the host clock on
    the CPU) and kernel launches (:func:`launch_counts`); per
    re-placement its step, imbalance
    before and after, pair-kernel launches and seconds; the step a run
    restored from."""
    steps: List[int] = dataclasses.field(default_factory=list)
    step_s: List[float] = dataclasses.field(default_factory=list)
    launches: List[Dict[str, int]] = dataclasses.field(default_factory=list)
    replacements: List[dict] = dataclasses.field(default_factory=list)
    restored_from: List[int] = dataclasses.field(default_factory=list)


#: the model kernels' modules, by the prefix of their counts
KERNELS = {"flash": flash_kernel, "gemm": gemm_kernel, "wkv6": wkv6_kernel,
           "rglru": rglru_kernel}


def launch_counts() -> Dict[str, int]:
    """The model kernels' launch counters (flash attention, the expert
    GEMM, WKV6 and the RG-LRU scan, each forward and backward), summed over
    dtypes."""
    out = {}
    for name, mod in KERNELS.items():
        out[f"{name}_fwd"] = sum(mod.LAUNCHES.values())
        out[f"{name}_bwd"] = sum(mod.BWD_LAUNCHES.values())
    return out


def train_loop(cfg, *, steps: int, seq_len: int, global_batch: int,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
               rebalance_every: int = 0, fault: Optional[FaultInjector] = None,
               lr: float = 3e-4, log_every: int = 10, seed: int = 0,
               expert_ranks: Optional[int] = None, device="cuda",
               log: Optional[TrainLog] = None, mesh=None,
               dtype=torch.bfloat16):
    """Train ``cfg`` for ``steps`` steps (from the latest checkpoint in
    ``ckpt_dir`` when there is one); returns (params, optimizer, losses of
    the steps this call ran).  The weights are bf16, as the reference's
    trainer inits them (``dtype`` chooses others).  ``log``, when given,
    receives what the run measured.  On ``mesh`` the params and optimizer
    hold this rank's shards, ``expert_ranks`` defaults to the mesh's model
    axis (1 without a mesh), and rank 0 prints."""
    speak = mesh is None or dist.get_rank() == 0
    # on a mesh rank 0 writes whole leaves one at a time, synchronously
    # (save_checkpoint)
    mgr = CheckpointManager(ckpt_dir, async_write=mesh is None) \
        if ckpt_dir else None
    start = 0
    if mgr and mgr.latest() is not None:
        model, params, opt_state, start = resume_on_mesh(
            cfg, device if mesh is None else mesh, ckpt_dir, dtype=dtype)
        if speak:
            print(f"[train] restored step {start}", flush=True)
        if log is not None:
            log.restored_from.append(start)
    else:
        model = build_model(cfg, device=device, dtype=dtype, mesh=mesh)
        params = model.init(torch.Generator(device=model.device)
                            .manual_seed(seed))
        opt_state = None
    opt = make_optimizer(params, lr=lr, warmup_steps=max(1, steps // 10),
                         total_steps=steps, ctx=model.ctx)
    if opt_state is not None:
        opt.load_state_leaves(opt_state)
    step_fn = make_train_step(model)
    on_card = model.device.type == "cuda"

    losses = []
    for step in range(start, steps):
        if fault is not None:
            fault.maybe_fail(step)
        batch = make_batch(cfg, seq_len, global_batch, step, seed=seed)
        before = launch_counts()
        if on_card:
            ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
            ev0.record()
        t0 = time.perf_counter()
        metrics = step_fn(params, opt, batch)
        if on_card:
            ev1.record()
        loss = float(metrics["loss"])
        dt = ev0.elapsed_time(ev1) / 1e3 if on_card \
            else time.perf_counter() - t0
        losses.append(loss)
        if log is not None:
            after = launch_counts()
            log.steps.append(step)
            log.step_s.append(dt)
            log.launches.append({k: after[k] - before[k] for k in after})
        if speak and (step % log_every == 0 or step == steps - 1):
            print(f"[train] step {step} loss {loss:.4f} ({dt:.2f}s)",
                  flush=True)
        if mgr and ((step + 1) % ckpt_every == 0 or step == steps - 1):
            save_checkpoint(mgr, step + 1, params, opt, model.ctx)
        if (rebalance_every and cfg.is_moe and (step + 1) % rebalance_every == 0
                and "expert_counts" in metrics):
            counts = metrics["expert_counts"].cpu().numpy().astype(np.float64)
            rec = rebalance_experts(params, opt, counts, cfg, expert_ranks,
                                    ctx=model.ctx)
            if log is not None and rec is not None:
                log.replacements.append(dict(rec, step=step + 1))
    if mgr:
        mgr.wait()
    return params, opt, losses


def save_checkpoint(mgr: CheckpointManager, step: int, params, opt: AdamW,
                    ctx=None) -> None:
    """``(params, AdamW state)`` as whole leaves.  On a mesh the leaves
    are gathered one at a time (all ranks take part) and rank 0 writes
    each before the next is gathered, so no rank holds more than one whole
    leaf and only rank 0 copies it to host memory; the other ranks wait at
    a barrier."""
    if ctx is None:
        mgr.save(step, (params, opt.state_leaves()))
        return
    specs = tree_leaves_specs(ctx.specs)
    state = opt.state_leaves()
    # the order of tree_leaves((params, state)): the params, the step, m, v
    pairs = (list(zip(tree_leaves(params), specs)) + [(state[0], ())]
             + list(zip(state[1:], specs * 2, strict=True)))
    whole = (ctx.gather(t.detach(), s) for t, s in pairs)
    if dist.get_rank() == 0:
        mgr.save_leaves(step, whole)
    else:
        for _ in whole:
            pass
    dist.barrier()


def _permuted(t: torch.Tensor, axis: int, perm: torch.Tensor, spec, ctx):
    """``t`` (a rank's shard) with its ``axis`` reordered by the global
    slot permutation ``perm``: where that axis is sharded over the model
    axis, the slices are gathered over the model group first and each rank
    keeps its new slots."""
    if ctx is None or spec[axis] != ctx.axes.model \
            or sharding.axis_size(ctx.mesh, ctx.axes.model) == 1:
        return t.index_select(axis, perm)
    whole = sharding.gather(t, ctx.mesh, tuple(
        e if i == axis else None for i, e in enumerate(spec)))
    return take_slots(whole, axis, perm,
                      sharding.axis_rank(ctx.mesh, ctx.axes.model),
                      t.shape[axis])


def take_slots(whole: torch.Tensor, axis: int, perm: torch.Tensor,
               rank: int, n: int) -> torch.Tensor:
    """Model rank ``rank``'s ``n`` slots after the permutation ``perm``,
    from the gathered leaf ``whole``: slot ``rank * n + j`` holds original
    expert ``perm[rank * n + j]``, wherever it lay."""
    return whole.index_select(axis, perm[rank * n:(rank + 1) * n])


def permute_experts(params, opt: Optional[AdamW], perms, cfg,
                    ctx=None) -> None:
    """Apply slot permutations in place: ``perms[p]`` (slot s holds original
    expert ``perms[p][s]``) to every MoE block of period ``p`` of the block
    pattern (the tail, as in the reference, is left alone): the three
    expert weights along E and the router's columns, and, when ``opt`` is
    given, their AdamW moments likewise.  On a mesh (``ctx``) expert
    slices move between model-axis ranks."""
    period = cfg.pattern_period
    n_scan = (cfg.num_layers // period) * period
    with torch.no_grad():
        for i, (blk, kind) in enumerate(zip(params["blocks"],
                                            cfg.layer_kinds())):
            if kind != BLOCK_MOE or i >= n_scan:
                continue
            moe = blk["moe"]
            perm = torch.as_tensor(np.asarray(perms[i // period]),
                                   dtype=torch.long, device=moe["w_gate"].device)
            for name, axis in (("w_gate", 0), ("w_up", 0), ("w_down", 0),
                               ("router", 1)):
                spec = None if ctx is None \
                    else ctx.specs["blocks"][i]["moe"][name]
                p = moe[name]
                targets = [p]
                if opt is not None:
                    st = opt.moments(p)
                    targets += [st["m"], st["v"]]
                for t in targets:
                    t.copy_(_permuted(t, axis, perm, spec, ctx))


def rebalance_experts(params, opt: Optional[AdamW], counts: np.ndarray, cfg,
                      expert_ranks: Optional[int] = None,
                      ctx=None) -> Optional[dict]:
    """CCM-LB plan on ``expert_ranks`` ranks (the mesh's model axis when
    None, 1 without a mesh) -> per-layer slot permutation applied to the
    live params and AdamW's moments.  Returns the re-placement's record, or
    None when the experts do not divide over the ranks.  The plan scores
    on the params' device (the pair kernel on the card); on a mesh rank
    0's plan is broadcast, so that every rank applies the same."""
    if expert_ranks is None:
        expert_ranks = 1 if ctx is None else sharding.axis_size(
            ctx.mesh, ctx.axes.model)
    n_dev = max(int(expert_ranks), 1)
    if cfg.num_experts % n_dev:
        return None
    dev = params["embed"].device.type
    n0 = scorer_kernel.PAIR_LAUNCHES["float64"]
    t0 = time.perf_counter()
    plan = plan_expert_placement(counts, cfg, n_dev,
                                 hbm_budget_bytes=H100_HBM_BYTES,
                                 rank_speed=None, device=dev)
    rec = {"imbalance_before": float(plan.imbalance_before),
           "imbalance_after": float(plan.imbalance_after),
           "pair_launches": scorer_kernel.PAIR_LAUNCHES["float64"] - n0,
           "plan_s": time.perf_counter() - t0,
           "applied": bool(plan.max_work_after < plan.max_work_before)}
    perms = plan.permutations
    if ctx is not None and dist.get_world_size() > 1:
        box = [(rec["applied"], perms)]
        dist.broadcast_object_list(box, src=0)
        rec["applied"], perms = box[0]
    if not rec["applied"]:
        return rec
    permute_experts(params, opt, perms, cfg, ctx=ctx)
    if ctx is None or dist.get_rank() == 0:
        print(f"[ccm-lb] expert re-placement: imbalance "
              f"{plan.imbalance_before:.3f} -> {plan.imbalance_after:.3f} "
              f"(replication suggested on {plan.replicated_blocks} blocks)",
              flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--rebalance-every", type=int, default=0)
    ap.add_argument("--expert-ranks", type=int, default=None,
                    help="ranks of the re-placement plan (default: the "
                    "mesh's model axis, 1 without a mesh)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None, metavar="D,M",
                    help="train on a D x M (data, model) mesh over the "
                    "world torchrun starts (NCCL on the card, gloo with "
                    "--device cpu)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the reference's 16 x 16 mesh (a world of 256)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    mesh = None
    if args.production_mesh or args.mesh:
        from repro_torch.launch import mesh as mesh_lib
        if args.production_mesh:
            mesh_lib.init_world(args.device)
            mesh = mesh_lib.make_production_mesh(
                device_type=torch.device(args.device).type)
        else:
            mesh = mesh_lib.make_local_mesh(*mesh_lib.parse_mesh(args.mesh),
                                            device=args.device)
    out = {}

    def once():
        out["run"] = train_loop(
            cfg, steps=args.steps, seq_len=args.seq_len,
            global_batch=args.global_batch, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every, rebalance_every=args.rebalance_every,
            lr=args.lr, expert_ranks=args.expert_ranks, device=args.device,
            mesh=mesh, dtype=getattr(torch, args.dtype))

    stats = run_with_restarts(once)
    if mesh is None or dist.get_rank() == 0:
        print(f"[train] done: restarts={stats.restarts} "
              f"wall={stats.wall_s:.1f}s")
    return out["run"]


if __name__ == "__main__":
    main()
