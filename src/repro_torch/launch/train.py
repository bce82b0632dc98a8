"""Training launcher, after the JAX package's ``launch/train.py``.

Runs any decoder --arch the port serves (smoke configs on the CPU; full
configs that fit on the card) with checkpoint/restart
fault tolerance and — for MoE archs — periodic CCM-LB expert re-placement
applied as function-preserving slot permutations of the live parameters
and of AdamW's moments.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b \\
      --smoke --device cpu --steps 50 --rebalance-every 20 --expert-ranks 4

runs on the card unless ``--device cpu``.  Where the reference reads the
mesh's model axis for the number of expert ranks, the port takes
``expert_ranks`` (one card has no mesh; 1 is what the reference's local
mesh gives).  The plan runs under the H100's HBM size and FLOP rate
(``balance.pipeline_stages``), not the reference's TPU figures.  Deviation
from the reference, on purpose: a re-placement permutes AdamW's m and v
with the experts; the reference permutes the parameters only, so after a
re-placement it updates each expert with another expert's moments (ROADMAP
queue 3).  rwkv6 and recurrentgemma train on the CPU only: their kernels
have no backward yet and refuse autograd on the card.  The reference's
``--production-mesh`` is not ported.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.balance.expert_placement import plan_expert_placement
from repro_torch.balance.pipeline_stages import H100_HBM_BYTES
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import BLOCK_MOE
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels.ccm_scorer import kernel as scorer_kernel
from repro_torch.kernels.flash import kernel as flash_kernel
from repro_torch.kernels.moe_gemm import kernel as gemm_kernel
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.models.model import build_model
from repro_torch.optim import AdamW
from repro_torch.runtime.elastic import resume_on_mesh
from repro_torch.runtime.fault import FaultInjector, run_with_restarts


@dataclasses.dataclass
class TrainLog:
    """What a :func:`train_loop` run measured, appended to as it runs:
    per step its index, seconds (CUDA events on the card, the host clock on
    the CPU) and kernel launches (flash forward and backward, expert GEMM
    in the forward and the backward); per re-placement its step, imbalance
    before and after, pair-kernel launches and seconds; the step a run
    restored from."""
    steps: List[int] = dataclasses.field(default_factory=list)
    step_s: List[float] = dataclasses.field(default_factory=list)
    launches: List[Dict[str, int]] = dataclasses.field(default_factory=list)
    replacements: List[dict] = dataclasses.field(default_factory=list)
    restored_from: List[int] = dataclasses.field(default_factory=list)


def launch_counts() -> Dict[str, int]:
    """The model kernels' launch counters, summed over dtypes."""
    return {"flash_fwd": sum(flash_kernel.LAUNCHES.values()),
            "flash_bwd": sum(flash_kernel.BWD_LAUNCHES.values()),
            "gemm_fwd": sum(gemm_kernel.LAUNCHES.values()),
            "gemm_bwd": sum(gemm_kernel.BWD_LAUNCHES.values())}


def train_loop(cfg, *, steps: int, seq_len: int, global_batch: int,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
               rebalance_every: int = 0, fault: Optional[FaultInjector] = None,
               lr: float = 3e-4, log_every: int = 10, seed: int = 0,
               expert_ranks: int = 1, device="cuda",
               log: Optional[TrainLog] = None):
    """Train ``cfg`` for ``steps`` steps (from the latest checkpoint in
    ``ckpt_dir`` when there is one); returns (params, optimizer, losses of
    the steps this call ran).  The weights are bf16, as the reference's
    trainer inits them.  ``log``, when given, receives what the run
    measured."""
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr and mgr.latest() is not None:
        model, params, opt_state, start = resume_on_mesh(cfg, device,
                                                         ckpt_dir)
        print(f"[train] restored step {start}", flush=True)
        if log is not None:
            log.restored_from.append(start)
    else:
        model = build_model(cfg, device=device)
        params = model.init(torch.Generator(device=model.device)
                            .manual_seed(seed))
        opt_state = None
    opt = make_optimizer(params, lr=lr, warmup_steps=max(1, steps // 10),
                         total_steps=steps)
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
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step} loss {loss:.4f} ({dt:.2f}s)",
                  flush=True)
        if mgr and ((step + 1) % ckpt_every == 0 or step == steps - 1):
            mgr.save(step + 1, (params, opt.state_leaves()))
        if (rebalance_every and cfg.is_moe and (step + 1) % rebalance_every == 0
                and "expert_counts" in metrics):
            counts = metrics["expert_counts"].cpu().numpy().astype(np.float64)
            rec = rebalance_experts(params, opt, counts, cfg, expert_ranks)
            if log is not None and rec is not None:
                log.replacements.append(dict(rec, step=step + 1))
    if mgr:
        mgr.wait()
    return params, opt, losses


def permute_experts(params, opt: Optional[AdamW], perms, cfg) -> None:
    """Apply slot permutations in place: ``perms[p]`` (slot s holds original
    expert ``perms[p][s]``) to every MoE block of period ``p`` of the block
    pattern (the tail, as in the reference, is left alone): the three
    expert weights along E and the router's columns, and, when ``opt`` is
    given, their AdamW moments likewise."""
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
                p = moe[name]
                targets = [p]
                if opt is not None:
                    st = opt.moments(p)
                    targets += [st["m"], st["v"]]
                for t in targets:
                    t.copy_(t.index_select(axis, perm))


def rebalance_experts(params, opt: Optional[AdamW], counts: np.ndarray, cfg,
                      expert_ranks: int) -> Optional[dict]:
    """CCM-LB plan on ``expert_ranks`` ranks -> per-layer slot permutation
    applied to the live params and AdamW's moments.  Returns the
    re-placement's record, or None when the experts do not divide over the
    ranks.  The plan scores on the params' device (the pair kernel on the
    card)."""
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
    if not rec["applied"]:
        return rec
    permute_experts(params, opt, plan.permutations, cfg)
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
    ap.add_argument("--expert-ranks", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))

    def once():
        train_loop(cfg, steps=args.steps, seq_len=args.seq_len,
                   global_batch=args.global_batch, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every,
                   rebalance_every=args.rebalance_every, lr=args.lr,
                   expert_ranks=args.expert_ranks, device=args.device)

    stats = run_with_restarts(once)
    print(f"[train] done: restarts={stats.restarts} wall={stats.wall_s:.1f}s")


if __name__ == "__main__":
    main()
