"""End-to-end driver: train a ~100M-parameter MoE LM for a few hundred steps
with the full substrate — data pipeline, AdamW, checkpointing, fault-tolerant
restart, and CCM-LB expert re-placement from live router statistics (the
port's copy of ``examples/train_moe_ccm.py``).

  PYTHONPATH=src python -m repro_torch.examples.train_moe_ccm [--steps 300]

On the card every step runs flash attention and the expert GEMM forward
and backward as kernels (bf16); ``--device cpu`` runs their plain versions.
A second run with the same ``--ckpt-dir`` resumes from its latest
checkpoint, as the reference's does.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import List, Optional

import torch

from repro_torch.configs.base import BLOCK_MOE, ModelConfig
from repro_torch.launch.train import TrainLog, train_loop
from repro_torch.runtime.fault import (FaultInjector, RestartStats,
                                       run_with_restarts)

# ~100M params: 2*16k*512 embed + 8 layers x (attn ~1.3M + 16 experts x
# 3*512*512 + shared mlp) ~= 118M
CONFIG_100M = ModelConfig(
    name="moe-100m",
    family="moe",
    num_layers=8,
    d_model=512,
    num_heads=8,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=16384,
    head_dim=64,
    block_pattern=(BLOCK_MOE,),
    num_experts=16,
    top_k=2,
    moe_d_ff=512,
    act="silu",
    remat=False,
)


@dataclasses.dataclass
class TrainRun:
    """What the example printed: the parameter count, the losses of the
    last attempt (after a restart, from the step it restored), the restart
    loop's stats, and the trainer's log over every attempt (step seconds,
    launches, re-placements, restores)."""
    n_params: int
    losses: List[float]
    stats: RestartStats
    log: TrainLog


def run(device="cuda", *, steps: int = 300, seq_len: int = 256,
        global_batch: int = 8, ckpt_dir: Optional[str] = None,
        fail_at: int = 0, cfg: ModelConfig = CONFIG_100M,
        ckpt_every: int = 50, rebalance_every: int = 50,
        dtype=torch.bfloat16) -> TrainRun:
    """``cfg`` trained on ``device``; ``fail_at`` > 0 injects a node
    failure at that step.  ``cfg``, ``ckpt_every``, ``rebalance_every``
    and the weights' ``dtype`` (bf16, as the reference's trainer inits
    them) are the script's constants, exposed so that a test can run it
    cut and in float32."""
    n = cfg.param_count()
    print(f"[example] ~{n / 1e6:.0f}M params, {steps} steps, "
          f"CCM expert re-placement every {rebalance_every} steps")
    inj = FaultInjector(fail_at_steps=(fail_at,) if fail_at else ())
    log = TrainLog()
    losses_all = []

    def once():
        _, _, losses = train_loop(
            cfg, steps=steps, seq_len=seq_len, global_batch=global_batch,
            ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
            rebalance_every=rebalance_every, fault=inj, lr=1e-3,
            log_every=20, device=device, log=log, dtype=dtype)
        losses_all.append(losses)

    stats = run_with_restarts(once)
    losses = losses_all[-1]
    print(f"[example] done: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(restarts={stats.restarts}, wall={stats.wall_s:.0f}s)")
    return TrainRun(n, losses, stats, log)


def main(argv=None) -> TrainRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "moe_ccm_ckpt"))
    ap.add_argument("--fail-at", type=int, default=0,
                    help="inject a node failure at this step (0 = off)")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cpu: the kernels' plain "
                    "versions)")
    args = ap.parse_args(argv)
    out = run(args.device, steps=args.steps, seq_len=args.seq_len,
              global_batch=args.global_batch, ckpt_dir=args.ckpt_dir,
              fail_at=args.fail_at)
    assert out.losses[-1] < out.losses[0], "loss did not decrease"
    return out


if __name__ == "__main__":
    main()
