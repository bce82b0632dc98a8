"""Multi-phase demo: an iterative application (paper §III-B) whose task
loads drift between executions, balanced once per phase (the port's copy
of ``examples/pipeline_phases.py``).

Shows the pipeline orchestrator's two amortizations — warm-started
assignments and shared CSR builds — against replanning every phase cold,
then the same machinery applied to a DP sequence-packing stream.

  PYTHONPATH=src python -m repro_torch.examples.pipeline_phases [--device cpu]

The orchestrator is host numpy; every phase scores its exchanges with the
pair kernel on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List

import numpy as np

from repro_torch.balance import rebalance_sequences_stream
from repro_torch.balance.seqpack import SeqPackResult
from repro_torch.core import (CCMParams, Phase, PipelineResult,
                              ccm_lb_pipeline, random_phase)


def drifting_phases(seed=0, ranks=32, n_phases=6, drift=0.08):
    base = random_phase(seed, num_ranks=ranks, num_tasks=25 * ranks,
                        num_blocks=3 * ranks, num_comms=50 * ranks,
                        mem_cap=1e12)
    rng = np.random.default_rng(seed + 1)
    phases = [base]
    for _ in range(n_phases - 1):
        prev = phases[-1]
        phases.append(dataclasses.replace(
            prev, task_load=prev.task_load
            * rng.lognormal(0.0, drift, prev.num_tasks)))
    return phases


@dataclasses.dataclass
class PipelineDemo:
    """What the demo printed: the phases, the cold and warm pipelines, and
    the sequence-packing stream's steps."""
    phases: List[Phase]
    cold: PipelineResult
    warm: PipelineResult
    stream: List[SeqPackResult]


def run(device="cuda") -> PipelineDemo:
    phases = drifting_phases()
    params = CCMParams(delta=1e-9)

    print(f"{len(phases)} phases, {phases[0].num_ranks} ranks, "
          f"{phases[0].num_tasks} tasks, load drift 8%/phase\n")

    cold = ccm_lb_pipeline(phases, params, warm_start=False, reuse_csr=False,
                           n_iter=3, batch_lock_events=8, device=device)
    warm = ccm_lb_pipeline(phases, params, n_iter=3, batch_lock_events=8,
                           device=device)

    print("phase |  cold transfers  imb |  warm transfers  imb  csr")
    for k, (c, w) in enumerate(zip(cold.runs, warm.runs)):
        print(f"  {k}   |  {c.result.transfers:14d}  {c.result.imbalance[-1]:.3f}"
              f" |  {w.result.transfers:14d}  {w.result.imbalance[-1]:.3f}"
              f"  {'reused' if w.csr_reused else 'built '}")
    print(f"\ntotals: cold {cold.total_transfers} transfers / "
          f"{cold.total_seconds:.2f}s   warm {warm.total_transfers} "
          f"transfers / {warm.total_seconds:.2f}s "
          f"({cold.total_seconds / warm.total_seconds:.2f}x)")

    # --- the same orchestrator behind a framework feature ------------------
    rng = np.random.default_rng(3)
    batches = [rng.lognormal(0.0, 0.8, 256) for _ in range(5)]
    stream = rebalance_sequences_stream(batches, n_ranks=16, seed=0,
                                        device=device)
    print("\nDP seq-pack stream (5 batches, 16 ranks): imbalance per step:")
    print("  " + "  ".join(f"{r.imbalance_before:.3f}->{r.imbalance_after:.3f}"
                           for r in stream))
    return PipelineDemo(phases, cold, warm, stream)


def main(argv=None) -> PipelineDemo:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where CCM-LB scores (cpu: the plain torch scorer)")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
