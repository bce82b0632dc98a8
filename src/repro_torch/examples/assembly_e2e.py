"""End-to-end Gemma-analogue assembly (paper §VI): REAL task execution with
measured durations, FNN cost model trained on one configuration and applied
to another, CCM-LB balancing, wave-based homing (the port's copy of
``examples/assembly_e2e.py``).

  PYTHONPATH=src python -m repro_torch.examples.assembly_e2e [--device cpu]

On the card every task is timed as one launch of the assembly-tile kernel,
the cost model trains there, and CCM-LB scores with the pair kernel;
``--device cpu`` times the tile's plain version on the host instead.
``run(durations="analytic")`` replaces the measured durations by the
tasks' FLOPs at a fixed rate (``execute.analytic_durations``) and balances
on them directly, with no cost model: that run is deterministic, so it is
the one held to the JAX package's ``run_assembly_comparison``.
``run(home=False)`` stops before the homing stage and returns the balanced
run, for a caller that plans the homing itself
(``plan_assembly_homing``).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.assembly import (AssemblyProblem, AssemblyRun,
                                  balance_assembly, build_problem,
                                  plan_assembly_homing)
from repro_torch.assembly.execute import analytic_durations, measure_durations
from repro_torch.costmodel import CostModel, train_cost_model
from repro_torch.costmodel.train import evaluate_cost_model


@dataclasses.dataclass
class AssemblyDemo:
    """What the demo printed: the training configuration and its
    durations, the cost model and its train-set metrics (None for analytic
    durations), and the A/B/C comparison of the target configuration."""
    train_problem: AssemblyProblem
    train_durations: np.ndarray
    model: Optional[CostModel]
    metrics: Optional[Dict[str, float]]
    run: AssemblyRun


# the target configuration that the cost model is applied to
TARGET = dict(n_unknowns=1536, num_ranks=8, seed=2, task_limit_u=32)


def run(device="cuda", durations: str = "measured",
        home: bool = True) -> AssemblyDemo:
    if durations not in ("measured", "analytic"):
        raise ValueError(f"durations must be 'measured' or 'analytic', not "
                         f"{durations!r}")
    # --- collect training data on a small configuration (measured!) --------
    train_p = build_problem(768, 4, task_limit_u=32, seed=1)
    model = metrics = None
    if durations == "analytic":
        print("analytic task durations (FLOPs / 2e9) on the training "
              "configuration ...")
        durs = analytic_durations(train_p)
    else:
        print("measuring task durations on the training configuration ...")
        durs = measure_durations(train_p, repeats=2, device=device)
    print(f"  {train_p.num_tasks} tasks, durations "
          f"{durs.min() * 1e6:.0f}us .. {durs.max() * 1e6:.0f}us")

    if durations == "measured":
        feats = train_p.features()
        print("training the FNN cost model (4x200, BN, dropout, LeakyReLU, "
              "AdamW, under-penalized RMSE, Alg.1 reduction) ...")
        model, _ = train_cost_model(feats, durs, epochs=120, batch_size=128,
                                    alpha=0.3,
                                    reduce_to=int(0.7 * len(durs)), seed=0,
                                    device=device)
        metrics = evaluate_cost_model(model, feats, durs)
        print(f"  train-set rel-err (median): "
              f"{metrics['rel_err_median']:.2%}, over-predict fraction: "
              f"{metrics['over_predict_frac']:.2f}")
        print("balancing the target configuration with PREDICTED durations "
              "...")
    else:
        print("balancing the target configuration with the analytic "
              "durations (no cost model) ...")

    # --- balance a larger, different configuration with predictions --------
    res = balance_assembly(**TARGET, durations=durations, cost_model=model,
                           device=device)
    if home:
        res = plan_assembly_homing(res)
    homing_t = res.homing.est_time_s if res.homing else 0.0
    print(f"  A  baseline (no overdecomposition) : {res.makespan_baseline:.4f}s")
    print(f"  B  overdecomposed, home layout     : "
          f"{res.makespan_overdecomposed:.4f}s "
          f"({res.speedup_overdecomposed:.2f}x)")
    print(f"  C  + CCM-LB (+homing {homing_t * 1e3:.2f}ms)   : "
          f"{res.makespan_ccmlb:.4f}s ({res.speedup_ccmlb:.2f}x)")
    print(f"  imbalance {res.imbalance_before:.3f} -> "
          f"{res.imbalance_after:.3f}; off-home slab copies: "
          f"{res.n_off_home_ranks}; homing waves: "
          f"{len(res.homing.waves) if res.homing else 0}")
    return AssemblyDemo(train_p, durs, model, metrics, res)


def main(argv=None) -> AssemblyDemo:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where tasks run, the cost model trains and CCM-LB "
                    "scores (cpu: the plain torch versions)")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
