"""Quickstart: the CCM model + CCM-LB on a synthetic phase, certified
against the MILP optimum (the port's copy of ``examples/quickstart.py``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

CCM-LB scores its exchanges with the pair kernel on the card unless
``--device cpu``; the MILP is host numpy.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.core import (CCMLBResult, CCMParams, CCMState, ccm_lb,
                              random_phase)
from repro_torch.core.milp import MILPResult, build_fwmp_reduced, solve_milp
from repro_torch.core.problem import initial_assignment


@dataclasses.dataclass
class Quickstart:
    """What the quickstart printed: the 16-rank phase before and after
    CCM-LB, then the certification of the 4-rank instance."""
    initial_max_work: float
    initial_imbalance: float
    result: CCMLBResult
    mean_load: float
    best: float
    milp: MILPResult


def run(device="cuda") -> Quickstart:
    # --- a phase: 16 ranks, 400 tasks, 48 shared blocks, 800 comm edges ----
    phase = random_phase(0, num_ranks=16, num_tasks=400, num_blocks=48,
                         num_comms=800, mem_cap=3e8)
    params = CCMParams(alpha=1.0, beta=1e-9, gamma=1e-11, delta=1e-9)
    a0 = initial_assignment(phase, "home")
    st0 = CCMState.build(phase, a0, params)
    print(f"initial : max work {st0.max_work():.3f}  "
          f"imbalance {st0.imbalance():.3f}")

    # --- CCM-LB: gossip + cluster transfers under memory constraints -------
    res = ccm_lb(phase, a0, params, n_iter=4, k_rounds=2, fanout=4, seed=1,
                 device=device)
    print(f"CCM-LB  : max work {res.max_work[-1]:.3f}  "
          f"imbalance {res.imbalance[-1]:.4f}  "
          f"transfers {res.transfers}")
    mean = phase.task_load.sum() / phase.num_ranks
    print(f"          ({100 * (res.max_work[-1] / mean - 1):.2f}% above the "
          f"mean-load lower bound)")

    # --- certify on a small instance against the MILP (paper §V) -----------
    small = random_phase(7, num_ranks=4, num_tasks=14, num_blocks=4,
                         num_comms=16, mem_cap=5e8)
    a0s = initial_assignment(small)
    best = min(ccm_lb(small, a0s, params, n_iter=4, fanout=3, seed=s,
                      device=device).max_work[-1] for s in range(12))
    milp = solve_milp(build_fwmp_reduced(small, params), max_nodes=2000,
                      time_limit_s=60)
    print("\nMILP certification (4 ranks / 14 tasks):")
    print(f"  optimal W_max   : {milp.objective:.4f} ({milp.status}, "
          f"{milp.nodes} nodes, {milp.wall_s:.1f}s)")
    print(f"  CCM-LB best/12  : {best:.4f} "
          f"(+{100 * (best - milp.objective) / milp.objective:.2f}% vs opt)")
    return Quickstart(float(st0.max_work()), float(st0.imbalance()), res,
                      float(mean), float(best), milp)


def main(argv=None) -> Quickstart:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where CCM-LB scores (cpu: the plain torch scorer)")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
