"""The §IV-B lock/grant protocol under real asynchrony (the port's copy of
``examples/async_balancer.py``).

The synchronous driver (core/ccmlb.py) releases every lock within the
turn that took it, so its conflict/yield/grant-chain counters are zero by
construction.  This demo runs the SAME protocol through the async
event-loop simulator (core/async_sim.py):

  1. at zero latency the event queue serializes — the trajectory is
     bitwise-identical to the synchronous driver (the parity bar);
  2. with a seeded message-latency distribution, concurrent lock requests
     collide, deadlock-avoidance yields fire, and queued requests drain
     through multi-hop grant chains — while the balancer still converges;
  3. a contended start (half the ranks empty) drives the counters up, and
     a gossip deadline makes stale information observable;
  4. seeded faults (message loss, duplication, a rank killed
     mid-iteration) exercise the hardened protocol: timeouts retry with
     backoff, duplicate grants/releases are absorbed idempotently, dead
     ranks' locks are reclaimed and their work migrates to survivors —
     and the transfer log still replays exactly onto the final
     assignment;
  5. chaos: a split-brain partition severs the mesh into two islands —
     each keeps balancing locally off its own gossip, then the window
     closes, the islands re-merge and the run quiesces; finally two
     fresh ranks JOIN mid-stream, inherit gossip state through the
     ordinary flood and end the run owning real work.

  PYTHONPATH=src python -m repro_torch.examples.async_balancer [--device cpu]

The event loop is host numpy; every run scores its exchanges with the pair
kernel on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np

from repro_torch.core import (CCMLBResult, CCMParams, FaultSpec, RankJoin,
                              ccm_lb, ccm_lb_async, random_phase)
from repro_torch.core.problem import initial_assignment


def counters(tag, res):
    print(f"  {tag:<22} imb {res.imbalance[0]:.3f}->{res.imbalance[-1]:.4f}"
          f"  transfers={res.transfers:<4d} conflicts={res.lock_conflicts:<4d}"
          f" yields={res.yields:<4d} chains={res.grant_chains:<3d}"
          f" max_chain={res.max_grant_chain:<3d} msgs={res.messages}")


def run(device="cuda") -> Dict[str, CCMLBResult]:
    """Every run of the five parts, by the tag its counters line prints
    (the synchronous run under ``"sync"``)."""
    phase = random_phase(1, num_ranks=16, num_tasks=400, num_blocks=48,
                         num_comms=800, mem_cap=1e12)
    params = CCMParams(delta=1e-9)
    a0 = initial_assignment(phase)
    lb = dict(n_iter=4, k_rounds=2, fanout=4, seed=0, device=device)
    runs = {}

    def show(tag, res):
        runs[tag] = res
        counters(tag, res)

    print("1) zero latency == serialized schedule == the synchronous driver")
    ref = ccm_lb(phase, a0, params, **lb)
    got = ccm_lb_async(phase, a0, params, **lb)
    assert np.array_equal(ref.assignment, got.assignment)
    assert ref.transfer_log == got.transfer_log
    show("sync", ref)
    show("async latency=0", got)
    print("  -> identical assignment AND transfer sequence, bit for bit\n")

    print("2) message latency: the protocol branches become load-bearing")
    for latency in (0.5, ("uniform", 0.5, 1.5)):
        res = ccm_lb_async(phase, a0, params, latency=latency, **lb)
        show(f"async latency={latency}", res)
    print()

    print("3) contention (half the ranks start empty) + a gossip deadline")
    a1 = (np.arange(phase.num_tasks) % 8).astype(np.int64)
    res = ccm_lb_async(phase, a1, params, n_iter=4, seed=3, fanout=6,
                       latency=("uniform", 0.5, 1.5), device=device)
    show("contended", res)
    stale = ccm_lb_async(phase, a1, params, n_iter=4, seed=3, fanout=6,
                         latency=("uniform", 0.5, 1.5), gossip_timeout=1.0,
                         device=device)
    show("contended+deadline", stale)
    print(f"  -> gossip deliveries dropped as stale: {stale.gossip_dropped}")
    print()

    print("4) faults: message loss + duplication, then a rank death")
    lossy = FaultSpec(drop=0.03, dup=0.1, req_timeout=3.0, seed=7)
    res = ccm_lb_async(phase, a0, params, latency=("uniform", 0.5, 1.5),
                       fault=lossy, **lb)
    show("lossy+dup", res)
    fs = res.fault_stats
    print(f"  -> injected: dropped={fs.dropped} duplicated={fs.duplicated};"
          f" absorbed: timeouts={res.timeouts}"
          f" retries_exhausted={res.retries_exhausted}"
          f" stale_grants={fs.stale_grants}"
          f" stale_releases={fs.stale_releases}"
          f" wedged_reclaimed={fs.wedged_reclaimed}")

    crash = FaultSpec(kill=((3, 1, 0.5),), seed=9)
    res = ccm_lb_async(phase, a0, params, latency=("uniform", 0.5, 1.5),
                       fault=crash, **lb)
    show("rank 3 killed @it1", res)
    replay = a0.copy()
    for tasks, r_from, r_to in res.transfer_log:
        replay[np.asarray(tasks, np.int64)] = r_to
    assert np.array_equal(replay, res.assignment)
    assert not (res.assignment == 3).any()
    print(f"  -> dead={res.dead_ranks}"
          f" recovered_tasks={res.fault_stats.recovered_tasks};"
          " transfer log replays exactly, no task left on the dead rank")
    print()

    print("5) chaos: a split-brain heal, then two ranks join mid-stream")
    split = FaultSpec(partition=((tuple(range(8)), tuple(range(8, 16)),
                                  0, 0.0, 15.0),), seed=11)
    res = ccm_lb_async(phase, a0, params, latency=("uniform", 0.5, 1.5),
                       fault=split, n_iter=8, k_rounds=2, fanout=4,
                       seed=0, quiesce_after=2, device=device)
    show("split-brain healed", res)
    fs = res.fault_stats
    print(f"  -> cross-island messages destroyed: {fs.partitioned_dropped};"
          f" after the heal the run quiesced in {len(res.iter_transfers)}"
          f" iterations (last two transfer counts:"
          f" {list(res.iter_transfers[-2:])})")

    res = ccm_lb_async(phase, a0, params, latency=("uniform", 0.5, 1.5),
                       membership=(RankJoin(iteration=1, count=2),), **lb)
    show("2 ranks join @it1", res)
    on_joined = int(np.isin(res.assignment, res.joined_ranks).sum())
    replay = a0.copy()
    for tasks, r_from, r_to in res.transfer_log:
        replay[np.asarray(tasks, np.int64)] = r_to
    assert np.array_equal(replay, res.assignment)
    print(f"  -> joined={res.joined_ranks} now own {on_joined} tasks"
          f" ({res.state.phase.num_ranks} ranks at the end);"
          " the log replays exactly across the membership change")
    return runs


def main(argv=None) -> Dict[str, CCMLBResult]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where CCM-LB scores (cpu: the plain torch scorer)")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
