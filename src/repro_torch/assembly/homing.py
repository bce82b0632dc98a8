"""Wave-based homing transfers (paper §VI-C).

After assembly, slabs computed (in whole or part) off their home rank must be
shipped home without exceeding node memory: transfers proceed in *waves*; in
each wave a slab may move only if the destination node has room for it (the
source frees its copy at the end of the wave).  When two ranks need to swap
but neither has headroom, one slab detours via the compute node with the most
free memory (the paper's escape hatch).

The port's own copy of ``repro/assembly/homing.py`` (host numpy), with the
same failure modes: no node with headroom for a detour, and no convergence.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class HomingPlan:
    waves: List[List[Tuple[int, int, int]]]   # per wave: (slab, src_node, dst_node)
    detours: int
    total_bytes: float
    est_time_s: float

    @property
    def n_off_home(self) -> int:
        return sum(len(w) for w in self.waves)


def plan_homing(slab_bytes: np.ndarray, slab_home_rank: np.ndarray,
                slab_location_rank: np.ndarray, *, ranks_per_node: int = 2,
                node_mem_cap: float, node_mem_used: np.ndarray,
                bandwidth: float = 12.5e9) -> HomingPlan:
    """All arrays indexed by slab; locations/homes are RANKS, capacity is per
    NODE (the paper limits concurrent shared blocks per node, not per rank).
    ``node_mem_used`` (n_nodes,) is the post-assembly residency per node.
    """
    n_slabs = slab_bytes.shape[0]
    node_of = lambda r: int(r) // ranks_per_node
    free = node_mem_cap - np.asarray(node_mem_used, np.float64).copy()
    pending = [s for s in range(n_slabs)
               if node_of(slab_location_rank[s]) != node_of(slab_home_rank[s])]
    waves: List[List[Tuple[int, int, int]]] = []
    detours = 0
    total_bytes = 0.0
    # larger slabs first: hardest to place
    pending.sort(key=lambda s: -slab_bytes[s])
    guard = 0
    while pending and guard < 10 * n_slabs + 10:
        guard += 1
        wave: List[Tuple[int, int, int]] = []
        moved = []
        freed: Dict[int, float] = {}
        for s in pending:
            src, dst = node_of(slab_location_rank[s]), node_of(slab_home_rank[s])
            if free[dst] >= slab_bytes[s]:
                free[dst] -= slab_bytes[s]
                freed[src] = freed.get(src, 0.0) + slab_bytes[s]
                wave.append((s, src, dst))
                slab_location_rank[s] = slab_home_rank[s]
                total_bytes += slab_bytes[s]
                moved.append(s)
        if not moved:
            # deadlock (mutual swaps with no headroom): detour the largest
            # pending slab via the node with the most free memory
            s = pending[0]
            spare = int(np.argmax(free))
            if free[spare] < slab_bytes[s]:
                raise RuntimeError("homing infeasible: no node has headroom")
            src = node_of(slab_location_rank[s])
            free[spare] -= slab_bytes[s]
            wave.append((s, src, spare))
            # it now lives on the spare node; next wave can take it home
            slab_location_rank[s] = spare * ranks_per_node
            freed[src] = freed.get(src, 0.0) + slab_bytes[s]
            total_bytes += slab_bytes[s]
            detours += 1
        # sources release their copies at the end of the wave
        for node, b in freed.items():
            free[node] += b
        waves.append(wave)
        pending = [s for s in pending
                   if node_of(slab_location_rank[s]) != node_of(slab_home_rank[s])]
        pending.sort(key=lambda s: -slab_bytes[s])
    if pending:
        raise RuntimeError("homing did not converge")
    return HomingPlan(waves, detours, total_bytes, total_bytes / bandwidth)
