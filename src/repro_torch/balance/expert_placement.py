"""CCM-driven MoE expert placement — the paper's technique as a first-class
framework feature.

Mapping: a (layer, expert) work item is a CCM *task* whose load is the
router's token count x per-token expert FLOPs; the expert's weights are its
*shared block* (replicable at HBM cost), homed where the optimizer state
lives; consecutive-layer co-activation gives the *comm* edges (tokens
flowing e_l -> e'_{l+1} cross the network iff the two experts sit on
different devices); the HBM budget is the hard eps constraint.

CCM-LB then plans a placement.  Applying an arbitrary plan = per-layer
permutations of the expert axis (slots): permuting expert weights AND the
router's output columns identically is a function-preserving transformation
(verified in tests), after which slot s lives on device s // (E / n_devices).
Plans that replicate an expert across ranks (sharded experts +
``replicate=True``) become REAL placements: ``PlacementPlan.serving``
carries the per-device replica sets, the per-copy routing shares and an
HBM byte audit for the serving engine, while the training path applies
the permutation-only projection of the plan (each expert at its primary
— heaviest-shard — device).

The port's copy of the JAX package's ``balance/expert_placement.py``: host
numpy, the engine's stage 2 scored on ``device`` (the pair kernel on the
card), and :func:`apply_expert_permutation` on torch tensors.  A task's
time is its FLOPs over ``peak_flops``, by default ``PEAK_FLOPS``, the
H100's dense bf16 peak, read when the phase is built; the reference's
figure is for another chip, and its parity tests set it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.balance.pipeline_stages import PEAK_FLOPS
from repro_torch.configs.base import ModelConfig
from repro_torch.core import CCMParams, ccm_lb_pipeline, run_ccm_lb
from repro_torch.core.problem import Phase


def phase_from_router_stats(counts: np.ndarray, cfg: ModelConfig,
                            n_devices: int, *, hbm_budget_bytes: float,
                            bytes_per_token: Optional[float] = None,
                            coactivation: Optional[np.ndarray] = None,
                            rank_speed: Optional[np.ndarray] = None,
                            shards_per_expert: int = 1,
                            peak_flops: Optional[float] = None) -> Phase:
    """counts: (L, E) tokens routed per (layer, expert).

    Returns a Phase with K = L*E*shards_per_expert tasks and N = L*E
    blocks (expert weights).  ``shards_per_expert`` splits each expert's
    token load into equal sub-tasks that SHARE the expert's weight block:
    with more than one shard the balancer's replication moves can place
    shards of a hot expert on several devices — each holding a weight
    copy — which is exactly the serving-time replicated-expert trade
    (parallelism bought with HBM).  At the default 1 the phase is
    bitwise-identical to the unsharded construction.  A task's load is its
    expert FLOPs over ``peak_flops`` (``None``: the module's
    ``PEAK_FLOPS``).
    """
    l_n, e_n = counts.shape
    s = int(shards_per_expert)
    if s < 1:
        raise ValueError("shards_per_expert must be >= 1")
    d, f = cfg.d_model, cfg.moe_d_ff
    flops_per_token = 6.0 * d * f  # 3 GLU matmuls, fwd
    peak = PEAK_FLOPS if peak_flops is None else peak_flops
    task_load = np.repeat(
        counts.reshape(-1) * flops_per_token / peak / s, s)
    expert_bytes = 3.0 * d * f * 2.0  # bf16 gate/up/down
    bytes_per_token = bytes_per_token or (d * 2.0)

    g_n = l_n * e_n                               # expert-block grid size
    k = g_n * s
    # shard t of expert g is task g*s + t; all shards share block g
    task_block = np.repeat(np.arange(g_n, dtype=np.int64), s)
    block_home = (np.arange(g_n) % e_n) * n_devices // e_n  # initial layout
    # comm edges: consecutive-layer co-activation volume
    comm_src, comm_dst, comm_vol = [], [], []
    total = counts.sum(axis=1, keepdims=True) + 1e-9
    for l in range(l_n - 1):
        p_l = counts[l] / total[l]
        p_n = counts[l + 1] / total[l + 1]
        if coactivation is not None:
            flow = coactivation[l]
        else:  # independence approximation
            flow = np.outer(p_l, p_n) * total[l]
        top = np.argsort(flow.reshape(-1))[::-1][: 4 * e_n]  # sparsify
        for idx in top:
            e_a, e_b = divmod(int(idx), e_n)
            v = flow[e_a, e_b] * bytes_per_token
            if v <= 0:
                continue
            # attach the flow to shard 0 of each endpoint expert (the
            # volume follows the expert, not an individual shard)
            comm_src.append((l * e_n + e_a) * s)
            comm_dst.append(((l + 1) * e_n + e_b) * s)
            comm_vol.append(float(v))

    return Phase(
        task_load=task_load,
        task_mem=np.full(k, 1e4),
        task_overhead=np.zeros(k),
        task_block=task_block,
        block_size=np.full(g_n, expert_bytes),
        block_home=block_home,
        comm_src=np.array(comm_src, np.int64) if comm_src else np.zeros(0, np.int64),
        comm_dst=np.array(comm_dst, np.int64) if comm_dst else np.zeros(0, np.int64),
        comm_vol=np.array(comm_vol) if comm_vol else np.zeros(0),
        rank_mem_base=np.zeros(n_devices),
        rank_mem_cap=np.full(n_devices, hbm_budget_bytes),
        rank_speed=rank_speed,
    )


@dataclasses.dataclass
class ServingPlan:
    """A real replicated-expert placement for the serving engine.

    Derived from the balancer's block residency (``block_count > 0``):
    every device hosting at least one shard of an expert holds a weight
    copy, and the router splits that expert's tokens across the copies
    in proportion to the shard loads the balancer placed there.
    """

    replicas: np.ndarray        # (L, E, D) bool — device holds a copy
    routing_shares: np.ndarray  # (L, E, D) — token share served per copy
                                # (rows sum to 1 for routed-to experts)
    hbm_bytes: np.ndarray       # (D,) expert-weight bytes resident
    hbm_budget_bytes: float     # the per-device budget the plan ran under
    replicated_experts: List[Tuple[int, int]]  # (layer, expert), >1 copy

    def within_budget(self) -> bool:
        return bool((self.hbm_bytes <= self.hbm_budget_bytes).all())


@dataclasses.dataclass
class PlacementPlan:
    assignment: np.ndarray              # (K,) task (expert shard) -> device
    permutations: np.ndarray            # (L, E) slot s on layer l holds
                                        #        original expert perm[l, s]
    imbalance_before: float
    imbalance_after: float
    replicated_blocks: int              # experts materialized on >1 device
    max_work_before: float
    max_work_after: float
    lb_result: object
    serving: Optional[ServingPlan] = None  # the real replica placement


def plan_expert_placement(counts: np.ndarray, cfg: ModelConfig,
                          n_devices: int, *, hbm_budget_bytes: float,
                          params: Optional[CCMParams] = None,
                          rank_speed: Optional[np.ndarray] = None,
                          n_iter: int = 4, fanout: int = 4,
                          seed: int = 0,
                          use_engine: bool = True,
                          device=None,
                          dtype: torch.dtype = torch.float64,
                          batch_lock_events: int = 1,
                          spec_window: int = 1,
                          spec_mode: str = "scan",
                          async_mode: bool = False,
                          latency=0.0,
                          gossip_timeout=None,
                          quiesce_after: Optional[int] = None,
                          replicate: bool = False,
                          shards_per_expert: int = 1
                          ) -> PlacementPlan:
    """Plan an expert placement with CCM-LB.  ``use_engine`` selects the
    vectorized evaluation engine (default; the scalar reference path gives
    identical plans — the knob exists for A/B benchmarking); ``device`` is
    where the engine scores stage 2 (``None``, the default, means
    ``"cuda"`` and raises without a card; ``"cpu"`` runs the plain torch
    scorer) and ``dtype`` its precision (``torch.float64``, bitwise the JAX
    package's ``backend="numpy"``, or ``torch.float32``);
    ``batch_lock_events`` defers and batches disjoint lock events,
    trajectory-exact; ``spec_window`` / ``spec_mode`` route stage 2
    through the speculative driver (core/spec.py, the window kernel on the
    card).  ``async_mode`` plans through the distributed event-loop
    simulator instead (``latency`` / ``gossip_timeout`` as in
    core/async_sim.py; at the default zero latency the plan is identical to
    the synchronous one).  ``quiesce_after`` stops early after that many
    consecutive zero-transfer iterations (core/quiesce.py).

    ``shards_per_expert`` > 1 splits each expert's token load into equal
    sub-tasks sharing the weight block, and ``replicate=True`` lets the
    balancer materialize a hot expert's shards on several devices (the
    memory-pressure move vocabulary, core/transfer.py) — the resulting
    copies and per-copy routing shares land in ``PlacementPlan.serving``."""
    l_n, e_n = counts.shape
    assert e_n % n_devices == 0
    phase = phase_from_router_stats(counts, cfg, n_devices,
                                    hbm_budget_bytes=hbm_budget_bytes,
                                    rank_speed=rank_speed,
                                    shards_per_expert=shards_per_expert)
    ccm = params or CCMParams(alpha=1.0, beta=2e-11, gamma=1e-13, delta=1e-12)
    # shards start at their expert's device
    a0 = np.repeat(phase.block_home, shards_per_expert).copy()
    res = run_ccm_lb(phase, a0, ccm, n_iter=n_iter, fanout=fanout, seed=seed,
                     use_engine=use_engine, device=device, dtype=dtype,
                     batch_lock_events=batch_lock_events,
                     spec_window=spec_window, spec_mode=spec_mode,
                     async_mode=async_mode, latency=latency,
                     gossip_timeout=gossip_timeout,
                     quiesce_after=quiesce_after, replicate=replicate)
    return _project_plan(counts, res, n_devices,
                         hbm_budget_bytes=hbm_budget_bytes)


def _serving_plan(res, l_n: int, e_n: int, n_devices: int,
                  hbm_budget_bytes: float) -> ServingPlan:
    """Turn block residency into the real serving placement: replicas
    from ``block_count > 0``, routing shares from the per-device shard
    loads, and a per-device HBM audit of the resident weight bytes."""
    st = res.state
    ph = st.phase
    g_n = l_n * e_n
    s = ph.num_tasks // g_n
    present = (st.block_count > 0)                      # (D, g_n)
    replicas = present.T.reshape(l_n, e_n, n_devices)
    # per-(expert, device) placed shard load -> routing shares
    placed = np.zeros((g_n, n_devices))
    np.add.at(placed, (np.arange(ph.num_tasks) // s, res.assignment),
              ph.task_load)
    tot = placed.sum(axis=1, keepdims=True)
    shares = np.divide(placed, tot, out=np.zeros_like(placed),
                       where=tot > 0)
    hbm = (present * ph.block_size[None, :]).sum(axis=1)
    multi = np.nonzero(present.sum(axis=0) > 1)[0]
    return ServingPlan(
        replicas=replicas,
        routing_shares=shares.reshape(l_n, e_n, n_devices),
        hbm_bytes=hbm,
        hbm_budget_bytes=float(hbm_budget_bytes),
        replicated_experts=[(int(g) // e_n, int(g) % e_n) for g in multi],
    )


def _project_plan(counts: np.ndarray, res, n_devices: int, *,
                  hbm_budget_bytes: Optional[float] = None) -> PlacementPlan:
    """Project a CCM-LB result onto per-layer slot permutations: on each
    layer, device dev gets the experts assigned to it (top e_loc by load if
    the plan overflows a device; spill handling keeps it a permutation).

    With sharded experts the permutation (the training path — one slot
    per expert) uses each expert's PRIMARY device, the one holding its
    heaviest shard; the full replica set goes to ``PlacementPlan.
    serving`` for the serving engine.  At one shard per expert the
    primary device is the task's device, matching the unsharded
    projection exactly."""
    l_n, e_n = counts.shape
    e_loc = e_n // n_devices
    perms = np.zeros((l_n, e_n), np.int64)
    ph = res.state.phase
    g_n = l_n * e_n
    s = ph.num_tasks // g_n
    heavy = np.argmax(ph.task_load.reshape(g_n, s), axis=1)
    primary = res.assignment[np.arange(g_n) * s + heavy]
    assign = primary.reshape(l_n, e_n)
    for l in range(l_n):
        buckets: List[List[int]] = [[] for _ in range(n_devices)]
        for e in range(e_n):
            buckets[int(assign[l, e])].append(e)
        # spill: move lightest experts out of overfull buckets
        loads = counts[l]
        overflow: List[int] = []
        for devb in buckets:
            devb.sort(key=lambda e: -loads[e])
            while len(devb) > e_loc:
                overflow.append(devb.pop())
        for devb in buckets:
            while len(devb) < e_loc and overflow:
                devb.append(overflow.pop(0))
        perm = [e for devb in buckets for e in devb]
        perms[l] = np.array(perm, np.int64)
    # replication realized by the plan: blocks present on >1 rank
    replicated = int(((res.state.block_count > 0).sum(axis=0) > 1).sum())

    budget = (float(ph.rank_mem_cap.max()) if hbm_budget_bytes is None
              else hbm_budget_bytes)
    return PlacementPlan(
        assignment=res.assignment,
        permutations=perms,
        imbalance_before=float(res.imbalance[0]),
        imbalance_after=res.state.imbalance(),
        replicated_blocks=replicated,
        max_work_before=float(res.max_work[0]),
        max_work_after=res.state.max_work(),
        lb_result=res,
        serving=_serving_plan(res, l_n, e_n, n_devices, budget),
    )


def plan_expert_placement_sequence(
        counts_seq: Sequence[np.ndarray], cfg: ModelConfig, n_devices: int, *,
        hbm_budget_bytes: float, params: Optional[CCMParams] = None,
        rank_speed: Optional[np.ndarray] = None, n_iter: int = 4,
        fanout: int = 4, seed: int = 0, warm_start: bool = True,
        use_engine: bool = True, device=None,
        dtype: torch.dtype = torch.float64,
        batch_lock_events: int = 1, spec_window: int = 1,
        spec_mode: str = "scan",
        quiesce_after: Optional[int] = None,
        replicate: bool = False,
        shards_per_expert: int = 1) -> List[PlacementPlan]:
    """Plan placements for a SEQUENCE of router-stat windows (paper §III-B
    iterative executions): each window's phase shares the (layer, expert)
    task/block grid, so phase ``k+1`` warm-starts from phase ``k``'s
    placement via :func:`repro_torch.core.ccm_lb_pipeline`.  On slowly
    drifting routing distributions the balancer then only repairs the
    drift — a fraction of the transfers (and wall-clock) of replanning each
    window from scratch (``warm_start=False``, the cold reference).

    Comm edges are re-derived per window (they follow the routing flows),
    so only the warm start amortizes here — CSR reuse kicks in when
    consecutive windows produce identical sparsified flow graphs.
    ``device`` / ``dtype`` as in :func:`plan_expert_placement`.
    """
    counts_seq = [np.asarray(c, np.float64) for c in counts_seq]
    if not counts_seq:
        return []
    l_n, e_n = counts_seq[0].shape
    assert e_n % n_devices == 0
    phases = [phase_from_router_stats(c, cfg, n_devices,
                                      hbm_budget_bytes=hbm_budget_bytes,
                                      rank_speed=rank_speed,
                                      shards_per_expert=shards_per_expert)
              for c in counts_seq]
    ccm = params or CCMParams(alpha=1.0, beta=2e-11, gamma=1e-13, delta=1e-12)
    a0 = np.repeat(phases[0].block_home, shards_per_expert).copy()
    pipe = ccm_lb_pipeline(phases, ccm, warm_start=warm_start,
                           a0=a0, seed=seed,
                           n_iter=n_iter, fanout=fanout,
                           use_engine=use_engine, device=device, dtype=dtype,
                           batch_lock_events=batch_lock_events,
                           spec_window=spec_window, spec_mode=spec_mode,
                           quiesce_after=quiesce_after, replicate=replicate)
    return [_project_plan(c, run.result, n_devices,
                          hbm_budget_bytes=hbm_budget_bytes)
            for c, run in zip(counts_seq, pipe.runs)]


def apply_expert_permutation(moe_params: Dict[str, torch.Tensor],
                             perm) -> Dict[str, torch.Tensor]:
    """Function-preserving slot permutation of one MoE layer's params.

    perm[s] = original expert now living in slot s (a sequence, numpy array
    or tensor; taken as a long tensor on the params' device).  Router output
    columns are permuted identically, so routing decisions follow the
    weights.  Other entries (the shared expert) are kept as they are.
    """
    perm = torch.as_tensor(perm, dtype=torch.long,
                           device=moe_params["w_gate"].device)
    out = dict(moe_params)
    out["w_gate"] = moe_params["w_gate"][perm]
    out["w_up"] = moe_params["w_up"][perm]
    out["w_down"] = moe_params["w_down"][perm]
    out["router"] = moe_params["router"][:, perm]
    return out


def all_to_all_bytes(counts: np.ndarray, assignment: np.ndarray,
                     n_devices: int, d_model: int,
                     bytes_per_el: float = 2.0) -> float:
    """Dispatch volume crossing the network under a placement: tokens
    originate uniformly across devices; a token reaching expert (l, e) on
    device dev crosses iff its source != dev (fraction 1 - 1/n)."""
    loads = counts.reshape(-1)
    cross = loads * (1.0 - 1.0 / n_devices)
    return float(cross.sum() * d_model * bytes_per_el)
