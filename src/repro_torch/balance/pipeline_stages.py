"""Layer -> pipeline-stage assignment via CCM (third framework application).

Mapping: layers are CCM tasks (per-layer flop cost — heterogeneous for
hybrid archs: an rglru block != a local-attn block != a MoE block); the
activation tensor flowing layer_i -> layer_{i+1} is a comm edge (crossing a
stage boundary = a send over the pipeline link); layer weights+optimizer
state are the memory load against each stage's HBM.  CCM-LB's beta term then
does the interesting work: non-contiguous stage assignments pay the
activation transfer repeatedly, so minimizing W induces contiguous,
cost-balanced stages — partitioning heterogeneous stacks without a bespoke
DP algorithm.

The port's copy of the JAX package's ``balance/pipeline_stages.py``: host
numpy, the engine's stage 2 scored on ``device``.  A layer's time is its
FLOPs over ``PEAK_FLOPS``, the H100's dense bf16 peak, read when a phase is
built, and a stage's memory budget defaults to the H100's 80 GB; the
reference's figures are for another chip, and its parity tests set them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import (BLOCK_MOE, BLOCK_REC, BLOCK_RWKV,
                                      ModelConfig)
from repro_torch.core import CCMParams, ccm_lb_pipeline, run_ccm_lb
from repro_torch.core.problem import Phase

# the H100 SXM's dense bf16 tensor-core peak (FLOP/s) and its HBM3 (bytes)
PEAK_FLOPS = 989e12
H100_HBM_BYTES = 80e9


def layer_flops(cfg: ModelConfig, kind: str, tokens: int) -> float:
    """Per-layer forward FLOPs for one microbatch of ``tokens`` tokens."""
    d, hd = cfg.d_model, cfg.head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    attn_proj = 2 * tokens * d * (h * hd + 2 * hkv * hd + h * hd)
    if kind == BLOCK_REC:
        return 2 * tokens * (5 * d * d) + 6 * tokens * d * cfg.d_ff
    if kind == BLOCK_RWKV:
        return 2 * tokens * (5 * d * d) + 6 * tokens * d * cfg.d_ff
    if kind == BLOCK_MOE:
        moe = 6 * tokens * cfg.top_k * d * cfg.moe_d_ff
        shared = 6 * tokens * d * cfg.d_ff * cfg.num_shared_experts
        return attn_proj + moe + shared
    ffn = 6 * tokens * d * cfg.d_ff
    return attn_proj + ffn


def layer_param_bytes(cfg: ModelConfig, kind: str) -> float:
    d = cfg.d_model
    attn = 2 * d * (cfg.num_heads * cfg.head_dim * 2
                    + 2 * cfg.num_kv_heads * cfg.head_dim)
    if kind == BLOCK_MOE:
        return attn + 2 * (cfg.num_experts * 3 * d * cfg.moe_d_ff
                           + cfg.num_shared_experts * 3 * d * cfg.d_ff)
    if kind in (BLOCK_REC, BLOCK_RWKV):
        return 2 * (5 * d * d + 3 * d * cfg.d_ff)
    return attn + 2 * 3 * d * cfg.d_ff


@dataclasses.dataclass
class StagePlan:
    assignment: np.ndarray        # (L,) layer -> stage
    stage_flops: np.ndarray       # (S,)
    imbalance: float
    cut_bytes: float              # activation bytes crossing stage edges
    contiguous: bool


def _stage_phase(cfg: ModelConfig, n_stages: int, tokens: int,
                 hbm_budget_bytes: float,
                 peak_flops: Optional[float] = None) -> Phase:
    """Layers-as-tasks phase for one microbatch size.  The chain topology
    (comm endpoints, no blocks) is independent of ``tokens``, so phases for
    different microbatch sizes share one PhaseCSR (pipeline amortization).
    A layer's load is its FLOPs over ``peak_flops`` (``None``: the module's
    ``PEAK_FLOPS``)."""
    kinds = cfg.layer_kinds()
    l_n = len(kinds)
    peak = PEAK_FLOPS if peak_flops is None else peak_flops
    loads = np.array([layer_flops(cfg, k, tokens) for k in kinds]) / peak
    act_bytes = float(tokens * cfg.d_model * 2)
    return Phase(
        task_load=loads,
        task_mem=np.array([layer_param_bytes(cfg, k) for k in kinds]),
        task_overhead=np.zeros(l_n),
        task_block=np.full(l_n, -1, np.int64),
        block_size=np.zeros(0),
        block_home=np.zeros(0, np.int64),
        comm_src=np.arange(l_n - 1, dtype=np.int64),
        comm_dst=np.arange(1, l_n, dtype=np.int64),
        comm_vol=np.full(l_n - 1, act_bytes),
        rank_mem_base=np.zeros(n_stages),
        rank_mem_cap=np.full(n_stages, hbm_budget_bytes),
    )


def _stage_params(phase: Phase) -> CCMParams:
    # beta chosen so one extra stage crossing costs ~ one layer's time:
    # beta * act_bytes ~ median layer time
    beta = float(np.median(phase.task_load) / phase.comm_vol[0]) \
        if phase.num_comms else 0.0
    return CCMParams(alpha=1.0, beta=beta, gamma=0.0, delta=0.0,
                     memory_constraint=True)


def _stage_plan(phase: Phase, res, n_stages: int) -> StagePlan:
    assign = res.assignment
    loads = phase.task_load
    stage_flops = np.bincount(assign, weights=loads, minlength=n_stages)
    crossings = assign[phase.comm_src] != assign[phase.comm_dst]
    contiguous = (bool(np.all(np.diff(assign) >= 0))
                  and crossings.sum() == n_stages - 1)
    mu = stage_flops.mean()
    return StagePlan(
        assignment=assign,
        stage_flops=stage_flops,
        imbalance=float(stage_flops.max() / mu - 1) if mu > 0 else 0.0,
        cut_bytes=float(phase.comm_vol[crossings].sum()),
        contiguous=contiguous,
    )


def plan_pipeline_stages(cfg: ModelConfig, n_stages: int, *,
                         tokens_per_microbatch: int = 4096,
                         hbm_budget_bytes: float = H100_HBM_BYTES,
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
                         quiesce_after: Optional[int] = None) -> StagePlan:
    """``device`` is where the engine scores stage 2: ``None`` (default)
    means ``"cuda"`` and raises without a card, ``"cpu"`` runs the plain
    torch scorer; ``dtype`` ``torch.float64`` (bitwise the JAX package's
    ``backend="numpy"``) or ``torch.float32``.  ``batch_lock_events``
    defers and batches disjoint lock events, trajectory-exact;
    ``spec_window`` / ``spec_mode`` route stage 2 through the speculative
    driver (core/spec.py).  ``async_mode`` plans through the distributed
    event-loop simulator (``latency`` / ``gossip_timeout`` per
    core/async_sim.py; zero latency plans identically to the synchronous
    driver).  ``quiesce_after`` stops early after that many consecutive
    zero-transfer iterations (core/quiesce.py).  With ``alpha=1`` and beta
    derived from the loads every work term scales with ``1 / PEAK_FLOPS``,
    so the plan does not depend on the peak; only ``stage_flops``'s unit
    does."""
    phase = _stage_phase(cfg, n_stages, tokens_per_microbatch,
                         hbm_budget_bytes)
    l_n = phase.num_tasks
    # initial: contiguous equal-count split
    a0 = np.minimum((np.arange(l_n) * n_stages) // l_n, n_stages - 1)
    res = run_ccm_lb(phase, a0, _stage_params(phase), n_iter=4,
                     fanout=min(4, n_stages - 1), seed=seed,
                     use_engine=use_engine, device=device, dtype=dtype,
                     batch_lock_events=batch_lock_events,
                     spec_window=spec_window, spec_mode=spec_mode,
                     async_mode=async_mode, latency=latency,
                     gossip_timeout=gossip_timeout,
                     quiesce_after=quiesce_after)
    return _stage_plan(phase, res, n_stages)


def plan_pipeline_stages_schedule(
        cfg: ModelConfig, n_stages: int,
        tokens_schedule: Sequence[int], *,
        hbm_budget_bytes: float = H100_HBM_BYTES, seed: int = 0,
        warm_start: bool = True, use_engine: bool = True,
        device=None, dtype: torch.dtype = torch.float64,
        batch_lock_events: int = 1, spec_window: int = 1,
        spec_mode: str = "scan",
        quiesce_after: Optional[int] = None) -> List[StagePlan]:
    """Re-plan the stage split as the microbatch size changes (sequence-
    length curriculum, serving traffic shifts): one CCM phase per entry of
    ``tokens_schedule``, run through :func:`ccm_lb_pipeline` so step ``k+1``
    starts from step ``k``'s split and — the chain topology being
    token-independent — every step after the first reuses the PhaseCSR.
    Work-model coefficients are re-derived per step (beta tracks the
    activation size).  ``device`` / ``dtype`` as in
    :func:`plan_pipeline_stages`."""
    if not tokens_schedule:
        return []
    phases = [_stage_phase(cfg, n_stages, int(t), hbm_budget_bytes)
              for t in tokens_schedule]
    l_n = phases[0].num_tasks
    a0 = np.minimum((np.arange(l_n) * n_stages) // l_n, n_stages - 1)
    pipe = ccm_lb_pipeline(phases, [_stage_params(p) for p in phases],
                           warm_start=warm_start, a0=a0, seed=seed,
                           n_iter=4, fanout=min(4, n_stages - 1),
                           use_engine=use_engine, device=device, dtype=dtype,
                           batch_lock_events=batch_lock_events,
                           spec_window=spec_window, spec_mode=spec_mode,
                           quiesce_after=quiesce_after)
    return [_stage_plan(phase, run.result, n_stages)
            for phase, run in zip(phases, pipe.runs)]
