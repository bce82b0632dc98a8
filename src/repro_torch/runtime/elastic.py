"""The balancer side of elastic scaling: the rank-renumbering frame for
shrinking a balancer onto its survivor set, and the join/expand frame for
growing it.

The port's copy of the pure-numpy part of ``repro/runtime/elastic.py``.
:func:`survivor_resize` is what the async fault harness
(core/async_sim.py) uses when ranks die mid-run: the survivor set is
renumbered contiguously so the CCM-LB problem can be restated at the
smaller rank count and warm-started via
``repro_torch.core.pipeline.warm_start_assignment``.
:func:`expand_phase` / :class:`RankJoin` are the join/expand
counterpart: fresh ranks appended to a phase's rank set mid-stream (a pod
joins), defaulting to the median capacity/speed of the existing ranks so
a join never manufactures an outlier.  :func:`resume_on_mesh` restores a
trainer's checkpoint onto a device (one card holds the model, so the
device takes the mesh's place); its imports are deferred so that the
async simulator imports this module without the model stack.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import numpy as np

from repro_torch.core.problem import Phase


def resume_on_mesh(cfg, device, ckpt_dir, with_opt: bool = True) -> Tuple:
    """Returns (model, params, opt_state_or_None, step) on ``device``, from
    the latest checkpoint in ``ckpt_dir``: ``(params, opt_state)`` as
    ``launch.train`` saves it, or params alone when ``with_opt`` is false.
    ``opt_state`` is ``AdamW.state_leaves``' list (``load_state_leaves``
    takes it).  The model is ``build_model``'s (bf16 weights, as the
    trainer's); a checkpoint of another structure or dtype raises."""
    import torch

    from repro_torch.checkpoint import CheckpointManager, tree_leaves
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import init_lm

    model = build_model(cfg, device=device)
    params_like = init_lm(None, cfg, dtype=model.dtype, device="meta")
    mgr = CheckpointManager(ckpt_dir)
    if with_opt:
        leaves = tree_leaves(params_like)
        opt_like = ([torch.zeros((), dtype=torch.int32, device="meta")]
                    + [torch.empty(t.shape, dtype=torch.float32,
                                   device="meta") for t in leaves] * 2)
        (params, opt_state), step = mgr.restore((params_like, opt_like),
                                                model.device)
        return model, params, opt_state, step
    params, step = mgr.restore(params_like, model.device)
    return model, params, None, step


@dataclasses.dataclass(frozen=True)
class SurvivorResize:
    """Contiguous renumbering of a rank set after deaths.

    ``survivors[j]`` is the ORIGINAL id of new rank ``j`` (sorted
    ascending, so relative order is preserved); ``old_to_new[r]`` maps an
    original id to its new id, with dead ranks mapped to ``n_new`` — one
    PAST the last valid new rank, so ``old_to_new[assignment]`` feeds
    straight into ``warm_start_assignment``'s out-of-range clipping
    (``prev < next.num_ranks``): tasks stranded on dead ranks are exactly
    the ones that fall back to the fresh initial placement.
    """

    survivors: np.ndarray     # (n_new,) original ids of the live ranks
    old_to_new: np.ndarray    # (n_old,) original id -> new id (dead -> n_new)

    @property
    def n_new(self) -> int:
        return int(self.survivors.size)


def survivor_resize(n_ranks: int, dead: Iterable[int]) -> SurvivorResize:
    """Build the renumbering frame for ``n_ranks`` minus the ``dead`` set."""
    dead = set(int(d) for d in dead)
    if not all(0 <= d < n_ranks for d in dead):
        raise ValueError(f"dead ranks out of range [0, {n_ranks})")
    survivors = np.array([r for r in range(n_ranks) if r not in dead],
                         np.int64)
    if survivors.size == 0:
        raise ValueError("no survivors to resize onto")
    old_to_new = np.full(n_ranks, survivors.size, np.int64)
    old_to_new[survivors] = np.arange(survivors.size, dtype=np.int64)
    return SurvivorResize(survivors, old_to_new)


@dataclasses.dataclass(frozen=True)
class RankJoin:
    """A membership event: ``count`` fresh ranks join before iteration
    ``iteration`` of a balancing run (async driver) or before phase
    ``iteration`` of a pipeline (``ccm_lb_pipeline(membership=...)``).

    ``mem_base`` / ``mem_cap`` / ``speed`` override the new ranks' rows;
    left ``None`` they default to the median of the phase they join
    (:func:`expand_phase`).  Joined ranks take the next ids past the
    current rank count, start empty, participate in gossip from their
    first iteration — inheriting peer state through the ordinary epidemic
    flood — and attract transfers like any underloaded rank: the
    rebalance IS the protocol, no side channel.
    """

    iteration: int
    count: int = 1
    mem_base: Optional[float] = None
    mem_cap: Optional[float] = None
    speed: Optional[float] = None

    def __post_init__(self):
        if self.iteration < 0:
            raise ValueError("RankJoin.iteration must be >= 0")
        if self.count < 1:
            raise ValueError("RankJoin.count must be >= 1")


def expand_phase(phase: Phase, count: int = 1, *,
                 mem_base: Optional[float] = None,
                 mem_cap: Optional[float] = None,
                 speed: Optional[float] = None) -> Phase:
    """Append ``count`` fresh ranks to a phase's rank set (the join/expand
    counterpart of :func:`survivor_resize`).

    Only the rank-indexed arrays grow; the task/block/comm structure is
    shared by object, so ``same_topology(phase, expanded)`` holds and a
    prebuilt :class:`~repro_torch.core.csr.PhaseCSR` (task/block adjacency —
    rank-independent by construction) stays valid.  Unspecified
    capacities/speeds default to the median of the existing ranks.
    """
    if count < 1:
        raise ValueError("expand_phase needs count >= 1")
    mb = float(np.median(phase.rank_mem_base)) if mem_base is None \
        else float(mem_base)
    mc = float(np.median(phase.rank_mem_cap)) if mem_cap is None \
        else float(mem_cap)
    new_mb = np.concatenate([phase.rank_mem_base, np.full(count, mb)])
    new_mc = np.concatenate([phase.rank_mem_cap, np.full(count, mc)])
    sp = float(np.median(phase.rank_speed)) if speed is None \
        else float(speed)
    new_speed = np.concatenate([phase.rank_speed, np.full(count, sp)])
    return Phase(
        task_load=phase.task_load, task_mem=phase.task_mem,
        task_overhead=phase.task_overhead, task_block=phase.task_block,
        block_size=phase.block_size, block_home=phase.block_home,
        comm_src=phase.comm_src, comm_dst=phase.comm_dst,
        comm_vol=phase.comm_vol,
        rank_mem_base=new_mb, rank_mem_cap=new_mc, rank_speed=new_speed)
