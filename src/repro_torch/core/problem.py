"""Phase/task-graph representation for the CCM model (paper §III-A).

The port's own copy of ``repro/core/problem.py``: the same dataclasses and
the same ``np.random.default_rng`` streams, so ``random_phase`` /
``scaling_phase`` / ``initial_assignment`` are field-equal to the JAX
package's.  A *phase* is a set of tasks between two synchronization points,
plus their communications and shared memory blocks, stored as flat numpy
arrays on the host (the balancer's control flow is host code).

Conventions (paper):
  - each task is assigned to exactly one rank (``assignment``);
  - each task accesses at most ONE shared block (``task_block``, -1 if none);
  - each block is homed at exactly one rank (``block_home``); homes and
    block-task membership are parameters the balancer may NOT change;
  - communications are directed task->task edges with a byte volume.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Phase:
    # --- tasks ---------------------------------------------------------------
    task_load: np.ndarray        # (K,) float, seconds — L(t)
    task_mem: np.ndarray         # (K,) float, bytes — M-(t) baseline
    task_overhead: np.ndarray    # (K,) float, bytes — M+(t) working overhead
    task_block: np.ndarray       # (K,) int, block id or -1
    # --- blocks --------------------------------------------------------------
    block_size: np.ndarray       # (N,) float, bytes — M(s)
    block_home: np.ndarray       # (N,) int, home rank
    # --- communications ------------------------------------------------------
    comm_src: np.ndarray         # (M,) int task id
    comm_dst: np.ndarray         # (M,) int task id
    comm_vol: np.ndarray         # (M,) float bytes
    # --- ranks ---------------------------------------------------------------
    rank_mem_base: np.ndarray    # (I,) float bytes — M-(r)
    rank_mem_cap: np.ndarray     # (I,) float bytes — M∞(r) per-rank bound (9)
    rank_speed: Optional[np.ndarray] = None  # (I,) relative speed (straggler
                                             # mitigation: load/speed)

    def __post_init__(self):
        self.task_load = np.asarray(self.task_load, np.float64)
        self.task_mem = np.asarray(self.task_mem, np.float64)
        self.task_overhead = np.asarray(self.task_overhead, np.float64)
        self.task_block = np.asarray(self.task_block, np.int64)
        self.block_size = np.asarray(self.block_size, np.float64)
        self.block_home = np.asarray(self.block_home, np.int64)
        self.comm_src = np.asarray(self.comm_src, np.int64)
        self.comm_dst = np.asarray(self.comm_dst, np.int64)
        self.comm_vol = np.asarray(self.comm_vol, np.float64)
        self.rank_mem_base = np.asarray(self.rank_mem_base, np.float64)
        self.rank_mem_cap = np.asarray(self.rank_mem_cap, np.float64)
        if self.rank_speed is None:
            self.rank_speed = np.ones(self.num_ranks, np.float64)
        else:
            self.rank_speed = np.asarray(self.rank_speed, np.float64)

    # ------------------------------------------------------------------ sizes
    @property
    def num_tasks(self) -> int:
        return int(self.task_load.shape[0])

    @property
    def num_blocks(self) -> int:
        return int(self.block_size.shape[0])

    @property
    def num_comms(self) -> int:
        return int(self.comm_vol.shape[0])

    @property
    def num_ranks(self) -> int:
        return int(self.rank_mem_base.shape[0])

    def validate(self):
        k, n, i = self.num_tasks, self.num_blocks, self.num_ranks
        assert self.task_block.max(initial=-1) < n
        assert self.task_block.min(initial=0) >= -1
        assert (0 <= self.block_home).all() and (self.block_home < i).all()
        assert (0 <= self.comm_src).all() and (self.comm_src < k).all()
        assert (0 <= self.comm_dst).all() and (self.comm_dst < k).all()
        assert (self.task_load >= 0).all() and (self.comm_vol >= 0).all()


@dataclasses.dataclass(frozen=True)
class CCMParams:
    """Coefficients of the work model (13)."""

    alpha: float = 1.0    # include compute load (Z2 in the paper)
    beta: float = 1e-9    # s/B off-rank communication
    gamma: float = 1e-11  # s/B on-rank communication
    delta: float = 1e-9   # s/B homing cost
    memory_constraint: bool = True  # epsilon in {0, +inf}
    # pressure policy: fraction of rank_mem_cap held back as headroom.
    # Every feasibility comparison (scalar, engine, compiled scorer) tests
    # against cap*(1-mem_headroom) — see repro_torch.core.ccm.effective_mem_cap —
    # so a rank drifting into the headroom band gets the eq. 9 barrier
    # (work = inf) and the stage-2 optimizer trades migration against
    # de-replication to restore feasibility.  0.0 (default) is bitwise
    # the legacy behavior.
    mem_headroom: float = 0.0


def same_topology(a: Phase, b: Phase) -> bool:
    """True iff the two phases share the adjacency structure a
    :class:`PhaseCSR` encodes — same task/block counts, same comm edge
    endpoints, same task->block map.  Loads, volumes, memory sizes and rank
    parameters may differ freely (none of them enter the CSR).  Both the
    pipeline's CSR sharing and ``CCMState.retarget`` engine carry-over are
    gated on this predicate."""
    if a is b:
        return True
    if (a.num_tasks != b.num_tasks or a.num_blocks != b.num_blocks
            or a.num_comms != b.num_comms):
        return False
    return (np.array_equal(a.comm_src, b.comm_src)
            and np.array_equal(a.comm_dst, b.comm_dst)
            and np.array_equal(a.task_block, b.task_block))


def random_phase(key: int, *, num_ranks: int, num_tasks: int, num_blocks: int,
                 num_comms: int, mem_cap: float = 1e9,
                 load_imbalance: float = 2.0) -> Phase:
    """Synthetic phase generator for tests/benchmarks.

    Task loads are log-normal (heavy-tailed, like Gemma's near-singular
    tiles); blocks get contiguous task groups (slab-like); comms connect
    random task pairs.
    """
    rng = np.random.default_rng(key)
    load = rng.lognormal(mean=0.0, sigma=load_imbalance * 0.5, size=num_tasks)
    task_mem = rng.uniform(1e4, 1e6, size=num_tasks)
    overhead = rng.uniform(1e4, 5e5, size=num_tasks)
    # contiguous groups of tasks share a block; some tasks have none
    task_block = np.full(num_tasks, -1, np.int64)
    if num_blocks > 0:
        groups = np.array_split(rng.permutation(num_tasks), num_blocks)
        for b, g in enumerate(groups):
            take = g[: max(1, int(len(g) * 0.9))]
            task_block[take] = b
    block_size = rng.uniform(1e6, 5e7, size=num_blocks)
    block_home = rng.integers(0, num_ranks, size=num_blocks)
    src = rng.integers(0, num_tasks, size=num_comms)
    dst = rng.integers(0, num_tasks, size=num_comms)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    vol = rng.lognormal(10.0, 1.0, size=src.shape[0])
    phase = Phase(
        task_load=load,
        task_mem=task_mem,
        task_overhead=overhead,
        task_block=task_block,
        block_size=block_size,
        block_home=block_home,
        comm_src=src,
        comm_dst=dst,
        comm_vol=vol,
        rank_mem_base=rng.uniform(1e6, 2e6, size=num_ranks),
        rank_mem_cap=np.full(num_ranks, mem_cap),
    )
    phase.validate()
    return phase


def scaling_phase(ranks: int) -> Phase:
    """The ``ccmlb_scaling`` instance family of the JAX package (25 tasks,
    3 blocks and 50 comm edges per rank, uncapped memory); the port's
    parity bars and its smoke run are defined on these instances."""
    return random_phase(1, num_ranks=ranks, num_tasks=25 * ranks,
                        num_blocks=3 * ranks, num_comms=50 * ranks,
                        mem_cap=1e12)


def initial_assignment(phase: Phase, mode: str = "home") -> np.ndarray:
    """Paper default: tasks start co-located with their block's home rank."""
    k = phase.num_tasks
    if mode == "home":
        if phase.num_blocks == 0:   # blockless phase: nothing is homed
            return (np.arange(k) % phase.num_ranks).astype(np.int64)
        a = np.where(phase.task_block >= 0,
                     phase.block_home[np.clip(phase.task_block, 0, None)],
                     np.arange(k) % phase.num_ranks)
        return a.astype(np.int64)
    if mode == "round_robin":
        return (np.arange(k) % phase.num_ranks).astype(np.int64)
    raise ValueError(mode)
