"""Overdecomposition of the matrix assembly into shared blocks and tasks
(paper §VI-B).

The solver prescribes a row-block per rank.  Each rank's block is split into
*slabs* of contiguous memory (all of the rank's rows x a column chunk) — the
CCM shared blocks, homed at the owning rank.  Work is overdecomposed by
limiting each task to at most ``u`` rows x ``u`` columns of a slab; separate
tasks handle different element-type pairs; tasks whose DOF pair produces no
coupling (zero blocks) are never instantiated.

The port's own copy of ``repro/assembly/problem.py`` (host numpy): the same
tasks, features and phase as the JAX package's, field for field.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.assembly.geometry import Geometry, make_cavity_geometry
from repro_torch.core.problem import Phase


@dataclasses.dataclass
class AssemblyTask:
    task_id: int
    slab: int               # shared block id
    home_rank: int
    rows: np.ndarray        # global DOF ids
    cols: np.ndarray
    elem_pair: int          # 0 tri-tri, 1 tri-bar / bar-tri, 2 bar-bar
    quad_order: int         # near-singular refinement level
    n_interactions: int

    def features(self, geom: Geometry) -> np.ndarray:
        """Inputs to the cost-model FNN (paper §VI-D: element types etc.)."""
        pr = geom.points[self.rows]
        pc = geom.points[self.cols]
        d_min = _min_dist(pr, pc)
        return np.array([
            len(self.rows), len(self.cols), self.n_interactions,
            float(self.elem_pair == 0), float(self.elem_pair == 1),
            float(self.elem_pair == 2), self.quad_order, d_min,
        ], np.float64)


FEATURE_NAMES = ("n_rows", "n_cols", "n_interactions", "is_tri_tri",
                 "is_tri_bar", "is_bar_bar", "quad_order", "min_dist")


def _min_dist(a: np.ndarray, b: np.ndarray) -> float:
    d = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1))
    return float(d.min()) if d.size else np.inf


def _quad_order(d_min: float) -> int:
    """Near-singular refinement: closer DOF sets need deeper quadrature.

    The steep ladder is what produces the paper's heavy-tailed task costs
    (singular Green's function for nearby DOFs, §VI-A)."""
    if d_min < 0.005:
        return 192
    if d_min < 0.05:
        return 64
    if d_min < 0.2:
        return 16
    return 4


@dataclasses.dataclass
class AssemblyProblem:
    geom: Geometry
    num_ranks: int
    rank_rows: List[np.ndarray]      # rows owned per rank (solver layout)
    slab_cols: List[np.ndarray]      # columns per slab
    slab_home: np.ndarray            # (n_slabs,)
    slab_bytes: np.ndarray           # (n_slabs,)
    tasks: List[AssemblyTask]

    @property
    def num_tasks(self) -> int:
        return len(self.tasks)

    def features(self) -> np.ndarray:
        return np.stack([t.features(self.geom) for t in self.tasks])

    def to_phase(self, durations: np.ndarray, *, mem_cap_bytes: float,
                 comm_byte: float = 8.0,
                 rank_speed: Optional[np.ndarray] = None) -> Phase:
        """Build the CCM phase: tasks with (predicted or measured) durations,
        slabs as shared blocks, and update-communication edges from tasks to
        the consumer of their slab (commutative += into the shared block)."""
        k = self.num_tasks
        task_block = np.array([t.slab for t in self.tasks], np.int64)
        # tasks contribute 'u x u' partial sums that must reach the slab —
        # modeled as a comm edge between tasks of the same slab (assembled
        # reduction), sized by the tile bytes.
        comm_src, comm_dst, comm_vol = [], [], []
        by_slab: dict = {}
        for t in self.tasks:
            by_slab.setdefault(t.slab, []).append(t.task_id)
        for slab, members in by_slab.items():
            anchor = members[0]
            for m in members[1:]:
                comm_src.append(m)
                comm_dst.append(anchor)
                tm = self.tasks[m]
                comm_vol.append(len(tm.rows) * len(tm.cols) * comm_byte)
        return Phase(
            task_load=durations,
            task_mem=np.array([len(t.rows) * len(t.cols) * comm_byte
                               for t in self.tasks]),
            task_overhead=np.full(k, 1e5),
            task_block=task_block,
            block_size=self.slab_bytes,
            block_home=self.slab_home,
            comm_src=np.array(comm_src, np.int64) if comm_src else np.zeros(0, np.int64),
            comm_dst=np.array(comm_dst, np.int64) if comm_dst else np.zeros(0, np.int64),
            comm_vol=np.array(comm_vol) if comm_vol else np.zeros(0),
            rank_mem_base=np.full(self.num_ranks, 1e6),
            rank_mem_cap=np.full(self.num_ranks, mem_cap_bytes),
            rank_speed=rank_speed,
        )


def build_problem(n_unknowns: int, num_ranks: int, *, task_limit_u: int = 96,
                  slabs_per_rank: int = 4, seed: int = 0,
                  entry_bytes: float = 8.0) -> AssemblyProblem:
    geom = make_cavity_geometry(n_unknowns, seed=seed)
    rank_rows = [np.array(r, np.int64)
                 for r in np.array_split(np.arange(n_unknowns), num_ranks)]

    slab_cols: List[np.ndarray] = []
    slab_home: List[int] = []
    slab_bytes: List[float] = []
    tasks: List[AssemblyTask] = []

    for r in range(num_ranks):
        rows = rank_rows[r]
        for cols in np.array_split(np.arange(n_unknowns), slabs_per_rank):
            slab_id = len(slab_cols)
            slab_cols.append(np.array(cols, np.int64))
            slab_home.append(r)
            slab_bytes.append(float(len(rows) * len(cols) * entry_bytes))
            # overdecompose the slab into u x u tasks, split by element pair
            for r0 in range(0, len(rows), task_limit_u):
                rsub = rows[r0:r0 + task_limit_u]
                for c0 in range(0, len(cols), task_limit_u):
                    csub = cols[c0:c0 + task_limit_u]
                    _emit_tasks(geom, rsub, csub, slab_id, r, tasks)

    return AssemblyProblem(
        geom=geom, num_ranks=num_ranks, rank_rows=rank_rows,
        slab_cols=slab_cols, slab_home=np.array(slab_home, np.int64),
        slab_bytes=np.array(slab_bytes), tasks=tasks)


def _emit_tasks(geom: Geometry, rows: np.ndarray, cols: np.ndarray,
                slab_id: int, home: int, out: List[AssemblyTask]):
    """Split a tile by element-type pair; skip zero (non-coupling) tiles."""
    for et_r in (0, 1):
        rsel = rows[geom.elem_type[rows] == et_r]
        if rsel.size == 0:
            continue
        for et_c in (0, 1):
            csel = cols[geom.elem_type[cols] == et_c]
            if csel.size == 0:
                continue
            inter = _interaction_count(geom, rsel, csel)
            if inter == 0:
                continue  # zero block: never instantiated (§VI-B)
            d_min = _min_dist(geom.points[rsel], geom.points[csel])
            pair = et_r + et_c  # 0 tri-tri, 1 mixed, 2 bar-bar
            out.append(AssemblyTask(
                task_id=len(out), slab=slab_id, home_rank=home,
                rows=rsel, cols=csel, elem_pair=pair,
                quad_order=_quad_order(d_min), n_interactions=inter))


def _interaction_count(geom: Geometry, rows: np.ndarray,
                       cols: np.ndarray) -> int:
    """DOF pairs that couple: same region, or either endpoint on a slot."""
    reg_r = geom.region[rows][:, None]
    reg_c = geom.region[cols][None, :]
    couple = (reg_r == reg_c) | (reg_r == 2) | (reg_c == 2)
    return int(couple.sum())
