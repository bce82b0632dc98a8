"""Geometry generator for the Gemma-analogue problem (paper §VI-A).

The port's own copy of ``repro/assembly/geometry.py``: the same
``np.random.default_rng(seed)`` stream, so points, regions and element
types are bitwise equal to the JAX package's.

Mimics the yaml_rect_cavity_2_slots_curve topology: a conducting block with
an interior cavity coupled to the exterior through two slots.  Unknowns
(RWG-like DOFs) are sampled on three regions:

  region 0 — exterior surface (plane-wave excited),
  region 1 — interior cavity wall,
  region 2 — the two slots (thin strips that couple 0 <-> 1).

Coupling rule (drives the zero blocks of §VI-B): two DOFs interact iff they
share a region, or one of them lies on a slot.  Interactions between nearby
DOFs are near-singular -> higher quadrature order -> the heavy-tailed task
costs that cause the load imbalance this paper exists to fix.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Geometry:
    points: np.ndarray      # (n, 3) DOF locations
    region: np.ndarray      # (n,) in {0, 1, 2}
    elem_type: np.ndarray   # (n,) in {0 tri, 1 bar} (slots use bar elements)

    @property
    def n(self) -> int:
        return self.points.shape[0]

    def couples(self, region_a: int, region_b: int) -> bool:
        return region_a == region_b or region_a == 2 or region_b == 2


def make_cavity_geometry(n_unknowns: int, seed: int = 0,
                         slot_frac: float = 0.04) -> Geometry:
    rng = np.random.default_rng(seed)
    n_slot = max(8, int(n_unknowns * slot_frac))
    n_rest = n_unknowns - n_slot
    n_out = n_rest * 6 // 10
    n_in = n_rest - n_out

    def cube_surface(n, lo, hi):
        face = rng.integers(0, 6, n)
        pts = rng.uniform(lo, hi, size=(n, 3))
        axis = face % 3
        val = np.where(face < 3, lo, hi)
        pts[np.arange(n), axis] = val
        return pts

    outer = cube_surface(n_out, 0.0, 2.0)
    inner = cube_surface(n_in, 0.1, 1.9)
    # two slots: thin strips on the x=0 and x=2 faces
    t = rng.uniform(0, 1, n_slot)
    half = n_slot // 2
    slot = np.zeros((n_slot, 3))
    slot[:half] = np.stack([np.zeros(half), 0.85 + 0.3 * t[:half],
                            np.full(half, 1.0)], 1)
    slot[half:] = np.stack([np.full(n_slot - half, 2.0),
                            0.85 + 0.3 * t[half:],
                            np.full(n_slot - half, 1.0)], 1)

    points = np.concatenate([outer, inner, slot])
    region = np.concatenate([np.zeros(n_out), np.ones(n_in),
                             np.full(n_slot, 2)]).astype(np.int64)
    elem_type = (region == 2).astype(np.int64)  # slots are bar elements
    # DOF numbering follows the mesh (region-contiguous, spatially sorted) —
    # this is what makes the solver's row-block layout imbalanced: ranks
    # owning slot/cavity rows get the near-singular, coupling-dense work.
    order = np.lexsort((points[:, 2], points[:, 1], points[:, 0], region))
    return Geometry(points[order], region[order], elem_type[order])
