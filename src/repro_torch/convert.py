"""Carry the JAX package's state across: build the port's ``Phase``,
``CCMParams`` and assignment from the reference's fields.

This system's "weights" are a phase (tasks, blocks, communications, ranks),
the CCM coefficients and an assignment.  :func:`from_reference` takes them
as plain data — ``dataclasses.asdict`` of the reference's ``Phase`` and
``CCMParams`` (numpy arrays and floats) plus the assignment array — so the
port never imports the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import numpy as np

from repro_torch.core.problem import CCMParams, Phase


def from_reference(phase_fields: Mapping, params_fields: Mapping,
                   assignment) -> Tuple[Phase, CCMParams, np.ndarray]:
    """The port's ``(Phase, CCMParams, assignment)`` holding copies of the
    reference's arrays; a field the port does not know raises."""
    phase = Phase(**{f.name: np.array(phase_fields[f.name], copy=True)
                     if phase_fields[f.name] is not None else None
                     for f in dataclasses.fields(Phase)})
    extra = set(phase_fields) - {f.name for f in dataclasses.fields(Phase)}
    if extra:
        raise ValueError(f"unknown Phase fields: {sorted(extra)}")
    params = CCMParams(**dict(params_fields))
    return phase, params, np.array(assignment, np.int64, copy=True)
