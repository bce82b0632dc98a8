"""Carry the JAX package's state across: build the port's ``Phase``,
``CCMParams`` and assignment, and its cost-model FNN, from the reference's
fields.

This system's "weights" are a phase (tasks, blocks, communications, ranks),
the CCM coefficients and an assignment, plus the cost model's FNN
parameters.  The functions here take them as plain data — numpy arrays,
floats and dicts, e.g. ``dataclasses.asdict`` of the reference's ``Phase``
or ``jax.tree.map(np.asarray, params)`` — so the port never imports the JAX
package.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import numpy as np
import torch

from repro_torch.core.problem import CCMParams, Phase
from repro_torch.costmodel.network import FNN, FNNConfig


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


def fnn_from_reference(params: Mapping, bn_state: Mapping,
                       cfg_fields: Mapping) -> FNN:
    """The port's FNN (on the CPU) holding copies of the reference's
    parameters ``{"layers": [{"w", "b", "bn_scale", "bn_bias"}, ...],
    "out_w", "out_b"}`` and batch-norm state ``{"layers": [{"mean",
    "var"}, ...]}``; ``cfg_fields`` is ``dataclasses.asdict`` of its
    ``FNNConfig``."""
    cfg = FNNConfig(**{**cfg_fields, "hidden": tuple(cfg_fields["hidden"])})
    net = FNN(cfg)

    def put(dst: torch.Tensor, a) -> None:
        src = torch.tensor(np.asarray(a, np.float32))
        if src.shape != dst.shape:
            raise ValueError(f"shape {tuple(src.shape)} where the port's FNN "
                             f"has {tuple(dst.shape)}")
        dst.copy_(src)

    with torch.no_grad():
        for layer, p, st in zip(net.layers, params["layers"],
                                bn_state["layers"], strict=True):
            for name in ("w", "b", "bn_scale", "bn_bias"):
                put(getattr(layer, name), p[name])
            put(layer.mean, st["mean"])
            put(layer.var, st["var"])
        put(net.out_w, params["out_w"])
        put(net.out_b, params["out_b"])
    return net
