"""Carry the JAX package's state across: build the port's ``Phase``,
``CCMParams`` and assignment, its cost-model FNN, and its LM parameters,
from the reference's fields.

This system's "weights" are a phase (tasks, blocks, communications, ranks),
the CCM coefficients and an assignment, the cost model's FNN parameters and
the model stack's parameters (the decoder LMs' and the
encoder-decoder's).  The functions here take them as plain data —
numpy arrays, floats and dicts, e.g. ``dataclasses.asdict`` of the
reference's ``Phase`` or ``jax.tree.map(np.asarray, params)`` — so the port
never imports the JAX package.  :func:`params_onto` carries an LM's tree
onto a model built on a mesh: each rank keeps its shards by
``sharding.spec_for``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
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


def _tensor(a) -> torch.Tensor:
    """A CPU tensor copy of a numpy array, bfloat16 (``ml_dtypes``) too."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _copy_tree(want, got, path: str):
    """``got`` (a reference subtree of numpy arrays) as tensors laid out like
    ``want`` (the port's meta-device tree); raises on a missing or unknown
    key, or a shape or dtype the port does not have."""
    if isinstance(want, dict):
        if not isinstance(got, Mapping) or set(got) != set(want):
            raise ValueError(f"{path or 'params'}: keys "
                             f"{sorted(got) if isinstance(got, Mapping) else got!r}"
                             f", the port has {sorted(want)}")
        return {k: _copy_tree(want[k], got[k], f"{path}/{k}") for k in want}
    t = _tensor(got)
    if tuple(t.shape) != tuple(want.shape) or t.dtype != want.dtype:
        raise ValueError(f"{path}: {tuple(t.shape)} {t.dtype} where the port "
                         f"has {tuple(want.shape)} {want.dtype}")
    return t


def lm_params_from_reference(values: Mapping, cfg: ModelConfig):
    """The port's LM parameters (CPU tensors, in the reference's dtypes and
    layouts, e.g. ``w_q (d, H, hd)``, ``w_gate (E, d, f)``) holding copies
    of the reference's ``split_lp_tree(init_lm(...))[0]`` tree given as numpy
    arrays: ``{"embed", "scan": {"b<i>": ...}, "final_norm"[, "tail":
    {"t<i>": ...}][, "lm_head"]}``.  The ``scan`` tree's leading period axis
    is un-stacked into one block per layer, then ``tail``'s blocks follow.
    Raises on an unknown or missing key, or a wrong shape or dtype."""
    from repro_torch.models.transformer import init_lm
    dtype = _tensor(values["embed"]).dtype
    want = init_lm(None, cfg, dtype=dtype, device="meta")
    period = cfg.pattern_period
    n_periods = cfg.num_layers // period
    n_tail = cfg.num_layers - n_periods * period
    top = sorted(set(want) - {"blocks"})
    expected = set(top) | {"scan"} | ({"tail"} if n_tail else set())
    if set(values) != expected:
        raise ValueError(f"params: keys {sorted(values)}, the port has "
                         f"{sorted(expected)}")
    for name, keys in (("scan", {f"b{i}" for i in range(period)}),
                       ("tail", {f"t{i}" for i in range(n_tail)})):
        if set(values.get(name, {})) != keys:
            raise ValueError(f"params/{name}: keys "
                             f"{sorted(values.get(name, {}))}, the port has "
                             f"{sorted(keys)}")
    scan = values["scan"]

    def period_slice(tree, p):
        if isinstance(tree, Mapping):
            return {k: period_slice(v, p) for k, v in tree.items()}
        a = np.asarray(tree)
        if a.ndim == 0 or a.shape[0] != n_periods:
            raise ValueError(f"params/scan: leading axis {a.shape} is not "
                             f"the {n_periods} periods")
        return a[p]

    blocks = []
    for layer, kind_want in enumerate(want["blocks"]):
        if layer < n_periods * period:
            p, i = divmod(layer, period)
            got = period_slice(scan[f"b{i}"], p)
            where = f"scan/b{i}[{p}]"
        else:
            i = layer - n_periods * period
            got, where = values["tail"][f"t{i}"], f"tail/t{i}"
        blocks.append(_copy_tree(kind_want, got, where))
    out = {k: _copy_tree(want[k], values[k], k) for k in top}
    out["blocks"] = blocks
    return out


def _unstack(tree, n: int, i: int, where: str):
    """Layer ``i`` of a reference scan tree whose leaves lead with ``n``."""
    if isinstance(tree, Mapping):
        return {k: _unstack(v, n, i, where) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.ndim == 0 or a.shape[0] != n:
        raise ValueError(f"params/{where}: leading axis {a.shape} is not "
                         f"the {n} layers")
    return a[i]


def encdec_params_from_reference(values: Mapping, cfg: ModelConfig):
    """The port's encoder-decoder parameters (CPU tensors, in the
    reference's dtypes and layouts) holding copies of the reference's
    ``split_lp_tree(init_encdec(...))[0]`` tree given as numpy arrays:
    ``{"embed", "enc_scan": {"b0": ...}, "enc_norm", "dec_scan": {"b0":
    ...}, "final_norm", "lm_head"}``.  Each scan's leading layer axis is
    un-stacked into one block per layer (``enc_blocks``, ``dec_blocks``).
    Raises on an unknown or missing key, or a wrong shape or dtype."""
    from repro_torch.models.encdec import init_encdec
    dtype = _tensor(values["embed"]).dtype
    want = init_encdec(None, cfg, dtype=dtype, device="meta")
    scans = {"enc_blocks": ("enc_scan", cfg.num_layers),
             "dec_blocks": ("dec_scan", cfg.num_decoder_layers)}
    top = sorted(set(want) - set(scans))
    expected = set(top) | {name for name, _ in scans.values()}
    if set(values) != expected:
        raise ValueError(f"params: keys {sorted(values)}, the port has "
                         f"{sorted(expected)}")
    out = {k: _copy_tree(want[k], values[k], k) for k in top}
    for key, (name, n) in scans.items():
        if set(values[name]) != {"b0"}:
            raise ValueError(f"params/{name}: keys {sorted(values[name])}, "
                             "the port has ['b0']")
        out[key] = [_copy_tree(blk, _unstack(values[name]["b0"], n, i, name),
                               f"{name}/b0[{i}]")
                    for i, blk in enumerate(want[key])]
    return out


def params_onto(model, values: Mapping):
    """The reference's LM or encoder-decoder parameters (numpy, as
    :func:`lm_params_from_reference` and
    :func:`encdec_params_from_reference` take them) as ``model`` holds
    them: on its device, and on a mesh this rank's shard of each leaf by
    its spec."""
    from repro_torch.models.model import shard_params
    cfg = model.cfg
    full = (encdec_params_from_reference(values, cfg)
            if cfg.arch_type == "encdec"
            else lm_params_from_reference(values, cfg))
    return shard_params(model, full)
