"""Uniform model API, after the JAX package's ``models/model.py``.

``build_model(cfg, mesh=...)`` returns a ``Model`` with init / loss /
prefill / decode closures for every architecture of the configs: the
decoder LMs (attention, MoE, ``rwkv6`` and ``rglru`` blocks, the vision
front end's stub, the ring cache) and the encoder-decoder
(``models/encdec.py``).  Without a mesh one device holds the model; on a
``DeviceMesh`` (``launch/mesh.py``) each rank holds its shard of every
leaf by ``sharding.spec_for`` of the leaf's logical axes
(:func:`param_axes`), and the closures take the local batch shard: the
layout of ``sharding.py``, which the reference's GSPMD partitioner
computes: the dense products split over the model axis where their leaves'
specs split them (the rank's heads, hidden columns, recurrent channels and
vocabulary rows), the experts over it too, FSDP over the data axis.

:func:`batch_specs`, :func:`cache_specs` and :func:`decode_token_specs`
are the reference's: meta tensors of a cell's global shapes with their
specs (``launch/steps.py`` lays a dry-run cell out by them, and
``launch/serve.py`` the caches of a served batch).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch import sharding
from repro_torch.configs.base import (BLOCK_ATTN, BLOCK_LOCAL, BLOCK_MOE,
                                      BLOCK_REC, BLOCK_RWKV, ModelConfig,
                                      ShapeConfig)
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.sharding import LocalBatch, MeshAxes, MeshCtx


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    dtype: torch.dtype
    init: Callable            # torch.Generator -> params (local shards)
    loss_fn: Callable         # (params, batch) -> (loss, metrics)
    prefill_fn: Callable      # (params, batch) -> (caches, logits)
    decode_fn: Callable       # (params, caches, token, pos) -> (caches, logits)
    mesh: object = None
    ctx: Optional[MeshCtx] = None   # the mesh, its axes, the params' specs


def param_axes(cfg: ModelConfig):
    """The logical axes of every parameter leaf, as a tree laid out like
    the params: the axes the reference's ``LP`` leaves carry."""
    tf_lib.check_config(cfg)
    if cfg.arch_type == "encdec":
        return encdec_lib.encdec_axes(cfg)
    return tf_lib.lm_axes(cfg)


def _init(cfg: ModelConfig):
    return encdec_lib.init_encdec if cfg.arch_type == "encdec" \
        else tf_lib.init_lm


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16):
    """The params' global shapes and dtypes, as ``meta`` tensors."""
    return _init(cfg)(None, cfg, dtype=dtype, device="meta")


def param_specs(cfg: ModelConfig, mesh, axes: Optional[MeshAxes] = None,
                dtype=torch.bfloat16):
    """The spec of every parameter leaf on ``mesh`` (a ``DeviceMesh`` or a
    ``sharding.AbstractMesh``)."""
    axes = axes or MeshAxes.for_mesh(mesh)
    return sharding.specs_for_tree(mesh, axes, param_axes(cfg),
                                   abstract_params(cfg, dtype))


def place(ctx: MeshCtx, tree, axes_tree):
    """This rank's shards of a subtree of whole leaves (``axes_tree``: its
    logical axes)."""
    def one(t, ax):
        spec = sharding.spec_for(ctx.mesh, ctx.axes, ax, tuple(t.shape))
        return sharding.shard(t, ctx.mesh, spec)
    return sharding.tree_map(one, tree, axes_tree)


def shard_params(model: "Model", full):
    """A rank's shards of a whole params tree (any device), moved to the
    model's device: how a tree made elsewhere (``convert``, a checkpoint)
    goes onto a mesh."""
    if model.ctx is None:
        return sharding.tree_map(lambda t: t.to(model.device), full)
    return sharding.tree_map(
        lambda t, s: sharding.shard(t, model.ctx.mesh, s).to(model.device),
        full, model.ctx.specs)


def build_model(cfg: ModelConfig, device="cuda", dtype=torch.bfloat16,
                mesh=None, axes: Optional[MeshAxes] = None) -> Model:
    """The model of ``cfg`` on ``device`` (the card unless the caller asks
    for the CPU) with weights in ``dtype``; on ``mesh`` (a
    ``DeviceMesh``), its local shards on this rank's device
    (``launch.mesh.mesh_device``; ``device`` must be of the mesh's device
    type), or on ``meta`` where ``device`` is ``"meta"`` (the dry-run;
    the mesh may then be a ``sharding.AbstractMesh`` with all axes of size
    1).  Raises for a CUDA device when no card is present, for a mesh of
    another device type than ``device``, and for a block kind the port
    does not know.

    On a mesh the closures take this rank's rows: a batch from
    :func:`local_batch` (any other batch is taken as the whole batch,
    held alike by every rank), and decode the caches that
    ``launch.serve.lay_out_caches`` returns, which carry their layout."""
    if mesh is not None and torch.device(device).type != "meta":
        from repro_torch.launch.mesh import mesh_device
        if torch.device(device).type != mesh.device_type:
            raise ValueError(f"build_model: device {str(device)!r} asked "
                             f"for on a {mesh.device_type} mesh")
        device = mesh_device(mesh)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: device 'cuda' asked for, but torch "
                           "sees no CUDA card (pass device='cpu' to run the "
                           "plain versions on the CPU)")
    tf_lib.check_config(cfg)
    ctx = None
    if mesh is not None:
        axes = axes or MeshAxes.for_mesh(mesh)
        ctx = MeshCtx(mesh, axes, param_specs(cfg, mesh, axes, dtype))
    init_fn = _init(cfg)

    def init(gen: torch.Generator):
        put = None if ctx is None else \
            (lambda tree, ax: place(ctx, tree, ax))
        return init_fn(gen, cfg, dtype=dtype, device=device, place=put)

    lib = encdec_lib if cfg.arch_type == "encdec" else None
    if lib is not None:
        loss, prefill, decode = (lib.encdec_loss, lib.encdec_prefill,
                                 lib.encdec_decode)
    else:
        loss, prefill, decode = (tf_lib.lm_loss, tf_lib.lm_prefill,
                                 tf_lib.lm_decode)

    def on(rows):
        return None if ctx is None else ctx.for_rows(rows)

    return Model(
        cfg, device, dtype, init=init,
        loss_fn=lambda p, b: loss(p, b, cfg, on(b)),
        prefill_fn=lambda p, b: prefill(p, b, cfg, on(b)),
        decode_fn=lambda p, c, t, pos: decode(p, c, t, pos, cfg, on(c)),
        mesh=mesh, ctx=ctx)


def local_batch(model: Model, batch):
    """This rank's rows of a global batch (numpy arrays or tensors) by
    :func:`_bspec` (all of them where the batch does not divide over the
    batch axes), as a ``sharding.LocalBatch`` that says which, for the
    closures to read (the loss's sums and the gradients' reductions).
    The batch as it is without a mesh."""
    ctx = model.ctx
    if ctx is None:
        return batch
    b = next(iter(batch.values())).shape[0]
    entry = ctx.batch_entry(b)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        spec = (entry,) + (None,) * (t.ndim - 1)
        out[k] = sharding.shard(t, ctx.mesh, spec)
    return LocalBatch(out, sharded=entry is not None)


# ------------------------------------------------------------- input specs
def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _bspec(axes: MeshAxes, b: int, mesh):
    if b % sharding.batch_size_divisor(mesh, axes) == 0:
        return axes.batch if len(axes.batch) > 1 else axes.batch[0]
    return None


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, axes: MeshAxes,
                kind: str):
    """(meta tensor tree, spec tree) for a step's data batch at the cell's
    global shapes.  kind: "train" | "prefill" — decode inputs are built
    separately."""
    b, s = shape.global_batch, shape.seq_len
    bs = _bspec(axes, b, mesh)
    dt, it = torch.bfloat16, torch.int64
    if cfg.arch_type == "encdec":
        s_dec = encdec_lib.decoder_len(cfg, s)
        batch = {"audio_embed": _meta((b, s, cfg.d_model), dt),
                 "tokens": _meta((b, s_dec), it)}
        specs = {"audio_embed": (bs, None, None), "tokens": (bs, None)}
        if kind == "train":
            batch["targets"] = _meta((b, s_dec), it)
            specs["targets"] = (bs, None)
        return batch, specs
    if cfg.frontend == "vision":
        p_media = cfg.num_media_positions
        s_text = s - p_media
        batch = {"media_embed": _meta((b, p_media, cfg.d_model), dt),
                 "tokens": _meta((b, s_text), it)}
        specs = {"media_embed": (bs, None, None), "tokens": (bs, None)}
        if kind == "train":
            batch["targets"] = _meta((b, s_text), it)
            specs["targets"] = (bs, None)
        return batch, specs
    batch = {"tokens": _meta((b, s), it)}
    specs = {"tokens": (bs, None)}
    if kind == "train":
        batch["targets"] = _meta((b, s), it)
        specs["targets"] = (bs, None)
    return batch, specs


def _seq_shard(axes: MeshAxes, b: int, s: int, mesh):
    """(batch_entry, seq_entry) for KV caches: batch over the batch axes when
    divisible, else shard the sequence dim as hard as divisibility allows."""
    sizes = sharding.mesh_sizes(mesh)
    if b % sharding.batch_size_divisor(mesh, axes) == 0:
        bspec = axes.batch if len(axes.batch) > 1 else axes.batch[0]
        seq = axes.model if s % sizes[axes.model] == 0 else None
        return bspec, seq
    combo = (axes.data, axes.model)
    size = sizes[axes.data] * sizes[axes.model]
    if s % size == 0:
        return None, combo
    return None, (axes.data if s % sizes[axes.data] == 0 else None)


def cache_specs(cfg: ModelConfig, b: int, s: int, mesh, axes: MeshAxes,
                s_dec: int = 448):
    """(meta cache tree, spec tree) of a batch of ``b`` sequences with
    caches of ``s`` positions, one dict a layer as the port's decode takes
    them (the reference's ``cache_specs`` without the leading period axis
    of its scan).  The encoder-decoder's self-attention caches have
    ``s_dec`` positions (the reference's 448) and its cross caches
    ``s``."""
    hkv, hd, d = cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    cb, cs = _seq_shard(axes, b, s, mesh)
    bf16 = torch.bfloat16
    if cfg.arch_type == "encdec":
        sds = _meta((b, s_dec, hkv, hd), bf16)
        cds = _meta((b, s, hkv, hd), bf16)
        sspec, cspec = (cb, None, None, None), (cb, cs, None, None)
        n = cfg.num_decoder_layers
        return ([{"sk": sds, "sv": sds, "ck": cds, "cv": cds}] * n,
                [{"sk": sspec, "sv": sspec, "ck": cspec, "cv": cspec}] * n)

    h_rwkv = d // cfg.rwkv_head_dim
    rhd = cfg.rwkv_head_dim
    m_size = sharding.mesh_sizes(mesh)[axes.model]

    def model_ok(dim):
        return axes.model if dim % m_size == 0 else None

    def entry(kind: str):
        if kind in (BLOCK_ATTN, BLOCK_LOCAL, BLOCK_MOE):
            s_eff, cb_e, cs_e = s, cb, cs
            if kind == BLOCK_LOCAL and cfg.window_kv_cache:
                s_eff = min(cfg.window_size, s)       # ring cache
                cb_e, cs_e = _seq_shard(axes, b, s_eff, mesh)
            t = _meta((b, s_eff, hkv, hd), bf16)
            spec = (cb_e, cs_e, None, None)
            return {"k": t, "v": t}, {"k": spec, "v": spec}
        if kind == BLOCK_RWKV:
            return (
                {"wkv": _meta((b, h_rwkv, rhd, rhd), torch.float32),
                 "tm_shift": _meta((b, d), bf16),
                 "cm_shift": _meta((b, d), bf16)},
                {"wkv": (cb, model_ok(h_rwkv), None, None),
                 "tm_shift": (cb, model_ok(d)),
                 "cm_shift": (cb, model_ok(d))})
        if kind == BLOCK_REC:
            w = cfg.rglru_conv_width
            return (
                {"h": _meta((b, d), torch.float32),
                 "conv": _meta((b, w - 1, d), bf16)},
                {"h": (cb, model_ok(d)),
                 "conv": (cb, None, model_ok(d))})
        raise ValueError(kind)

    pairs = [entry(kind) for kind in cfg.layer_kinds()]
    return [c for c, _ in pairs], [sp for _, sp in pairs]


def decode_layout(c_specs):
    """The specs a rank's decode caches are laid out by, from
    :func:`cache_specs`' spec tree: their batch dimension holds the
    rank's rows already (``sharding.LocalCaches.sharded`` says whether
    those are its share), so its entry is dropped."""
    return [{k: (None,) + tuple(sp[1:]) for k, sp in layer.items()}
            for layer in c_specs]


def decode_token_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       axes: MeshAxes) -> Tuple:
    """(token meta tensor, its spec, position meta tensor, its spec) of a
    decode cell."""
    b = shape.global_batch
    bs = _bspec(axes, b, mesh)
    return (_meta((b, 1), torch.int64), (bs, None),
            _meta((), torch.int64), ())
