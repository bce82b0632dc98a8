"""Step builders, after the JAX package's ``launch/steps.py``: the train,
prefill and decode steps that the trainer and the server call, and the
dry-run's "lowered" cells.

Parameters are a tree of tensors (``models.transformer.init_lm``'s layout);
``checkpoint.tree_leaves`` flattens it in the order that the optimizer and
the checkpoints share.  On a mesh the trees hold this rank's shards; the
train step takes the global batch, keeps its rows (``model.local_batch``),
sums each leaf's gradient over the batch axes that its gather did not
already reduce, and clips by the whole model's norm.

Where the reference lowers a cell with ``jax.jit(...).lower`` on abstract
values, the port has nothing to compile: :func:`lower_cell` builds the
cell's parameters, AdamW state, batch and caches as ``meta`` tensors of
this rank's shapes (by their specs), and :class:`Lowered` runs the step
once on them under ``roofline.Counter``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch import sharding
from repro_torch.checkpoint import tree_leaves
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import (Model, batch_specs, build_model,
                                      cache_specs, decode_layout,
                                      decode_token_specs, local_batch)
from repro_torch.optim import AdamW, warmup_cosine


def _leaf_axes(spec) -> tuple:
    return tuple(a for e in spec for a in sharding._entry_axes(e))


def make_optimizer(params, *, lr=3e-4, warmup_steps=100,
                   total_steps=10000, ctx=None) -> AdamW:
    """AdamW over ``tree_leaves(params)`` (which it makes leaves that
    require grad) with the reference train step's schedule and its weight
    decay, 0.1.  On a mesh (``ctx``) the clipping norm sums each shard's
    squares over the axes its leaf is sharded on."""
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    reduce = None
    if ctx is not None:
        axes = [_leaf_axes(s) for s in tree_leaves_specs(ctx.specs)]

        def reduce(i, sq):
            return sharding.psum(sq, ctx.mesh, axes[i])
    return AdamW(leaves, warmup_cosine(lr, warmup_steps, total_steps),
                 weight_decay=0.1, norm_reduce=reduce)


def tree_leaves_specs(specs):
    """The specs of a spec tree in ``tree_leaves`` order (a spec is a
    tuple, not a node)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in tree_leaves_specs(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in tree_leaves_specs(v)]
    return [specs]


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``: integers (tokens, targets)
    as int64, the stub front ends' float embeddings as they are (a
    ``sharding.LocalBatch`` stays one)."""
    def one(v):
        t = torch.as_tensor(v, device=device)
        return t if t.is_floating_point() else t.long()
    if isinstance(batch, sharding.LocalBatch):
        return batch.with_values(one)
    return {k: one(v) for k, v in batch.items()}


def sync_grads(params, ctx, batch) -> None:
    """Sum each leaf's gradient over the batch axes (when ``batch``, the
    rows the loss ran on, is sharded over them) that its spec does not
    shard it over: a gather over the data axis already reduce-scattered
    it there.  Nothing is summed over the model axis: a leaf sharded on
    it has its shard's whole gradient, and a leaf replicated over it has
    the same whole gradient on every model rank (a value that enters a
    split product passes ``sharding.ModelAxis.enter``, whose gradient
    sums the ranks' parts; a replicated leaf that a rank slices, as
    ``w_k`` where the kv heads do not divide the axis, is entered
    itself)."""
    if ctx is None or not ctx.for_rows(batch).batch_sharded:
        return
    for t, spec in zip(tree_leaves(params), tree_leaves_specs(ctx.specs),
                       strict=True):
        names = [a for a in ctx.axes.batch if a not in _leaf_axes(spec)]
        if t.grad is not None and names:
            sharding.all_reduce_(t.grad, ctx.mesh, names)


def make_train_step(model: Model):
    """``train_step(params, opt, batch) -> metrics``: the loss and its
    gradients, then one AdamW update of ``params`` in place (the port's
    counterpart of the reference's donated buffers).  The metrics hold the
    loss too; they are tensors on the model's device.  On a mesh ``batch``
    is the global batch and the metrics are the global ones."""

    def train_step(params, opt: AdamW, batch) -> Dict[str, torch.Tensor]:
        opt.zero_grad(set_to_none=True)
        local = to_device(local_batch(model, batch), model.device)
        loss, metrics = model.loss_fn(params, local)
        loss.backward()
        sync_grads(params, model.ctx, local)
        opt.step()
        opt.zero_grad(set_to_none=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return metrics

    return train_step


def make_prefill_step(model: Model):
    def prefill_step(params, batch):
        with torch.inference_mode():
            return model.prefill_fn(params, batch)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, cache, token, pos):
        with torch.inference_mode():
            return model.decode_fn(params, cache, token, pos)
    return decode_step


# ------------------------------------------------------------------ lowering
def named(mesh, spec_tree):
    """Each spec of a tree as its DTensor placements on ``mesh``."""
    return sharding.tree_map(lambda s: sharding.placements_for(mesh, s),
                             spec_tree)


def _local_meta(tree, specs, mesh):
    return sharding.tree_map(
        lambda t, s: torch.empty(sharding.local_shape(mesh, s, t.shape),
                                 dtype=t.dtype, device="meta"), tree, specs)


def abstract_params(model: Model):
    """(this rank's params as ``meta`` tensors, their spec tree), nothing
    allocated."""
    params = model.init(None)
    return params, model.ctx.specs


def abstract_opt(params_meta):
    """AdamW state mirroring the params' shards (ZeRO-1): the step and
    float32 m and v, as ``meta`` tensors."""
    f32 = [torch.empty(t.shape, dtype=torch.float32, device="meta")
           for t in tree_leaves(params_meta)]
    return [torch.zeros((), dtype=torch.int32, device="meta")] + f32 + [
        torch.empty_like(t) for t in f32]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


@dataclasses.dataclass
class Lowered:
    """A cell's step ready to run once on ``meta``: ``run`` does the step;
    ``memory`` is this rank's bytes of parameters, their gradients (a
    train step), AdamW state, caches and batch (activations and gathered
    weights not counted)."""
    run: Callable[[], Any]
    memory: Dict[str, int]

    def analyze(self) -> dict:
        from repro_torch import roofline
        _, stats = roofline.count(self.run)
        return stats


def _no_grad(fn, *args):
    # no_grad, not inference_mode: under inference_mode composite ops
    # (einsum) reach the counter whole and their products go uncounted
    with torch.no_grad():
        return fn(*args)


def _build(cfg: ModelConfig, mesh) -> Model:
    return build_model(cfg, device="meta", mesh=mesh)


def lower_train(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Lowered:
    model = _build(cfg, mesh)
    params, _ = abstract_params(model)
    batch, _ = batch_specs(cfg, shape, mesh, model.ctx.axes, "train")
    opt = make_optimizer(params, warmup_steps=100, total_steps=10000,
                         ctx=model.ctx)
    step = make_train_step(model)
    local = local_batch(model, batch)
    memory = {"params": _nbytes(params), "grads": _nbytes(params),
              "opt": _nbytes(abstract_opt(params)), "caches": 0,
              "batch": _nbytes(local)}
    return Lowered(lambda: step(params, opt, batch), memory)


def lower_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Lowered:
    model = _build(cfg, mesh)
    params, _ = abstract_params(model)
    batch, _ = batch_specs(cfg, shape, mesh, model.ctx.axes, "prefill")
    local = local_batch(model, batch)
    memory = {"params": _nbytes(params), "opt": 0, "caches": 0,
              "batch": _nbytes(local)}
    return Lowered(lambda: _no_grad(model.prefill_fn, params, local), memory)


def lower_decode(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Lowered:
    model = _build(cfg, mesh)
    axes = model.ctx.axes
    params, _ = abstract_params(model)
    caches, c_specs = cache_specs(cfg, shape.global_batch, shape.seq_len,
                                  mesh, axes)
    local_caches = _local_meta(caches, c_specs, mesh)
    tok, tok_spec, _, _ = decode_token_specs(cfg, shape, mesh, axes)
    token = _local_meta(tok, tok_spec, mesh)
    local_caches = sharding.LocalCaches(local_caches, decode_layout(c_specs),
                                        sharded=tok_spec[0] is not None)
    memory = {"params": _nbytes(params), "opt": 0,
              "caches": _nbytes(local_caches), "batch": _nbytes(token)}
    return Lowered(lambda: _no_grad(model.decode_fn, params, local_caches,
                                    token, shape.seq_len - 1), memory)


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Lowered:
    if shape.kind == "train":
        return lower_train(cfg, shape, mesh)
    if shape.kind == "prefill":
        return lower_prefill(cfg, shape, mesh)
    return lower_decode(cfg, shape, mesh)
