"""Logical-axis -> mesh-axis mapping and the collectives of the port's mesh,
after the JAX package's ``sharding.py``.

Models name each parameter dimension by a *logical* axis ("embed", "heads",
"mlp", "expert", ...; ``models.model.param_axes``); :func:`spec_for`
resolves them to a spec, one entry a dimension: a mesh-axis name, a tuple of
them, or None (replicated), with the reference's rules: a dimension that
does not divide its mesh axis is replicated (e.g. kv_heads = 8 on a 16-way
model axis), and a mesh axis shards at most one dimension, the largest.
The spec logic reads only the mesh's axis names and sizes, so it runs on an
:class:`AbstractMesh` (no process group) as on a ``DeviceMesh``;
:func:`placements_for` gives the DTensor ``Shard`` / ``Replicate``
placements of a spec.

The layout is the reference's, as its GSPMD partitioner computes it:
activations are batch-sharded over the batch axes and replicated over the
model axis; a dense leaf is stored by its spec, gathered at use over the
data axis only (FSDP, :meth:`MeshCtx.gather_local`), and its model-axis
shard is the rank's share of the product (Megatron's tensor parallelism):
q, k, v, the MLP's gate and up, RWKV6's r, k, v, g and channel-mix key, the
RG-LRU's input projections and the vocabulary are column-parallel (the
rank's heads, channels or vocabulary rows), w_o, w_down and the recurrent
blocks' output projections row-parallel with a sum over the model axis.
A layer takes a :class:`ModelAxis` (``MeshCtx.model_axis``, None where
the leaf is not split) and does that: :meth:`ModelAxis.enter` before a
column-parallel product, :meth:`ModelAxis.sum` after a row-parallel one,
:meth:`ModelAxis.scatter` where a row-parallel product feeds a consumer
split by channel (the RG-LRU's gates).  Experts are sharded over the model
axis with their hidden dimension sharded over the data axis
(``models/moe.py``).

Collectives run over a ``torch.distributed`` ``DeviceMesh``'s axis groups
(NCCL on the card, gloo on the CPU, the ``fake`` backend in the dry-run)
and are skipped on an axis of size 1, as the reference skips its FSDP
gather at ``data_size == 1``.  Their gradients follow the layout: a gather
over an axis whose ranks hold different batch shards reduce-scatters its
gradient; a gather over an axis whose ranks compute the same values (the
model axis) takes its own chunk of the gradient; :func:`psum` sums partial
results with an identity gradient and :func:`fan_in` passes a replicated
value into a partitioned region and sums its gradient (Megatron's g and f).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import roofline

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Which mesh axes play which role."""

    batch: Tuple[str, ...]        # batch / fsdp data axes, e.g. ("pod","data")
    data: str = "data"            # fsdp weight axis
    model: str = "model"          # tensor/expert-parallel axis

    @staticmethod
    def for_mesh(mesh) -> "MeshAxes":
        if "pod" in axis_names(mesh):
            return MeshAxes(batch=("pod", "data"))
        return MeshAxes(batch=("data",))


# Logical axis -> mesh axis role. Resolved against a MeshAxes instance.
LOGICAL_RULES = {
    "vocab": "model",
    "embed": "data",        # fsdp on the d_model dim of weight matrices
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "rnn": "model",         # recurrent-width dim (rwkv / rg-lru)
    "expert": "model",      # expert parallelism
    "expert_mlp": "data",   # fsdp on per-expert hidden dim
    "layers": None,
    "conv": None,
    "lora": None,
    None: None,
}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes and nothing else, as
    ``jax.sharding.AbstractMesh``: enough for :func:`spec_for`."""

    sizes: Tuple[Tuple[str, int], ...]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.sizes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.sizes)


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def _entry_axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_for(mesh, axes: MeshAxes, logical: Sequence[Optional[str]],
             shape: Sequence[int]) -> Spec:
    """Resolve logical axes to a spec (the reference's ``PartitionSpec``
    entries as a tuple).

    Rules: non-divisible dims are replicated; if two dims resolve to the same
    mesh axis (e.g. a (E, d, f) expert weight mapping both d and f to the
    fsdp axis, or a square (d, d) projection), only the largest dim keeps
    the mesh axis — a mesh axis may shard at most one dim.
    """
    sizes = mesh_sizes(mesh)
    entries = []
    for dim, name in zip(shape, logical, strict=True):
        target = LOGICAL_RULES.get(name)
        if target is None:
            entries.append(None)
            continue
        mesh_axis = axes.model if target == "model" else axes.data
        if mesh_axis in sizes and dim % sizes[mesh_axis] == 0:
            entries.append(mesh_axis)
        else:
            entries.append(None)
    # dedupe: keep the largest dim per mesh axis
    for axis in set(e for e in entries if e is not None):
        idxs = [i for i, e in enumerate(entries) if e == axis]
        if len(idxs) > 1:
            keep = max(idxs, key=lambda i: shape[i])
            for i in idxs:
                if i != keep:
                    entries[i] = None
    return tuple(entries)


def specs_for_tree(mesh, axes: MeshAxes, axes_tree, params):
    """The spec of every leaf of ``params`` (tensors, or anything with a
    ``shape``) from the matching tree of logical axes."""
    if isinstance(params, dict):
        return {k: specs_for_tree(mesh, axes, axes_tree[k], params[k])
                for k in params}
    if isinstance(params, (list, tuple)):
        return type(params)(specs_for_tree(mesh, axes, a, p)
                            for a, p in zip(axes_tree, params, strict=True))
    return spec_for(mesh, axes, axes_tree, tuple(params.shape))


def batch_spec(axes: MeshAxes, ndim: int, batch_dim: int = 0) -> Spec:
    entries = [None] * ndim
    entries[batch_dim] = axes.batch if len(axes.batch) > 1 else axes.batch[0]
    return tuple(entries)


def batch_size_divisor(mesh, axes: MeshAxes) -> int:
    sizes = mesh_sizes(mesh)
    return int(np.prod([sizes[a] for a in axes.batch]))


def placements_for(mesh, spec: Spec):
    """The DTensor placements of ``spec`` on ``mesh``, one a mesh
    dimension: ``Shard(d)`` where tensor dimension d's entry names that
    mesh axis, else ``Replicate()``.  A dimension sharded over a tuple of
    axes is split over them in mesh order, which is the order of the
    reference's tuple entries (("pod", "data"), ("data", "model"))."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axis_names(mesh):
        dims = [d for d, e in enumerate(spec) if name in _entry_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def local_shape(mesh, spec: Spec, shape: Sequence[int]) -> Tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` tensor laid out by
    ``spec``."""
    sizes = mesh_sizes(mesh)
    out = []
    for dim, entry in zip(shape, spec, strict=True):
        n = int(np.prod([sizes[a] for a in _entry_axes(entry)]))
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {entry} ({n})")
        out.append(dim // n)
    return tuple(out)


def constrain(x: torch.Tensor, mesh, spec: Spec,
              shape: Sequence[int]) -> torch.Tensor:
    """The reference pins a layout for its partitioner; the port holds its
    local tensors by hand, so this checks that ``x`` has the local shape
    that ``spec`` implies for a global ``shape``, and returns it."""
    want = local_shape(mesh, spec, shape)
    if tuple(x.shape) != want:
        raise ValueError(f"local shape {tuple(x.shape)}, spec {spec} of "
                         f"{tuple(shape)} implies {want}")
    return x


# ------------------------------------------------------------- collectives
def axis_size(mesh, name: str) -> int:
    return mesh_sizes(mesh)[name]


def axis_rank(mesh, name: str) -> int:
    """This process's coordinate on axis ``name`` (0 on an abstract
    mesh)."""
    if getattr(mesh, "mesh_dim_names", None) is None:
        return 0
    return mesh.get_local_rank(name)


def _all_gather(x: torch.Tensor, mesh, name: str, dim: int) -> torch.Tensor:
    n = axis_size(mesh, name)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, src, group=mesh.get_group(name))
    roofline.add_axis_bytes("all-gather", name, src)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, mesh, name: str,
                    dim: int) -> torch.Tensor:
    n = axis_size(mesh, name)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    scatter = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    scatter(out, src, group=mesh.get_group(name))
    roofline.add_axis_bytes("reduce-scatter", name, src)
    return out.movedim(0, dim)


def all_reduce_(x: torch.Tensor, mesh, names: Sequence[str],
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``x`` in place over the mesh axes ``names`` (a sum unless
    ``op`` says otherwise; no gradient); axes of size 1 are skipped."""
    for name in names:
        if axis_size(mesh, name) > 1:
            dist.all_reduce(x, op=op, group=mesh.get_group(name))
            roofline.add_axis_bytes("all-reduce", name, x)
    return x


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over one mesh axis; the gradient is
    reduce-scattered (``reduce``: the axis's ranks computed on different
    data) or chunked (they computed the same values)."""

    @staticmethod
    def forward(ctx, x, mesh, name, dim, reduce):
        ctx.args = (mesh, name, dim, reduce)
        return _all_gather(x, mesh, name, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, name, dim, reduce = ctx.args
        if reduce:
            g = _reduce_scatter(g, mesh, name, dim)
        else:
            n = axis_size(mesh, name)
            g = g.chunk(n, dim)[axis_rank(mesh, name)].contiguous()
        return g, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    """Sum over one mesh axis, each rank keeping its chunk along ``dim``;
    the gradient is all-gathered (every rank's partial fed every chunk)."""

    @staticmethod
    def forward(ctx, x, mesh, name, dim):
        ctx.args = (mesh, name, dim)
        return _reduce_scatter(x, mesh, name, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, name, dim = ctx.args
        return _all_gather(g, mesh, name, dim), None, None, None


class _Psum(torch.autograd.Function):
    """Sum over mesh axes; identity gradient (each rank's part of a sum
    that every rank then uses alike)."""

    @staticmethod
    def forward(ctx, x, mesh, names):
        return all_reduce_(x.clone(), mesh, names)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _FanIn(torch.autograd.Function):
    """Identity; the gradient summed over mesh axes (a replicated value
    used by partitioned work)."""

    @staticmethod
    def forward(ctx, x, mesh, names):
        ctx.args = (mesh, names)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, names = ctx.args
        return all_reduce_(g.clone(), mesh, names), None, None


def _live(mesh, names: Sequence[str]) -> Tuple[str, ...]:
    return tuple(n for n in names if axis_size(mesh, n) > 1)


def psum(x: torch.Tensor, mesh, names: Sequence[str]) -> torch.Tensor:
    """``x`` summed over the mesh axes ``names``, gradient the identity;
    ``x`` itself where every axis has size 1."""
    names = _live(mesh, names)
    return _Psum.apply(x, mesh, names) if names else x


def fan_in(x: torch.Tensor, mesh, names: Sequence[str]) -> torch.Tensor:
    """``x``, with its gradient summed over the mesh axes ``names``."""
    names = _live(mesh, names)
    return _FanIn.apply(x, mesh, names) if names else x


def gather(x: torch.Tensor, mesh, spec: Spec,
           reduce_axes: Sequence[str] = (),
           only: Optional[Sequence[str]] = None) -> torch.Tensor:
    """The full tensor of a local shard laid out by ``spec`` (over the axes
    in ``only``, when given, and the others left sharded).  A dimension
    sharded over a tuple of axes gathers the inner axis first.  The
    gradient reduce-scatters over the axes in ``reduce_axes`` and takes
    this rank's chunk over the others."""
    for dim, entry in enumerate(spec):
        for name in reversed(_entry_axes(entry)):
            if only is not None and name not in only:
                continue
            if axis_size(mesh, name) > 1:
                x = _Gather.apply(x, mesh, name, dim, name in reduce_axes)
    return x


def shard(x: torch.Tensor, mesh, spec: Spec) -> torch.Tensor:
    """This rank's shard of the full tensor ``x`` by ``spec`` (a slice, no
    communication; contiguous)."""
    for dim, entry in enumerate(spec):
        names = _entry_axes(entry)
        if not names:
            continue
        n, idx = 1, 0
        for name in names:
            idx = idx * axis_size(mesh, name) + axis_rank(mesh, name)
            n *= axis_size(mesh, name)
        if n > 1:
            x = x.chunk(n, dim)[idx]
    return x.contiguous()


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The model axis that a layer's dense products are split over, as
    one rank sees it (``MeshCtx.model_axis``): ``size`` ranks, this one
    ``rank``, whose shard of a split dimension is its n entries from
    :meth:`start`.  Its collectives are Megatron's:
    :meth:`enter` before a column-parallel product (the identity, the
    gradient summed over the axis), :meth:`sum` after a row-parallel one
    (the gradient the identity), :meth:`scatter` (a sum of which each rank
    keeps its chunk), :meth:`max` (no gradient) and :meth:`gather` (the
    chunks of a value that every rank then uses alike).  A layer takes
    None where its leaves are not split, and computes them whole."""

    mesh: object
    name: str

    @property
    def size(self) -> int:
        return axis_size(self.mesh, self.name)

    @property
    def rank(self) -> int:
        return axis_rank(self.mesh, self.name)

    def start(self, n: int) -> int:
        """The first index of this rank's ``n`` entries of a dimension
        split over the axis."""
        return self.rank * n

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return fan_in(x, self.mesh, (self.name,))

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return psum(x, self.mesh, (self.name,))

    def scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _ReduceScatter.apply(x, self.mesh, self.name,
                                    dim % x.dim())

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_(x.detach().clone(), self.mesh, (self.name,),
                           op=dist.ReduceOp.MAX)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _Gather.apply(x, self.mesh, self.name, dim % x.dim(), False)


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    """A model's mesh: the ``DeviceMesh``, its axes' roles, the spec of
    every parameter leaf (``specs``, the params' tree), and whether the
    rows a call computes on are this rank's share of a batch sharded over
    the batch axes (``batch_sharded``; where every rank holds all of them,
    nothing is summed over those axes).  Frozen: a model keeps one, and
    each call takes its own by :meth:`for_rows` from the layout its batch
    or caches carry (:class:`LocalBatch`, :class:`LocalCaches`)."""

    mesh: object
    axes: MeshAxes
    specs: object = None
    batch_sharded: bool = True

    def for_rows(self, rows) -> "MeshCtx":
        """This ctx for a call on ``rows`` (a batch or caches): sharded
        where they are a :class:`LocalBatch` or :class:`LocalCaches` that
        says so; any other batch is the whole batch on every rank."""
        sharded = bool(getattr(rows, "sharded", False))
        if sharded == self.batch_sharded:
            return self
        return dataclasses.replace(self, batch_sharded=sharded)

    @property
    def reduce_axes(self) -> Tuple[str, ...]:
        return self.axes.batch if self.batch_sharded else ()

    @property
    def batch_ranks(self) -> int:
        return batch_size_divisor(self.mesh, self.axes) \
            if self.batch_sharded else 1

    def gather(self, x, spec: Spec, only=None):
        return gather(x, self.mesh, spec, self.reduce_axes, only)

    def gather_local(self, x, spec: Spec):
        """``x`` gathered over every axis but the model axis: a dense
        leaf as the rank computes with it (its model-axis shard)."""
        return self.gather(x, spec, only=tuple(
            a for a in axis_names(self.mesh) if a != self.axes.model))

    def gather_tree(self, tree, specs):
        """Every leaf of ``tree`` as the rank computes with it
        (:meth:`gather_local`)."""
        return tree_map(self.gather_local, tree, specs)

    def model_axis(self, entry: Entry) -> Optional[ModelAxis]:
        """The :class:`ModelAxis` of a leaf dimension whose spec entry is
        ``entry``, where that names the model axis and it has more than
        one rank; None (compute whole) otherwise."""
        if self.axes.model not in _entry_axes(entry) \
                or axis_size(self.mesh, self.axes.model) == 1:
            return None
        return ModelAxis(self.mesh, self.axes.model)

    def batch_entry(self, b: int) -> Entry:
        """The batch dimension's entry for a batch of ``b``."""
        if b % batch_size_divisor(self.mesh, self.axes):
            return None
        return self.axes.batch if len(self.axes.batch) > 1 \
            else self.axes.batch[0]


class LocalBatch(dict):
    """A rank's rows of a batch (``models.model.local_batch``), with
    ``sharded``: whether they are its share of rows split over the batch
    axes (False: every rank holds them all)."""

    def __init__(self, items, sharded: bool):
        super().__init__(items)
        self.sharded = sharded

    def with_values(self, fn) -> "LocalBatch":
        """The same rows with ``fn`` applied to every value."""
        return LocalBatch({k: fn(v) for k, v in self.items()}, self.sharded)


class LocalCaches(list):
    """A rank's decode caches, one dict a layer, with their layout:
    ``specs`` (one dict of specs a layer) lays out the sequence (and other
    non-batch) dimensions; the batch dimension holds the rank's rows,
    which are its share of the batch where ``sharded``."""

    def __init__(self, caches, specs, sharded: bool):
        super().__init__(caches)
        self.specs = specs
        self.sharded = sharded

    def like(self, caches) -> "LocalCaches":
        """``caches`` laid out as these."""
        return LocalCaches(caches, self.specs, self.sharded)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts / lists / tuples, with the
    matching leaves of the trees in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)
