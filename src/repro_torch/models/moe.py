"""Mixture-of-Experts FFN with expert parallelism, after the JAX package's
``models/moe.py``.

The layout is the reference's "replicated-token EP": activations are
batch-sharded over the data axes and replicated over the model axis;
experts are sharded over the model axis, their weights' second largest
dimension FSDP-sharded over the data axis by ``sharding.spec_for`` and
all-gathered at use.  :func:`local_moe` is the reference's ``_local_moe``,
the body that one rank runs, written on local tensors as a function of
``(model_rank, model_size)``: tokens are routed top-k by an f32 router;
each of the rank's ``E / model_size`` experts takes its top-capacity
tokens (the capacity from the LOCAL token count; a dropped token is a
zero-weight row) into one (E_loc, C, d) buffer, and the three expert
products run as the expert GEMM (``kernels/moe_gemm``: the CUDA kernel on
the card, its plain torch version on the CPU; under autograd its backward
kernel).  All local experts are handled at once where the reference loops
over them; the result is the same, the f32 sums into ``out`` aside (the
card adds them in no set order).  :func:`moe_forward` applies the
collectives around the body: the FSDP all-gather of ``w_gate``, ``w_up``
and ``w_down`` over the data axis, the ``psum`` of ``out`` over the model
axis, ``counts`` summed and ``aux`` averaged over the batch axes.  With no
mesh it is the body at ``model_size = 1`` with no collective, which is the
one-device path.

Router statistics (tokens-per-expert) are returned as in the reference: they
are the task loads of the CCM load balancer's expert placement.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import sharding
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gemm import ops as gemm_ops
from repro_torch.models.layers import (activation, dense_init, init_mlp,
                                       mlp_axes, mlp_forward)

EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def init_moe(gen, cfg: ModelConfig, dtype=torch.bfloat16, device="cuda"):
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    kw = dict(dtype=dtype, device=device)
    params = {
        "router": dense_init(gen, (d, e), dtype=torch.float32, device=device),
        "w_gate": dense_init(gen, (e, d, f), in_axis=1, **kw),
        "w_up": dense_init(gen, (e, d, f), in_axis=1, **kw),
        "w_down": dense_init(gen, (e, f, d), in_axis=1, **kw),
    }
    if cfg.num_shared_experts:
        params["shared"] = init_mlp(gen, d, cfg.d_ff * cfg.num_shared_experts,
                                    **kw)
    return params


def moe_axes(cfg: ModelConfig):
    axes = {"router": ("embed", None),
            "w_gate": ("expert", "embed", "expert_mlp"),
            "w_up": ("expert", "embed", "expert_mlp"),
            "w_down": ("expert", "expert_mlp", "embed")}
    if cfg.num_shared_experts:
        axes["shared"] = mlp_axes()
    return axes


def _capacity(cfg: ModelConfig, tokens: int) -> int:
    c = int(cfg.capacity_factor * tokens * cfg.top_k / cfg.num_experts) + 1
    c = (c + 7) // 8 * 8
    return max(1, min(c, tokens))


def _top(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row and their indices, equal entries
    lower index first: ``jax.lax.top_k``'s order, which ``torch.topk`` does
    not promise (the capacity selection has many equal -1 entries)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x_flat: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """The f32 router: (probs (T, E), top_vals (T, k) renormalised,
    top_idx (T, k))."""
    logits = x_flat.to(torch.float32) @ router_w
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = _top(probs, top_k)
    top_vals = top_vals / torch.clamp_min(top_vals.sum(-1, keepdim=True), 1e-9)
    return probs, top_vals, top_idx


def _count(idx: torch.Tensor, e: int) -> torch.Tensor:
    """Occurrences of each of ``e`` ids in ``idx``, float32 (integer
    sums, exact in any order; shape-static, so it runs on ``meta``)."""
    c = torch.zeros((e,), dtype=torch.int64, device=idx.device)
    c.scatter_add_(0, idx.reshape(-1), torch.ones_like(idx.reshape(-1)))
    return c.to(torch.float32)


def local_moe(router_w, w_gate, w_up, w_down, x: torch.Tensor, *,
              cfg: ModelConfig, act_name: str, model_rank: int = 0,
              model_size: int = 1, enter=None):
    """One rank's body.  x: (B_loc, S, d), the same on every model rank;
    ``w_*``: this rank's (E / model_size, d, f) experts, gathered over
    the data axis.  Returns (out (T, d) float32: this rank's experts'
    share of the output, aux_loss, counts (E,)) on the local tokens.
    ``enter`` (identity when None) wraps the replicated values that feed
    the rank's experts (the tokens and their routing weights), so that
    their gradient can be summed over the model axis."""
    b, s, d = x.shape
    t = b * s
    e = cfg.num_experts
    if e % model_size:
        raise ValueError(f"{e} experts do not divide over {model_size} "
                         "model ranks")
    e_loc = e // model_size
    x_flat = x.reshape(t, d)
    probs, top_vals, top_idx = route(x_flat, router_w, cfg.top_k)
    x_in = x_flat
    if enter is not None:
        x_in, top_vals = enter(x_flat), enter(top_vals)

    # each expert's top-capacity tokens by routing weight; a token routed
    # elsewhere weighs -1 and is an invalid (zero-weight) row if selected
    cap = _capacity(cfg, t)
    w_te = torch.zeros((t, e), dtype=torch.float32, device=x.device)
    w_te.scatter_(1, top_idx, top_vals)
    if model_size > 1:
        lo = model_rank * e_loc
        w_te = w_te[:, lo:lo + e_loc]
    sel_w, sel_i = _top(torch.where(w_te > 0, w_te, -1.0).T, cap)  # (E_l, C)
    valid = (sel_w > 0).to(torch.float32)

    act = activation(act_name)
    xg = x_in[sel_i]                                             # (E_l, C, d)
    g = act(gemm_ops.expert_gemm(xg, w_gate))
    u = gemm_ops.expert_gemm(xg, w_up)
    h = gemm_ops.expert_gemm(g * u, w_down).to(torch.float32)
    h = h * (sel_w * valid)[..., None]
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    out.index_add_(0, sel_i.reshape(-1), h.reshape(-1, d))

    # router stats: tokens-per-expert counts + Switch-style aux loss
    f_frac = _count(top_idx[:, 0], e) / t
    aux = e * torch.sum(f_frac * probs.mean(0))
    counts = _count(top_idx, e)
    return out, aux, counts


def moe_forward(params, x: torch.Tensor, cfg: ModelConfig, act_name: str,
                ctx=None, spec=None):
    """x: (B, S, d), the local batch shard on a mesh.  Returns (y, stats)
    where stats = {'aux_loss', 'expert_counts'}.

    On a mesh (``ctx``, a ``sharding.MeshCtx``; ``spec``, the block's MoE
    specs) ``params`` holds the router and shared expert gathered over the
    data axis (the shared expert's hidden columns the rank's, where its
    spec splits them over the model axis) and this rank's shards of the
    expert weights, which are gathered here over the data axis only;
    every model rank's expert output is summed over the model axis, the
    counts over the batch axes, and the aux loss averaged over them."""
    b, s, d = x.shape
    if ctx is None:
        out, aux, counts = local_moe(
            params["router"], params["w_gate"], params["w_up"],
            params["w_down"], x, cfg=cfg, act_name=act_name)
    else:
        mesh, model = ctx.mesh, ctx.axes.model
        m_size = sharding.axis_size(mesh, model)
        m_rank = sharding.axis_rank(mesh, model)
        w = [ctx.gather(params[n], spec[n], only=(ctx.axes.data,))
             for n in EXPERT_LEAVES]
        if m_size > 1 and model not in (spec["w_gate"][0],):
            # experts replicated over the model axis: take this rank's
            e_loc = cfg.num_experts // m_size
            w = [t[m_rank * e_loc:(m_rank + 1) * e_loc] for t in w]
        out, aux, counts = local_moe(
            params["router"], *w, x, cfg=cfg, act_name=act_name,
            model_rank=m_rank, model_size=m_size,
            enter=lambda t: sharding.fan_in(t, mesh, (model,)))
        out = sharding.psum(out, mesh, (model,))
        counts = sharding.all_reduce_(counts, mesh, ctx.reduce_axes)
        n = ctx.batch_ranks
        if n > 1:
            aux = sharding.psum(aux, mesh, ctx.reduce_axes) / n
    y = out.reshape(b, s, d).to(x.dtype)
    if cfg.num_shared_experts:
        # the shared expert is a dense MLP, split over the model axis as
        # its spec says, with its own sum (the experts' is above)
        tp = None if ctx is None else ctx.model_axis(
            spec["shared"]["w_down"][0])
        y = y + mlp_forward(params["shared"], x, act_name, tp=tp)
    return y, {"aux_loss": aux, "expert_counts": counts}
