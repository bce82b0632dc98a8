"""Mixture-of-Experts FFN on one device, after the JAX package's
``models/moe.py``: the body of ``_local_moe`` with ``model_size = data_size
= 1`` (its ``shard_map``, the FSDP ``all_gather`` and the ``psum`` wait for
the sharding slice).

Tokens are routed top-k by an f32 router; each expert takes its
top-capacity tokens (static capacity: a dropped token is a zero-weight row)
into one (E, C, d) buffer, and the three expert products run as the expert
GEMM (``kernels/moe_gemm``: the CUDA kernel on the card, its plain torch
version on the CPU).  All experts are handled at once where the reference
loops over them; the result is the same, the f32 sums into ``out`` aside
(the card adds them in no set order).

Router statistics (tokens-per-expert) are returned as in the reference: they
are the task loads of the CCM load balancer's expert placement.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gemm import ops as gemm_ops
from repro_torch.models.layers import (activation, dense_init, init_mlp,
                                       mlp_forward)


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


def moe_forward(params, x: torch.Tensor, cfg: ModelConfig, act_name: str):
    """x: (B, S, d).  Returns (y, stats) where stats = {'aux_loss',
    'expert_counts'}."""
    b, s, d = x.shape
    t = b * s
    e = cfg.num_experts
    x_flat = x.reshape(t, d)
    probs, top_vals, top_idx = route(x_flat, params["router"], cfg.top_k)

    # each expert's top-capacity tokens by routing weight; a token routed
    # elsewhere weighs -1 and is an invalid (zero-weight) row if selected
    cap = _capacity(cfg, t)
    w_te = torch.zeros((t, e), dtype=torch.float32, device=x.device)
    w_te.scatter_(1, top_idx, top_vals)
    sel_w, sel_i = _top(torch.where(w_te > 0, w_te, -1.0).T, cap)  # (E, C)
    valid = (sel_w > 0).to(torch.float32)

    act = activation(act_name)
    xg = x_flat[sel_i]                                            # (E, C, d)
    g = act(gemm_ops.expert_gemm(xg, params["w_gate"]))
    u = gemm_ops.expert_gemm(xg, params["w_up"])
    h = gemm_ops.expert_gemm(g * u, params["w_down"]).to(torch.float32)
    h = h * (sel_w * valid)[..., None]
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    out.index_add_(0, sel_i.reshape(-1), h.reshape(-1, d))

    # router stats: tokens-per-expert counts + Switch-style aux loss
    f_frac = torch.bincount(top_idx[:, 0], minlength=e).to(torch.float32) / t
    aux = e * torch.sum(f_frac * probs.mean(0))
    counts = torch.bincount(top_idx.reshape(-1), minlength=e).to(
        torch.float32)
    y = out.reshape(b, s, d).to(x.dtype)
    if cfg.num_shared_experts:
        y = y + mlp_forward(params["shared"], x, act_name)
    return y, {"aux_loss": aux, "expert_counts": counts}
