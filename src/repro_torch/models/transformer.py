"""Decoder-only LM assembly for the attention and MoE block kinds, after the
JAX package's ``models/transformer.py``.

Parameters are plain dicts: ``{"embed", "blocks": [one dict per layer],
"final_norm"[, "lm_head"]}``.  Layer ``l`` has kind
``cfg.layer_kinds()[l]``; a Python loop over the blocks replaces the
reference's ``lax.scan`` over stacked periods and its unrolled tail
(``convert.lm_params_from_reference`` un-stacks a reference tree into this
layout).  Serving state is one ``{"k", "v"}`` KV cache per layer, (B, S,
Hkv, hd) each.

Ported here: ``attn``, ``local_attn`` and ``moe`` blocks, prefill and
decode.  Not yet: the ``rwkv6`` and ``rglru`` blocks (ROADMAP queue 2,
items 5-6), the encoder-decoder and the vision front end, and the training
loss (ROADMAP queue 1, item 11).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.configs.base import (BLOCK_ATTN, BLOCK_LOCAL, BLOCK_MOE,
                                      BLOCK_REC, BLOCK_RWKV, ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (dense_init, init_mlp, mlp_forward,
                                       rms_norm, softcap)

_ATTN_KINDS = (BLOCK_ATTN, BLOCK_LOCAL, BLOCK_MOE)
_NOT_PORTED = {
    BLOCK_RWKV: "the rwkv6 block is not ported yet (ROADMAP queue 2, item 5: "
                "rwkv6-7b serving with the wkv6 kernel)",
    BLOCK_REC: "the rglru block is not ported yet (ROADMAP queue 2, item 6: "
               "recurrentgemma-9b with the rglru kernel)",
}


def _check_kind(kind: str) -> None:
    if kind in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[kind])
    if kind not in _ATTN_KINDS:
        raise ValueError(kind)


def check_config(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run."""
    if cfg.arch_type == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder is not ported yet (ROADMAP "
            "queue 1, item 11)")
    if cfg.frontend == "vision":
        raise NotImplementedError(
            f"{cfg.name}: the vision front end is not ported yet (ROADMAP "
            "queue 1, item 11)")
    if cfg.window_kv_cache:
        raise NotImplementedError(
            f"{cfg.name}: the ring KV cache (window_kv_cache) is not ported "
            "yet (ROADMAP queue 1, item 11)")
    for kind in set(cfg.layer_kinds()):
        _check_kind(kind)


# ---------------------------------------------------------------------- init
def init_block(gen, kind: str, cfg: ModelConfig, dtype=torch.bfloat16,
               device="cuda") -> Dict[str, Any]:
    _check_kind(kind)
    p: Dict[str, Any] = {
        "norm_attn": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                 device=device),
        "norm_mlp": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                device=device),
        "attn": attn.init_attention(gen, cfg, dtype=dtype, device=device),
    }
    if kind == BLOCK_MOE:
        p["moe"] = moe_lib.init_moe(gen, cfg, dtype=dtype, device=device)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype=dtype,
                            device=device)
    return p


def init_lm(gen, cfg: ModelConfig, dtype=torch.bfloat16,
            device="cuda") -> Dict[str, Any]:
    """Full LM params, drawn from the generator ``gen`` (on ``device``); on
    the ``meta`` device, shapes and dtypes only (``gen`` may be None)."""
    check_config(cfg)
    params: Dict[str, Any] = {
        "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), in_axis=1,
                            dtype=dtype, device=device),
        "blocks": [init_block(gen, kind, cfg, dtype, device)
                   for kind in cfg.layer_kinds()],
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                       dtype=dtype, device=device)
    return params


# ------------------------------------------------------------------- forward
def block_train(p, kind: str, x, positions, cfg: ModelConfig,
                return_kv: bool = False):
    """One block, full-sequence.  Returns (x, stats, kv_or_None)."""
    _check_kind(kind)
    stats = {}
    mask_kind = "local" if kind == BLOCK_LOCAL else "causal"
    h = rms_norm(x, p["norm_attn"], cfg.norm_eps)
    a, k_c, v_c = attn.attention_forward_kv(
        p["attn"], h, cfg, mask_kind=mask_kind, positions=positions)
    x = x + a
    h = rms_norm(x, p["norm_mlp"], cfg.norm_eps)
    if kind == BLOCK_MOE:
        y, stats = moe_lib.moe_forward(p["moe"], h, cfg, cfg.act)
    else:
        y = mlp_forward(p["mlp"], h, cfg.act)
    return x + y, stats, ((k_c, v_c) if return_kv else None)


def block_decode(p, kind: str, x, cache, pos: int, cfg: ModelConfig):
    """One block, one-token decode; ``cache`` ({"k", "v"}) is updated in
    place.  Returns (x, cache)."""
    _check_kind(kind)
    mask_kind = "local" if kind == BLOCK_LOCAL else "causal"
    h = rms_norm(x, p["norm_attn"], cfg.norm_eps)
    a, ck, cv = attn.attention_decode(p["attn"], h, cache["k"], cache["v"],
                                      pos, cfg, mask_kind=mask_kind)
    x = x + a
    h = rms_norm(x, p["norm_mlp"], cfg.norm_eps)
    if kind == BLOCK_MOE:
        y, _ = moe_lib.moe_forward(p["moe"], h, cfg, cfg.act)
    else:
        y = mlp_forward(p["mlp"], h, cfg.act)
    return x + y, {"k": ck, "v": cv}


def _merge_stats(stats_list):
    out: Dict[str, Any] = {}
    for st in stats_list:
        for k, v in st.items():
            out[k] = out[k] + v if k in out else v
    return out


def run_stack(params, x, positions, cfg: ModelConfig,
              collect_cache: bool = False):
    """All blocks in order.  Returns (x, stats, caches).

    Stats as the reference's scan gives them: the aux loss summed over
    layers, the expert counts one row per period of the block pattern
    (summed over the period's blocks), the tail's added to every row."""
    kinds = cfg.layer_kinds()
    period = cfg.pattern_period
    n_periods = len(kinds) // period
    caches: List[Dict[str, torch.Tensor]] = []
    per_period, tail_stats = [], []
    for i, (p, kind) in enumerate(zip(params["blocks"], kinds)):
        x, st, kv = block_train(p, kind, x, positions, cfg,
                                return_kv=collect_cache)
        if i < n_periods * period:
            if i % period == 0:
                per_period.append([])
            per_period[-1].append(st)
        else:
            tail_stats.append(st)
        if collect_cache:
            caches.append({"k": kv[0], "v": kv[1]})
    merged = [_merge_stats(sts) for sts in per_period]
    stats: Dict[str, Any] = {}
    if merged and "aux_loss" in merged[0]:
        stats = {"aux_loss": torch.stack([m["aux_loss"] for m in merged]).sum(),
                 "expert_counts": torch.stack(
                     [m["expert_counts"] for m in merged])}
    stats = _merge_stats([stats] + tail_stats)
    return x, stats, caches


# ----------------------------------------------------------------- embedding
def embed_tokens(params, tokens, cfg: ModelConfig):
    x = params["embed"][tokens]
    if cfg.tie_embeddings:
        scale = torch.sqrt(torch.tensor(float(cfg.d_model),
                                        dtype=torch.float32))
        x = x * scale.to(x.dtype).to(x.device)
    return x


def unembed(params, x, cfg: ModelConfig):
    table = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.einsum("bsd,dv->bsv", x, table).to(torch.float32)
    return softcap(logits, cfg.final_softcap)


def lm_inputs(params, batch, cfg: ModelConfig):
    """Token embedding -> (x, positions)."""
    check_config(cfg)
    x = embed_tokens(params, batch["tokens"], cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    return x, positions


# ------------------------------------------------------------------- serving
def lm_prefill(params, batch, cfg: ModelConfig):
    """Prompt pass: returns (caches, last-position logits (B, 1, V) f32)."""
    x, positions = lm_inputs(params, batch, cfg)
    x, _, caches = run_stack(params, x, positions, cfg, collect_cache=True)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return caches, unembed(params, x[:, -1:], cfg)


def lm_decode(params, caches, token, pos: int, cfg: ModelConfig):
    """One-token decode.  token: (B, 1) integer; pos: int.  The caches are
    updated in place and returned with the logits (B, 1, V) f32."""
    x = embed_tokens(params, token, cfg)
    new = []
    for p, kind, cache in zip(params["blocks"], cfg.layer_kinds(), caches,
                              strict=True):
        x, c = block_decode(p, kind, x, cache, pos, cfg)
        new.append(c)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return new, unembed(params, x, cfg)
