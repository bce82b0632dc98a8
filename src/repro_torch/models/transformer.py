"""Decoder-only LM assembly, after the JAX package's ``models/transformer.py``.

Parameters are plain dicts: ``{"embed", "blocks": [one dict per layer],
"final_norm"[, "lm_head"]}``.  Layer ``l`` has kind
``cfg.layer_kinds()[l]``; a Python loop over the blocks replaces the
reference's ``lax.scan`` over stacked periods and its unrolled tail
(``convert.lm_params_from_reference`` un-stacks a reference tree into this
layout).  Serving state is one dict per layer, as the reference's
``_pack_cache`` makes it: ``{"k", "v"}`` (B, S, Hkv, hd) for the attention
and MoE blocks, ``{"wkv", "tm_shift", "cm_shift"}`` for ``rwkv6`` (the
(B, H, hd, hd) WKV state and the two token-shift carries), ``{"h",
"conv"}`` for ``rglru`` (the recurrence's h and the conv tail).

Ported here: the ``attn``, ``local_attn``, ``moe``, ``rwkv6`` and
``rglru`` blocks, the training loss (:func:`lm_loss`, with ``cfg.remat``
around each period of the block pattern), prefill and decode.  Not yet: the
ring KV cache (ROADMAP queue 1, item 7.1), the encoder-decoder and the
vision front end (item 7.5).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.configs.base import (BLOCK_ATTN, BLOCK_LOCAL, BLOCK_MOE,
                                      BLOCK_REC, BLOCK_RWKV, ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import rwkv6 as rwkv_lib
from repro_torch.models.layers import (dense_init, init_mlp, mlp_forward,
                                       rms_norm, softcap)

_ATTN_KINDS = (BLOCK_ATTN, BLOCK_LOCAL, BLOCK_MOE)
_KINDS = _ATTN_KINDS + (BLOCK_RWKV, BLOCK_REC)


def _check_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise ValueError(kind)


def check_config(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run."""
    if cfg.arch_type == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder is not ported yet (ROADMAP "
            "queue 1, item 7.5)")
    if cfg.frontend == "vision":
        raise NotImplementedError(
            f"{cfg.name}: the vision front end is not ported yet (ROADMAP "
            "queue 1, item 7.5)")
    if cfg.window_kv_cache:
        raise NotImplementedError(
            f"{cfg.name}: the ring KV cache (window_kv_cache) is not ported "
            "yet (ROADMAP queue 1, item 7.1)")
    for kind in set(cfg.layer_kinds()):
        _check_kind(kind)


# ---------------------------------------------------------------------- init
def init_block(gen, kind: str, cfg: ModelConfig, dtype=torch.bfloat16,
               device="cuda") -> Dict[str, Any]:
    _check_kind(kind)
    f32 = dict(dtype=torch.float32, device=device)
    kw = dict(dtype=dtype, device=device)
    p: Dict[str, Any] = {
        "norm_attn": torch.zeros((cfg.d_model,), **f32),
        "norm_mlp": torch.zeros((cfg.d_model,), **f32),
    }
    if kind in _ATTN_KINDS:
        p["attn"] = attn.init_attention(gen, cfg, **kw)
    if kind == BLOCK_MOE:
        p["moe"] = moe_lib.init_moe(gen, cfg, **kw)
    elif kind == BLOCK_RWKV:
        p["time_mix"] = rwkv_lib.init_time_mix(gen, cfg, **kw)
        p["channel_mix"] = rwkv_lib.init_channel_mix(gen, cfg, **kw)
    elif kind == BLOCK_REC:
        p["rec"] = rglru_lib.init_rglru_block(gen, cfg, **kw)
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, **kw)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, **kw)
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
    """One block, full-sequence.  Returns (x, stats, cache_or_None), the
    cache packed as ``block_decode`` takes it."""
    _check_kind(kind)
    stats = {}
    h = rms_norm(x, p["norm_attn"], cfg.norm_eps)
    if kind == BLOCK_RWKV:
        y, (wkv, tm_last) = rwkv_lib.time_mix_forward(p["time_mix"], h, cfg)
        x = x + y
        h = rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        y, cm_last = rwkv_lib.channel_mix_forward(p["channel_mix"], h)
        cache = {"wkv": wkv, "tm_shift": tm_last, "cm_shift": cm_last}
    elif kind == BLOCK_REC:
        y, (h_last, tail) = rglru_lib.rglru_block_forward(p["rec"], h, cfg)
        x = x + y
        h = rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        y = mlp_forward(p["mlp"], h, cfg.act)
        cache = {"h": h_last, "conv": tail}
    else:
        mask_kind = "local" if kind == BLOCK_LOCAL else "causal"
        a, k_c, v_c = attn.attention_forward_kv(
            p["attn"], h, cfg, mask_kind=mask_kind, positions=positions)
        x = x + a
        h = rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        if kind == BLOCK_MOE:
            y, stats = moe_lib.moe_forward(p["moe"], h, cfg, cfg.act)
        else:
            y = mlp_forward(p["mlp"], h, cfg.act)
        cache = {"k": k_c, "v": v_c}
    return x + y, stats, (cache if return_kv else None)


def block_decode(p, kind: str, x, cache, pos: int, cfg: ModelConfig):
    """One block, one-token decode; a K/V cache is updated in place, the
    recurrent state is replaced.  Returns (x, cache)."""
    _check_kind(kind)
    h = rms_norm(x, p["norm_attn"], cfg.norm_eps)
    if kind == BLOCK_RWKV:
        y, (wkv, tm_last) = rwkv_lib.time_mix_step(
            p["time_mix"], h, cache["wkv"], cache["tm_shift"], cfg)
        x = x + y
        h = rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        y, cm_last = rwkv_lib.channel_mix_forward(p["channel_mix"], h,
                                                  prev_x=cache["cm_shift"])
        return x + y, {"wkv": wkv, "tm_shift": tm_last, "cm_shift": cm_last}
    if kind == BLOCK_REC:
        y, (h_last, tail) = rglru_lib.rglru_block_forward(
            p["rec"], h, cfg, state=(cache["h"], cache["conv"]))
        x = x + y
        h = rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        return x + mlp_forward(p["mlp"], h, cfg.act), {"h": h_last,
                                                        "conv": tail}
    mask_kind = "local" if kind == BLOCK_LOCAL else "causal"
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


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of matrix products without
    batch dimensions (as ``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable`` keeps dot_generals), recompute the
    rest."""
    policy = torch_checkpoint.CheckpointPolicy
    return policy.MUST_SAVE if op in _DOTS else policy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` as the reference's ``_remat`` wraps a period: recomputed in the
    backward pass (``cfg.remat``, policy ``"full"``), with the matrix
    products kept (``"dots"``), or stored whole (``"none"`` or
    ``remat=False``).  Every policy gives the same values and gradients."""
    if not cfg.remat or cfg.remat_policy == "none":
        return fn
    kw = dict(use_reentrant=False)
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat_policy != "full":
        raise ValueError(f"remat_policy {cfg.remat_policy!r}")
    return lambda *args: torch_checkpoint.checkpoint(fn, *args, **kw)


def run_stack(params, x, positions, cfg: ModelConfig,
              collect_cache: bool = False):
    """All blocks in order.  Returns (x, stats, caches).

    Stats as the reference's scan gives them: the aux loss summed over
    layers, the expert counts one row per period of the block pattern
    (summed over the period's blocks), the tail's added to every row.
    Under autograd (and not collecting caches) each period runs through
    :func:`_remat`, as the reference's scan body does; the tail does not."""
    kinds = cfg.layer_kinds()
    period = cfg.pattern_period
    n_periods = len(kinds) // period
    blocks = params["blocks"]
    caches: List[Dict[str, torch.Tensor]] = []

    def period_fn(x, i):
        sts = []
        for j in range(i * period, (i + 1) * period):
            x, st, cache = block_train(blocks[j], kinds[j], x, positions, cfg,
                                       return_kv=collect_cache)
            sts.append(st)
            if collect_cache:
                caches.append(cache)
        return x, _merge_stats(sts)

    body = period_fn
    if torch.is_grad_enabled() and not collect_cache:
        body = _remat(period_fn, cfg)
    merged = []
    for i in range(n_periods):
        x, st = body(x, i)
        merged.append(st)
    tail_stats = []
    for j in range(n_periods * period, len(kinds)):
        x, st, cache = block_train(blocks[j], kinds[j], x, positions, cfg,
                                   return_kv=collect_cache)
        tail_stats.append(st)
        if collect_cache:
            caches.append(cache)
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


# -------------------------------------------------------------------- losses
def _ce_piece(x, targets, table, cfg: ModelConfig):
    """(nll_sum, token_count) over one sequence piece; the label logit is a
    gather of the head's columns, no one-hot."""
    logits = torch.einsum("bsd,dv->bsv", x, table).to(torch.float32)
    logits = softcap(logits, cfg.final_softcap)
    lse = torch.logsumexp(logits, dim=-1)                    # (B, S)
    mask = targets >= 0
    lbl_w = table[:, torch.clamp_min(targets, 0)]            # (d, B, S)
    lbl_logit = torch.einsum("bsd,dbs->bs", x, lbl_w).to(torch.float32)
    lbl_logit = softcap(lbl_logit, cfg.final_softcap)
    nll = (lse - lbl_logit) * mask
    return nll.sum(), mask.sum()


def masked_cross_entropy(params, x, targets, cfg: ModelConfig):
    """CE over the vocab without a one-hot: logsumexp - label logit, over
    the tokens whose target is >= 0.  Returns (mean nll, token count).

    With cfg.ce_chunk > 0 the sequence is processed in chunks, so the f32
    (B, chunk, V) logits tile replaces the full (B, S, V) one."""
    table = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    s = x.shape[1]
    if cfg.ce_chunk and s > cfg.ce_chunk:
        pieces = [_ce_piece(x[:, lo:lo + cfg.ce_chunk],
                            targets[:, lo:lo + cfg.ce_chunk], table, cfg)
                  for lo in range(0, s, cfg.ce_chunk)]
        nll = functools.reduce(torch.add, (p[0] for p in pieces))
        cnt = functools.reduce(torch.add, (p[1] for p in pieces))
    else:
        nll, cnt = _ce_piece(x, targets, table, cfg)
    denom = torch.clamp_min(cnt, 1)
    return nll / denom, denom


def lm_loss(params, batch, cfg: ModelConfig):
    """The training loss: (loss, metrics), metrics ``ce_loss``, ``tokens``
    and, for MoE, ``moe_aux_loss`` and ``expert_counts`` (periods, E); the
    loss adds 0.01 of the aux loss to the cross-entropy, as the reference.
    ``batch``: ``tokens`` and ``targets`` (B, S) integer tensors on the
    params' device."""
    x, positions = lm_inputs(params, batch, cfg)
    x, stats, _ = run_stack(params, x, positions, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    loss, denom = masked_cross_entropy(params, x, batch["targets"], cfg)
    metrics = {"ce_loss": loss, "tokens": denom}
    if "aux_loss" in stats:
        metrics["moe_aux_loss"] = stats["aux_loss"]
        metrics["expert_counts"] = stats["expert_counts"]
        loss = loss + 0.01 * stats["aux_loss"]
    return loss, metrics


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
