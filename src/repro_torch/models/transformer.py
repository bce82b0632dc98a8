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
``rglru`` blocks, the vision front end's stub (``media_embed`` prepended to
the token embeddings), the training loss (:func:`lm_loss`, with
``cfg.remat`` around each period of the block pattern), prefill and decode,
with a ring cache for the local layers under ``cfg.window_kv_cache``.  The
encoder-decoder is ``models/encdec.py``.

On a mesh (``ctx``, a ``sharding.MeshCtx``) every function takes the local
batch shard and the parameters' local shards, and computes as the
reference's GSPMD layout does: each block gathers its dense leaves over the
data axis only (:func:`gather_block`) and splits its dense products over
the model axis where their specs do (:func:`tp_of`: attention heads, MLP
hidden columns, RWKV6 heads, RG-LRU channels; ``sharding.ModelAxis``),
the MoE block takes its local expert shards (``moe.moe_forward``); the
embedding is a vocab-parallel lookup, the loss a vocab-parallel
cross-entropy (the max and the sum of exponentials reduced over the model
axis), and the served logits are the rank's vocabulary columns gathered
once a step.  The loss sums its token counts and NLL over the batch axes.
Decode gathers each cache leaf by the layout the caches carry
(``sharding.LocalCaches``) at use, but for the recurrent state that the
rank computes itself (:func:`state_in_place`), and keeps its shard of the
result.  Where the reference pins the activations' layout
(``Ctx.bconstrain``), the port's activations are the local batch shard by
construction.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch import sharding
from repro_torch.configs.base import (BLOCK_ATTN, BLOCK_LOCAL, BLOCK_MOE,
                                      BLOCK_REC, BLOCK_RWKV, ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import rwkv6 as rwkv_lib
from repro_torch.models.layers import (dense_init, init_mlp, mlp_axes,
                                       mlp_forward, rms_norm, softcap)

_ATTN_KINDS = (BLOCK_ATTN, BLOCK_LOCAL, BLOCK_MOE)
_KINDS = _ATTN_KINDS + (BLOCK_RWKV, BLOCK_REC)


def _check_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise ValueError(kind)


def check_config(cfg: ModelConfig) -> None:
    """Raise for a block kind the port does not know."""
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


def block_axes(kind: str, cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of :func:`init_block`'s leaves."""
    _check_kind(kind)
    axes: Dict[str, Any] = {"norm_attn": ("embed",), "norm_mlp": ("embed",)}
    if kind in _ATTN_KINDS:
        axes["attn"] = attn.attention_axes()
    if kind == BLOCK_MOE:
        axes["moe"] = moe_lib.moe_axes(cfg)
    elif kind == BLOCK_RWKV:
        axes["time_mix"] = rwkv_lib.time_mix_axes(cfg)
        axes["channel_mix"] = rwkv_lib.channel_mix_axes()
    elif kind == BLOCK_REC:
        axes["rec"] = rglru_lib.rglru_axes(cfg)
        axes["mlp"] = mlp_axes()
    else:
        axes["mlp"] = mlp_axes()
    return axes


def lm_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of :func:`init_lm`'s leaves, leaf for leaf: the
    reference's ``LP`` axes (a scan leaf's without its leading
    ``"layers"``, which maps to no mesh axis)."""
    axes: Dict[str, Any] = {
        "embed": ("vocab", "embed"),
        "blocks": [block_axes(kind, cfg) for kind in cfg.layer_kinds()],
        "final_norm": ("embed",),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def _placed(place, tree, axes):
    return tree if place is None else place(tree, axes)


def init_lm(gen, cfg: ModelConfig, dtype=torch.bfloat16,
            device="cuda", place=None) -> Dict[str, Any]:
    """Full LM params, drawn from the generator ``gen`` (on ``device``); on
    the ``meta`` device, shapes and dtypes only (``gen`` may be None).
    ``place(subtree, axes)``, when given, maps each top-level leaf and
    each block to what is kept (a mesh rank's shards) as soon as it is
    drawn, so that one block at a time is whole."""
    check_config(cfg)
    axes = lm_axes(cfg)
    params: Dict[str, Any] = {
        "embed": _placed(place, dense_init(
            gen, (cfg.vocab_size, cfg.d_model), in_axis=1, dtype=dtype,
            device=device), axes["embed"]),
        "blocks": [_placed(place, init_block(gen, kind, cfg, dtype, device),
                           ax)
                   for kind, ax in zip(cfg.layer_kinds(), axes["blocks"])],
        "final_norm": _placed(place, torch.zeros(
            (cfg.d_model,), dtype=torch.float32, device=device),
            axes["final_norm"]),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _placed(place, dense_init(
            gen, (cfg.d_model, cfg.vocab_size), dtype=dtype, device=device),
            axes["lm_head"])
    return params


def gather_block(p, spec, ctx):
    """A block's leaves gathered over the data axis at use on a mesh (each
    keeps its model-axis shard), but the MoE experts' weights, which
    ``moe_forward`` gathers itself."""
    if ctx is None:
        return p
    out = {k: ctx.gather_tree(v, spec[k]) for k, v in p.items()
           if k != "moe"}
    if "moe" in p:
        out["moe"] = {k: v if k in moe_lib.EXPERT_LEAVES
                      else ctx.gather_tree(v, spec["moe"][k])
                      for k, v in p["moe"].items()}
    return out


# the leaf (and its dimension) whose spec says whether a sub-layer's dense
# products are split over the model axis
_SPLIT_BY = {"attn": ("w_q", 1), "self_attn": ("w_q", 1),
             "cross_attn": ("w_q", 1), "mlp": ("w_down", 0),
             "time_mix": ("w_o", 0), "channel_mix": ("w_v", 0),
             "rec": ("w_out", 0)}


def tp_of(ctx, spec, sub: str):
    """The ``sharding.ModelAxis`` that sub-layer ``sub`` of a block (specs
    ``spec``) splits its dense products over, or None: no mesh, a model
    axis of one rank, or a leaf that its spec leaves whole there."""
    if ctx is None:
        return None
    leaf, dim = _SPLIT_BY[sub]
    return ctx.model_axis(spec[sub][leaf][dim])


def state_in_place(kind: str, spec, ctx):
    """The recurrent state keys of a ``kind`` layer (specs ``spec``)
    that a rank computes for its own heads or channels and so keeps in
    place: RWKV6's WKV state, the RG-LRU's h and conv tail, where the
    block's products are split over the model axis.  The token-shift
    carries feed the whole-width mixes, so they are gathered."""
    if kind == BLOCK_RWKV and tp_of(ctx, spec, "time_mix") is not None:
        return ("wkv",)
    if kind == BLOCK_REC and tp_of(ctx, spec, "rec") is not None:
        return ("h", "conv")
    return ()


# ------------------------------------------------------------------- forward
def block_train(p, kind: str, x, positions, cfg: ModelConfig,
                return_kv: bool = False, ctx=None, spec=None):
    """One block, full-sequence.  Returns (x, stats, cache_or_None), the
    cache packed as ``block_decode`` takes it.  On a mesh ``p`` holds the
    block's local shards and ``spec`` their specs."""
    _check_kind(kind)
    p = gather_block(p, spec, ctx)
    stats = {}
    h = rms_norm(x, p["norm_attn"], cfg.norm_eps)
    if kind == BLOCK_RWKV:
        y, (wkv, tm_last) = rwkv_lib.time_mix_forward(
            p["time_mix"], h, cfg, tp=tp_of(ctx, spec, "time_mix"))
        x = x + y
        h = rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        y, cm_last = rwkv_lib.channel_mix_forward(
            p["channel_mix"], h, tp=tp_of(ctx, spec, "channel_mix"))
        cache = {"wkv": wkv, "tm_shift": tm_last, "cm_shift": cm_last}
    elif kind == BLOCK_REC:
        y, (h_last, tail) = rglru_lib.rglru_block_forward(
            p["rec"], h, cfg, tp=tp_of(ctx, spec, "rec"))
        x = x + y
        h = rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        y = mlp_forward(p["mlp"], h, cfg.act, tp=tp_of(ctx, spec, "mlp"))
        cache = {"h": h_last, "conv": tail}
    else:
        mask_kind = "local" if kind == BLOCK_LOCAL else "causal"
        tp = tp_of(ctx, spec, "attn")
        a, k_c, v_c = attn.attention_forward_kv(
            p["attn"], h, cfg, mask_kind=mask_kind, positions=positions,
            tp=tp)
        x = x + a
        h = rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        if kind == BLOCK_MOE:
            y, stats = moe_lib.moe_forward(
                p["moe"], h, cfg, cfg.act, ctx=ctx,
                spec=None if ctx is None else spec["moe"])
        else:
            y = mlp_forward(p["mlp"], h, cfg.act,
                            tp=tp_of(ctx, spec, "mlp"))
        if return_kv:                   # the caches hold every kv head
            k_c, v_c = (attn.whole_kv_heads(t, cfg, tp) for t in (k_c, v_c))
        cache = {"k": k_c, "v": v_c}
    return x + y, stats, (cache if return_kv else None)


def block_decode(p, kind: str, x, cache, pos: int, cfg: ModelConfig,
                 ctx=None, spec=None):
    """One block, one-token decode; a K/V cache is updated in place (a ring
    for a local layer under ``cfg.window_kv_cache``), the recurrent state is
    replaced.  Returns (x, cache)."""
    _check_kind(kind)
    p = gather_block(p, spec, ctx)
    h = rms_norm(x, p["norm_attn"], cfg.norm_eps)
    if kind == BLOCK_RWKV:
        y, (wkv, tm_last) = rwkv_lib.time_mix_step(
            p["time_mix"], h, cache["wkv"], cache["tm_shift"], cfg,
            tp=tp_of(ctx, spec, "time_mix"))
        x = x + y
        h = rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        y, cm_last = rwkv_lib.channel_mix_forward(
            p["channel_mix"], h, prev_x=cache["cm_shift"],
            tp=tp_of(ctx, spec, "channel_mix"))
        return x + y, {"wkv": wkv, "tm_shift": tm_last, "cm_shift": cm_last}
    if kind == BLOCK_REC:
        y, (h_last, tail) = rglru_lib.rglru_block_forward(
            p["rec"], h, cfg, state=(cache["h"], cache["conv"]),
            tp=tp_of(ctx, spec, "rec"))
        x = x + y
        h = rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        return x + mlp_forward(p["mlp"], h, cfg.act,
                               tp=tp_of(ctx, spec, "mlp")), {"h": h_last,
                                                             "conv": tail}
    mask_kind = "local" if kind == BLOCK_LOCAL else "causal"
    ring = kind == BLOCK_LOCAL and cfg.window_kv_cache
    a, ck, cv = attn.attention_decode(p["attn"], h, cache["k"], cache["v"],
                                      pos, cfg, mask_kind=mask_kind,
                                      ring=ring, tp=tp_of(ctx, spec, "attn"))
    x = x + a
    h = rms_norm(x, p["norm_mlp"], cfg.norm_eps)
    if kind == BLOCK_MOE:
        y, _ = moe_lib.moe_forward(p["moe"], h, cfg, cfg.act, ctx=ctx,
                                   spec=None if ctx is None else spec["moe"])
    else:
        y = mlp_forward(p["mlp"], h, cfg.act, tp=tp_of(ctx, spec, "mlp"))
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
              collect_cache: bool = False, ctx=None):
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
    specs = [None] * len(kinds) if ctx is None else ctx.specs["blocks"]
    caches: List[Dict[str, torch.Tensor]] = []

    def period_fn(x, i):
        sts = []
        for j in range(i * period, (i + 1) * period):
            x, st, cache = block_train(blocks[j], kinds[j], x, positions, cfg,
                                       return_kv=collect_cache, ctx=ctx,
                                       spec=specs[j])
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
                                   return_kv=collect_cache, ctx=ctx,
                                   spec=specs[j])
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
def _leaf(params, name: str, ctx):
    """A top-level leaf, gathered over the data axis on a mesh (its
    model-axis shard, the rank's vocabulary rows, stays)."""
    t = params[name]
    return t if ctx is None else ctx.gather_local(t, ctx.specs[name])


def _head(params, cfg: ModelConfig, ctx):
    """(the output head (d, V) or its rank's vocabulary columns, the
    ``sharding.ModelAxis`` the vocabulary is split over or None)."""
    if cfg.tie_embeddings:
        tp = None if ctx is None else ctx.model_axis(ctx.specs["embed"][0])
        return _leaf(params, "embed", ctx).T, tp
    tp = None if ctx is None else ctx.model_axis(ctx.specs["lm_head"][1])
    return _leaf(params, "lm_head", ctx), tp


def _rank_rows(ids, n: int, tp):
    """(ids as rows of the rank's n vocabulary entries, clamped into
    range; whether each id is the rank's)."""
    local = ids - tp.start(n)
    inside = (local >= 0) & (local < n)
    return torch.clamp(local, 0, n - 1), inside


def embed_tokens(params, tokens, cfg: ModelConfig, ctx=None):
    """Token embeddings (times sqrt(d) for a tied head).  With the
    vocabulary split over the model axis each rank looks up its rows,
    zero elsewhere, and the ranks' rows are summed."""
    table = _leaf(params, "embed", ctx)
    tp = None if ctx is None else ctx.model_axis(ctx.specs["embed"][0])
    if tp is None:
        x = table[tokens]
    else:
        rows, inside = _rank_rows(tokens, table.shape[0], tp)
        x = tp.sum(torch.where(inside[..., None], table[rows], 0))
    if cfg.tie_embeddings:
        scale = torch.sqrt(torch.tensor(float(cfg.d_model),
                                        dtype=torch.float32))
        x = x * scale.to(x.dtype).to(x.device)
    return x


def head_logits(x, table, cfg: ModelConfig, tp=None):
    """Logits (float32, soft-capped) of ``x`` on the output head
    ``table`` (d, V); with ``tp`` ``table`` holds the rank's vocabulary
    columns and their logits are gathered, the whole logits on every
    rank."""
    if tp is not None:
        x = tp.enter(x)
    logits = torch.einsum("bsd,dv->bsv", x, table).to(torch.float32)
    logits = softcap(logits, cfg.final_softcap)
    return logits if tp is None else tp.gather(logits, -1)


def unembed(params, x, cfg: ModelConfig, ctx=None):
    """Logits (float32, soft-capped), computed vocab-parallel where the
    head's spec splits the vocabulary over the model axis."""
    table, tp = _head(params, cfg, ctx)
    return head_logits(x, table, cfg, tp)


def lm_inputs(params, batch, cfg: ModelConfig, ctx=None):
    """Token embedding (after the stub vision front end's ``media_embed``
    (B, P_media, d), cast to the embeddings' dtype, where the config has
    one) -> (x, positions), positions running over media and text."""
    check_config(cfg)
    x = embed_tokens(params, batch["tokens"], cfg, ctx)
    if cfg.frontend == "vision" and "media_embed" in batch:
        media = batch["media_embed"].to(device=x.device, dtype=x.dtype)
        x = torch.cat([media, x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    return x, positions


# -------------------------------------------------------------------- losses
def _ce_piece(x, targets, table, cfg: ModelConfig, tp=None):
    """(nll_sum, token_count) over one sequence piece; the label logit is a
    gather of the head's columns, no one-hot.  With ``tp`` ``table`` holds
    the rank's vocabulary columns: the logits' max and their exponentials'
    sum are reduced over the model axis, and the label's logit comes from
    the rank that holds the label."""
    logits = torch.einsum("bsd,dv->bsv", x, table).to(torch.float32)
    logits = softcap(logits, cfg.final_softcap)
    mask = targets >= 0
    if tp is None:
        lse = torch.logsumexp(logits, dim=-1)                # (B, S)
        lbl_w = table[:, torch.clamp_min(targets, 0)]        # (d, B, S)
        lbl = torch.einsum("bsd,dbs->bs", x, lbl_w).to(torch.float32)
    else:
        top = tp.max(logits.amax(-1))
        lse = top + torch.log(tp.sum(
            torch.exp(logits - top[..., None]).sum(-1)))
        cols, inside = _rank_rows(targets, table.shape[1], tp)
        lbl = torch.einsum("bsd,dbs->bs", x, table[:, cols]).to(
            torch.float32)
        lbl = tp.sum(torch.where(inside & mask, lbl, 0))
    lbl_logit = softcap(lbl, cfg.final_softcap)
    nll = (lse - lbl_logit) * mask
    return nll.sum(), mask.sum()


def head_nll(x, targets, table, cfg: ModelConfig, tp=None):
    """(nll_sum, token_count) of ``x`` on the output head ``table`` (the
    rank's vocabulary columns with ``tp``), over the tokens whose target
    is >= 0; with cfg.ce_chunk > 0 the sequence is processed in chunks, so
    the f32 (B, chunk, V) logits tile replaces the full (B, S, V) one."""
    if tp is not None:
        x = tp.enter(x)
    s = x.shape[1]
    if cfg.ce_chunk and s > cfg.ce_chunk:
        pieces = [_ce_piece(x[:, lo:lo + cfg.ce_chunk],
                            targets[:, lo:lo + cfg.ce_chunk], table, cfg, tp)
                  for lo in range(0, s, cfg.ce_chunk)]
        nll = functools.reduce(torch.add, (p[0] for p in pieces))
        cnt = functools.reduce(torch.add, (p[1] for p in pieces))
        return nll, cnt
    return _ce_piece(x, targets, table, cfg, tp)


def masked_cross_entropy(params, x, targets, cfg: ModelConfig, ctx=None):
    """CE over the vocab without a one-hot: logsumexp - label logit, over
    the tokens whose target is >= 0 (:func:`head_nll`).  Returns (mean
    nll, token count).

    On a mesh the vocabulary is split over the model axis where its spec
    does (:func:`_ce_piece`), the count is summed over the batch axes, and
    the mean is the global one: each rank's NLL over the global count,
    summed over the batch axes with an identity gradient."""
    table, tp = _head(params, cfg, ctx)
    nll, cnt = head_nll(x, targets, table, cfg, tp)
    if ctx is not None:
        cnt = sharding.all_reduce_(cnt.clone(), ctx.mesh, ctx.reduce_axes)
    denom = torch.clamp_min(cnt, 1)
    if ctx is not None:
        return sharding.psum(nll / denom, ctx.mesh, ctx.reduce_axes), denom
    return nll / denom, denom


def lm_loss(params, batch, cfg: ModelConfig, ctx=None):
    """The training loss: (loss, metrics), metrics ``ce_loss``, ``tokens``
    and, for MoE, ``moe_aux_loss`` and ``expert_counts`` (periods, E); the
    loss adds 0.01 of the aux loss to the cross-entropy, as the reference.
    ``batch``: ``tokens`` and ``targets`` (B, S) integer tensors on the
    params' device, and for the vision front end ``media_embed``, whose
    positions take no target (-1)."""
    x, positions = lm_inputs(params, batch, cfg, ctx)
    x, stats, _ = run_stack(params, x, positions, cfg, ctx=ctx)
    x = rms_norm(x, _leaf(params, "final_norm", ctx), cfg.norm_eps)
    targets = batch["targets"]
    if cfg.frontend == "vision" and "media_embed" in batch:
        pad = targets.new_full((targets.shape[0],
                                batch["media_embed"].shape[1]), -1)
        targets = torch.cat([pad, targets], dim=1)
    loss, denom = masked_cross_entropy(params, x, targets, cfg, ctx)
    metrics = {"ce_loss": loss, "tokens": denom}
    if "aux_loss" in stats:
        metrics["moe_aux_loss"] = stats["aux_loss"]
        metrics["expert_counts"] = stats["expert_counts"]
        loss = loss + 0.01 * stats["aux_loss"]
    return loss, metrics


# ------------------------------------------------------------------- serving
def lm_prefill(params, batch, cfg: ModelConfig, ctx=None):
    """Prompt pass: returns (caches, last-position logits (B, 1, V) f32).
    On a mesh the caches are the local batch's, whole along the sequence
    and over the kv heads, the recurrent state that
    :func:`state_in_place` names the rank's shard (``launch.serve`` lays
    them out)."""
    x, positions = lm_inputs(params, batch, cfg, ctx)
    x, _, caches = run_stack(params, x, positions, cfg, collect_cache=True,
                             ctx=ctx)
    x = rms_norm(x, _leaf(params, "final_norm", ctx), cfg.norm_eps)
    return caches, unembed(params, x[:, -1:], cfg, ctx)


def gathered_caches(caches, ctx, in_place=None):
    """Each cache leaf whole at use on a mesh, by the layout the caches
    carry (``sharding.LocalCaches``), but the keys that ``in_place`` (one
    tuple a layer, :func:`state_in_place`) names, which keep their
    model-axis shard: a rank's K/V caches then hold every kv head over the
    whole sequence (it reads its own heads), its recurrent state its own
    heads or channels.  The caches as they are otherwise."""
    specs = getattr(caches, "specs", None)
    if ctx is None or specs is None:
        return caches
    in_place = in_place or [()] * len(caches)
    return [{k: ctx.gather_local(v, spec[k]) if k in keep
             else ctx.gather(v, spec[k]) for k, v in c.items()}
            for c, spec, keep in zip(caches, specs, in_place, strict=True)]


def kept_caches(new, caches, ctx, in_place=None):
    """This rank's shards of the caches ``new`` (whole, but the keys
    ``in_place`` names, which are its shards already), laid out as
    ``caches`` (the decode's input) are."""
    specs = getattr(caches, "specs", None)
    if ctx is None or specs is None:
        return new
    in_place = in_place or [()] * len(new)
    return caches.like(
        [{k: v if k in keep else sharding.shard(v, ctx.mesh, spec[k])
          for k, v in c.items()}
         for c, spec, keep in zip(new, specs, in_place, strict=True)])


def lm_in_place(cfg: ModelConfig, ctx):
    """:func:`state_in_place` of every layer (empty without a mesh)."""
    if ctx is None:
        return None
    return [state_in_place(kind, spec, ctx)
            for kind, spec in zip(cfg.layer_kinds(), ctx.specs["blocks"],
                                  strict=True)]


def lm_decode(params, caches, token, pos: int, cfg: ModelConfig, ctx=None):
    """One-token decode.  token: (B, 1) integer; pos: int.  The caches are
    updated in place and returned with the logits (B, 1, V) f32."""
    x = embed_tokens(params, token, cfg, ctx)
    specs = [None] * cfg.num_layers if ctx is None else ctx.specs["blocks"]
    in_place = lm_in_place(cfg, ctx)
    new = []
    for p, kind, cache, spec in zip(params["blocks"], cfg.layer_kinds(),
                                    gathered_caches(caches, ctx, in_place),
                                    specs, strict=True):
        x, c = block_decode(p, kind, x, cache, pos, cfg, ctx=ctx, spec=spec)
        new.append(c)
    x = rms_norm(x, _leaf(params, "final_norm", ctx), cfg.norm_eps)
    return kept_caches(new, caches, ctx, in_place), unembed(params, x, cfg,
                                                            ctx)
