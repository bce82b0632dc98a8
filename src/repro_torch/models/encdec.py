"""Encoder-decoder assembly (the whisper-large-v3 backbone), after the JAX
package's ``models/encdec.py``.

The audio front end is a stub, as in the reference: a batch carries
precomputed frame embeddings ``audio_embed`` (B, S_enc, d_model), which the
encoder casts to the weights' dtype (the reference promotes instead; the
two agree wherever the embeddings already have the weights' dtype).  The
encoder is a bidirectional stack over the frames (RoPE, ``mask_kind=
"none"``); the decoder a causal stack with cross-attention to the encoder's
output.  The decoder length of a shape cell is min(448, seq_len // 8)
(whisper's 448-token label budget), at least 8.

Parameters are plain dicts: ``{"embed", "enc_blocks": [one dict per
layer], "enc_norm", "dec_blocks": [...], "final_norm", "lm_head"}``; a
Python loop over the blocks replaces the reference's ``lax.scan``
(``convert.encdec_params_from_reference`` un-stacks a reference tree).  The
decoder's serving state is one dict per layer, ``{"sk", "sv"}`` (the
self-attention's K/V, padded to prompt + new tokens by
``launch.serve.pad_caches``) and ``{"ck", "cv"}`` (the cross-attention's,
at the encoder's length, never written).

On a mesh (``ctx``, a ``sharding.MeshCtx``) the batch is the local shard,
each layer gathers its leaves over the data axis at use
(``transformer.gather_block``) and splits its products over the model axis
as their specs do (``transformer.tp_of``): the encoder's self-attention,
the decoder's self- and cross-attention on the rank's heads (whisper's 20
split at 2 and 4 ranks, whole at 16), the MLPs on its hidden columns; the
embedding, head and loss are vocab-parallel and the loss the global mean,
as in ``models/transformer.py``; the reference pins its activations'
layout with ``ctx.bconstrain``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense_init, init_mlp, mlp_axes,
                                       mlp_forward, rms_norm)
from repro_torch.models.transformer import (_leaf, _placed, _remat,
                                            embed_tokens, gather_block,
                                            gathered_caches, kept_caches,
                                            masked_cross_entropy, tp_of,
                                            unembed)


def decoder_len(cfg: ModelConfig, seq_len: int) -> int:
    return max(8, min(448, seq_len // 8))


def init_enc_block(gen, cfg: ModelConfig, dtype=torch.bfloat16,
                   device="cuda") -> Dict[str, Any]:
    f32 = dict(dtype=torch.float32, device=device)
    kw = dict(dtype=dtype, device=device)
    return {
        "norm_attn": torch.zeros((cfg.d_model,), **f32),
        "attn": attn.init_attention(gen, cfg, **kw),
        "norm_mlp": torch.zeros((cfg.d_model,), **f32),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, **kw),
    }


def init_dec_block(gen, cfg: ModelConfig, dtype=torch.bfloat16,
                   device="cuda") -> Dict[str, Any]:
    f32 = dict(dtype=torch.float32, device=device)
    kw = dict(dtype=dtype, device=device)
    return {
        "norm_self": torch.zeros((cfg.d_model,), **f32),
        "self_attn": attn.init_attention(gen, cfg, **kw),
        "norm_cross": torch.zeros((cfg.d_model,), **f32),
        "cross_attn": attn.init_attention(gen, cfg, **kw),
        "norm_mlp": torch.zeros((cfg.d_model,), **f32),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, **kw),
    }


def encdec_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of :func:`init_encdec`'s leaves, leaf for leaf (a
    scan leaf's without its leading ``"layers"``)."""
    attn_ax = attn.attention_axes()
    enc = {"norm_attn": ("embed",), "attn": attn_ax, "norm_mlp": ("embed",),
           "mlp": mlp_axes()}
    dec = {"norm_self": ("embed",), "self_attn": attn_ax,
           "norm_cross": ("embed",), "cross_attn": attn_ax,
           "norm_mlp": ("embed",), "mlp": mlp_axes()}
    return {"embed": ("vocab", "embed"),
            "enc_blocks": [enc] * cfg.num_layers, "enc_norm": ("embed",),
            "dec_blocks": [dec] * cfg.num_decoder_layers,
            "final_norm": ("embed",), "lm_head": ("embed", "vocab")}


def init_encdec(gen, cfg: ModelConfig, dtype=torch.bfloat16,
                device="cuda", place=None) -> Dict[str, Any]:
    """Full encoder-decoder params, drawn from the generator ``gen`` (on
    ``device``); on the ``meta`` device, shapes and dtypes only.
    ``place`` as ``transformer.init_lm`` takes it."""
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    ax = encdec_axes(cfg)
    return {
        "embed": _placed(place, dense_init(
            gen, (cfg.vocab_size, cfg.d_model), in_axis=1, **kw),
            ax["embed"]),
        "enc_blocks": [_placed(place, init_enc_block(gen, cfg, **kw), a)
                       for a in ax["enc_blocks"]],
        "enc_norm": _placed(place, torch.zeros((cfg.d_model,), **f32),
                            ax["enc_norm"]),
        "dec_blocks": [_placed(place, init_dec_block(gen, cfg, **kw), a)
                       for a in ax["dec_blocks"]],
        "final_norm": _placed(place, torch.zeros((cfg.d_model,), **f32),
                              ax["final_norm"]),
        "lm_head": _placed(place, dense_init(
            gen, (cfg.d_model, cfg.vocab_size), **kw), ax["lm_head"]),
    }


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device)[None, :].expand(b, s)


def _specs(ctx, key: str, n: int):
    return [None] * n if ctx is None else ctx.specs[key]


def run_encoder(params, audio_embed, cfg: ModelConfig, ctx=None):
    """The encoder stack over (B, S_enc, d) frame embeddings -> its normed
    output in the weights' dtype.  Under autograd each layer runs through
    ``transformer._remat``, as the reference's scan body does."""
    x = audio_embed.to(device=params["embed"].device,
                       dtype=params["embed"].dtype)
    positions = _positions(x)

    def layer(x, blk, spec):
        blk = gather_block(blk, spec, ctx)
        h = rms_norm(x, blk["norm_attn"], cfg.norm_eps)
        a, _, _ = attn.attention_forward_kv(blk["attn"], h, cfg,
                                            mask_kind="none",
                                            positions=positions,
                                            tp=tp_of(ctx, spec, "attn"))
        x = x + a
        h = rms_norm(x, blk["norm_mlp"], cfg.norm_eps)
        return x + mlp_forward(blk["mlp"], h, cfg.act,
                               tp=tp_of(ctx, spec, "mlp"))

    body = _remat(layer, cfg) if torch.is_grad_enabled() else layer
    for blk, spec in zip(params["enc_blocks"],
                         _specs(ctx, "enc_blocks", cfg.num_layers)):
        x = body(x, blk, spec)
    return rms_norm(x, _leaf(params, "enc_norm", ctx), cfg.norm_eps)


def _dec_layer(blk, x, enc_out, positions, cfg: ModelConfig, ctx=None,
               spec=None, return_kv: bool = False):
    """One decoder block, full sequence -> (x, its four caches, every kv
    head, or None)."""
    blk = gather_block(blk, spec, ctx)
    tp_self, tp_cross = (tp_of(ctx, spec, k)
                         for k in ("self_attn", "cross_attn"))
    h = rms_norm(x, blk["norm_self"], cfg.norm_eps)
    a, sk, sv = attn.attention_forward_kv(blk["self_attn"], h, cfg,
                                          mask_kind="causal",
                                          positions=positions, tp=tp_self)
    x = x + a
    h = rms_norm(x, blk["norm_cross"], cfg.norm_eps)
    a, ck, cv = attn.attention_forward_kv(blk["cross_attn"], h, cfg,
                                          mask_kind="none",
                                          positions=positions, kv_x=enc_out,
                                          tp=tp_cross)
    x = x + a
    h = rms_norm(x, blk["norm_mlp"], cfg.norm_eps)
    x = x + mlp_forward(blk["mlp"], h, cfg.act, tp=tp_of(ctx, spec, "mlp"))
    if not return_kv:
        return x, None
    whole = {"sk": (sk, tp_self), "sv": (sv, tp_self), "ck": (ck, tp_cross),
             "cv": (cv, tp_cross)}
    return x, {k: attn.whole_kv_heads(t, cfg, tp)
               for k, (t, tp) in whole.items()}


def run_decoder(params, tokens, enc_out, cfg: ModelConfig,
                collect_cache: bool = False, ctx=None):
    """The decoder stack over ``tokens`` (B, S) with cross-attention to
    ``enc_out`` -> (normed x, per-layer caches or None).  Under autograd
    (and not collecting caches) each layer runs through
    ``transformer._remat``."""
    x = embed_tokens(params, tokens, cfg, ctx)
    positions = _positions(x)

    def layer(x, blk, enc_out, spec):
        return _dec_layer(blk, x, enc_out, positions, cfg, ctx, spec)[0]

    body = layer
    if torch.is_grad_enabled() and not collect_cache:
        body = _remat(layer, cfg)
    caches = []
    for blk, spec in zip(params["dec_blocks"],
                         _specs(ctx, "dec_blocks", cfg.num_decoder_layers)):
        if collect_cache:
            x, cache = _dec_layer(blk, x, enc_out, positions, cfg, ctx, spec,
                                  return_kv=True)
            caches.append(cache)
        else:
            x = body(x, blk, enc_out, spec)
    x = rms_norm(x, _leaf(params, "final_norm", ctx), cfg.norm_eps)
    return x, (caches if collect_cache else None)


def encdec_loss(params, batch, cfg: ModelConfig, ctx=None):
    """(loss, metrics ``ce_loss`` and ``tokens``) on ``audio_embed``,
    ``tokens`` and ``targets`` (-1: no target)."""
    enc_out = run_encoder(params, batch["audio_embed"], cfg, ctx)
    x, _ = run_decoder(params, batch["tokens"], enc_out, cfg, ctx=ctx)
    loss, denom = masked_cross_entropy(params, x, batch["targets"], cfg, ctx)
    return loss, {"ce_loss": loss, "tokens": denom}


def encdec_prefill(params, batch, cfg: ModelConfig, ctx=None):
    """Encoder, then the decoder prompt pass: returns (caches,
    last-position logits (B, 1, V) f32)."""
    enc_out = run_encoder(params, batch["audio_embed"], cfg, ctx)
    x, caches = run_decoder(params, batch["tokens"], enc_out, cfg,
                            collect_cache=True, ctx=ctx)
    return caches, unembed(params, x[:, -1:], cfg, ctx)


def encdec_decode(params, caches, token, pos: int, cfg: ModelConfig,
                  ctx=None):
    """One-token decode.  token: (B, 1); caches: one ``{"sk", "sv", "ck",
    "cv"}`` dict per decoder layer, the self-attention's updated in place.
    Returns (caches, logits (B, 1, V) f32)."""
    x = embed_tokens(params, token, cfg, ctx)
    new = []
    for blk, cache, spec in zip(
            params["dec_blocks"], gathered_caches(caches, ctx),
            _specs(ctx, "dec_blocks", cfg.num_decoder_layers), strict=True):
        blk = gather_block(blk, spec, ctx)
        h = rms_norm(x, blk["norm_self"], cfg.norm_eps)
        a, sk, sv = attn.attention_decode(blk["self_attn"], h, cache["sk"],
                                          cache["sv"], pos, cfg,
                                          mask_kind="causal",
                                          tp=tp_of(ctx, spec, "self_attn"))
        x = x + a
        h = rms_norm(x, blk["norm_cross"], cfg.norm_eps)
        a, _, _ = attn.attention_decode(blk["cross_attn"], h, cache["ck"],
                                        cache["cv"], pos, cfg,
                                        mask_kind="none", cross=True,
                                        tp=tp_of(ctx, spec, "cross_attn"))
        x = x + a
        h = rms_norm(x, blk["norm_mlp"], cfg.norm_eps)
        x = x + mlp_forward(blk["mlp"], h, cfg.act,
                            tp=tp_of(ctx, spec, "mlp"))
        new.append({"sk": sk, "sv": sv, "ck": cache["ck"], "cv": cache["cv"]})
    x = rms_norm(x, _leaf(params, "final_norm", ctx), cfg.norm_eps)
    return kept_caches(new, caches, ctx), unembed(params, x, cfg, ctx)
