"""GQA self-attention: full/sliding-window masks, logit softcap, and decode
with an updatable KV cache (after the JAX package's ``models/attention.py``;
its cross-attention, used by the encoder-decoder only, and its ring cache,
``cfg.window_kv_cache``, wait for the slices that need them).

Prefill (:func:`attention_forward_kv`) runs the flash kernel
(``kernels/flash``): the CUDA kernel on the card, its plain torch version on
the CPU.  Decode (:func:`attention_decode`) is one query row over the cache
and stays plain torch (:func:`_sdpa`), as it is jnp code outside any Pallas
kernel in the reference.  The reference's ``_sdpa_chunked`` (the XLA
stand-in for the flash kernel, behind ``cfg.attn_kv_chunk``) is not ported:
the flash kernel does that work here.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.models.layers import apply_rope, dense_init, softcap


def init_attention(gen, cfg: ModelConfig, dtype=torch.bfloat16,
                   device="cuda"):
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    return {
        "w_q": dense_init(gen, (d, h, hd), **kw),
        "w_k": dense_init(gen, (d, hkv, hd), **kw),
        "w_v": dense_init(gen, (d, hkv, hd), **kw),
        "w_o": dense_init(gen, (h, hd, d), in_axis=(0, 1), **kw),
    }


def _mask_bias(q_pos, k_pos, kind: str, window: int) -> torch.Tensor:
    """(q, k) additive mask bias in f32.  q_pos: (...,Sq), k_pos: (...,Sk)."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    if kind == "causal":
        ok = k <= q
    elif kind == "local":
        ok = (k <= q) & (k > q - window)
    else:
        raise ValueError(kind)
    return torch.where(ok, 0.0, -1e30).to(torch.float32)


def _sdpa(q, k, v, bias, logit_cap: float) -> torch.Tensor:
    """q: (B,Sq,H,hd)  k,v: (B,Sk,Hkv,hd)  bias: broadcastable (B,1,Sq,Sk).

    The scores are a product in the inputs' dtype widened to f32 afterwards
    (bf16 scores are rounded to bf16 first, as in the reference)."""
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    q = q.reshape(b, sq, hkv, g, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q, k).to(torch.float32)
    scores = scores / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
    scores = softcap(scores, logit_cap)
    scores = scores + bias[:, :, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, h, hd)


def attention_forward_kv(params, x, cfg: ModelConfig, *, mask_kind: str,
                         positions):
    """Training/prefill self-attention.  Returns (out, k, v) so prefill can
    populate the KV cache for free.

    The flash kernel masks by row index from 0 for q and k; those are the
    reference's position masks for the positions ``lm_inputs`` makes
    (``arange(S)``).
    """
    q = torch.einsum("bsd,dhe->bshe", x, params["w_q"])
    k = torch.einsum("bsd,dhe->bshe", x, params["w_k"])
    v = torch.einsum("bsd,dhe->bshe", x, params["w_v"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = flash_ops.flash_attention(
        q, k, v, causal=True,
        window=cfg.window_size if mask_kind == "local" else 0,
        softcap=cfg.logit_softcap)
    return torch.einsum("bshe,hed->bsd", out, params["w_o"]), k, v


# ------------------------------------------------------------------- decode
def attention_decode(params, x, cache_k, cache_v, pos: int,
                     cfg: ModelConfig, *, mask_kind: str):
    """One-token decode.  x: (B,1,d); cache_{k,v}: (B,S,Hkv,hd); pos: int.

    The new K/V row is written into the caches in place (``index_copy_``;
    the reference returns updated copies with ``dynamic_update_slice``).
    Returns (out, cache_k, cache_v).
    """
    b = x.shape[0]
    s_max = cache_k.shape[1]
    dev = x.device
    q = torch.einsum("bsd,dhe->bshe", x, params["w_q"])
    k_new = torch.einsum("bsd,dhe->bshe", x, params["w_k"])
    v_new = torch.einsum("bsd,dhe->bshe", x, params["w_v"])
    at = torch.full((b, 1), pos, device=dev)
    q = apply_rope(q, at, cfg.rope_theta)
    k_new = apply_rope(k_new, at, cfg.rope_theta)
    write_at = torch.tensor([pos], device=dev)
    cache_k.index_copy_(1, write_at, k_new.to(cache_k.dtype))
    cache_v.index_copy_(1, write_at, v_new.to(cache_v.dtype))
    k_pos = torch.arange(s_max, device=dev)[None, :]
    bias = _mask_bias(at, k_pos, "local" if mask_kind == "local" else "causal",
                      cfg.window_size)[:, None]
    out = _sdpa(q, cache_k, cache_v, bias, cfg.logit_softcap)
    out = torch.einsum("bshe,hed->bsd", out, params["w_o"])
    return out, cache_k, cache_v
