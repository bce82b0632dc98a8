"""GQA attention: full, sliding-window and unmasked self-attention,
cross-attention, logit softcap, and decode with an updatable KV cache, a
ring cache (``cfg.window_kv_cache``) or a fixed cross-attention cache
(after the JAX package's ``models/attention.py``).

Prefill (:func:`attention_forward_kv`) runs the flash kernel
(``kernels/flash``): the CUDA kernel on the card, its plain torch version on
the CPU; unmasked self-attention (the encoder) and cross-attention run it
non-causal.  Decode (:func:`attention_decode`) is one query row over the cache
and stays plain torch (:func:`_sdpa`), as it is jnp code outside any Pallas
kernel in the reference.  The reference's ``_sdpa_chunked`` (the XLA
stand-in for the flash kernel, behind ``cfg.attn_kv_chunk``) is not ported:
the flash kernel does that work here.

With ``tp`` (a ``sharding.ModelAxis``: the heads split over the model
axis) a rank computes its H / M q heads (:func:`rank_heads`) and the kv
heads they use: its shard of ``w_k`` and ``w_v`` where the kv heads divide
the axis, else its slice of the replicated weights (one kv head for
qwen's 2 q heads a rank at 16 ranks: a local group of 2, not 8).  The
flash kernel runs on those heads, and ``w_o`` is row-parallel, its partial
output summed over the axis.
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


def attention_axes():
    return {"w_q": ("embed", "heads", "head_dim"),
            "w_k": ("embed", "kv_heads", "head_dim"),
            "w_v": ("embed", "kv_heads", "head_dim"),
            "w_o": ("heads", "head_dim", "embed")}


def rank_heads(cfg: ModelConfig, tp):
    """(lo, n, kv_lo, kv_n): the rank's q heads [lo, lo + n) and the kv
    heads [kv_lo, kv_lo + kv_n) they use (q head h uses kv head h // g,
    g = H / Hkv); all of them without ``tp``.  Raises where the rank's q
    heads neither hold whole groups nor sit in one."""
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    if tp is None:
        return 0, h, 0, hkv
    n, g = h // tp.size, h // hkv
    if n * tp.size != h or (n % g and g % n):
        raise ValueError(f"{cfg.name}: {h} q heads in groups of {g} do not "
                         f"split over {tp.size} model ranks")
    lo = tp.start(n)
    return lo, n, lo // g, max(1, n // g)


def _kv_weights(params, cfg: ModelConfig, tp):
    """``w_k`` and ``w_v`` for the rank's kv heads: its shard where the
    spec splits them, else its slice of the replicated weights, whose
    gradient is then summed over the model axis (ranks share kv heads)."""
    w_k, w_v = params["w_k"], params["w_v"]
    if tp is None or w_k.shape[1] != cfg.num_kv_heads:
        return w_k, w_v
    _, _, kv_lo, kv_n = rank_heads(cfg, tp)
    return tuple(tp.enter(w)[:, kv_lo:kv_lo + kv_n] for w in (w_k, w_v))


def whole_kv_heads(t: torch.Tensor, cfg: ModelConfig, tp) -> torch.Tensor:
    """Every kv head of a (B, S, kv_n, hd) tensor that holds the rank's
    (:func:`rank_heads`): gathered over the model axis, each head taken
    from the first rank that computed it.  ``t`` itself without ``tp``."""
    if tp is None:
        return t
    blocks = tp.gather(t, 2)                      # (B, S, M * kv_n, hd)
    _, n, _, kv_n = rank_heads(cfg, tp)
    g = cfg.num_heads // cfg.num_kv_heads
    idx = []
    for j in range(cfg.num_kv_heads):
        r = j * g // n
        idx.append(r * kv_n + j - r * n // g)
    if idx == list(range(blocks.shape[2])):
        return blocks
    return blocks[:, :, idx]


def _mask_bias(q_pos, k_pos, kind: str, window: int) -> torch.Tensor:
    """(q, k) additive mask bias in f32.  q_pos: (...,Sq), k_pos: (...,Sk)."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    if kind == "causal":
        ok = k <= q
    elif kind == "local":
        ok = (k <= q) & (k > q - window)
    elif kind == "none":
        ok = torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                        dtype=torch.bool, device=q.device)
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
                         positions, kv_x=None, tp=None):
    """Training/prefill attention.  ``kv_x`` set => cross-attention: K/V
    from ``kv_x``, no RoPE on either side, nothing masked.  ``mask_kind``:
    ``"causal"``, ``"local"`` (causal within ``cfg.window_size``) or
    ``"none"`` (bidirectional, the encoder's).  Returns (out, k, v) so
    prefill can populate the KV cache for free.

    The flash kernel masks by row index from 0 for q and k; those are the
    reference's position masks for the positions the models make
    (``arange(S)``).  The reference's ``kv_positions`` only feed its
    ``"none"`` mask, which ignores them, so they are not taken here.

    With ``tp`` the returned K/V hold the rank's kv heads
    (:func:`rank_heads`; :func:`whole_kv_heads` makes the caches' whole).
    """
    if kv_x is not None and mask_kind != "none":
        raise ValueError(f"cross-attention is unmasked, got {mask_kind!r}")
    if mask_kind not in ("causal", "local", "none"):
        raise ValueError(mask_kind)
    if tp is not None:
        _, n, _, _ = rank_heads(cfg, tp)
        if params["w_q"].shape[1] != n:
            raise ValueError(f"{cfg.name}: w_q holds "
                             f"{params['w_q'].shape[1]} heads, the rank "
                             f"computes {n}")
        x = tp.enter(x)
        kv_x = None if kv_x is None else tp.enter(kv_x)
    kv_in = x if kv_x is None else kv_x
    w_k, w_v = _kv_weights(params, cfg, tp)
    q = torch.einsum("bsd,dhe->bshe", x, params["w_q"])
    k = torch.einsum("bsd,dhe->bshe", kv_in, w_k)
    v = torch.einsum("bsd,dhe->bshe", kv_in, w_v)
    if kv_x is None:                                  # self-attention: RoPE
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = flash_ops.flash_attention(
        q, k, v, causal=mask_kind != "none",
        window=cfg.window_size if mask_kind == "local" else 0,
        softcap=cfg.logit_softcap)
    out = torch.einsum("bshe,hed->bsd", out, params["w_o"])
    return (out if tp is None else tp.sum(out)), k, v


# ------------------------------------------------------------------- decode
def attention_decode(params, x, cache_k, cache_v, pos: int,
                     cfg: ModelConfig, *, mask_kind: str, cross: bool = False,
                     ring: bool = False, tp=None):
    """One-token decode.  x: (B,1,d); cache_{k,v}: (B,S,Hkv,hd); pos: int.

    The new K/V row is written into the caches in place (``index_copy_``;
    the reference returns updated copies with ``dynamic_update_slice``).
    ``cross=True``: the caches hold the encoder's K/V, are not written, and
    nothing is masked (no RoPE either).  ``ring=True`` (a local layer under
    ``cfg.window_kv_cache``): the cache is a ring of S slots, position p in
    slot p % S, K stored with RoPE at its true position; slot s holds
    position pos - ((pos - s) mod S), masked while that is negative.  With
    S = min(window, prompt + new), as ``launch.serve.pad_caches`` makes
    it, that is the local mask.  Returns (out, cache_k, cache_v).

    With ``tp`` the caches hold every kv head (as ``cache_specs`` lays
    them out): the rank computes its q heads and its kv heads' new row,
    writes every head's row (gathered over the model axis) and reads its
    kv heads (:func:`rank_heads`).
    """
    b = x.shape[0]
    s_max = cache_k.shape[1]
    dev = x.device
    if tp is not None:
        x = tp.enter(x)
    q = torch.einsum("bsd,dhe->bshe", x, params["w_q"])
    at = torch.full((b, 1), pos, device=dev)
    if not cross:
        w_k, w_v = _kv_weights(params, cfg, tp)
        k_new = torch.einsum("bsd,dhe->bshe", x, w_k)
        v_new = whole_kv_heads(torch.einsum("bsd,dhe->bshe", x, w_v), cfg,
                               tp)
        q = apply_rope(q, at, cfg.rope_theta)
        k_new = whole_kv_heads(apply_rope(k_new, at, cfg.rope_theta), cfg,
                               tp)
        write_at = torch.tensor([pos % s_max if ring else pos], device=dev)
        cache_k.index_copy_(1, write_at, k_new.to(cache_k.dtype))
        cache_v.index_copy_(1, write_at, v_new.to(cache_v.dtype))
    slots = torch.arange(s_max, device=dev)[None, :]
    if cross:
        bias = torch.zeros((b, 1, 1, s_max), dtype=torch.float32, device=dev)
    elif ring:
        k_pos = pos - torch.remainder(pos - slots, s_max)
        bias = torch.where(k_pos >= 0, 0.0, -1e30).to(torch.float32)
        bias = bias[:, None, None, :].expand(b, 1, 1, s_max)
    else:
        bias = _mask_bias(at, slots,
                          "local" if mask_kind == "local" else "causal",
                          cfg.window_size)[:, None]
    k_read, v_read = cache_k, cache_v
    if tp is not None:
        _, _, kv_lo, kv_n = rank_heads(cfg, tp)
        k_read = cache_k[:, :, kv_lo:kv_lo + kv_n]
        v_read = cache_v[:, :, kv_lo:kv_lo + kv_n]
    out = _sdpa(q, k_read, v_read, bias, cfg.logit_softcap)
    out = torch.einsum("bshe,hed->bsd", out, params["w_o"])
    return (out if tp is None else tp.sum(out)), cache_k, cache_v
