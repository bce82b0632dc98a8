"""A decoder of full-attention blocks with a gated MLP (the port's ``attn``
block, as ``tinyllama-1.1b`` lays it out), served: the logits at chosen
positions of whole sequences.

Each block: RMS norm, GQA attention (q head h on kv head h // (H / Hkv))
with rotary embeddings at positions 0..S-1 under a causal mask, the output
projection, a residual; RMS norm, act(x W_gate) * (x W_up) W_down, a
residual.  The final RMS norm and the untied head give float32 logits.
Attention runs in blocks of query rows, so that a long prompt fits beside
nothing else on the card; that changes no value."""
from __future__ import annotations

import math

import torch

from perfbench.reference.common import rms_norm, rope, silu
from perfbench.reference.precision import Precision

ATTN_BLOCK = 512
ACTS = {"silu": silu}


def attention(q, k, v, prec: Precision):
    """Causal GQA: q (B, S, H, hd), k, v (B, S, Hkv, hd) -> (B, S, H, hd)."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    kl, vl = prec.low(k), prec.low(v)
    outs = []
    for lo in range(0, s, ATTN_BLOCK):
        qb = q[:, lo:lo + ATTN_BLOCK]
        n = qb.shape[1]
        sc = torch.einsum("bqkgd,bskd->bkgqs",
                          prec.low(qb).reshape(b, n, hkv, g, hd), kl)
        sc = sc / math.sqrt(hd)
        qi = torch.arange(lo, lo + n, device=q.device)[:, None]
        ki = torch.arange(s, device=q.device)[None, :]
        sc = sc.masked_fill(ki > qi, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", prec.low(p), vl)
        outs.append(o.reshape(b, n, h, hd))
    return torch.cat(outs, dim=1)


def block(p, x, m, prec: Precision):
    h = prec.low(rms_norm(x, p["norm_attn"], m["norm_eps"]))
    a = p["attn"]
    q = rope(torch.einsum("bsd,dhe->bshe", h, prec.low(a["w_q"])),
             m["rope_theta"])
    k = rope(torch.einsum("bsd,dhe->bshe", h, prec.low(a["w_k"])),
             m["rope_theta"])
    v = torch.einsum("bsd,dhe->bshe", h, prec.low(a["w_v"]))
    o = attention(q, k, v, prec)
    x = x + torch.einsum("bshe,hed->bsd", prec.low(o), prec.low(a["w_o"]))
    h = prec.low(rms_norm(x, p["norm_mlp"], m["norm_eps"]))
    f = p["mlp"]
    gate = ACTS[m["act"]](h @ prec.low(f["w_gate"]))
    up = h @ prec.low(f["w_up"])
    return x + prec.low(gate * up) @ prec.low(f["w_down"])


@torch.no_grad()
def logits_at(w, tokens, first: int, m, prec: Precision = None
              ) -> torch.Tensor:
    """Float32 logits (B, T - first, V) at positions first..T-1 of
    ``tokens`` (B, T) int64, from float32 weights ``w`` (the program's
    tree layout)."""
    if m.get("tie_embeddings"):
        raise ValueError("attn_lm: a tied head is not modelled")
    prec = prec or Precision()
    x = w["embed"][tokens]
    for p in w["blocks"]:
        x = block(p, x, m, prec)
    x = rms_norm(x[:, first:], w["final_norm"], m["norm_eps"])
    return prec.low(x) @ prec.low(w["lm_head"])
