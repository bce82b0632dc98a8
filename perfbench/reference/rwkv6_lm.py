"""An RWKV6 ("Finch", arXiv:2404.05892) decoder as the port lays out its
weights, served: the logits at chosen positions of whole sequences.

Each block: RMS norm, the time mix, a residual; RMS norm, the channel mix,
a residual.  The time mix shifts its input by one token (zeros before the
first), mixes each of r, k, v, w, g by a data-dependent interpolation
(x + (x_prev - x) (mu + tanh((x + (x_prev - x) mu_x) A) B), a LoRA of rank
``mix_lora`` a mix), projects r, k, v, g, takes the decay
log w = -exp(clip(w0 + tanh(x_w A_w) B_w, -20, 8)), and runs the WKV
recurrence per head of ``head_dim``:

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T

then a group norm per head (eps ``group_norm_eps``), the silu(g) gate and
the output projection.  The channel mix: the same shift, relu(x_k K)^2 V
gated by sigmoid(x_r R).  The final RMS norm and the head give float32
logits.

The recurrence runs in chunks of :data:`CHUNK` tokens: inside a chunk each
pair (t, s < t) weighs k_s by exp(sum of log w over s < tau < t), never
above 1, so no decay overflows whatever its size; the chunks' states are
carried in order.  The sequence is processed in blocks of :data:`BLOCK`
tokens through all layers, each layer carrying its shift and state, so
that a long prompt fits beside nothing else on the card."""
from __future__ import annotations

import torch

from perfbench.reference.common import rms_norm, silu
from perfbench.reference.precision import Precision

CHUNK = 16
BLOCK = 2048


def wkv(r, k, v, log_w, u, state):
    """r, k, v, log_w (B, T, H, hd), u (H, hd), state (B, H, hd, hd), all
    float32 -> (y (B, T, H, hd), the state after the last token)."""
    b, t, h, hd = r.shape
    n = -(-t // CHUNK)
    pad = n * CHUNK - t

    def chunks(x):
        if pad:
            x = torch.cat([x, x.new_zeros((b, pad, h, hd))], dim=1)
        return x.reshape(b, n, CHUNK, h, hd).permute(0, 3, 1, 2, 4)

    r, k, v, log_w = (chunks(x) for x in (r, k, v, log_w))
    cum = torch.cumsum(log_w, dim=3)                 # through t
    prev = cum - log_w                               # through t - 1
    pairs = r.new_zeros((b, h, n, CHUNK, CHUNK))
    for s in range(CHUNK - 1):
        decay = torch.exp(prev[..., s + 1:, :] - cum[..., s:s + 1, :])
        pairs[..., s + 1:, s] = (r[..., s + 1:, :] * k[..., s:s + 1, :]
                                 * decay).sum(-1)
    y = pairs @ v + (r * u[None, :, None, None, :] * k).sum(
        -1, keepdim=True) * v
    last = cum[..., -1:, :]
    carried = (k * torch.exp(last - cum)).transpose(-1, -2) @ v
    keep = torch.exp(last[..., 0, :])                # (B, H, n, hd)
    starts = []
    for c in range(n):
        starts.append(state)
        state = keep[:, :, c, :, None] * state + carried[:, :, c]
    y = y + (r * torch.exp(prev)) @ torch.stack(starts, dim=2)
    y = y.permute(0, 2, 3, 1, 4).reshape(b, n * CHUNK, h, hd)[:, :t]
    return y, state


def _shift(x, prev):
    return torch.cat([prev[:, None], x[:, :-1]], dim=1), x[:, -1]


def time_mix(p, x, st, m, prec: Precision):
    b, t, d = x.shape
    hd = m["head_dim"]
    h = d // hd
    shifted, st["tm"] = _shift(x, st["tm"])
    dx = shifted - x
    xxx = x + dx * p["mu_x"]
    lora = torch.tanh(prec.high(xxx) @ prec.high(p["mix_a"]))
    lora = lora.reshape(b, t, 5, m["mix_lora"])
    delta = torch.einsum("btnr,nrd->nbtd", prec.high(lora),
                         prec.high(p["mix_b"]))
    mixed = x[None] + dx[None] * (p["mu"][:, None, None, :] + delta)
    xr, xk, xv, xw, xg = mixed
    r = (prec.low(xr) @ prec.low(p["w_r"])).reshape(b, t, h, hd)
    k = (prec.low(xk) @ prec.low(p["w_k"])).reshape(b, t, h, hd)
    v = (prec.low(xv) @ prec.low(p["w_v"])).reshape(b, t, h, hd)
    g = silu(prec.low(xg) @ prec.low(p["w_g"]))
    lw = torch.tanh(prec.high(xw) @ prec.high(p["w_a"]))
    z = p["w0"].reshape(-1) + prec.high(lw) @ prec.high(p["w_b"])
    log_w = -torch.exp(torch.clamp(z, -20.0, 8.0)).reshape(b, t, h, hd)
    y, st["wkv"] = wkv(prec.low(r), prec.low(k), prec.low(v), log_w, p["u"],
                       st["wkv"])
    mu = y.mean(-1, keepdim=True)
    var = (y - mu).square().mean(-1, keepdim=True)
    y = ((y - mu) * torch.rsqrt(var + m["group_norm_eps"])).reshape(b, t, d)
    y = (y * p["ln_w"] + p["ln_b"]) * g
    return prec.low(y) @ prec.low(p["w_o"])


def channel_mix(p, x, st, prec: Precision):
    shifted, st["cm"] = _shift(x, st["cm"])
    dx = shifted - x
    xk = x + dx * p["mu_k"]
    xr = x + dx * p["mu_r"]
    kk = torch.relu(prec.low(xk) @ prec.low(p["w_k"])).square()
    kv = prec.low(kk) @ prec.low(p["w_v"])
    return torch.sigmoid(prec.low(xr) @ prec.low(p["w_r"])) * kv


@torch.no_grad()
def logits_at(w, tokens, first: int, m, prec: Precision = None
              ) -> torch.Tensor:
    """Float32 logits (B, T - first, V) at positions first..T-1 of
    ``tokens`` (B, T) int64, from float32 weights ``w`` (the program's
    tree layout)."""
    prec = prec or Precision()
    b, t = tokens.shape
    d, hd = m["d_model"], m["head_dim"]
    dev = w["embed"].device
    states = [{"tm": torch.zeros((b, d), device=dev),
               "cm": torch.zeros((b, d), device=dev),
               "wkv": torch.zeros((b, d // hd, hd, hd), device=dev)}
              for _ in w["blocks"]]
    out = []
    for lo in range(0, t, BLOCK):
        x = w["embed"][tokens[:, lo:lo + BLOCK]]
        for p, st in zip(w["blocks"], states):
            h = rms_norm(x, p["norm_attn"], m["norm_eps"])
            x = x + time_mix(p["time_mix"], h, st, m, prec)
            h = rms_norm(x, p["norm_mlp"], m["norm_eps"])
            x = x + channel_mix(p["channel_mix"], h, st, prec)
        keep = max(first - lo, 0)
        if keep < x.shape[1]:
            x = rms_norm(x[:, keep:], w["final_norm"], m["norm_eps"])
            out.append(prec.low(x) @ prec.low(w["lm_head"]))
    return torch.cat(out, dim=1)
