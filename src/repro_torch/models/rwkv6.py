"""RWKV6 ("Finch") block, after the JAX package's ``models/rwkv6.py``:
data-dependent token shift and the WKV6 recurrence with per-channel
data-dependent decay (the time mix), and the squared-ReLU channel mix.
[arXiv:2404.05892]

Prefill (:func:`time_mix_forward`) runs the recurrence through
``kernels/rwkv6`` (the CUDA kernel on the card, its plain chunked version
on the CPU), which also returns the final (B, H, hd, hd) state.  Decode
(:func:`time_mix_step`) is the O(1)-state step in plain torch, as it is jnp
code outside any Pallas kernel in the reference.  Parameter names and
shapes are the reference's, so ``convert.lm_params_from_reference``
carries weights across unchanged.

With ``tp`` (a ``sharding.ModelAxis``: the recurrent width split over the
model axis) a rank computes its H / M heads: ``w_r``, ``w_k``, ``w_v`` and
``w_g`` are column-parallel, the decay's LoRA output takes the rank's
columns of ``w_b``, WKV6 runs on its heads with its rows of ``u`` and
``w0``, the group norm on its heads, and ``w_o`` is row-parallel with a
sum over the axis.  The token-shift mixes (``mu``, ``mix_a``, ``mix_b``,
``w_a``) stay whole, as their specs leave them.  In the channel mix
``w_k`` is column-parallel and ``w_v`` row-parallel; ``w_r`` (embed,
embed) stays whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6 import ops as wkv6_ops
from repro_torch.models.layers import activation, dense_init, group_norm

MIX_LORA = 32
DECAY_LORA = 64


def init_time_mix(gen, cfg: ModelConfig, dtype=torch.bfloat16,
                  device="cuda"):
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "mu_x": torch.zeros((d,), **f32),
        "mu": torch.zeros((5, d), **f32),
        "mix_a": dense_init(gen, (d, 5 * MIX_LORA), scale=0.1, **f32),
        "mix_b": torch.zeros((5, MIX_LORA, d), **f32),
        "w0": torch.full((h, hd), -6.0, **f32),
        "w_a": dense_init(gen, (d, DECAY_LORA), scale=0.1, **f32),
        "w_b": torch.zeros((DECAY_LORA, d), **f32),
        "u": torch.zeros((h, hd), **f32),
        "w_r": dense_init(gen, (d, d), dtype=dtype, device=device),
        "w_k": dense_init(gen, (d, d), dtype=dtype, device=device),
        "w_v": dense_init(gen, (d, d), dtype=dtype, device=device),
        "w_g": dense_init(gen, (d, d), dtype=dtype, device=device),
        "w_o": dense_init(gen, (d, d), dtype=dtype, device=device),
        "ln_w": torch.ones((d,), **f32),
        "ln_b": torch.zeros((d,), **f32),
    }


def time_mix_axes(cfg: ModelConfig):
    rnn = "rnn" if cfg.shard_rnn else None
    return {"mu_x": ("embed",), "mu": (None, "embed"),
            "mix_a": ("embed", "lora"), "mix_b": (None, "lora", "embed"),
            "w0": (rnn, "head_dim"), "w_a": ("embed", "lora"),
            "w_b": ("lora", "embed"), "u": (rnn, "head_dim"),
            "w_r": ("embed", rnn), "w_k": ("embed", rnn),
            "w_v": ("embed", rnn), "w_g": ("embed", rnn),
            "w_o": (rnn, "embed"), "ln_w": (rnn,), "ln_b": (rnn,)}


def channel_mix_axes():
    return {"mu_k": ("embed",), "mu_r": ("embed",), "w_k": ("embed", "mlp"),
            "w_v": ("mlp", "embed"), "w_r": ("embed", "embed")}


def init_channel_mix(gen, cfg: ModelConfig, dtype=torch.bfloat16,
                     device="cuda"):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": torch.zeros((d,), dtype=torch.float32, device=device),
        "mu_r": torch.zeros((d,), dtype=torch.float32, device=device),
        "w_k": dense_init(gen, (d, f), dtype=dtype, device=device),
        "w_v": dense_init(gen, (f, d), dtype=dtype, device=device),
        "w_r": dense_init(gen, (d, d), dtype=dtype, device=device),
    }


def _token_shift(x, prev=None):
    """Shift the sequence right by one; ``prev`` (B, d) fills slot 0 (the
    decode carry)."""
    if prev is None:
        pad = torch.zeros_like(x[:, :1])
    else:
        pad = prev[:, None, :].to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


def _ddlerp(p, x, shifted):
    """RWKV6 data-dependent interpolation -> (5, B, S, d) mixed inputs,
    float32."""
    dx = (shifted - x).to(torch.float32)
    xf = x.to(torch.float32)
    xxx = xf + dx * p["mu_x"]
    lora = torch.tanh(xxx @ p["mix_a"])                 # (B, S, 5 * r)
    b, s, _ = lora.shape
    lora = lora.reshape(b, s, 5, MIX_LORA)
    delta = torch.einsum("bsnr,nrd->nbsd", lora, p["mix_b"])
    return xf[None] + dx[None] * (p["mu"][:, None, None, :] + delta)


def _projections(p, x, shifted, cfg: ModelConfig, tp=None):
    """(r, k, v, g, log_w) of the rank's heads (all of them without
    ``tp``)."""
    mixed = _ddlerp(p, x, shifted)
    xr, xk, xv, xw, xg = [mixed[i].to(x.dtype) for i in range(5)]
    b, s, _ = x.shape
    hd = cfg.rwkv_head_dim
    n = p["w_r"].shape[1]                      # the rank's channels
    h = n // hd
    if p["u"].shape[0] * hd != n:
        raise ValueError(f"{cfg.name}: {n} channels a rank are not whole "
                         f"heads of {hd}")
    lora = torch.tanh(xw.to(torch.float32) @ p["w_a"])
    w_b = p["w_b"]
    if tp is not None:
        xr, xk, xv, xg, lora = map(tp.enter, (xr, xk, xv, xg, lora))
        w_b = tp.enter(w_b)[:, tp.start(n):tp.start(n) + n]
    r = (xr @ p["w_r"]).reshape(b, s, h, hd)
    k = (xk @ p["w_k"]).reshape(b, s, h, hd)
    v = (xv @ p["w_v"]).reshape(b, s, h, hd)
    g = activation("silu")(xg @ p["w_g"])
    # data-dependent log-decay, < 0 (w = exp(-exp(z))); the reference's
    # bf16 @ f32 promotes to f32
    z = p["w0"].reshape(-1) + lora @ w_b
    log_w = -torch.exp(torch.clamp(z, -20.0, 8.0)).reshape(b, s, h, hd)
    return r, k, v, g, log_w


def _out(p, y, g, x, h: int, tp=None):
    """Group norm over heads, the silu gate and the output projection
    (row-parallel with ``tp``)."""
    y = group_norm(y.to(x.dtype), p["ln_w"], p["ln_b"], num_groups=h)
    y = (y.to(torch.float32) * g).to(x.dtype)
    y = y @ p["w_o"]
    return y if tp is None else tp.sum(y)


def time_mix_forward(p, x, cfg: ModelConfig, chunk: int = 16, tp=None):
    """Prefill.  x: (B, S, d) -> (B, S, d), and the final (state
    (B, H, hd, hd) float32 (the rank's heads with ``tp``), last x
    (B, d)).  ``chunk`` is the plain version's chunk on the CPU."""
    b, s, _ = x.shape
    shifted = _token_shift(x)
    r, k, v, g, log_w = _projections(p, x, shifted, cfg, tp)
    y, state = wkv6_ops.wkv6(r, k, v, log_w, p["u"], chunk=chunk)
    return _out(p, y.reshape(b, s, -1), g, x, r.shape[2], tp), (
        state, x[:, -1, :])


def wkv6_step(state, r, k, v, log_w, u):
    """O(1) decode step.  state: (B, H, hd, hd); r, k, v, log_w:
    (B, H, hd).  Returns (new state, y (B, H, hd)), float32."""
    rf, kf, vf = (t.to(torch.float32) for t in (r, k, v))
    # y[j] = sum_i r_i (S[i, j] + u_i k_i v_j)
    y = torch.einsum("bhk,bhkv->bhv", rf, state) + (
        (rf * u[None] * kf).sum(-1, keepdim=True) * vf)
    new_state = state * torch.exp(log_w.to(torch.float32))[..., None] + (
        kf[..., :, None] * vf[..., None, :])
    return new_state, y


def time_mix_step(p, x, state, prev_x, cfg: ModelConfig, tp=None):
    """Decode step.  x: (B, 1, d); state: (B, H, hd, hd) (the rank's
    heads with ``tp``); prev_x: (B, d).  Returns (out (B, 1, d), (new
    state, last x))."""
    b = x.shape[0]
    shifted = _token_shift(x, prev=prev_x)
    r, k, v, g, log_w = _projections(p, x, shifted, cfg, tp)
    new_state, y = wkv6_step(state, r[:, 0], k[:, 0], v[:, 0], log_w[:, 0],
                             p["u"])
    return _out(p, y.reshape(b, 1, -1), g, x, r.shape[2], tp), (
        new_state, x[:, -1, :])


def channel_mix_forward(p, x, prev_x=None, tp=None):
    """Squared-ReLU channel mix.  Returns (out, last x carry).  With
    ``tp`` the params hold the rank's hidden columns."""
    shifted = _token_shift(x, prev=prev_x)
    dx = (shifted - x).to(torch.float32)
    xf = x.to(torch.float32)
    xk = (xf + dx * p["mu_k"]).to(x.dtype)
    xr = (xf + dx * p["mu_r"]).to(x.dtype)
    if tp is not None:
        xk = tp.enter(xk)
    kk = torch.square(F.relu(xk @ p["w_k"]))
    kv = kk @ p["w_v"]
    if tp is not None:
        kv = tp.sum(kv)
    out = torch.sigmoid((xr @ p["w_r"]).to(torch.float32)).to(x.dtype) * kv
    return out, x[:, -1, :]
