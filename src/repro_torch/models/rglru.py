"""Griffin / RecurrentGemma recurrent block, after the JAX package's
``models/rglru.py``: a causal depthwise conv1d and the RG-LRU gated diagonal
linear recurrence.  [arXiv:2402.19427]

Prefill (``state=None``) runs the recurrence through ``kernels/rglru`` (the
CUDA kernel on the card, its plain version on the CPU), where the reference
runs ``jax.lax.associative_scan``.  A decode step (one token, with state)
is ``h = a h0 + b`` in plain torch, which is what the reference's length-1
scan computes; no kernel runs there in either package.  State is
(h (B, d_rnn) float32, conv tail (B, conv_width - 1, d_rnn)).

With ``tp`` (a ``sharding.ModelAxis``: the recurrent width split over the
model axis) a rank computes its d_rnn / M channels: ``w_in_x`` and
``w_in_gate`` are column-parallel, the conv, ``lambda_p``, ``b_a``,
``b_x``, the scan and the state run on the rank's channels, and ``w_out``
is row-parallel with a sum over the axis.  The gates ``w_a`` and ``w_x``
are (rnn, rnn) with the model axis on their input dimension (the
reference's spec), so a rank's float32 product is a partial sum over its
input channels, which :meth:`ModelAxis.scatter` sums and splits to its
output channels: every rank then computes only its own channels' gates,
and no gate weight is gathered.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.models.layers import activation, dense_init


def init_rglru_block(gen, cfg: ModelConfig, dtype=torch.bfloat16,
                     device="cuda"):
    d = cfg.d_model
    dr = d  # rnn width = d_model
    lam = torch.empty((dr,), dtype=torch.float32, device=device)
    if not lam.is_meta:
        lam.uniform_(0.9 ** 2, 0.999 ** 2, generator=gen)
    # a = sigmoid(lambda_p), initialised so that a^c = lam: a in
    # [0.9, 0.999] (the standard Griffin init)
    root = lam ** (1.0 / cfg.rglru_c)
    f32 = dict(dtype=torch.float32, device=device)
    kw = dict(dtype=dtype, device=device)
    return {
        "w_in_x": dense_init(gen, (d, dr), **kw),
        "w_in_gate": dense_init(gen, (d, dr), **kw),
        "conv_w": torch.zeros((cfg.rglru_conv_width, dr), **f32),
        "conv_b": torch.zeros((dr,), **f32),
        "w_a": dense_init(gen, (dr, dr), **kw),
        "b_a": torch.zeros((dr,), **f32),
        "w_x": dense_init(gen, (dr, dr), **kw),
        "b_x": torch.zeros((dr,), **f32),
        "lambda_p": torch.log(root / (1.0 - root)),
        "w_out": dense_init(gen, (dr, d), **kw),
    }


def rglru_axes(cfg: ModelConfig):
    rnn = "rnn" if cfg.shard_rnn else None
    return {"w_in_x": ("embed", rnn), "w_in_gate": ("embed", rnn),
            "conv_w": ("conv", rnn), "conv_b": (rnn,), "w_a": (rnn, rnn),
            "b_a": (rnn,), "w_x": (rnn, rnn), "b_x": (rnn,),
            "lambda_p": (rnn,), "w_out": (rnn, "embed")}


def _conv1d(p, y, tail=None):
    """Causal depthwise conv of width W.  y: (B, S, dr); tail:
    (B, W - 1, dr).  Returns (out, new tail), in y's dtype."""
    w = p["conv_w"]
    width = w.shape[0]
    if tail is None:
        tail = torch.zeros((y.shape[0], width - 1, y.shape[2]),
                           dtype=y.dtype, device=y.device)
    ypad = torch.cat([tail.to(y.dtype), y], dim=1)
    out = sum(ypad[:, i:i + y.shape[1]] * w[i].to(y.dtype)
              for i in range(width))
    new_tail = ypad[:, ypad.shape[1] - (width - 1):]
    return out + p["conv_b"].to(y.dtype), new_tail


def _gates(p, y, cfg: ModelConfig, tp=None):
    """RG-LRU gates in float32.  y: (..., dr) (the rank's channels with
    ``tp``).  Returns (log a, b); the reference returns a = exp(log a) in
    place of log a."""
    yf = y.to(torch.float32)
    pre_a = yf @ p["w_a"].to(torch.float32)
    pre_x = yf @ p["w_x"].to(torch.float32)
    if tp is not None:
        pre_a, pre_x = tp.scatter(pre_a, -1), tp.scatter(pre_x, -1)
    r = torch.sigmoid(pre_a + p["b_a"])
    i = torch.sigmoid(pre_x + p["b_x"])
    log_a0 = F.logsigmoid(p["lambda_p"])       # log a in (-inf, 0)
    log_a = cfg.rglru_c * r * log_a0           # a_t = a^(c r_t)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return log_a, mult * (i * yf)


def rglru_block_forward(p, x, cfg: ModelConfig, state=None, tp=None):
    """Griffin recurrent block.  x: (B, S, d); state = (h, conv tail) or
    None (the rank's channels with ``tp``).  Returns (out, (h_last
    float32, new conv tail))."""
    h0, tail = state if state is not None else (None, None)
    if tp is not None:
        x = tp.enter(x)
    y = x @ p["w_in_x"]
    gate = activation("gelu")((x @ p["w_in_gate"]).to(torch.float32))
    y, new_tail = _conv1d(p, y, tail)
    log_a, b = _gates(p, y, cfg, tp)
    if h0 is not None:
        # h0 folds into the first step: b_0 + a_0 h0
        b0 = b[:, :1] + torch.exp(log_a[:, :1]) * h0[:, None].to(
            torch.float32)
        b = torch.cat([b0, b[:, 1:]], dim=1)
    if h0 is not None and y.shape[1] == 1:
        h = b                                  # the length-1 scan
    else:
        h = rglru_ops.rglru_scan_op(log_a, b)
    out = (h.to(y.dtype).to(torch.float32) * gate).to(x.dtype) @ p["w_out"]
    return (out if tp is None else tp.sum(out)), (h[:, -1], new_tail)
