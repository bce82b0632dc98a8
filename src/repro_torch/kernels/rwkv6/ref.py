"""Plain torch versions of WKV6, written after the JAX package's
``kernels/rwkv6/ref.py::reference_wkv6`` (the sequential oracle) and
``models/rwkv6.py::wkv6_chunked`` (the chunked form the model runs), and
of its gradient (:func:`wkv6_backward`).  The CPU tests use them, the entry
point takes :func:`wkv6_chunked` for CPU tensors (autograd differentiates
it), and ``chip_smoke.py`` holds the CUDA kernels (``csrc/wkv6.cu``,
``csrc/wkv6_bwd.cu``) against them on the card.
"""
from __future__ import annotations

import torch


def reference_wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r, k, v, log_w: (BH, S, hd); u: (BH, hd).  The exact sequential
    recurrence, in float32, returned in r's dtype::

        y_t = S_{t-1}^T r_t + (sum_i r_i u_i k_i) v_t
        S_t = diag(w_t) S_{t-1} + k_t v_t^T
    """
    bh, s, hd = r.shape
    rf, kf, vf = (x.to(torch.float32) for x in (r, k, v))
    wf = torch.exp(log_w.to(torch.float32))
    uf = u.to(torch.float32)
    state = torch.zeros((bh, hd, hd), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(s):
        rt, kt, vt = rf[:, t], kf[:, t], vf[:, t]
        ys.append(torch.einsum("bi,bij->bj", rt, state)
                  + (rt * uf * kt).sum(-1, keepdim=True) * vt)
        state = state * wf[:, t, :, None] + kt[:, :, None] * vt[:, None, :]
    return torch.stack(ys, dim=1).to(r.dtype)


def pick_chunk(s: int, target: int) -> int:
    """Largest divisor of s that is <= target (``_pick_chunk``)."""
    c = min(target, s)
    while s % c:
        c -= 1
    return max(c, 1)


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_w: torch.Tensor, u: torch.Tensor, chunk: int = 16):
    """Chunked WKV6 in the model layout.  r, k, v, log_w: (B, S, H, hd);
    u: (H, hd).  Returns y (B, S, H, hd) float32 and the final state
    (B, H, hd, hd) float32.  Within a chunk every decay factor is an
    exp of a non-positive number, so fast decay cannot overflow."""
    b, s, h, hd = r.shape
    chunk = pick_chunk(s, chunk)
    nc = s // chunk
    rf, kf, vf, lw = (x.to(torch.float32).reshape(b, nc, chunk, h, hd)
                      for x in (r, k, v, log_w))
    uf = u.to(torch.float32)
    state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                device=r.device), -1)
    ys = []
    for c in range(nc):
        rc, kc, vc, lwc = rf[:, c], kf[:, c], vf[:, c], lw[:, c]
        cs = torch.cumsum(lwc, dim=1)                  # inclusive
        cse = cs - lwc                                 # exclusive
        # inter-chunk: y1[t] = (r_t * exp(cse_t)) @ state
        y1 = torch.einsum("bthk,bhkv->bthv", rc * torch.exp(cse), state)
        # intra-chunk: pair[t,s,i] = r_t[i] k_s[i] exp(cse_t - cs_s), s < t
        ratio = cse[:, :, None] - cs[:, None, :]       # (B, t, s, H, hd)
        pair = rc[:, :, None] * kc[:, None, :] * torch.exp(
            torch.clamp(ratio, max=0.0))
        scores = pair.sum(-1) * tri[None, :, :, None]  # (B, t, s, H)
        y2 = torch.einsum("btsh,bshv->bthv", scores, vc)
        # diagonal (the current-token bonus u)
        diag = (rc * uf[None, None] * kc).sum(-1, keepdim=True) * vc
        decay_to_end = torch.exp(cs[:, -1:] - cs)
        state = state * torch.exp(cs[:, -1])[:, :, :, None] + torch.einsum(
            "bshk,bshv->bhkv", kc * decay_to_end, vc)
        ys.append(y1 + y2 + diag)
    y = torch.stack(ys, dim=1).reshape(b, s, h, hd)
    return y, state


def wkv6_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  log_w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
                  d_state=None):
    """The gradient of :func:`reference_wkv6`'s y and final state in the
    model layout: r, k, v, log_w, dy (B, S, H, hd), u (H, hd), d_state
    (B, H, hd, hd) or None (zero) -> (dr, dk, dv, dlog_w (B, S, H, hd),
    du (H, hd)), float32.  Step by step in float32, holding both states:
    S_{t-1} for every t from a forward walk, then, from G = d_state
    backwards, ``G_{t-1} = diag(w_t) G_t + r_t dy_t^T`` and::

        dr_t = S_{t-1} dy_t + u o k_t (v_t . dy_t)
        dk_t = G_t v_t + u o r_t (v_t . dy_t)
        dv_t = G_t^T k_t + (sum_i r_t u k_t) dy_t
        dlog_w_t = w_t o rowsum(G_t o S_{t-1})
        du = sum_{b, t} r_t o k_t (v_t . dy_t)
    """
    b, s, h, hd = r.shape
    rf, kf, vf, wf, dyf = (x.to(torch.float32).transpose(1, 2).reshape(
        b * h, s, hd) for x in (r, k, v, torch.exp(log_w.float()), dy))
    uf = u.to(torch.float32).repeat(b, 1)                  # (BH, hd)
    state = torch.zeros((b * h, hd, hd), dtype=torch.float32,
                        device=r.device)
    before = []
    for t in range(s):
        before.append(state)
        state = wf[:, t, :, None] * state + kf[:, t, :, None] * vf[:, t, None]
    g = (torch.zeros_like(state) if d_state is None
         else d_state.to(torch.float32).reshape(b * h, hd, hd).clone())
    vd = (vf * dyf).sum(-1, keepdim=True)                  # (BH, S, 1)
    bonus = (rf * uf[:, None] * kf).sum(-1, keepdim=True)
    grads = [torch.empty_like(rf) for _ in range(4)]
    for t in reversed(range(s)):
        grads[0][:, t] = torch.einsum("bij,bj->bi", before[t], dyf[:, t]) \
            + uf * kf[:, t] * vd[:, t]
        grads[1][:, t] = torch.einsum("bij,bj->bi", g, vf[:, t]) \
            + uf * rf[:, t] * vd[:, t]
        grads[2][:, t] = torch.einsum("bij,bi->bj", g, kf[:, t]) \
            + bonus[:, t] * dyf[:, t]
        grads[3][:, t] = wf[:, t] * (g * before[t]).sum(-1)
        g = wf[:, t, :, None] * g + rf[:, t, :, None] * dyf[:, t, None]
    du = (rf * kf * vd).sum(1).reshape(b, h, hd).sum(0)
    return tuple(x.reshape(b, h, s, hd).transpose(1, 2)
                 for x in grads) + (du,)
