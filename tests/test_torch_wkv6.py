"""Port parity, WKV6: ``repro_torch.kernels.rwkv6`` against the JAX package's
``repro.kernels.rwkv6`` and ``repro.models.rwkv6.wkv6_chunked`` on the same
inputs (made with numpy).

On the CPU the port's entry point (``ops.wkv6``) runs its plain chunked
version (``ref.wkv6_chunked``); it is held against the reference's
sequential oracle (``reference_wkv6``), its Pallas kernel in interpret mode
at chunks 16, 32 and 64 (``tests/test_kernels.py``'s cases), and the final
state of its ``wkv6_chunked``.  Tolerances: float32 ``atol=2e-4`` against
the oracle and the Pallas kernel (``tests/test_kernels.py``'s; the chunked
and sequential forms sum in another order), ``atol=rtol=1e-4`` against
``wkv6_chunked`` (the same chunked arithmetic); bf16 inputs one bf16 ulp of
the output (``atol=rtol=1e-2``).  The CUDA kernel is held against the plain
versions on the card by the ``cuda``-marked test, which skips without a
card.

The gradient: the plain backward (``ref.wkv6_backward``) is held against
``jax.vjp`` of the reference's oracle and of its ``wkv6_chunked``, and the
backward kernel's algorithm (the pair identity for dlog_w), emulated in
float32, against float64 autograd at S 512; tolerances in each test's
docstring.  The ``cuda``-marked test holds the backward kernel to the plain
backward on the card.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6 import reference_wkv6 as r_reference_wkv6
from repro.kernels.rwkv6 import wkv6 as r_wkv6
from repro.models.rwkv6 import wkv6_chunked as r_wkv6_chunked
from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6 import kernel, ops, ref

F32 = dict(atol=2e-4, rtol=0)
SAME = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=1e-2, rtol=1e-2)


def _inputs(b, s, h, hd, seed=0, log_w=None):
    """tests/test_kernels.py's distributions: r, k at 0.5, v standard,
    log_w = -exp(N(0, 1)) unless given, u at 0.3."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((b, s, h, hd)).astype(np.float32) * 0.5
    k = rng.standard_normal((b, s, h, hd)).astype(np.float32) * 0.5
    v = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    lw = (-np.exp(rng.standard_normal((b, s, h, hd))) if log_w is None
          else np.full((b, s, h, hd), log_w)).astype(np.float32)
    u = rng.standard_normal((h, hd)).astype(np.float32) * 0.3
    return r, k, v, lw, u


def _fold(x):
    b, s, h, hd = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, s, hd)


def _unfold(y, b, h):
    bh, s, hd = y.shape
    return y.reshape(b, h, s, hd).transpose(0, 2, 1, 3)


def _oracle(r, k, v, lw, u):
    """The reference's sequential oracle, in the model layout."""
    b, _, h, hd = r.shape
    uf = np.tile(u[None], (b, 1, 1)).reshape(b * h, hd)
    y = r_reference_wkv6(*(jnp.asarray(_fold(x)) for x in (r, k, v, lw)),
                         jnp.asarray(uf))
    return _unfold(np.asarray(y, np.float32), b, h)


def _np(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("s", [64, 128])
def test_wkv6_chunk_boundaries(chunk, s):
    """The plain chunked version at chunk 16, 32 and 64 against the
    reference's oracle and its Pallas kernel (interpret mode) at the same
    chunk: ``atol=2e-4``; the port's own oracle agrees to the same."""
    b, h, hd = 2, 2, 32
    r, k, v, lw, u = _inputs(b, s, h, hd)
    y, state = ref.wkv6_chunked(*(torch.tensor(x) for x in (r, k, v, lw, u)),
                                chunk=chunk)
    assert y.dtype == torch.float32 and state.shape == (b, h, hd, hd)
    np.testing.assert_allclose(_np(y), _oracle(r, k, v, lw, u), **F32)
    pallas = r_wkv6(*(jnp.asarray(x) for x in (r, k, v, lw, u)),
                    chunk=chunk, interpret=True)
    np.testing.assert_allclose(_np(y), np.asarray(pallas, np.float32), **F32)
    uf = np.tile(u[None], (b, 1, 1)).reshape(b * h, hd)
    own = ref.reference_wkv6(*(torch.tensor(_fold(x))
                               for x in (r, k, v, lw)), torch.tensor(uf))
    np.testing.assert_allclose(_unfold(_np(own), b, h), _np(y), **F32)


@pytest.mark.parametrize("s,chunk", [(64, 16), (100, 16), (48, 64)])
def test_wkv6_state_matches_wkv6_chunked(s, chunk):
    """Output and final state against the model's ``wkv6_chunked`` (S 100
    picks chunk 10, S 48 at target 64 picks 48): ``atol=rtol=1e-4``."""
    r, k, v, lw, u = _inputs(2, s, 3, 16, seed=1)
    y, state = ops.wkv6(*(torch.tensor(x) for x in (r, k, v, lw, u)),
                        chunk=chunk)
    want_y, want_state = r_wkv6_chunked(
        *(jnp.asarray(x) for x in (r, k, v, lw, u)), chunk=chunk)
    np.testing.assert_allclose(_np(y), np.asarray(want_y), **SAME)
    np.testing.assert_allclose(_np(state), np.asarray(want_state), **SAME)
    assert ref.pick_chunk(s, chunk) == {64: 16, 100: 10, 48: 48}[s]


@pytest.mark.parametrize("log_w", [-15.0, -float(np.exp(8.0))])
def test_wkv6_fast_decay_stability(log_w):
    """Near-total decay every step (-15, and the model's clip at -exp(8)):
    finite; y against the model's ``wkv6_chunked`` and the reference's
    oracle, ``atol=2e-4`` at -15; at -exp(8) also ``rtol=1e-2``: the
    chunked form's cumulated log-decay reaches -4.8e4 within a chunk, where
    a float32 ulp is 2^-8, so the exponents of its exp(cse_t - cs_s) ratios
    are off by a few such ulps (the reference's ``wkv6_chunked`` as the
    port's, each with its own cumsum rounding).  The state keeps only the last token's
    k v^T (``atol=2e-4``)."""
    r, k, v, lw, u = _inputs(1, 64, 1, 16, seed=2, log_w=log_w)
    u = np.zeros_like(u)
    y, state = ops.wkv6(*(torch.tensor(x) for x in (r, k, v, lw, u)))
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    tol = dict(atol=2e-4, rtol=0 if log_w == -15.0 else 1e-2)
    want_y, _ = r_wkv6_chunked(*(jnp.asarray(x) for x in (r, k, v, lw, u)))
    np.testing.assert_allclose(_np(y), np.asarray(want_y), **tol)
    np.testing.assert_allclose(_np(y), _oracle(r, k, v, lw, u), **tol)
    last = np.outer(k[0, -1, 0], v[0, -1, 0])
    np.testing.assert_allclose(state[0, 0].numpy(), last, **F32)


def test_wkv6_bf16_inputs():
    """bf16 r, k, v (float32 log_w and u, as the model gives them): y comes
    back in bf16, within one bf16 ulp of the oracle on the same bf16
    values."""
    r, k, v, lw, u = _inputs(2, 40, 2, 16, seed=3)
    rb, kb, vb = (torch.tensor(x, dtype=torch.bfloat16) for x in (r, k, v))
    y, state = ops.wkv6(rb, kb, vb, torch.tensor(lw), torch.tensor(u))
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    want = _oracle(*(_np(t) for t in (rb, kb, vb)), lw, u)
    np.testing.assert_allclose(_np(y), want, **BF16)


def test_cuda_launch_raises_on_cpu_tensors():
    """The kernel's launcher takes CUDA tensors only; CPU tensors go through
    ``ops`` to the plain version."""
    x = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.wkv6_fwd(x, x, x, x, torch.zeros((2, 8)))


def test_launch_counts_reset():
    """``reset_launches`` zeroes every dtype's count of the forward and
    the backward (``chip_smoke.py`` zeroes them before each run it
    counts)."""
    kernel.LAUNCHES["bfloat16"] = 3
    kernel.BWD_LAUNCHES["float32"] = 2
    kernel.reset_launches()
    assert kernel.LAUNCHES == {"bfloat16": 0, "float32": 0}
    assert kernel.BWD_LAUNCHES == {"bfloat16": 0, "float32": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [1, 8, 32, 33, 64, 100, 128])
def test_launch_geometry_fits_the_card(hd, dtype):
    """``kernel.launch_geometry``, the launch of ``csrc/wkv6.cu`` (which
    refuses any other): one block per (batch, head); the head dim padded to
    the smallest of 32, 64, 128 that holds it; two columns a thread and
    rows a thread in multiples of 4 (16-byte reads); within an H100's
    threads a block and shared memory; the served (4, S, 64, 64) bf16 as
    256 blocks of 8 warps.  The constants are the kernel source's."""
    src = kernel.SOURCE.read_text()
    for name, value in (("TOKENS", kernel.TOKENS),
                        ("GROUPS", kernel.ROW_GROUPS)):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) \
            == str(value)
    g = kernel.launch_geometry(4, 64, hd, dtype)
    assert g.grid == 256
    assert g.head_pad in (32, 64, 128) and hd <= g.head_pad
    assert g.head_pad == 32 or hd > g.head_pad // 2
    assert g.threads == g.row_groups * g.head_pad // 2
    assert g.threads % 32 == 0 and g.threads <= 1024
    assert (g.head_pad // g.row_groups) % 4 == 0
    assert g.smem_bytes <= _build.MAX_SMEM_BYTES
    if (hd, dtype) == (64, torch.bfloat16):
        assert g.threads == 256


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version_on_the_card():
    """The CUDA kernel against the plain versions on the same card inputs:
    y against the sequential oracle (the kernel's own form; float32
    ``atol=2e-4, rtol=1e-5``, bf16 y one bf16 ulp, ``rtol=2^-7``), y and
    the final state against ``wkv6_chunked`` (the same; at the clip extreme
    the state only, where the chunked form's y is inexact, as above), at
    chunk boundaries, a ragged S, fast decay, head dims 8 to 128, the
    served shape (4, 512, 64, 64) and hd 128 at a ragged S.  Skips without
    a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [(2, 64, 2, 32, None), (2, 128, 2, 32, None),
             (1, 100, 3, 64, None), (1, 64, 1, 16, -15.0),
             (1, 64, 1, 16, -float(np.exp(8.0))), (1, 37, 2, 8, None),
             (1, 70, 2, 128, None), (4, 512, 64, 64, None),
             (2, 77, 3, 128, None)]
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, h, hd, log_w in cases:
            r, k, v, lw, u = (torch.tensor(x, device="cuda") for x in
                              _inputs(b, s, h, hd, log_w=log_w))
            r, k, v = (t.to(dtype) for t in (r, k, v))
            y, state = ops.wkv6(r, k, v, lw, u)
            assert y.dtype == dtype and state.dtype == torch.float32
            rtol = 1e-5 if dtype == torch.float32 else 2 ** -7
            fold = [t.transpose(1, 2).reshape(b * h, s, hd)
                    for t in (r, k, v, lw)]
            oracle = ref.reference_wkv6(*fold, u.repeat(b, 1))
            torch.testing.assert_close(
                y.float(), oracle.reshape(b, h, s, hd).transpose(1, 2)
                .float(), atol=2e-4, rtol=rtol)
            want_y, want_state = ref.wkv6_chunked(r, k, v, lw, u)
            if log_w is None or log_w == -15.0:
                torch.testing.assert_close(
                    y.float(), want_y.to(dtype).float(), atol=2e-4,
                    rtol=rtol)
            torch.testing.assert_close(state, want_state, atol=2e-4,
                                       rtol=1e-5)


def _share(got, want):
    """The largest |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _jax_vjp(fn, primals, cotangents):
    import jax
    _, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in primals))
    return [np.asarray(g, np.float32) for g in vjp(cotangents)]


def _jax_oracle(b, s, h, hd):
    """The reference's sequential oracle as a function of model-layout
    (r, k, v, log_w, u), for ``jax.vjp``."""
    def oracle(r, k, v, lw, u):
        uf = jnp.tile(u[None], (b, 1, 1)).reshape(b * h, hd)
        y = r_reference_wkv6(*(x.transpose(0, 2, 1, 3).reshape(b * h, s, hd)
                               for x in (r, k, v, lw)), uf)
        return y.reshape(b, h, s, hd).transpose(0, 2, 1, 3)
    return oracle


def _plain_backward(r, k, v, lw, u, dy, ds=None):
    got = ref.wkv6_backward(*(torch.tensor(x) for x in (r, k, v, lw, u, dy)),
                            None if ds is None else torch.tensor(ds))
    return [g.numpy() for g in got]


@pytest.mark.parametrize("s,h,hd,log_w", [(40, 2, 16, None), (33, 3, 8, None),
                                           (64, 1, 16, -15.0)])
def test_wkv6_backward_matches_jax_grad_of_reference(s, h, hd, log_w):
    """The plain backward (``ref.wkv6_backward``: S_{t-1} held for every
    t, G walked back) against ``jax.vjp`` of the reference's sequential
    oracle ``reference_wkv6`` on the same dy: dr, dk, dv, dlog_w and du
    each within 2e-5 of its largest |value| (float32 on both sides, sums
    in other orders; about 1e-6 is seen)."""
    r, k, v, lw, u = _inputs(2, s, h, hd, seed=5, log_w=log_w)
    dy = np.random.default_rng(6).standard_normal(r.shape).astype(np.float32)
    want = _jax_vjp(_jax_oracle(*r.shape), (r, k, v, lw, u),
                    jnp.asarray(dy))
    got = _plain_backward(r, k, v, lw, u, dy)
    for name, g, w in zip(("dr", "dk", "dv", "dlog_w", "du"), got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        assert _share(g, w) <= 2e-5, name


@pytest.mark.parametrize("s,chunk", [(48, 16), (100, 10)])
def test_wkv6_backward_matches_jax_grad_of_wkv6_chunked(s, chunk):
    """The plain backward against ``jax.vjp`` of the model's
    ``wkv6_chunked`` (the training form), with a gradient of the final
    state as well as of y, away from the decay clip: each gradient within
    2e-5 of its largest |value|."""
    r, k, v, lw, u = _inputs(2, s, 2, 16, seed=7)
    rng = np.random.default_rng(8)
    dy = rng.standard_normal(r.shape).astype(np.float32)
    ds = rng.standard_normal((2, 2, 16, 16)).astype(np.float32)
    want = _jax_vjp(lambda *a: r_wkv6_chunked(*a, chunk=chunk),
                    (r, k, v, lw, u), (jnp.asarray(dy), jnp.asarray(ds)))
    got = _plain_backward(r, k, v, lw, u, dy, ds)
    for name, g, w in zip(("dr", "dk", "dv", "dlog_w", "du"), got, want):
        assert _share(g, w) <= 2e-5, name


def test_wkv6_backward_at_the_decay_clip():
    """At the model's clip log_w = -exp(8) every w is 0 in float32: the
    plain backward against ``jax.vjp`` of the oracle (exact there, unlike
    the chunked form), within 2e-5 of each largest |value|; dlog_w = w o
    rowsum(G o S) is exactly 0 on both sides."""
    r, k, v, lw, u = _inputs(1, 64, 2, 16, seed=9, log_w=-float(np.exp(8.0)))
    dy = np.random.default_rng(10).standard_normal(r.shape).astype(
        np.float32)
    want = _jax_vjp(_jax_oracle(*r.shape), (r, k, v, lw, u),
                    jnp.asarray(dy))
    got = _plain_backward(r, k, v, lw, u, dy)
    assert (got[3] == 0).all() and (want[3] == 0).all()
    for name, g, w in zip(("dr", "dk", "dv", "du"), got[:3] + got[4:],
                          want[:3] + want[4:]):
        assert _share(g, w) <= 2e-5, name


def _fma(a, b, c):
    """float32 fused multiply-add: the exact product and sum in float64,
    rounded once to float32."""
    return (a.double() * b.double() + c.double()).float()


def _tree(x):
    """Sum the last dim (a power of two) in the kernel's tree order:
    neighbours first (the butterfly over lanes, the groups' partials)."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _row_dot(x, y, scale=None):
    """The kernel's per-token dot product: 8 segments of HD / 8 elements,
    each adding x_i y_i (x_i times ``scale`` first, rounded) in order with
    fused multiply-adds, then the segments in tree order.  x, y
    (..., HD)."""
    if scale is not None:
        x = x * scale
    seg = x.shape[-1] // 8
    xs = x.reshape(x.shape[:-1] + (8, seg))
    ys = y.reshape(y.shape[:-1] + (8, seg))
    acc = torch.zeros(x.shape[:-1] + (8,), dtype=torch.float32)
    for m in range(seg):
        acc = _fma(xs[..., m], ys[..., m], acc)
    return _tree(acc)


def _walk_sums(state, vec, sum_dim):
    """A walk's product of one token, as the kernel sums it: ``state``
    (BH, HD, HD); ``vec`` (BH, HD) over the summed index (the columns when
    ``sum_dim`` is 2, the rows when 1), split into ``BWD_GROUPS`` groups
    of R, each summed in two chains (even and odd c, fused multiply-adds)
    and the chains added, then the groups in tree order."""
    bh, hd_pad, _ = state.shape
    groups = kernel.BWD_GROUPS
    rr = hd_pad // groups
    st = state if sum_dim == 2 else state.transpose(1, 2)
    st = st.reshape(bh, hd_pad, groups, rr)
    vg = vec.reshape(bh, 1, groups, rr)
    chains = [torch.zeros((bh, hd_pad, groups)) for _ in range(2)]
    for c in range(rr):
        chains[c & 1] = _fma(st[..., c], vg[..., c], chains[c & 1])
    return _tree(chains[0] + chains[1])


def _kernel_walks(r, k, v, lw, u, dy, ds):
    """``csrc/wkv6_bwd.cu``'s algorithm, step for step in float32 torch on
    folded (BH, S, hd) inputs, u (BH, hd), ds (BH, hd, hd), padded to the
    kernel's head dim with zeros (w = 1): the per-token dot products once a
    token in the kernel's order (``_row_dot``: v_t . dy_t, v_t . dy_{t+1},
    sum_i r u k); a forward walk one token behind (S_{t-2}) for dr and c_t = r_t
    w_{t-1} (S_{t-2} dy_t), a backward walk one token behind (G_{s+1}) for
    dk and e_s = k_s w_{s+1} (G_{s+1} v_s), a backward walk of G for dv,
    each token's product summed as ``_walk_sums`` and each update S =
    fma(w, S, k v) with k v rounded; c_T from the final state in the same
    order; and dlog_w as the suffix sums of c (from c_T) less those of e,
    du in t order."""
    bh, s, hd = r.shape
    pad = 32 if hd <= 32 else 64 if hd <= 64 else 128

    def padded(x, value=0.0):
        return torch.nn.functional.pad(x, (0, pad - hd), value=value)
    r, k, v, dy = (padded(x) for x in (r, k, v, dy))
    w = torch.exp(padded(lw))
    u = padded(u)
    ds = torch.nn.functional.pad(ds, (0, pad - hd, 0, pad - hd))
    zero = torch.zeros((bh, pad), dtype=torch.float32)
    one = torch.ones_like(zero)
    vd = _row_dot(v, dy)                                  # v_t . dy_t
    vn = torch.zeros_like(vd)                              # v_t . dy_{t+1}
    vn[:, :-1] = _row_dot(v[:, :-1], dy[:, 1:])
    bonus = _row_dot(r, k, u[:, None])
    state = torch.zeros((bh, pad, pad), dtype=torch.float32)
    dr, c = torch.empty_like(r), torch.empty_like(r)
    du = torch.zeros_like(zero)
    for t in range(s):
        wp, kp, vp = ((x[:, t - 1] if t else z) for x, z in
                      ((w, one), (k, zero), (v, zero)))
        pv = vn[:, t - 1] if t else torch.zeros(bh)
        wa = wp * _walk_sums(state, dy[:, t], 2)
        dr[:, t] = (wa + kp * pv[:, None]) + (u * k[:, t]) * vd[:, t, None]
        c[:, t] = r[:, t] * wa
        du = _fma(r[:, t] * k[:, t], vd[:, t, None], du)
        state = _fma(wp[:, :, None], state, kp[:, :, None] * vp[:, None])
    groups = kernel.BWD_GROUPS
    chain = torch.zeros((bh, pad, groups))
    prod = (ds, state)
    for cc in range(pad // groups):
        chain = _fma(*(x.reshape(bh, pad, groups, -1)[..., cc] for x in prod),
                     chain)
    c_tail = w[:, -1] * _tree(chain)
    g = ds.clone()
    dk, e = torch.empty_like(r), torch.empty_like(r)
    for t in reversed(range(s)):
        last = t == s - 1
        wn = one if last else w[:, t + 1]
        rn, dyn = (zero, zero) if last else (r[:, t + 1], dy[:, t + 1])
        wb = wn * _walk_sums(g, v[:, t], 2)
        dk[:, t] = (wb + rn * vn[:, t, None]) + (u * r[:, t]) * vd[:, t, None]
        e[:, t] = 0.0 if last else k[:, t] * wb
        g = _fma(wn[:, :, None], g, rn[:, :, None] * dyn[:, None])
    g = ds.clone()
    dv = torch.empty_like(r)
    for t in reversed(range(s)):
        dv[:, t] = _fma(bonus[:, t, None], dy[:, t], _walk_sums(g, k[:, t], 1))
        g = _fma(w[:, t, :, None], g, r[:, t, :, None] * dy[:, t, None])
    acc, dlw = c_tail, torch.empty_like(r)
    for t in reversed(range(s)):
        acc = acc - e[:, t]
        dlw[:, t] = acc
        acc = acc + c[:, t]
    return tuple(x[..., :hd] for x in (dr, dk, dv, dlw, du))


def _float64_grads(r, k, v, lw, u, dy, ds):
    """Autograd of the sequential recurrence in float64 (the truth)."""
    xs = [t.clone().requires_grad_() for t in (r, k, v, lw, u)]
    rr, kk, vv, ll, uu = xs
    state = torch.zeros_like(ds)
    w = torch.exp(ll)
    loss = 0.0
    for t in range(r.shape[1]):
        y = torch.einsum("bi,bij->bj", rr[:, t], state) \
            + (rr[:, t] * uu * kk[:, t]).sum(-1, keepdim=True) * vv[:, t]
        loss = loss + (y * dy[:, t]).sum()
        state = w[:, t, :, None] * state + kk[:, t, :, None] * vv[:, t, None]
    loss = loss + (state * ds).sum()
    return torch.autograd.grad(loss, xs)


@pytest.fixture
def one_thread():
    """Torch on one thread for the test, restored after: the walks are 512
    steps of small products, which a thread pool shared with other test
    processes slows a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("log_w", [None, -float(np.exp(-6.0)),
                                   -float(np.exp(8.0))])
def test_kernel_algorithm_cancellation_at_s512(log_w, one_thread):
    """The backward kernel's dlog_w is a difference of suffix sums (the
    pair identity in ``csrc/wkv6_bwd.cu``), which could cancel.  Its
    algorithm, emulated in float32 (``_kernel_walks``), against float64
    autograd at S 512, hd 64, for random decay, the model's initial decay
    -exp(-6) (slow: long sums) and the clip -exp(8): every gradient within
    4e-6 of its largest |value| (up to 1.5e-6 seen, as the direct form in
    float32 gives: no cancellation beyond float32 summation), and at the
    clip dlog_w exactly 0."""
    r, k, v, lw, u = _inputs(1, 512, 2, 64, seed=11, log_w=log_w)
    rng = np.random.default_rng(12)
    dy = rng.standard_normal(r.shape)
    ds = rng.standard_normal((2, 64, 64))
    folded = [torch.tensor(_fold(x)) for x in (r, k, v, lw, dy)]
    uf, dsf = torch.tensor(u), torch.tensor(ds)
    r64, k64, v64, lw64, dy64 = (x.double() for x in folded)
    want = _float64_grads(r64, k64, v64, lw64, uf.double(), dy64,
                          dsf.double())
    got = _kernel_walks(*(x.float() for x in folded[:4]), uf.float(),
                        folded[4].float(), dsf.float())
    for name, g, w in zip(("dr", "dk", "dv", "dlog_w", "du"), got, want):
        assert _share(g.numpy(), w.numpy()) <= 4e-6, name
    if log_w is not None and log_w < -100:
        assert (got[3] == 0).all()


def test_meta_autograd_counts_the_backward():
    """On ``meta`` tensors under autograd ``ops.wkv6`` counts the forward
    kernel's work and, in the backward, the backward kernel's (12 hd^2
    operations a token and head; r, k, v, dy read and dr, dk, dv written
    in r's dtype, log_w read and dlog_w written in float32, u and du)
    instead of raising."""
    from repro_torch import roofline
    b, s, h, hd = 2, 8, 3, 16
    r = torch.empty((b, s, h, hd), device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    lw = torch.empty((b, s, h, hd), device="meta", requires_grad=True)
    u = torch.empty((h, hd), device="meta", requires_grad=True)
    with roofline.Counter() as c:
        y, _ = ops.wkv6(r, r, r, lw, u)
        y.sum().backward()
    st = c.stats()
    assert st["kernel_calls"] == {"wkv6": 1, "wkv6_bwd": 1}
    assert ops.cost(r, lw, u, backward=True) == (
        12 * hd * hd * b * s * h, 7 * r.numel() * 2 + 8 * lw.numel()
        + 8 * u.numel())
    assert r.grad is not None and r.grad.shape == r.shape


@pytest.mark.parametrize("hd", [1, 8, 32, 33, 64, 100, 128])
def test_bwd_geometry_fits_the_card(hd):
    """``kernel.bwd_geometry``, the backward walks' launch (which
    ``csrc/wkv6_bwd.cu`` checks): three blocks a (batch, head), one a
    role; the summed index of the state padded to 32, 64 or 128 in
    ``BWD_GROUPS`` groups of a multiple of 4 (16-byte broadcast loads),
    two lane indices a thread, whole warps; within an H100's threads a
    block and, in both dtypes, its shared memory: the double-buffered raw
    window of ``TOKENS`` + 1 tokens (log_w float32; r, k, v, dy in the
    dtype), three float32 arrays of it, the walks' partial sums, u and
    the per-token scalars (two a window row), each array 16-byte aligned.
    The constants are the kernel source's."""
    src = kernel.BWD_SOURCE.read_text()
    for name, value in (("TOKENS", kernel.TOKENS),
                        ("GROUPS", kernel.BWD_GROUPS),
                        ("SCALARS", kernel.BWD_SCALARS)):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) \
            == str(value)
    assert "constexpr int WINDOW = TOKENS + 1;" in src
    window = kernel.TOKENS + 1
    assert kernel.BWD_SCALARS >= 2 * window and kernel.BWD_SCALARS % 4 == 0
    for dtype, size in ((torch.float32, 4), (torch.bfloat16, 2)):
        g = kernel.bwd_geometry(4, 64, hd, dtype)
        assert g.grid == 3 * 256
        assert g.head_pad in (32, 64, 128) and hd <= g.head_pad
        assert g.threads == g.groups * g.head_pad // 2
        assert g.threads % 32 == 0 and g.threads <= 1024
        assert (g.head_pad // g.groups) % 4 == 0
        # an item of the sums: 16 bytes of an output row, whole in the row
        assert g.head_pad % (16 // size) == 0
        row = window * g.head_pad
        floats = (2 + 3) * row + kernel.TOKENS * g.groups * g.head_pad \
            + g.head_pad + kernel.BWD_SCALARS
        assert g.smem_bytes == 4 * floats + size * 8 * row
        assert (4 * floats) % 16 == 0 and (size * row) % 16 == 0
        assert g.smem_bytes <= _build.MAX_SMEM_BYTES


@pytest.mark.cuda
def test_cuda_backward_matches_plain_version_on_the_card():
    """The backward kernel (through ``ops.wkv6``'s autograd function, and
    called alone with a final-state gradient) against the plain backward
    on the same card inputs: each gradient within 2e-5 of its largest
    |value| in float32 (sums in other orders), and dr, dk, dv within 2^-7
    in bf16 (each rounded once to bf16), dlog_w and du (float32 outputs of
    the same bf16 inputs) within 2e-5; at chunk boundaries, a ragged S,
    head dims 8 to 128, the clip (dlog_w exactly 0) and the training shape
    (4, 512, 64, 64).  Two runs give the same bits.  Skips without a
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [(2, 64, 2, 32, None), (1, 100, 3, 64, None),
             (1, 64, 1, 16, -float(np.exp(8.0))), (1, 37, 2, 8, None),
             (2, 77, 3, 128, None), (4, 512, 64, 64, None)]
    for dtype in (torch.float32, torch.bfloat16):
        low = 2e-5 if dtype == torch.float32 else 2 ** -7
        for b, s, h, hd, log_w in cases:
            r, k, v, lw, u = (torch.tensor(x, device="cuda") for x in
                              _inputs(b, s, h, hd, log_w=log_w))
            r, k, v = (t.to(dtype) for t in (r, k, v))
            rng = np.random.default_rng(13)
            dy = torch.tensor(rng.standard_normal(r.shape), device="cuda",
                              dtype=dtype)
            ds = torch.tensor(rng.standard_normal((b, h, hd, hd)),
                              device="cuda", dtype=torch.float32)
            want = ref.wkv6_backward(r, k, v, lw, u, dy, ds)
            got = kernel.wkv6_bwd(r, k, v, lw, u, dy, ds)
            assert torch.equal(got[3], kernel.wkv6_bwd(
                r, k, v, lw, u, dy, ds)[3])
            for g, w, tol in zip(got, want, (low, low, low, 2e-5, 2e-5)):
                assert _share(g.float().cpu(), w.cpu()) <= tol
            if log_w is not None:
                assert (got[3] == 0).all()
            leaves = [t.clone().requires_grad_() for t in (r, k, v, lw, u)]
            y, _ = ops.wkv6(*leaves)
            grads = torch.autograd.grad(y, leaves, dy)
            want = ref.wkv6_backward(r, k, v, lw, u, dy)
            for g, w, tol in zip(grads, want, (low, low, low, 2e-5, 2e-5)):
                assert _share(g.float().cpu(), w.cpu()) <= tol
