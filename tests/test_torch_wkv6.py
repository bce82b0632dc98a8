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
    """``reset_launches`` zeroes every dtype's count (``chip_smoke.py``
    zeroes them before each run it counts)."""
    kernel.LAUNCHES["bfloat16"] = 3
    kernel.reset_launches()
    assert kernel.LAUNCHES == {"bfloat16": 0, "float32": 0}


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
