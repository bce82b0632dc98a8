"""Port parity, flash attention: ``repro_torch.kernels.flash`` against the
JAX package's ``repro.kernels.flash`` on the same inputs (made with numpy).

On the CPU the port's entry point (``ops.flash_attention``) runs its plain
torch version; it is held against the reference's oracle
(``reference_attention``) and against the Pallas kernel in interpret mode,
over the cases of ``tests/test_kernels.py``.  Tolerances, those of
``test_kernels.py``: 2e-5 (``atol`` and ``rtol``) in float32 (both sides
compute in float32; the sums run in another order), 2e-2 in bfloat16 (the
same float32 math on bf16 inputs, the output rounded once to bf16, so one
bf16 ulp apart at most).  The bf16 CUDA kernel rounds p to bf16 before
p . v; ``ref.reference_attention_bf16_p``, the plain model of that, is held
to the reference's oracle at the bf16 tolerance on cut served shapes.  The
CUDA kernel is held against the plain version on the card by the
``cuda``-marked test, which skips without a card.  The gradient: on the
CPU autograd through the plain version against ``jax.grad`` of the
reference's jnp attention (what the JAX package differentiates when it
trains), and the backward kernel's plain model beside it; on the card the
backward kernel against the plain version's autograd (``cuda`` marker).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash import flash_attention as r_flash_attention
from repro.kernels.flash import reference_attention as r_reference_attention
from repro_torch.kernels.flash import kernel, ops, ref

CASES = [
    (2, 128, 128, 4, 2, 64, True, 0, 0.0),      # GQA causal
    (1, 256, 256, 4, 4, 64, True, 64, 0.0),     # sliding window
    (2, 128, 128, 8, 2, 32, True, 0, 50.0),     # softcap (gemma2)
    (1, 192, 192, 2, 1, 64, False, 0, 0.0),     # bidirectional (encoder)
    (1, 96, 160, 2, 2, 64, False, 0, 0.0),      # cross-attn shape, ragged blocks
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(b, sq, skv, hq, hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, hd)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, hd)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, hd)).astype(np.float32))


def _fold(x, h):
    b, s, _, hd = x.shape
    x = (x.permute(0, 2, 1, 3) if isinstance(x, torch.Tensor)
         else x.transpose(0, 2, 1, 3))
    return x.reshape(b * h, s, hd)


def _np(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,sq,skv,hq,hkv,hd,causal,window,cap", CASES)
def test_flash_matches_reference(b, sq, skv, hq, hkv, hd, causal, window,
                                 cap, dtype):
    """Tolerance 2e-5 (float32) or 2e-2 (bfloat16), atol and rtol."""
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(b, sq, skv, hq, hkv, hd)
    got = ops.flash_attention(*(torch.tensor(a, dtype=tdt) for a in (q, k, v)),
                              causal=causal, window=window, softcap=cap)
    assert got.dtype == tdt and tuple(got.shape) == (b, sq, hq, hd)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    oracle = r_reference_attention(_fold(jq, hq), _fold(jk, hkv),
                                   _fold(jv, hkv), causal=causal,
                                   window=window, softcap=cap)
    oracle = np.asarray(oracle, np.float32).reshape(b, hq, sq, hd)
    np.testing.assert_allclose(_np(got), oracle.transpose(0, 2, 1, 3),
                               atol=tol, rtol=tol)
    pallas = r_flash_attention(jq, jk, jv, causal=causal, window=window,
                               softcap=cap, block_q=64, block_k=64,
                               interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(pallas, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_folded_plain_version_matches_oracle(dtype):
    """The plain version in the kernel's folded layout, with a fully masked
    row block (a window that ends before the keys do), against the
    reference's oracle.  Tolerance as above."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(3)
    q = rng.standard_normal((4, 128, 64)).astype(np.float32)
    k = rng.standard_normal((2, 64, 64)).astype(np.float32)
    v = rng.standard_normal((2, 64, 64)).astype(np.float32)
    got = ref.reference_attention(*(torch.tensor(a, dtype=tdt)
                                     for a in (q, k, v)),
                                  causal=False, window=16)
    want = r_reference_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                 causal=False, window=16)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    assert (_np(got)[:, 80:] == 0).all()      # rows that see no key


# (B, Sq, Skv, Hq, Hkv, hd, causal, window, cap): the served shapes cut to
# one sequence: qwen3-moe-30b-a3b (8 query heads on one K/V head) and
# recurrentgemma-9b (2 on 1, 2560 tokens past the 2048-token window)
SERVED_CUT = {"qwen": (1, 512, 512, 8, 1, 128, True, 0, 0.0),
              "recurrentgemma": (1, 2560, 2560, 2, 1, 256, True, 2048, 0.0)}


@pytest.mark.parametrize("case", list(SERVED_CUT), ids=list(SERVED_CUT))
def test_bf16_p_model_matches_reference(case):
    """The plain model of the bf16 kernel's arithmetic (p rounded to bf16
    before p . v) against the reference's oracle on bf16 inputs, at the
    bf16 tolerance (2e-2, atol and rtol): the new rounding fits the
    tolerance budget the kernel is held to."""
    b, sq, skv, hq, hkv, hd, causal, window, cap = SERVED_CUT[case]
    jdt, tdt, tol = DTYPES["bfloat16"]
    q, k, v = (_fold(a, h) for a, h in zip(_inputs(b, sq, skv, hq, hkv, hd),
                                           (hq, hkv, hkv)))
    got = ref.reference_attention_bf16_p(
        *(torch.tensor(a, dtype=tdt) for a in (q, k, v)), causal=causal,
        window=window, softcap=cap)
    assert got.dtype == torch.float32
    want = r_reference_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                 causal=causal, window=window, softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_bf16_launch_raises_on_other_tiles():
    """The bf16 kernel's tiles are fixed: another block shape raises, it is
    not ignored."""
    q = torch.zeros((2, 8, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="fixed"):
        kernel.flash_attention_fwd(q, q, q, block_q=32)


def test_cuda_launch_raises_on_cpu_tensors():
    """The kernel's launcher takes CUDA tensors only; CPU tensors go through
    ``ops`` to the plain version."""
    q = torch.zeros((2, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_fwd(q, q, q)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version_on_the_card():
    """The CUDA kernel against the plain version on the same card inputs,
    with the tolerances above, at these cases and the served shapes (qwen,
    recurrentgemma and gemma2-27b's soft-capped local attention); in bf16
    also against the plain model of its p rounding (atol 4e-3, rtol half a
    bf16 ulp, as ``chip_smoke.py``); and block-shape independence (atol
    1e-5 in float32, the reference's own bound).  Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for dtype in DTYPES:
        _, tdt, tol = DTYPES[dtype]
        for case in CASES + [(4, 512, 512, 32, 4, 128, True, 0, 0.0),
                             (4, 2560, 2560, 16, 1, 256, True, 2048, 0.0),
                             (1, 4608, 4608, 32, 16, 128, True, 4096, 50.0)]:
            b, sq, skv, hq, hkv, hd, causal, window, cap = case
            t = [torch.tensor(a, dtype=tdt, device="cuda")
                 for a in _inputs(b, sq, skv, hq, hkv, hd)]
            got = ops.flash_attention(*t, causal=causal, window=window,
                                      softcap=cap)
            fold = [_fold(x, h).contiguous()
                    for x, h in zip(t, (hq, hkv, hkv))]
            want = ref.reference_attention(*fold, causal=causal,
                                           window=window, softcap=cap)
            want = want.reshape(b, hq, sq, hd).transpose(1, 2)
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol)
            if tdt == torch.bfloat16:
                model = ref.reference_attention_bf16_p(
                    *fold, causal=causal, window=window, softcap=cap)
                model = model.reshape(b, hq, sq, hd).transpose(1, 2)
                torch.testing.assert_close(got.float(), model, atol=4e-3,
                                           rtol=2 ** -8)
    t = [torch.tensor(a, device="cuda") for a in _inputs(1, 128, 128, 2, 2,
                                                         64)]
    outs = [ops.flash_attention(*t, block_q=bq, block_k=bk)
            for bq, bk in ((32, 32), (64, 17), (64, 64))]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], atol=1e-5, rtol=0)


# ------------------------------------------------------------------ gradient
# (B, Sq, Skv, Hq, Hkv, hd, causal, window, cap): CASES with the reference
# _sdpa's masks (a window is causal there, "local"), and causal Sq != Skv
GRAD_CASES = CASES + [(1, 96, 160, 2, 2, 64, True, 0, 0.0)]


def _sdpa_grads(q, k, v, d_out, causal, window, cap):
    """jax.grad of the reference's jnp attention (``models/attention.py``
    ``_sdpa`` with its ``_mask_bias``, positions from 0), the function the
    JAX package differentiates when it trains, in float32."""
    from repro.models.attention import _mask_bias, _sdpa
    sq, skv = q.shape[1], k.shape[1]
    kind = "local" if window else ("causal" if causal else "none")
    bias = _mask_bias(jnp.arange(sq)[None], jnp.arange(skv)[None], kind,
                      window)[:, None]

    def f(q, k, v):
        return jnp.sum(_sdpa(q, k, v, bias, cap) * d_out)

    return jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                            for a in (q, k, v)))


@pytest.mark.parametrize("b,sq,skv,hq,hkv,hd,causal,window,cap", GRAD_CASES)
def test_flash_gradient_matches_jax_grad_of_sdpa(b, sq, skv, hq, hkv, hd,
                                                 causal, window, cap):
    """On the CPU, autograd through ``ops.flash_attention`` (the plain
    version) against ``jax.grad`` of the reference's ``_sdpa`` (GQA, a
    window, the soft-cap, Sq != Skv), float32: dq, dk, dv within 1e-5 of
    each one's largest |value| (the same float32 arithmetic, summed in
    another order); and the backward kernel's plain model
    (``ref.attention_bwd``, its LSE / D / dS formula) against the same."""
    q, k, v = _inputs(b, sq, skv, hq, hkv, hd)
    d_out = np.random.default_rng(9).standard_normal(q.shape).astype(
        np.float32)
    want = [np.asarray(g) for g in _sdpa_grads(q, k, v, d_out, causal,
                                               window, cap)]
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                              softcap=cap)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(d_out))
    fold = [_fold(torch.tensor(a), h) for a, h in ((q, hq), (k, hkv),
                                                   (v, hkv))]
    o = ref.reference_attention(*fold, causal=causal, window=window,
                                softcap=cap)
    model = ref.attention_bwd(*fold, o, _fold(torch.tensor(d_out), hq),
                              causal=causal, window=window, softcap=cap)
    for name, g, m, w, h in zip("qkv", got, model, want, (hq, hkv, hkv)):
        scale = np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * scale,
                                   err_msg=f"d{name}")
        m = m.reshape(b, h, -1, hd).permute(0, 2, 1, 3).numpy()
        np.testing.assert_allclose(m, w, rtol=0, atol=1e-5 * scale,
                                   err_msg=f"d{name}, plain model")


def test_backward_launch_raises_on_cpu_tensors():
    """The backward kernel's launcher takes CUDA tensors only; on the CPU
    autograd differentiates the plain version."""
    q = torch.zeros((2, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_bwd(q, q, q, q, q)


@pytest.mark.cuda
def test_cuda_backward_kernel_matches_plain_autograd_on_the_card():
    """The gradient through ``ops.flash_attention`` on the card (the
    forward kernel, then the backward kernel, one launch each) against
    autograd through the plain version in float32 on the same inputs, at
    the cases above and the training shape: dq, dk, dv within 1e-4 (float32
    inputs) or 2e-2 (bf16 inputs) of each one's largest |value|.  Skips
    without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(4)
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        tdt = DTYPES[dtype][1]
        for case in GRAD_CASES + [(4, 512, 512, 32, 4, 128, True, 0, 0.0),
                                  (1, 70, 70, 2, 1, 256, True, 0, 0.0),
                                  (1, 128, 64, 2, 1, 64, False, 16, 0.0)]:
            b, sq, skv, hq, hkv, hd, causal, window, cap = case
            t = [torch.tensor(a, dtype=tdt, device="cuda",
                              requires_grad=True)
                 for a in _inputs(b, sq, skv, hq, hkv, hd)]
            d_out = torch.tensor(rng.standard_normal((b, sq, hq, hd)),
                                 dtype=tdt, device="cuda")
            n0 = kernel.BWD_LAUNCHES[dtype]
            got = torch.autograd.grad(
                ops.flash_attention(*t, causal=causal, window=window,
                                    softcap=cap), t, d_out)
            assert kernel.BWD_LAUNCHES[dtype] == n0 + 1
            fold = [_fold(x.detach().float(), h).requires_grad_()
                    for x, h in zip(t, (hq, hkv, hkv))]
            out = ref.reference_attention(*fold, causal=causal,
                                          window=window, softcap=cap)
            want = torch.autograd.grad(out, fold,
                                       _fold(d_out.float(), hq))
            for g, w, h in zip(got, want, (hq, hkv, hkv)):
                w = w.reshape(b, h, -1, hd).transpose(1, 2)
                err = float((g.float() - w).abs().max())
                assert err <= tol * float(w.abs().max()), (case, dtype, err)
