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


@pytest.mark.parametrize("b,sq,skv,hq,hkv,hd,causal,window,cap", CASES)
def test_bf16_tile_walk_model_matches_reference_and_row_max_model(
        b, sq, skv, hq, hkv, hd, causal, window, cap):
    """The plain model of the bf16 kernel's online softmax
    (``ref.reference_attention_bf16_tiles``: p rounded to bf16 against the
    running max of its walk over 64-key tiles) on bf16 inputs: against the
    reference's oracle at the bf16 tolerance (2e-2, atol and rtol), and
    against the model that rounds p against each row's final max
    (``ref.reference_attention_bf16_p``) within 2^-8 of the largest |v|
    (each of the two rounds a p to within 2^-9 of its exact value, and the
    rows' weights sum to 1), plus 1e-5 for float32 sums in another
    order; and its slack (what a p within ``ref.P_SLACK`` of a bf16
    rounding midpoint moves an output if rounded the other way, at most
    2^-7 of the largest |v|) covers what every p moved by ``P_SLACK`` of
    itself, up or down, before its rounding does to the output, within
    1e-5."""
    jdt, tdt, tol = DTYPES["bfloat16"]
    q, k, v = (_fold(a, h) for a, h in zip(_inputs(b, sq, skv, hq, hkv, hd),
                                           (hq, hkv, hkv)))
    tq, tk, tv = (torch.tensor(a, dtype=tdt) for a in (q, k, v))
    kw = dict(causal=causal, window=window, softcap=cap)
    got = ref.reference_attention_bf16_tiles(tq, tk, tv, **kw)
    assert got.dtype == torch.float32 and got.shape == tq.shape
    want = r_reference_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                 **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    row_max = ref.reference_attention_bf16_p(tq, tk, tv, **kw)
    bound = 2 ** -8 * float(tv.float().abs().max()) + 1e-5
    assert float((got - row_max).abs().max()) <= bound
    # its slack: what a p within P_SLACK of a bf16 midpoint moves an output
    # if it rounds the other way; every p moved by P_SLACK of itself before
    # its rounding (which flips exactly those) moves the model's output by
    # no more than that, beyond float32 noise
    out, slack = ref.reference_attention_bf16_tiles(tq, tk, tv, **kw,
                                                    slack=True)
    assert torch.equal(out, got) and (slack >= 0).all()
    assert float(slack.max()) <= 2 ** -7 * float(tv.float().abs().max())
    bf16 = ref._bf16
    for sign in (1.0, -1.0):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ref, "_bf16",
                       lambda t, s=sign: bf16(t * (1 + s * ref.P_SLACK)))
            moved = ref.reference_attention_bf16_tiles(tq, tk, tv, **kw)
        assert bool(((moved - out).abs() <= slack + 1e-5).all())


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
    also against the plain model of its tile walk and p rounding
    (``ref.reference_attention_bf16_tiles``; atol 4e-3, rtol half a bf16
    ulp beyond the model's slack for p near a bf16 midpoint, as
    ``chip_smoke.py``); and block-shape independence (atol
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
                model, slack = (m.reshape(b, hq, sq, hd).transpose(1, 2)
                                for m in ref.reference_attention_bf16_tiles(
                                    *fold, causal=causal, window=window,
                                    softcap=cap, slack=True))
                over = (got.float() - model).abs() - slack \
                    - (4e-3 + 2 ** -8 * model.abs())
                assert float(over.max()) <= 0, (case, float(over.max()))
    t = [torch.tensor(a, device="cuda") for a in _inputs(1, 128, 128, 2, 2,
                                                         64)]
    outs = [ops.flash_attention(*t, block_q=bq, block_k=bk)
            for bq, bk in ((32, 32), (64, 17), (64, 64))]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], atol=1e-5, rtol=0)


# (B, Sq, Skv, Hq, Hkv, hd): the encoder-decoder's unmasked uses, cut: the
# encoder (Sq = Skv, no multiple of the 64-row tile), the cross-attention
# (a short decoder prompt against many frames, and one query row), and GQA
UNMASKED = [(2, 150, 150, 4, 4, 16), (2, 8, 150, 4, 4, 16),
            (1, 1, 70, 4, 4, 16), (1, 12, 40, 8, 2, 32)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,sq,skv,hq,hkv,hd", UNMASKED)
def test_unmasked_plain_version_matches_sdpa(b, sq, skv, hq, hkv, hd, dtype):
    """``ops.flash_attention(causal=False)`` (the plain version), as the
    encoder and the cross-attention call it, against the reference's jnp
    attention ``_sdpa`` with ``_mask_bias(..., "none")`` on the same
    inputs; tolerance as above (2e-5 float32, 2e-2 bf16)."""
    from repro.models.attention import _mask_bias, _sdpa
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(b, sq, skv, hq, hkv, hd, seed=5)
    got = ops.flash_attention(*(torch.tensor(a, dtype=tdt) for a in (q, k, v)),
                              causal=False)
    bias = _mask_bias(jnp.arange(sq)[None], jnp.arange(skv)[None], "none",
                      0)[:, None]
    want = _sdpa(*(jnp.asarray(a, jnp.float32) for a in (q, k, v)), bias,
                 0.0)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ------------------------------------------------------------------ gradient
# (B, Sq, Skv, Hq, Hkv, hd, causal, window, cap): CASES with the reference
# _sdpa's masks (a window is causal there, "local"), causal Sq != Skv, and
# recurrentgemma's local attention cut (hd 256, one kv head, a window, a
# length that is no multiple of the 64-row tile)
GRAD_CASES = CASES + [(1, 96, 160, 2, 2, 64, True, 0, 0.0),
                      (1, 160, 160, 4, 1, 256, True, 64, 0.0)]


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


# ------------------------------------------- the tensor-core backward's model
@pytest.mark.parametrize("b,sq,skv,hq,hkv,hd,causal,window,cap", GRAD_CASES)
def test_bf16_products_model_matches_jax_grad(b, sq, skv, hq, hkv, hd,
                                              causal, window, cap):
    """The plain model of the tensor-core backward's rounding
    (``ref.attention_bwd(bf16_products=True)``: P and dS rounded to bf16
    before their products, float32 sums) on float32 inputs, against
    ``jax.grad`` of the reference's ``_sdpa``: dq, dk, dv within 1e-2 of
    each one's largest |value|, half of the 2e-2 that the bf16 kernel is
    held to on the card (the rounding alone gave at most 2.7e-3 here), so
    that the new rounding leaves the kernel's own output rounding room."""
    q, k, v = _inputs(b, sq, skv, hq, hkv, hd)
    d_out = np.random.default_rng(9).standard_normal(q.shape).astype(
        np.float32)
    want = [np.asarray(g) for g in _sdpa_grads(q, k, v, d_out, causal,
                                               window, cap)]
    fold = [_fold(torch.tensor(a), h) for a, h in ((q, hq), (k, hkv),
                                                   (v, hkv))]
    o = ref.reference_attention(*fold, causal=causal, window=window,
                                softcap=cap)
    model = ref.attention_bwd(*fold, o, _fold(torch.tensor(d_out), hq),
                              causal=causal, window=window, softcap=cap,
                              bf16_products=True)
    for name, m, w, h in zip("qkv", model, want, (hq, hkv, hkv)):
        m = m.reshape(b, h, -1, hd).permute(0, 2, 1, 3).numpy()
        np.testing.assert_allclose(m, w, rtol=0,
                                   atol=1e-2 * np.abs(w).max(),
                                   err_msg=f"d{name}")


def _jax_row_lse(q, k, causal, window, cap):
    """The log-sum-exp, in log2 units, of the reference's masked logits
    (``_sdpa``'s scores: the einsum over hd, 1 / sqrt(hd), the soft-cap,
    ``_mask_bias``), in the folded (B * Hkv * group, Sq) layout."""
    from repro.models.attention import _mask_bias, softcap
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    kind = "local" if window else ("causal" if causal else "none")
    bias = _mask_bias(jnp.arange(sq)[None], jnp.arange(skv)[None], kind,
                      window)[:, None]
    qj = jnp.asarray(q).reshape(b, sq, hkv, hq // hkv, hd)
    s = jnp.einsum("bqhgd,bkhd->bhgqk", qj, jnp.asarray(k))
    s = softcap(s / jnp.sqrt(jnp.float32(hd)), cap) + bias[:, :, None]
    lse = jax.nn.logsumexp(s, axis=-1) / np.log(2.0)
    return np.asarray(lse).reshape(b * hq, sq)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,hd,causal,window,cap", GRAD_CASES)
def test_row_lse_matches_reference_logsumexp(b, sq, skv, hq, hkv, hd,
                                             causal, window, cap):
    """``ref.row_lse`` (what the forward's LSE instance writes: each row's
    log-sum-exp in log2 units) against the log-sum-exp of the reference's
    masked logits, float32: within 1e-5 absolute (values of order 5 in
    log2 units; float32 sums of exp in another order); and
    ``ref.attention_bwd`` fed with it (P = 2^(s log2 e - lse), as the
    tensor-core kernels compute P) against its own log-sum-exp: dq, dk, dv
    within 1e-5 of each one's largest |value| (exp2 against exp, one
    float32 rounding apart)."""
    q, k, v = _inputs(b, sq, skv, hq, hkv, hd)
    fold = [_fold(torch.tensor(a), h) for a, h in ((q, hq), (k, hkv),
                                                   (v, hkv))]
    lse = ref.row_lse(fold[0], fold[1], causal=causal, window=window,
                      softcap=cap)
    assert lse.dtype == torch.float32 and lse.shape == (b * hq, sq)
    np.testing.assert_allclose(lse.numpy(),
                               _jax_row_lse(q, k, causal, window, cap),
                               rtol=0, atol=1e-5)
    d_out = _fold(torch.tensor(np.random.default_rng(9).standard_normal(
        q.shape).astype(np.float32)), hq)
    o = ref.reference_attention(*fold, causal=causal, window=window,
                                softcap=cap)
    own = ref.attention_bwd(*fold, o, d_out, causal=causal, window=window,
                            softcap=cap)
    fed = ref.attention_bwd(*fold, o, d_out, causal=causal, window=window,
                            softcap=cap, lse=lse)
    for name, got, want in zip("qkv", fed, own):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()),
                                   err_msg=f"d{name}")


def test_row_lse_of_rows_that_see_no_key():
    """A row that sees no key (a window that ends before the keys do) gets
    0, as the forward's LSE instance writes it; the backward's model fed
    with it gives those rows dq = 0."""
    rng = np.random.default_rng(3)
    q = torch.tensor(rng.standard_normal((4, 128, 64)), dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((2, 64, 64)), dtype=torch.float32)
    lse = ref.row_lse(q, k, causal=False, window=16)
    assert (lse[:, 80:] == 0).all() and (lse[:, :79] != 0).all()
    o = ref.reference_attention(q, k, k, causal=False, window=16)
    dq, _, _ = ref.attention_bwd(q, k, k, o, torch.ones_like(q),
                                 causal=False, window=16, lse=lse,
                                 bf16_products=True)
    assert (dq[:, 80:] == 0).all()


def test_tensor_core_backward_is_chosen_by_shape():
    """bf16 at hd 64, 128 and 256 takes the tensor-core backward (and the
    forward's LSE instance); float32 and the other head dims do not; the
    LSE instance refuses another shape before anything else."""
    assert kernel.tc_backward(torch.bfloat16, 64)
    assert kernel.tc_backward(torch.bfloat16, 128)
    assert kernel.tc_backward(torch.bfloat16, 256)
    for dtype, hd in ((torch.bfloat16, 8), (torch.bfloat16, 32),
                      (torch.float32, 256), (torch.float32, 64),
                      (torch.float32, 128), (torch.bfloat16, 96)):
        assert not kernel.tc_backward(dtype, hd)
    assert kernel.lse_rows(1) == 64 and kernel.lse_rows(512) == 512 \
        and kernel.lse_rows(100) == 128
    q = torch.zeros((2, 8, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="LSE instance"):
        kernel.flash_attention_fwd(q, q, q, with_lse=True)


@pytest.mark.parametrize("bhq,bhkv,skv,sms,want", [
    (32, 2, 2560, 132, 4),    # recurrentgemma's training shape: 80 kv blocks
    (64, 4, 2560, 132, 2),    # its served batch: 160
    (4, 1, 160, 132, 4),      # few kv tiles: one block a q head
    (2, 2, 70, 132, 1),       # no group to split
    (32, 2, 2560, 16, 1),     # a card of 16 SMs
    (36, 2, 2560, 132, 6)])   # the fewest that divide the group of 18
def test_hd256_dkdv_splits(bhq, bhkv, skv, sms, want):
    """``kernel.dkdv_splits``, the hd 256 backward's split of a kv head's q
    heads over dK/dV blocks: the fewest splits dividing the group that give
    at least two (kv tile, kv head, split) blocks a streaming
    multiprocessor, else one a q head; chosen by the shape alone."""
    got = kernel.dkdv_splits(bhq, bhkv, skv, sms)
    assert got == want
    group = bhq // bhkv
    blocks = -(-skv // kernel.TILE) * bhkv
    assert group % got == 0
    assert blocks * got >= 2 * sms or got == group
    assert all(group % s or blocks * s < 2 * sms for s in range(1, got))


@pytest.mark.cuda
def test_cuda_tensor_core_backward_matches_its_model():
    """The tensor-core backward (bf16, hd 64, 128 and 256) at the gradient
    cases and the training shapes (qwen's, recurrentgemma's local
    attention): the forward's LSE instance gives the plain
    instance's output bit for bit and row statistics within 2e-5 of
    ``ref.row_lse``; two backward launches give the same bits; dq, dk, dv
    within 2^-7 of each one's largest |value| of the plain model of their
    rounding (``ref.attention_bwd(bf16_products=True)`` fed the kernel's
    output and row statistics), as ``chip_smoke.py`` holds them.  Skips
    without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(7)
    for case in GRAD_CASES + [(4, 512, 512, 32, 4, 128, True, 0, 0.0),
                              (2, 2560, 2560, 16, 1, 256, True, 2048, 0.0)]:
        b, sq, skv, hq, hkv, hd, causal, window, cap = case
        if not kernel.tc_backward(torch.bfloat16, hd):
            continue
        kw = dict(causal=causal, window=window, softcap=cap)
        q, k, v = (_fold(torch.tensor(a, dtype=torch.bfloat16,
                                      device="cuda"), h).contiguous()
                   for a, h in zip(_inputs(b, sq, skv, hq, hkv, hd),
                                   (hq, hkv, hkv)))
        d_out = torch.tensor(rng.standard_normal(q.shape),
                             dtype=torch.bfloat16, device="cuda")
        plain = kernel.flash_attention_fwd(q, k, v, **kw)
        out, lse = kernel.flash_attention_fwd(q, k, v, with_lse=True, **kw)
        assert torch.equal(plain, out), case
        lse_err = float((lse[:, :sq] - ref.row_lse(q, k, **kw)).abs().max())
        assert lse_err <= 2e-5, (case, lse_err)
        runs = [kernel.flash_attention_bwd(q, k, v, out, d_out, lse=lse, **kw)
                for _ in range(2)]
        assert all(torch.equal(a, c) for a, c in zip(*runs)), case
        model = ref.attention_bwd(q, k, v, out, d_out, lse=lse,
                                  bf16_products=True,
                                  out_dtype=torch.float32, **kw)
        for g, m in zip(runs[0], model):
            err = float((g.float() - m).abs().max())
            assert err <= 2 ** -7 * float(m.abs().max()), (case, err)
