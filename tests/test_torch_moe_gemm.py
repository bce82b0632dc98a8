"""Port parity, the expert GEMM: ``repro_torch.kernels.moe_gemm`` against the
JAX package's ``repro.kernels.moe_gemm`` on the same inputs (made with
numpy).

On the CPU the port's entry point (``ops.expert_gemm``) runs its plain torch
version; it is held against the reference's oracle
(``reference_expert_gemm``) and against the Pallas kernel in interpret mode.
Tolerances, those of ``tests/test_kernels.py``: ``rtol=1e-5, atol=1e-4`` in
float32 (float32 sums in another order), ``rtol=3e-2, atol=3e-1`` in
bfloat16 (both accumulate in float32 and round once to bf16, so one bf16
ulp apart at most).  The CUDA kernel is held against the plain version on
the card by the ``cuda``-marked test, which skips without a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gemm import expert_gemm as r_expert_gemm
from repro.kernels.moe_gemm import reference_expert_gemm as r_reference
from repro_torch.kernels.moe_gemm import kernel, ops, ref

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
# (E, C, d, f): the reference tests' two shapes, then ragged C and f with d a
# multiple of the Pallas kernel's K block (its one requirement)
CASES = [(4, 64, 128, 96), (8, 32, 256, 64), (3, 37, 128, 70), (5, 4, 64, 130)]
# the bf16 CUDA kernel against the plain version on the card, tightly: both
# accumulate the exact bf16 products in float32 and round once, so they
# differ only where float32 sums taken in another order fall on two sides
# of a bf16 rounding boundary (one ulp, at most 2^-7 of the value); atol
# for results near 0
BF16_ULP_TOL = dict(rtol=2 ** -7, atol=1e-3)


def _inputs(e, c, d, f, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((e, c, d)).astype(np.float32),
            (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("e,c,d,f", CASES)
def test_expert_gemm_matches_reference(e, c, d, f, dtype):
    """Tolerance ``rtol=tol, atol=10 tol``, tol 1e-5 (float32) or 3e-2
    (bfloat16)."""
    jdt, tdt, tol = DTYPES[dtype]
    x, w = _inputs(e, c, d, f)
    got = ops.expert_gemm(torch.tensor(x, dtype=tdt),
                          torch.tensor(w, dtype=tdt))
    assert got.dtype == tdt and tuple(got.shape) == (e, c, f)
    got = got.to(torch.float32).numpy()
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    np.testing.assert_allclose(got, np.asarray(r_reference(jx, jw),
                                               np.float32),
                               rtol=tol, atol=tol * 10)
    pallas = r_expert_gemm(jx, jw, block_c=32, block_f=32, block_k=64,
                           interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                               rtol=tol, atol=tol * 10)


def test_cuda_launch_raises_on_cpu_tensors():
    """The kernel's launcher takes CUDA tensors only; CPU tensors go through
    ``ops`` to the plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        kernel.expert_gemm_fwd(torch.zeros((2, 4, 8)), torch.zeros((2, 8, 3)))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version_on_the_card():
    """The CUDA kernel against the plain version on the same card inputs, at
    the tolerances above (and in bf16 also at ``BF16_ULP_TOL``), at these
    shapes, the serve path's (prefill C = 168, decode C = 4, gate/up and
    down) and C = 1, 13 and 300 (two N tiles of the TMA kernel).  Skips
    without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in DTYPES:
        _, tdt, tol = DTYPES[dtype]
        for case in CASES + [(128, 168, 2048, 768), (128, 168, 768, 2048),
                             (128, 4, 2048, 768), (128, 4, 768, 2048),
                             (8, 1, 2048, 768), (8, 13, 2048, 768),
                             (8, 300, 2048, 768)]:
            x, w = (torch.tensor(a, dtype=tdt, device="cuda")
                    for a in _inputs(*case))
            got = ops.expert_gemm(x, w)
            want = ref.reference_expert_gemm(x, w)
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol * 10)
            if tdt == torch.bfloat16:
                torch.testing.assert_close(got.float(), want.float(),
                                           **BF16_ULP_TOL)


@pytest.mark.parametrize("e,c,d,f", CASES)
def test_expert_gemm_gradient_matches_jax_grad(e, c, d, f):
    """On the CPU, autograd through ``ops.expert_gemm`` (the plain version)
    against ``jax.grad`` of the reference's per-expert product (the einsum
    of ``reference_expert_gemm``, which the JAX package differentiates),
    float32: dX and dW within 1e-5 of each one's largest |value|."""
    import jax
    x, w = _inputs(e, c, d, f)
    dy = np.random.default_rng(5).standard_normal((e, c, f)).astype(
        np.float32)
    want = jax.grad(lambda a, b: jnp.sum(r_reference(a, b) * dy),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.tensor(a, requires_grad=True) for a in (x, w))
    got = torch.autograd.grad(ops.expert_gemm(tx, tw), (tx, tw),
                              torch.tensor(dy))
    for g, wt in zip(got, want):
        wt = np.asarray(wt)
        np.testing.assert_allclose(g.numpy(), wt, rtol=0,
                                   atol=1e-5 * np.abs(wt).max())


def test_backward_launch_raises_on_cpu_tensors():
    """The gradient's launcher takes CUDA tensors only."""
    x, w = torch.zeros((2, 4, 8)), torch.zeros((2, 8, 3))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.expert_gemm_bwd(x, w, torch.zeros((2, 4, 3)))


@pytest.mark.cuda
def test_cuda_backward_matches_plain_autograd_on_the_card():
    """dX and dW through ``ops.expert_gemm`` on the card (two launches:
    the transpose-bit variants on the operands in place for bf16 with d and
    f multiples of 8, the kernel on transposed copies otherwise; the
    variants also with one block a tile, bit for bit) against autograd
    through the plain
    version on the same inputs, at the tolerances of the forward test, at
    these shapes and the training path's (C = 168, gate/up and down).
    Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(6)
    for dtype in DTYPES:
        _, tdt, tol = DTYPES[dtype]
        for case in CASES + [(128, 168, 2048, 768), (128, 168, 768, 2048)]:
            e, c, d, f = case
            x, w = (torch.tensor(a, dtype=tdt, device="cuda")
                    for a in _inputs(*case))
            dy = torch.tensor(rng.standard_normal((e, c, f)), dtype=tdt,
                              device="cuda")
            n0 = kernel.BWD_LAUNCHES[dtype]
            xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
            got = torch.autograd.grad(ops.expert_gemm(xg, wg), (xg, wg), dy)
            assert kernel.BWD_LAUNCHES[dtype] == n0 + 2
            xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
            want = torch.autograd.grad(ref.reference_expert_gemm(xr, wr),
                                       (xr, wr), dy)
            for g, wt in zip(got, want):
                torch.testing.assert_close(g.float(), wt.float(), rtol=tol,
                                           atol=tol * 10)
            # one block a tile walks the same tiles: the same bits
            if kernel.in_place(x, w, dy):
                runs = kernel.plan_bwd(x, w, dy)
                for g, r in zip(got, runs):
                    assert torch.equal(g, kernel._launch_tma(r, 0))


# ---------------------------------------------------- the backward's plan
def _view(t, strides, shape):
    """The (E, rows, cols) matrix a planned launch reads from ``t``'s
    storage, as a view (nothing is copied)."""
    return t.as_strided(shape, strides, t.storage_offset())


def _bwd_inputs(e, c, d, f, dtype):
    x, w = _inputs(e, c, d, f)
    dy = np.random.default_rng(5).standard_normal((e, c, f)).astype(
        np.float32)
    return x, w, dy, [torch.tensor(a, dtype=dtype) for a in (x, w, dy)]


@pytest.mark.parametrize("e,c,d,f", [s for s in CASES
                                     if s[2] % 8 == 0 and s[3] % 8 == 0])
def test_bwd_plan_reads_bf16_operands_in_place(e, c, d, f):
    """bf16 with d and f multiples of 8: the backward's two launches read
    x, w and dy where they lie (no copy): dX from w (K-major, transpose bit
    0) and dy (K-major), dW from dy (MN-major, bit 1) and x (MN-major),
    with the strides of the tensors as they are stored."""
    _, _, _, (x, w, dy) = _bwd_inputs(e, c, d, f, torch.bfloat16)
    assert kernel.in_place(x, w, dy)
    runs = {r.out: r for r in kernel.plan_bwd(x, w, dy)}
    assert set(runs) == {"dx", "dw"}
    dx, dw = runs["dx"], runs["dw"]
    assert dx.copies == () and dw.copies == ()
    assert (dx.a.data_ptr(), dx.b.data_ptr()) == (w.data_ptr(),
                                                  dy.data_ptr())
    assert (dw.a.data_ptr(), dw.b.data_ptr()) == (dy.data_ptr(),
                                                  x.data_ptr())
    assert (dx.ta, dx.tb, dw.ta, dw.tb) == (0, 0, 1, 1)
    assert (dx.m, dx.n, dx.k) == (d, c, f) and (dw.m, dw.n, dw.k) == (f, d, c)
    assert dx.a_strides == w.stride() and dw.b_strides == x.stride()
    assert dx.b_strides == (c * f, 1, f) and dw.a_strides == (c * f, 1, f)
    only = kernel.plan_bwd(x, w, dy, need_dx=False)
    assert [r.out for r in only] == ["dw"]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("e,c,d,f", CASES)
def test_bwd_plan_views_give_jax_vjp(e, c, d, f, dtype):
    """A plain einsum over exactly the views each planned launch reads
    (out[e, n, m] = sum_k A[e, m, k] B[e, k, n], computed in float32)
    gives dX and dW equal to ``jax.vjp`` of the reference's
    ``reference_expert_gemm`` on the same (bf16-rounded) values: within
    1e-5 of each one's largest |value| (float32 sums in another order).
    The ragged and float32 shapes read transposed copies (the plan names
    them); the rest read the tensors in place."""
    import jax
    _, tdt, _ = DTYPES[dtype]
    _, _, _, (x, w, dy) = _bwd_inputs(e, c, d, f, tdt)
    xf, wf, dyf = (jnp.asarray(t.to(torch.float32).numpy())
                   for t in (x, w, dy))
    _, vjp = jax.vjp(r_reference, xf, wf)
    want = dict(zip(("dx", "dw"), (np.asarray(g) for g in vjp(dyf))))
    runs = kernel.plan_bwd(x, w, dy)
    assert [r.out for r in runs] == ["dx", "dw"]
    for r in runs:
        a = _view(r.a, r.a_strides, (r.e, r.m, r.k)).float()
        b = _view(r.b, r.b_strides, (r.e, r.k, r.n)).float()
        got = torch.einsum("emk,ekn->enm", a, b).numpy()
        assert got.shape == want[r.out].shape
        np.testing.assert_allclose(got, want[r.out], rtol=0,
                                   atol=1e-5 * np.abs(want[r.out]).max(),
                                   err_msg=r.out)
        in_place = tdt == torch.bfloat16 and d % 8 == 0 and f % 8 == 0
        assert (r.copies == ()) == in_place
