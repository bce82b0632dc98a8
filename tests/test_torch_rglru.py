"""Port parity, the RG-LRU scan: ``repro_torch.kernels.rglru`` against the
JAX package's ``repro.kernels.rglru`` on the same inputs (made with numpy).

On the CPU the port's entry point (``ops.rglru_scan_op``) runs its plain
version (``ref.reference_rglru``); it is held against the reference's
sequential oracle and its Pallas kernel in interpret mode over
``tests/test_kernels.py``'s cases, at that test's ``atol=1e-4``
(float32; the Pallas kernel's closed form sums in another order), and to
one bf16 ulp of the output for bf16 ``b``.  The plain backward
(``ref.rglru_backward``) is held against ``jax.vjp`` of the reference's
oracle.  The CUDA kernels are held against the plain versions on the card
by the ``cuda``-marked tests, which skip without a card.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru import reference_rglru as r_reference_rglru
from repro.kernels.rglru import rglru_scan_op as r_rglru_scan_op
from repro_torch.kernels import _build
from repro_torch.kernels.rglru import kernel, ops, ref

CASES = [(128, 64, 32, 32), (256, 64, 64, 64), (64, 128, 64, 32)]


def _inputs(b, s, w, seed=0):
    """tests/test_kernels.py's distributions: log_a = -0.1 exp(N(0, 1)) -
    1e-3, b standard normal."""
    rng = np.random.default_rng(seed)
    la = (-np.exp(rng.standard_normal((b, s, w))) * 0.1 - 1e-3)
    return (la.astype(np.float32),
            rng.standard_normal((b, s, w)).astype(np.float32))


@pytest.mark.parametrize("s,w,chunk,block_w", CASES)
def test_rglru_matches_reference(s, w, chunk, block_w):
    """Against the reference's oracle and its Pallas kernel (interpret
    mode, at the case's chunk and width block): ``atol=1e-4``."""
    la, b = _inputs(2, s, w)
    got = ops.rglru_scan_op(torch.tensor(la), torch.tensor(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, s, w)
    oracle = r_reference_rglru(jnp.asarray(la), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=1e-4,
                               rtol=0)
    pallas = r_rglru_scan_op(jnp.asarray(la), jnp.asarray(b), chunk=chunk,
                             block_w=block_w, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-4,
                               rtol=0)


def test_rglru_ragged_and_bf16():
    """A length and a width that are no tile multiples (the Pallas kernel
    needs S % 64 == 0 and W % 256 == 0; the port takes any), against the
    oracle at ``atol=1e-4``; bf16 ``b`` comes back in bf16 within one bf16
    ulp (``atol=rtol=1e-2``) of the oracle on the same bf16 values."""
    la, b = _inputs(3, 77, 50, seed=1)
    got = ops.rglru_scan_op(torch.tensor(la), torch.tensor(b))
    oracle = r_reference_rglru(jnp.asarray(la), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=1e-4,
                               rtol=0)
    bb = torch.tensor(b, dtype=torch.bfloat16)
    got = ops.rglru_scan_op(torch.tensor(la), bb)
    assert got.dtype == torch.bfloat16
    oracle = r_reference_rglru(jnp.asarray(la),
                               jnp.asarray(bb.float().numpy(), jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(oracle, np.float32), atol=1e-2,
                               rtol=1e-2)


def test_cuda_launch_raises_on_cpu_tensors():
    """The kernel's launcher takes CUDA tensors only; CPU tensors go through
    ``ops`` to the plain version."""
    x = torch.zeros((1, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.rglru_fwd(x, x)


def test_cuda_backward_raises_on_cpu_tensors():
    """The backward's launcher takes CUDA tensors only, as the forward's
    does: nothing falls back to the plain version."""
    x = torch.zeros((1, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.rglru_bwd(x, x, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [50, 300, 4096, 4100])
def test_bwd_geometry_fits_the_card(w, dtype):
    """``kernel.bwd_geometry``, the backward's launch (which
    ``csrc/rglru.cu`` checks): a thread a channel, ``BWD_CHANNELS`` a
    block, whole warps; the TMA ring exactly where a row of W elements is
    a whole number of 16 bytes in h's dtype (log_a's float32 rows then
    are too; at W 50 in neither dtype, at 300 and 4100 in float32 only,
    at 4096 in both) and the addresses are 16-byte aligned, else plain
    loads with no ring and no shared memory; a box's rows a whole number
    of 16 bytes and each box and output tile 128-byte aligned in the
    ring; at least three stages; the ring within an H100's shared memory
    with room for two blocks an SM.  The constants are the kernel
    source's."""
    src = kernel.SOURCE.read_text()
    for name in ("BWD_CHANNELS", "BWD_STEPS", "BWD_STAGES", "BWD_OUTS"):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) \
            == str(getattr(kernel, name))
    size = 2 if dtype == torch.bfloat16 else 4
    g = kernel.bwd_geometry(w, dtype)
    assert g.threads == kernel.BWD_CHANNELS and g.threads % 32 == 0
    assert (g.grid_x - 1) * g.threads < w <= g.grid_x * g.threads
    assert g.tma == ((w * size) % 16 == 0)
    assert g.tma == {50: False, 300: size == 4, 4096: True,
                     4100: size == 4}[w]
    assert not kernel.bwd_geometry(w, dtype, aligned=False).tma
    if not g.tma:
        assert (g.stages, g.smem_bytes) == (0, 0)
        return
    tile = kernel.BWD_CHANNELS * kernel.BWD_STEPS
    for elem in (4, size):
        assert (kernel.BWD_CHANNELS * elem) % 16 == 0
        assert (tile * elem) % 128 == 0
    assert max(kernel.BWD_CHANNELS, kernel.BWD_STEPS) <= 256
    assert g.stages == kernel.BWD_STAGES >= 3 and kernel.BWD_OUTS >= 3
    assert g.steps == kernel.BWD_STEPS
    assert g.smem_bytes == 128 + g.stages * tile * (4 + 2 * size) \
        + kernel.BWD_OUTS * tile * (4 + size) + 8 * g.stages
    assert g.smem_bytes <= _build.MAX_SMEM_BYTES
    assert 2 * (g.smem_bytes + 1024) <= 233472


# (B, S, W): recurrentgemma's serve shape, its training shape, its serve
# shape on a 4-rank model axis, then ragged ones (a last chunk cut short,
# segments of two register loads)
FWD_SHAPES = [(4, 2560, 4096), (2, 2560, 4096), (4, 2560, 1024),
              (4, 100, 4100), (3, 600, 50), (1, 5000, 64), (1, 1, 300)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,s,w", FWD_SHAPES)
def test_fwd_geometry_fits_the_card(bsz, s, w, dtype):
    """``kernel.fwd_geometry``, the forward's launch (which ``csrc/rglru.cu``
    checks), from the shape alone and the same for b in either dtype (the
    chunks' summaries are float32): chunks that cover S with the last one
    not empty (the three timed shapes: 10 chunks of 256 steps), each
    ``SCAN_WARPS`` segments of a whole number of ``SCAN_STEPS`` register
    loads, no more than ``MAX_CHUNKS`` of them, a block of whole warps a
    (chunk, 32 channels), and the scratch the launch zeroes and the kernel
    fills: two float32 summaries a (chunk, channel), then a flag a block
    and the ticket.  The constants are the kernel source's."""
    src = kernel.SOURCE.read_text()
    for name in ("SCAN_WARPS", "SCAN_STEPS"):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) \
            == str(getattr(kernel, name))
    assert dtype in kernel._DTYPES
    g = kernel.fwd_geometry(bsz, s, w)
    per_chunk = kernel.SCAN_WARPS * kernel.SCAN_STEPS
    assert g.threads == 32 * kernel.SCAN_WARPS
    assert g.chunks * g.steps >= s > (g.chunks - 1) * g.steps
    assert g.steps % per_chunk == 0 and 1 <= g.chunks <= kernel.MAX_CHUNKS
    # warp j + 1 brings chunk j's summary: k < chunks <= SCAN_WARPS
    assert kernel.MAX_CHUNKS <= kernel.SCAN_WARPS
    assert g.steps == per_chunk or (g.steps - per_chunk) * kernel.MAX_CHUNKS \
        < s
    groups = bsz * -(-w // 32)
    assert g.grid == g.chunks * groups
    assert g.scratch_bytes == 8 * g.chunks * bsz * w + 4 * (g.grid + 1)
    assert (g.chunks, g.steps) == {(4, 2560, 4096): (10, 256),
                                   (2, 2560, 4096): (10, 256),
                                   (4, 2560, 1024): (10, 256),
                                   (4, 100, 4100): (1, 256),
                                   (3, 600, 50): (3, 256),
                                   (1, 5000, 64): (10, 512),
                                   (1, 1, 300): (1, 256)}[(bsz, s, w)]


@pytest.mark.parametrize("bsz,s,w,cut", [(2, 2560, 4096, 256),
                                         (4, 2560, 1024, 256),
                                         (3, 600, 50, 50), (1, 5000, 64, 64)])
def test_chunked_model_matches_the_sequential_scan(bsz, s, w, cut):
    """The chunked forward's arithmetic (``ref.rglru_chunked``: segments
    walked from 0, their summaries folded into chunks' and carries) at the
    chunks ``kernel.fwd_geometry`` gives the shape, on ``cut`` of its
    channels, against the sequential plain version in float32: within
    atol 1e-5 and rtol 1e-5, as the card's kernel is held in the ``cuda``
    test below (only the carries' roundings differ, and a < 1 damps them:
    one float32 ulp of h at most here), and the first segment bit for
    bit."""
    g = kernel.fwd_geometry(bsz, s, w)
    assert g.chunks > 1
    la, b = (torch.tensor(x) for x in _inputs(bsz, s, cut, seed=6))
    got = ref.rglru_chunked(la, b, g.chunks, g.steps, kernel.SCAN_WARPS)
    want = ref.reference_rglru(la, b)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    seg = g.steps // kernel.SCAN_WARPS
    assert torch.equal(got[:, :seg], want[:, :seg])


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version_on_the_card():
    """The CUDA kernel against the plain version on the same card inputs,
    at the cases above, the three timed shapes of ``FWD_SHAPES`` (serve,
    training, model-axis) and ragged ones: float32 ``atol=1e-5,
    rtol=1e-5`` (exp may differ in the last bit; a chunk's carry rounds
    once), its first segment bit for bit (the same steps in the same order
    from h = 0), bf16 one bf16 ulp.  Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for bsz, s, w in [(2, 128, 64), (2, 256, 64), (2, 64, 128),
                      (2, 77, 50)] + FWD_SHAPES:
        la, b = (torch.tensor(x, device="cuda")
                 for x in _inputs(bsz, s, w))
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)):
            got = ops.rglru_scan_op(la, b.to(dtype))
            want = ref.reference_rglru(la, b.to(dtype))
            assert got.dtype == dtype
            torch.testing.assert_close(got.float(), want.float(), atol=1e-5,
                                       rtol=tol)
            seg = kernel.fwd_geometry(bsz, s, w).steps // kernel.SCAN_WARPS
            if dtype == torch.float32:
                assert torch.equal(got[:, :seg], want[:, :seg])


def _share(got, want):
    """The largest |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("b,s,w", [(2, 128, 64), (2, 64, 128), (3, 77, 50),
                                   (1, 1, 300)])
def test_rglru_backward_matches_jax_grad_of_reference(b, s, w):
    """The plain backward (``ref.rglru_backward``, from the forward's h)
    against ``jax.vjp`` of the reference's oracle ``reference_rglru`` on
    the same dh: dlog_a and db each within 1e-5 of its largest |value|
    (float32 on both sides; the reference's autodiff of its scan sums the
    same terms in another order)."""
    import jax
    la, bb = _inputs(b, s, w, seed=3)
    dh = np.random.default_rng(4).standard_normal(la.shape).astype(
        np.float32)
    _, vjp = jax.vjp(r_reference_rglru, jnp.asarray(la), jnp.asarray(bb))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dh))]
    h = ref.reference_rglru(torch.tensor(la), torch.tensor(bb))
    got = ref.rglru_backward(torch.tensor(la), h, torch.tensor(dh))
    for name, g, wt in zip(("dlog_a", "db"), got, want):
        assert g.dtype == torch.float32 and g.shape == wt.shape
        assert _share(g.numpy(), wt) <= 1e-5, name


def test_meta_autograd_counts_the_backward():
    """On ``meta`` tensors under autograd ``ops.rglru_scan_op`` counts the
    forward kernel's work and, in the backward, the backward kernel's (5
    operations an element; log_a, h, dh read, dlog_a, db written, float32)
    instead of raising."""
    from repro_torch import roofline
    la = torch.empty((2, 16, 8), device="meta", requires_grad=True)
    b = torch.empty((2, 16, 8), device="meta", requires_grad=True)
    with roofline.Counter() as c:
        ops.rglru_scan_op(la, b).sum().backward()
    assert c.stats()["kernel_calls"] == {"rglru": 1, "rglru_bwd": 1}
    assert ops.cost(la, backward=True) == (5 * la.numel(), 20 * la.numel())
    assert la.grad.shape == la.shape and b.grad.shape == b.shape


def test_launch_counts_reset():
    """``reset_launches`` zeroes the forward's and the backward's counts
    (``chip_smoke.py`` zeroes them before each run it counts)."""
    kernel.LAUNCHES["float32"] = 3
    kernel.BWD_LAUNCHES["float32"] = 2
    kernel.reset_launches()
    assert kernel.LAUNCHES == {"bfloat16": 0, "float32": 0}
    assert kernel.BWD_LAUNCHES == {"bfloat16": 0, "float32": 0}


@pytest.mark.cuda
def test_cuda_backward_matches_plain_version_on_the_card():
    """The backward kernel (through ``ops.rglru_scan_op``'s autograd
    function) against the plain backward on the same card inputs: float32
    within 1e-5 of each gradient's largest |value| and bit for bit (the
    same steps in the same order, the same exp), bf16 db within one bf16
    ulp (2^-7), at the training shape (2, 2560, 4096) and ragged S and W
    (the TMA ring and the plain loads).  Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for s, w in [(2560, 4096), (77, 50), (1, 300), (100, 4100)]:
        la, b = (torch.tensor(x, device="cuda") for x in _inputs(2, s, w))
        dh = torch.tensor(np.random.default_rng(5).standard_normal(la.shape),
                          device="cuda", dtype=torch.float32)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)):
            la_g = la.clone().requires_grad_()
            b_g = b.to(dtype).requires_grad_()
            h = ops.rglru_scan_op(la_g, b_g)
            got = torch.autograd.grad(h, (la_g, b_g), dh.to(dtype))
            want = ref.rglru_backward(la, h.detach(), dh.to(dtype))
            assert got[1].dtype == dtype
            for g, wt, t in zip(got, want, (1e-5, tol)):
                assert _share(g.float().cpu(), wt.cpu()) <= t
            if dtype == torch.float32:
                assert all(torch.equal(g, wt) for g, wt in zip(got, want))


def test_cpu_path_differentiates_the_plain_version():
    """On the CPU the scan is the plain version, which autograd
    differentiates (recurrentgemma trains there): the gradient of
    sum(h) against b is finite and nonzero."""
    b = torch.randn((1, 8, 4), requires_grad=True)
    ops.rglru_scan_op(-torch.ones((1, 8, 4)), b).sum().backward()
    assert torch.isfinite(b.grad).all() and b.grad.abs().sum() > 0
