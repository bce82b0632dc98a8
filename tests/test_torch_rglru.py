"""Port parity, the RG-LRU scan: ``repro_torch.kernels.rglru`` against the
JAX package's ``repro.kernels.rglru`` on the same inputs (made with numpy).

On the CPU the port's entry point (``ops.rglru_scan_op``) runs its plain
version (``ref.reference_rglru``); it is held against the reference's
sequential oracle and its Pallas kernel in interpret mode over
``tests/test_kernels.py``'s cases, at that test's ``atol=1e-4``
(float32; the Pallas kernel's closed form sums in another order), and to
one bf16 ulp of the output for bf16 ``b``.  The CUDA kernel is held against
the plain version on the card by the ``cuda``-marked test, which skips
without a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru import reference_rglru as r_reference_rglru
from repro.kernels.rglru import rglru_scan_op as r_rglru_scan_op
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


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version_on_the_card():
    """The CUDA kernel against the plain version on the same card inputs:
    float32 ``atol=1e-5, rtol=1e-5`` (the same steps in the same order; exp
    may differ in the last bit), bf16 one bf16 ulp, at the cases above and
    ragged shapes.  Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for s, w in [(128, 64), (256, 64), (64, 128), (77, 50), (1, 300)]:
        la, b = (torch.tensor(x, device="cuda") for x in _inputs(2, s, w))
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)):
            got = ops.rglru_scan_op(la, b.to(dtype))
            want = ref.reference_rglru(la, b.to(dtype))
            assert got.dtype == dtype
            torch.testing.assert_close(got.float(), want.float(), atol=1e-5,
                                       rtol=tol)


@pytest.mark.cuda
def test_cuda_kernel_refuses_autograd():
    """The RG-LRU kernel has no backward yet: on the card, a call that
    autograd would record raises (naming the ROADMAP item) instead of
    returning a tensor with no gradient; under ``no_grad`` it runs.
    Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    log_a = -torch.ones((1, 8, 4), device="cuda")
    b = torch.randn((1, 8, 4), device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="F14"):
        ops.rglru_scan_op(log_a, b)
    with torch.no_grad():
        assert not ops.rglru_scan_op(log_a, b).requires_grad


def test_cpu_path_differentiates_the_plain_version():
    """On the CPU the scan is the plain version, which autograd
    differentiates (recurrentgemma trains there): the gradient of
    sum(h) against b is finite and nonzero."""
    b = torch.randn((1, 8, 4), requires_grad=True)
    ops.rglru_scan_op(-torch.ones((1, 8, 4)), b).sum().backward()
    assert torch.isfinite(b.grad).all() and b.grad.abs().sum() > 0
