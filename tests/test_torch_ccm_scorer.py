"""Port parity, the stage-2 scorer: the plain torch version
(``repro_torch.kernels.ccm_scorer.ref``) and the kernel wrapper's CPU route
against the JAX package's NumPy reference (``repro.kernels.ccm_scorer
.ref.score_tiles``) and its Pallas kernel run in interpret mode
(``score_tiles_fwd(..., interpret=True)``), on the same numpy tiles.

Tolerance: none.  The scorer uses only add, sub, max, compare and select
in one fixed association, so float64 results are bitwise-equal to both
references, and float32 results bitwise-equal to the float32 interpret
kernel (``np.testing.assert_array_equal``; NaN lanes must match as NaN).
The CUDA kernel itself is held to the same plain version on the card by
``chip_smoke.py`` and by the card-only test at the end of this file."""
import jax
import numpy as np
import pytest
import torch

from repro.kernels.ccm_scorer import layout as r_layout
from repro.kernels.ccm_scorer import ops as r_ops
from repro.kernels.ccm_scorer import ref as r_ref
from repro.kernels.ccm_scorer.kernel import score_tiles_fwd
from repro_torch.kernels.ccm_scorer import kernel, layout, ops, ref
from repro_torch.kernels.ccm_scorer.layout import N_AV, N_PM, N_SC, SC
from repro_torch.core import CCMParams


def _random_tiles(seed, e_n=4, a_n=16, b_n=16):
    rng = np.random.default_rng(seed)
    av = rng.uniform(-2, 2, (e_n, N_AV, a_n))
    bv = rng.uniform(-2, 2, (e_n, N_AV, b_n))
    pm = rng.uniform(-2, 2, (e_n, N_PM, a_n, b_n))
    sc = rng.uniform(0.1, 3.0, (e_n, N_SC))
    sc[:, SC.na] = rng.integers(0, a_n, e_n)
    sc[:, SC.nb] = rng.integers(0, b_n, e_n)
    return av, bv, pm, sc


def _torch_score(tiles, dtype=torch.float64):
    return ref.score_tiles(*(torch.tensor(t, dtype=dtype)
                             for t in tiles)).numpy()


def _interpret(tiles, np_dtype):
    """The JAX package's Pallas kernel in interpret mode, float64 under
    ``jax.enable_x64`` (as its own tests run it)."""
    args = [t.astype(np_dtype) for t in tiles]
    if np_dtype == np.float64:
        with jax.enable_x64(True):
            return np.asarray(score_tiles_fwd(*args, interpret=True))
    return np.asarray(score_tiles_fwd(*args, interpret=True))


def test_layout_constants_equal_reference():
    for cls in ("AV", "PM", "SC", "OUT"):
        mine = {k: v for k, v in vars(getattr(layout, cls)).items()
                if not k.startswith("_")}
        theirs = {k: v for k, v in vars(getattr(r_layout, cls)).items()
                  if not k.startswith("_")}
        assert mine == theirs, cls
    assert (layout.N_AV, layout.N_PM, layout.N_SC, layout.N_OUT) == \
        (r_layout.N_AV, r_layout.N_PM, r_layout.N_SC, r_layout.N_OUT) == \
        (14, 6, 32, 10)


# (seed, E, A, B): includes the single-lane tile, a one-sided give (B=1)
# and the empty-candidate event (na = nb = 0 is drawn with A = B = 1)
SHAPES = [(0, 4, 16, 16), (1, 1, 13, 13), (2, 8, 13, 5), (3, 1, 1, 1),
          (4, 3, 1, 7), (5, 2, 9, 1)]


@pytest.mark.parametrize("seed,e_n,a_n,b_n", SHAPES)
def test_plain_torch_f64_bitwise_vs_numpy_ref_and_pallas_interpret(
        seed, e_n, a_n, b_n):
    tiles = _random_tiles(seed, e_n, a_n, b_n)
    got = _torch_score(tiles)
    np.testing.assert_array_equal(got, r_ref.score_tiles(*tiles))
    np.testing.assert_array_equal(got, _interpret(tiles, np.float64))
    # the wrapper's CPU route is the plain version
    wrapped = kernel.score_tiles(*(torch.tensor(t) for t in tiles))
    np.testing.assert_array_equal(wrapped.numpy(), got)


@pytest.mark.parametrize("seed,e_n,a_n,b_n", SHAPES[:3])
def test_plain_torch_f32_bitwise_vs_pallas_interpret_f32(seed, e_n, a_n,
                                                         b_n):
    tiles = _random_tiles(seed, e_n, a_n, b_n)
    got = _torch_score(tiles, torch.float32)
    want = _interpret(tiles, np.float32)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_masked_tail_zero_and_inf():
    """Slots past (na, nb) are exactly 0 (flow/load/homing planes) and +inf
    (memory planes); live slots are finite."""
    tiles = _random_tiles(7, e_n=2, a_n=8, b_n=8)
    tiles[3][:, SC.na] = [2, 0]
    tiles[3][:, SC.nb] = [3, 0]
    out = _torch_score(tiles)
    np.testing.assert_array_equal(out, r_ref.score_tiles(*tiles))
    for e, (na, nb) in enumerate(((2, 3), (0, 0))):
        tail = np.ones((8, 8), bool)
        tail[:na + 1, :nb + 1] = False
        assert (out[e, :8][:, tail] == 0.0).all()
        assert np.isposinf(out[e, 8:][:, tail]).all()
        assert np.isfinite(out[e, :, :na + 1, :nb + 1]).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_nan_inputs_propagate_like_the_reference(dtype):
    """NaN in a max operand must come out NaN (np.maximum semantics, not
    CUDA fmax), on both the sent/recv maxima and the overhead maxima."""
    tiles = _random_tiles(11, e_n=3, a_n=5, b_n=6)
    tiles[3][:, SC.na] = 4
    tiles[3][:, SC.nb] = 5
    tiles[0][0, r_layout.AV.ovh, 2] = np.nan      # mem_b max operand
    tiles[1][1, r_layout.AV.out_other, 3] = np.nan  # off_b via sent_b
    tiles[3][2, SC.ovh_a] = np.nan                 # mem_a max operand
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    got = _torch_score(tiles, dtype)
    assert np.isnan(got).any()
    np.testing.assert_array_equal(got, _interpret(tiles, np_dtype))
    if dtype == torch.float64:
        np.testing.assert_array_equal(got, r_ref.score_tiles(*tiles))


def test_padding_never_changes_live_lanes():
    """Zero-padding a tile (as the launcher pads a batch to its largest
    event) leaves every live lane bitwise unchanged."""
    tiles = _random_tiles(13, e_n=3, a_n=6, b_n=4)
    tiles[3][:, SC.na] = [5, 2, 0]
    tiles[3][:, SC.nb] = [3, 1, 2]
    small = _torch_score(tiles)
    av, bv, pm, sc = tiles
    big = [np.zeros((3, N_AV, 11)), np.zeros((3, N_AV, 9)),
           np.zeros((3, N_PM, 11, 9)), sc]
    big[0][:, :, :6], big[1][:, :, :4], big[2][:, :, :6, :4] = av, bv, pm
    np.testing.assert_array_equal(_torch_score(big)[:, :, :6, :4], small)


@pytest.mark.parametrize("mem_constraint", [True, False])
def test_host_combines_bitwise_vs_reference(mem_constraint):
    tiles = _random_tiles(17, e_n=3, a_n=7, b_n=5)
    tiles[3][:, SC.mem_cap_a] = 2.0
    tiles[3][:, SC.mem_cap_b] = 3.5
    out = _torch_score(tiles)
    sc = tiles[3]
    params = CCMParams(alpha=1.0, beta=0.3, gamma=0.7, delta=0.11,
                       memory_constraint=mem_constraint)
    for got, want in zip(ops.combine_work(out, sc, params),
                         r_ops.combine_work(out, sc, params)):
        np.testing.assert_array_equal(got, want)
    outp = out[1][:, [0, 2, 4], [1, 0, 3]]
    for got, want in zip(ops.combine_work_pairs(outp, sc[1], params),
                         r_ops.combine_work_pairs(outp, sc[1], params)):
        np.testing.assert_array_equal(got, want)
    terms = np.random.default_rng(3).uniform(0, 4, (10, 6))
    for got, want in zip(ops.combine_terms(terms, sc[0], params),
                         r_ops.combine_terms(terms, sc[0], params)):
        np.testing.assert_array_equal(got, want)


def test_wrapper_rejects_tensors_off_the_card():
    """A tile set that is not all on the CPU must be all on one CUDA device;
    anything else raises instead of falling back."""
    av, bv, pm, sc = (torch.tensor(t) for t in _random_tiles(0, 1, 2, 2))
    with pytest.raises(ValueError):
        kernel.score_tiles(av.to("meta"), bv, pm, sc)
    with pytest.raises(ValueError):
        kernel.score_tiles(*(t.to("meta") for t in (av, bv, pm, sc)))


def test_cuda_kernel_equals_plain_version_on_the_card():
    """Runs only where there is a card (``chip_smoke.py`` runs the full
    check): the CUDA kernel against the plain version, float64 and
    float32, exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for dtype in (torch.float64, torch.float32):
        for seed, e_n, a_n, b_n in SHAPES:
            t = [torch.tensor(x, dtype=dtype, device="cuda")
                 for x in _random_tiles(seed, e_n, a_n, b_n)]
            before = kernel.LAUNCHES[str(dtype).removeprefix("torch.")]
            got = kernel.score_tiles(*t)
            assert kernel.LAUNCHES[str(dtype).removeprefix("torch.")] == \
                before + 1
            assert torch.equal(got, ref.score_tiles(*t))
