"""Port parity, the stage-2 scorer: the plain torch version
(``repro_torch.kernels.ccm_scorer.ref``) and the kernel wrapper's CPU route
against the JAX package's NumPy reference (``repro.kernels.ccm_scorer
.ref.score_tiles``) and its Pallas kernel run in interpret mode
(``score_tiles_fwd(..., interpret=True)``), on the same numpy tiles; the
pair scorer (``ref.score_pairs``, and the packed fused version the launcher
runs, ``ref.score_pairs_packed``) against the reference's pair path
(``ref.score_pairs_xp``) and its launcher ``jit.score_events(...,
backend="numpy")``.

Tolerance: none.  The scorer uses only add, sub, max, compare and select
in one fixed association, so float64 results are bitwise-equal to both
references, and float32 results bitwise-equal to the float32 interpret
kernel (``np.testing.assert_array_equal``; NaN lanes must match as NaN).
The combine's products, quotients and sums are float64 eager operations,
each rounded once, as in numpy, so the fused results are bitwise too.
The CUDA kernels themselves are held to the same plain versions on the
card by ``chip_smoke.py`` and by the card-only tests in this file."""
import jax
import numpy as np
import pytest
import torch

from repro.kernels.ccm_scorer import jit as r_jit
from repro.kernels.ccm_scorer import layout as r_layout
from repro.kernels.ccm_scorer import ops as r_ops
from repro.kernels.ccm_scorer import ref as r_ref
from repro.kernels.ccm_scorer.kernel import score_tiles_fwd
from repro_torch.kernels.ccm_scorer import kernel, launch, layout, ops, ref
from repro_torch.kernels.ccm_scorer.layout import (AV, N_AV, N_OUT, N_PM,
                                                   N_SC, OUT, SC)
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


# ------------------------------------------------------------ pair scorer
def _random_pairs(rng, a_n, b_n, p):
    """``p`` (ia, ib) pairs of an (a_n, b_n) tile, drawn without
    replacement (every pair of the tile when ``p`` is ``a_n * b_n``)."""
    lanes = rng.choice(a_n * b_n, size=p, replace=False)
    return np.stack([lanes // b_n, lanes % b_n], axis=1).astype(np.int64)


def _with_nans(tiles):
    """NaN in a max operand of two events' lanes (mem_b through the
    a-overhead, off_b through sent_b) and in one event's scalar (mem_a);
    the last event's lanes all live, the others keep their masked tails."""
    av, bv, pm, sc = tiles
    sc[-1, SC.na], sc[-1, SC.nb] = av.shape[2] - 1, bv.shape[2] - 1
    av[0, AV.ovh, 0] = np.nan
    bv[-1, AV.out_other, 0] = np.nan
    sc[-1, SC.ovh_a] = np.nan
    return tiles


@pytest.mark.parametrize("seed,e_n,a_n,b_n", SHAPES)
def test_score_pairs_bitwise_vs_reference_pairs_and_tile_gather(
        seed, e_n, a_n, b_n):
    """The port's pair layout equals the reference's ``score_pairs_xp`` and
    the gather of the full tile, bit for bit in float64, masked tails (na,
    nb below the tile) and NaN lanes included."""
    rng = np.random.default_rng(100 + seed)
    av, bv, pm, sc = _with_nans(_random_tiles(seed, e_n, a_n, b_n))
    p_n = min(a_n * b_n, 7)
    pr = np.stack([_random_pairs(rng, a_n, b_n, p_n) for _ in range(e_n)])
    ia, ib = pr[..., 0], pr[..., 1]                     # (E, P)
    e = np.arange(e_n)[:, None]
    avp = np.moveaxis(av[e, :, ia], 2, 1)               # (E, N_AV, P)
    bvp = np.moveaxis(bv[e, :, ib], 2, 1)
    pmp = np.moveaxis(pm[e, :, ia, ib], 2, 1)
    iaf, ibf = ia.astype(np.float64), ib.astype(np.float64)
    got = ref.score_pairs(*(torch.tensor(x) for x in
                            (avp, bvp, pmp, sc, iaf, ibf))).numpy()
    assert got.shape == (e_n, N_OUT, p_n)
    np.testing.assert_array_equal(
        got, r_ref.score_pairs_xp(avp, bvp, pmp, sc, iaf, ibf))
    tile = r_ref.score_tiles(av, bv, pm, sc)
    np.testing.assert_array_equal(
        got, np.moveaxis(tile[e, :, ia, ib], 2, 1))
    assert np.isnan(got).any()
    tail = (ia > sc[:, SC.na, None]) | (ib > sc[:, SC.nb, None])
    if tail.any():
        assert (got[:, OUT.mem_a][tail] == np.inf).all()


def _events(seed, sizes, mem_constraint=True, nans=False):
    """Random unpadded per-event features ``(av, bv, pm, sc)`` as the
    engine builds them (sc float64, na/nb the true counts), speeds other
    than 1, caps that split the pairs into feasible and not, and ragged
    shortlists: ``sizes`` holds (na + 1, nb + 1, P) per event, P = 0 for
    an empty shortlist."""
    rng = np.random.default_rng(seed)
    feats, pairs = [], []
    for a_k, b_k, p in sizes:
        av = rng.uniform(-2, 2, (N_AV, a_k))
        bv = rng.uniform(-2, 2, (N_AV, b_k))
        pm = rng.uniform(-2, 2, (N_PM, a_k, b_k))
        sc = rng.uniform(0.1, 3.0, N_SC)
        sc[SC.na], sc[SC.nb] = a_k - 1, b_k - 1
        sc[SC.speed_a], sc[SC.speed_b] = rng.uniform(0.3, 4.0, 2)
        sc[SC.mem_cap_a], sc[SC.mem_cap_b] = rng.uniform(8.0, 12.0, 2)
        if nans:
            av[AV.ovh, 0] = np.nan
            bv[AV.load, b_k - 1] = np.nan
        feats.append((av, bv, pm, sc))
        pairs.append(_random_pairs(rng, a_k, b_k, p))
    params = CCMParams(alpha=1.3, beta=0.3, gamma=0.7, delta=0.11,
                       memory_constraint=mem_constraint)
    return feats, pairs, params


# (na + 1, nb + 1, P) per event: solo events (a full tile, a one-sided
# give, a 32-pair shortlist), then batches with ragged P, padding and
# empty shortlists inside
EVENT_SETS = [
    [(6, 5, 30)], [(1, 9, 9)], [(13, 13, 32)],
    [(4, 6, 11), (7, 3, 21), (2, 2, 4)],
    [(5, 5, 0), (9, 4, 32), (3, 8, 0), (13, 13, 32), (1, 1, 1)],
    [(13, 13, 32)] * 8,
]


@pytest.mark.parametrize("mem_constraint", [True, False])
@pytest.mark.parametrize("which", range(len(EVENT_SETS)))
def test_packed_pairs_bitwise_vs_reference_score_events(which,
                                                        mem_constraint):
    """The launcher's CPU route (the packer and the plain fused version)
    equals the reference launcher ``jit.score_events(...,
    backend="numpy")`` per pair, solo and batched, ragged and empty
    shortlists, NaN lanes included."""
    feats, pairs, params = _events(which, EVENT_SETS[which], mem_constraint,
                                   nans=which % 2 == 1)
    launch.reset_stats()
    got = launch.score_events(feats, pairs, params, device=torch.device(
        "cpu"), dtype=torch.float64)
    want = r_jit.score_events(feats, pairs, params, backend="numpy")
    assert len(got) == len(want) == len(feats)
    for (wa, wb, fe), (wa2, wb2, fe2), pr in zip(got, want, pairs):
        assert wa.shape == wb.shape == fe.shape == (len(pr),)
        assert wa.dtype == np.float64 and fe.dtype == bool
        np.testing.assert_array_equal(wa, wa2)
        np.testing.assert_array_equal(wb, wb2)
        np.testing.assert_array_equal(fe, fe2)
    live = [s for s in EVENT_SETS[which] if s[2]]
    assert launch.STATS["calls"] == 1
    assert dict(launch.STATS["shapes"]) == {
        (len(live), max(s[0] for s in live), max(s[1] for s in live)): 1}
    assert sum(launch.STATS["split"].values()) == pytest.approx(
        launch.STATS["seconds"])
    if mem_constraint and which % 2 == 0:     # no NaN memory high
        fe_all = np.concatenate([r[2] for r in got])
        assert fe_all.any() and not fe_all.all()


@pytest.mark.parametrize("which", [0, 3, 4])
def test_packed_pairs_f32_equal_host_combine_of_f32_planes(which):
    """In float32 the planes are float32 and the combine float64, against
    the event's float64 scalar row: the fused result equals
    ``ops.combine_work_pairs`` (and the reference's) on the widened float32
    planes, gathered at the pairs, with the float64 row."""
    feats, pairs, params = _events(10 + which, EVENT_SETS[which])
    got = launch.score_events(feats, pairs, params, device=torch.device(
        "cpu"), dtype=torch.float32)
    for (av, bv, pm, sc), pr, res in zip(feats, pairs, got):
        if not len(pr):
            assert all(len(x) == 0 for x in res)
            continue
        tiles = [torch.tensor(x[None], dtype=torch.float32)
                 for x in (av, bv, pm, sc)]
        planes = ref.score_tiles(*tiles)[0].numpy().astype(np.float64)
        outp = planes[:, pr[:, 0], pr[:, 1]]
        for x, y, z in zip(res, ops.combine_work_pairs(outp, sc, params),
                           r_ops.combine_work_pairs(outp, sc, params)):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)


def _packed(feats, pairs, params, dtype):
    st = launch.Staging(torch.device("cpu"), dtype)
    _, regions, dev_ptrs = launch.pack(feats, pairs, params, st)
    assert dev_ptrs is None
    return [torch.from_numpy(v) for v in regions]


def test_pack_layout_and_wrapper_cpu_route():
    """The packed regions hold the padded tiles, the float64 combine rows
    and the int32 offsets and pairs; ``kernel.score_pairs`` on CPU tensors
    is the plain fused version; a pair outside its tile raises, through
    the wrapper and through the launcher."""
    feats, pairs, params = _events(3, EVENT_SETS[3])
    av, bv, pm, sc, cf, offs, pr = _packed(feats, pairs, params,
                                           torch.float64)
    assert av.shape == (3, N_AV, 7) and pm.shape == (3, N_PM, 7, 6)
    assert offs.tolist() == [0, 11, 32, 36] and pr.dtype == torch.int32
    assert (av[0, :, 4:] == 0).all() and (pm[1, :, :, 3:] == 0).all()
    np.testing.assert_array_equal(cf[:, :4].numpy(), [[1.3, 0.3, 0.7, 0.11]]
                                  * 3)
    np.testing.assert_array_equal(
        cf[:, 4:].numpy(), [f[3][[SC.speed_a, SC.speed_b, SC.mem_cap_a,
                                  SC.mem_cap_b]] for f in feats])
    got = kernel.score_pairs(av, bv, pm, sc, cf, offs, pr, True)
    want = ref.score_pairs_packed(av, bv, pm, sc, cf, offs, pr, True)
    assert got.shape == (3, 36) and got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    for ia, ib in ((7, 0), (0, 6), (-1, 0)):
        bad = pr.clone()
        bad[12] = torch.tensor((ia, ib))
        with pytest.raises(IndexError):
            kernel.score_pairs(av, bv, pm, sc, cf, offs, bad, True)
    bad = [p.copy() for p in pairs]
    bad[1][0] = (7, 0)
    with pytest.raises(IndexError):
        launch.score_events(feats, bad, params, device=torch.device("cpu"),
                            dtype=torch.float64)
    with pytest.raises(ValueError):
        kernel.score_pairs(av.to("meta"), bv, pm, sc, cf, offs, pr, True)


@pytest.mark.cuda
def test_cuda_pair_kernel_equals_plain_version_on_the_card():
    """Runs only where there is a card (``chip_smoke.py`` runs the full
    check): the fused pair kernel against its plain version, float64 and
    float32 (float64 combine), exact, with its launch count; and the
    launcher's card route against its CPU route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for which, mc in ((0, True), (3, False), (4, True), (5, True)):
        feats, pairs, params = _events(20 + which, EVENT_SETS[which], mc,
                                       nans=True)
        for dtype in (torch.float64, torch.float32):
            t = [x.cuda() for x in _packed(feats, pairs, params, dtype)]
            name = str(dtype).removeprefix("torch.")
            before = kernel.PAIR_LAUNCHES[name]
            got = kernel.score_pairs(*t, mc)
            assert kernel.PAIR_LAUNCHES[name] == before + 1
            torch.testing.assert_close(
                got, ref.score_pairs_packed(*t, mc), rtol=0, atol=0,
                equal_nan=True)
            card = launch.score_events(feats, pairs, params,
                                       device=torch.device("cuda"),
                                       dtype=dtype)
            host = launch.score_events(feats, pairs, params,
                                       device=torch.device("cpu"),
                                       dtype=dtype)
            for x, y in zip(card, host):
                for u, v in zip(x, y):
                    np.testing.assert_array_equal(u, v)
    # a pair off its tile raises on the card's route too, and the next
    # call is unharmed
    bad = [p.copy() for p in pairs]
    bad[-1][0] = (0, 13)
    with pytest.raises(IndexError):
        launch.score_events(feats, bad, params, device=torch.device("cuda"),
                            dtype=torch.float64)
    again = launch.score_events(feats, pairs, params,
                                device=torch.device("cuda"),
                                dtype=torch.float64)
    for x, y in zip(again, launch.score_events(
            feats, pairs, params, device=torch.device("cpu"),
            dtype=torch.float64)):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
