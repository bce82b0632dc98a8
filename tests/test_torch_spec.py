"""Port parity, the speculative-scan slice: ``PhaseEngine.spec_raw``, the
window scorer (``ref.score_spec_rows``, ``launch.score_spec``), the
speculative driver (``ccm_lb(spec_window=...)``) and the fleet mode
(``ccm_lb_many``) of ``repro_torch`` on the CPU, against the JAX package
(``repro``) and against the port's own host engine.

Tolerances:

- window rows (``spec_raw``): none, bit for bit with the JAX package's;
- the window scorer against the JAX package's compiled ``score_spec``: the
  same selected slot, w_a and w_b within ``SPEC_RTOL`` relative, and the
  score (a difference of works) within ``SPEC_RTOL`` of the larger work
  (the XLA body sums F's slices in its own order and may contract the
  combine into fused multiply-adds; the port sums sequentially and rounds
  each step; the distances measured on these rows are stated beside
  ``SPEC_RTOL``);
- trajectories (assignment, transfer log and count): none, against both
  the port's host engine and the JAX package's spec path; max_work
  ``allclose`` as in ``tests/test_spec_scan.py``.

The JAX package's spec path needs ``jax.experimental.enable_x64``, which
jax 0.9 removed; a shim is scoped to the reference runs here, as in
``tests/test_torch_ccmlb.py`` (the JAX package itself is left as it is).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import CCMParams as RParams
from repro.core import ccm_lb as r_ccm_lb
from repro.core import spec as r_spec
from repro.core.problem import initial_assignment as r_initial_assignment
from repro.core.problem import random_phase as r_random_phase
from repro.kernels.ccm_scorer import jit as r_jit
from repro_torch.convert import from_reference
from repro_torch.core import (CCMParams, ccm_lb, ccm_lb_many,
                              initial_assignment, random_phase)
from repro_torch.core import spec as t_spec
from repro_torch.kernels.ccm_scorer import (kernel, launch, layout, ref,
                                            spec_cases)

R_PARAMS = RParams(delta=1e-9)
KW = dict(n_iter=3, k_rounds=2, fanout=4, seed=0, use_engine=True)
#: the five (mode, fill, window) cases of tests/test_spec_scan.py
SPEC_CASES = [("scan", "disjoint", 2), ("scan", "disjoint", 8),
              ("scan", "greedy", 8), ("vmap", "disjoint", 4),
              ("vmap", "greedy", 8)]
#: window scorer vs the JAX package's XLA body, relative to the works:
#: measured on the 1025 rows of CAPTURE_CASES, 1022 are bit-identical in
#: every finite column; the worst differs by one ulp of w_b (2.1e-16
#: relative; 2.7e-14 of its score, 128 ulps, since the score is w_before
#: less the work).  Four ulps of the larger work:
SPEC_RTOL = 4 * 2.0 ** -52


def _phase(seed, ranks=8, tasks=160):
    return r_random_phase(seed, num_ranks=ranks, num_tasks=tasks,
                          num_blocks=3 * ranks, num_comms=4 * tasks,
                          mem_cap=1e12)


def _memory_phase(seed=3, mem_cap=2.4e8, ranks=16):
    """The shape of tests/test_torch_ccmlb.py's memory phase at 16 ranks.
    Seed 3 with a 2.4e8-byte cap: every rank starts under its cap and the
    cap binds (the host engine makes 115 transfers, 122 without it); with
    2.0e8 two ranks start over it."""
    return r_random_phase(seed, num_ranks=ranks, num_tasks=25 * ranks,
                          num_blocks=3 * ranks, num_comms=50 * ranks,
                          mem_cap=mem_cap)


PHASES = {"phase11": lambda: _phase(11, ranks=16, tasks=320),
          "memory16": _memory_phase}
#: (phase, params, max_candidates, mode, fill, window) of the runs whose
#: window rows are captured on both sides
CAPTURE_CASES = {
    "phase11": ("phase11", R_PARAMS, 12, "scan", "disjoint", 8),
    "phase11-greedy": ("phase11", R_PARAMS, 12, "vmap", "greedy", 8),
    "memory16": ("memory16", RParams(), 12, "scan", "disjoint", 8),
    "phase11-mc3": ("phase11", R_PARAMS, 3, "scan", "greedy", 8),
}


def _port(phase, params, a0):
    return from_reference(dataclasses.asdict(phase),
                          dataclasses.asdict(params), a0)


@functools.lru_cache(maxsize=None)
def _host(phase_name, params, max_candidates):
    """The port's host-engine run (no speculation)."""
    phase = PHASES[phase_name]()
    a0 = r_initial_assignment(phase)
    tph, tparams, ta = _port(phase, params, a0)
    return ccm_lb(tph, ta, tparams, device="cpu",
                  max_candidates=max_candidates, **KW)


@functools.lru_cache(maxsize=None)
def _spec_runs(phase_name, params, max_candidates, mode, fill, window):
    """The JAX package's and the port's spec runs of one case, each with
    the windows its launcher scored: ``[(raws, out), ...]`` (the JAX
    package's compiled output; the port's rows only)."""
    phase = PHASES[phase_name]()
    a0 = r_initial_assignment(phase)
    r_windows, t_windows = [], []
    r_score = r_jit.score_spec
    t_score = launch.score_spec

    def r_record(raws, **kw):
        out = r_score(raws, **kw)
        r_windows.append(([(row.copy(), eb) for row, eb in raws], out))
        return out

    def t_record(raws, **kw):
        t_windows.append([(row.copy(), eb) for row, eb in raws])
        return t_score(raws, **kw)

    kw = dict(KW, max_candidates=max_candidates, spec_window=window,
              spec_mode=mode, spec_fill=fill, spec_trace=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        mp.setattr(r_spec.scorer_jit, "score_spec", r_record)
        mp.setattr(t_spec.launch, "score_spec", t_record)
        want = r_ccm_lb(phase, a0, params, **kw)
        tph, tparams, ta = _port(phase, params, a0)
        got = ccm_lb(tph, ta, tparams, device="cpu", **kw)
    return want, got, r_windows, t_windows


def _assert_same_trajectory(got, want):
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert got.transfer_log == want.transfer_log
    assert got.transfers == want.transfers
    np.testing.assert_allclose(got.max_work, want.max_work)


def _lanes(max_candidates):
    a_n = layout.bucket_lanes(max_candidates + 1)
    p_n = layout.bucket_pairs(min(max_candidates * (max_candidates + 2),
                                  32))
    return a_n, p_n


def _stacked(raws, a_n, p_n, b_n=None):
    """The port's window buffer of ``raws``, as ``launch.score_spec``
    stacks it (contiguous); ``b_n`` defaults to ``a_n``."""
    eb = max(e for _, e in raws)
    offs = layout.spec_offsets(eb, a_n, a_n if b_n is None else b_n, p_n)
    buf = np.zeros((layout.bucket_events(len(raws)), offs[-1]))
    launch.stack_spec(raws, buf, eb, offs[4])
    return buf


def _scatter_cases():
    """The adversarial scatter rows of ``spec_cases`` built from two real
    rows of the phase11 capture: ``{label: raws}``."""
    a_n, p_n = _lanes(12)
    _, _, _, t_windows = _spec_runs(*CAPTURE_CASES["phase11"])
    rows = [raw for raws in t_windows for raw in raws]
    return dict(spec_cases.scatter_cases(rows[:2], a_n, a_n, p_n))


SCATTER_CASES = ("one bin", "distinct bins", "straddle", "eb 512",
                 "eb 1024", "eb 2048", "all pads", "order")


# ----------------------------------------------------------- (a) layout
def test_layout_helpers_equal_the_reference():
    for n in list(range(0, 300)) + [511, 512, 513, 1000, 4097]:
        assert layout.bucket_lanes(n) == r_jit.bucket_lanes(n)
        assert layout.bucket_events(n) == r_jit.bucket_events(n)
        assert layout.bucket_pairs(n) == r_jit.bucket_pairs(n)
        assert layout.bucket_edges(n) == r_jit.bucket_edges(n)
    for n, floor, cap in ((5, 8, 8), (200, 128, 128), (3, 1, 4)):
        assert (layout.bucket_lanes(n, floor=floor, cap=cap)
                == r_jit.bucket_lanes(n, floor=floor, cap=cap))
    for eb in (32, 64, 256, 1024):
        for a_n, b_n in ((8, 8), (16, 16), (16, 32), (128, 128)):
            for p_n in (32, 64):
                offs = layout.spec_offsets(eb, a_n, b_n, p_n)
                assert offs == r_jit._spec_offsets(eb, a_n, b_n, p_n)
                assert layout.spec_edge_bucket(offs[-1], a_n, b_n,
                                               p_n) == eb
    assert layout.spec_groups(16, 16) == (3, 18, 33)


# ----------------------------------------- (b) spec_raw rows, bit for bit
@pytest.mark.parametrize("case", list(CAPTURE_CASES))
def test_spec_raw_rows_equal_the_reference_bitwise(case):
    want, got, r_windows, t_windows = _spec_runs(*CAPTURE_CASES[case])
    assert len(r_windows) == len(t_windows) > 0
    n_rows = 0
    for (r_raws, _), t_raws in zip(r_windows, t_windows):
        assert len(r_raws) == len(t_raws)
        for (r_row, r_eb), (t_row, t_eb) in zip(r_raws, t_raws):
            assert r_eb == t_eb
            assert r_row.dtype == t_row.dtype == np.float64
            np.testing.assert_array_equal(r_row.view(np.int64),
                                          t_row.view(np.int64))
            n_rows += 1
    assert n_rows > 50
    if case == "memory16":      # the caps are finite in the rows
        o_sc = layout.spec_offsets(t_eb, 16, 16, 32)[4]
        assert np.isfinite(t_row[o_sc + layout.SC.mem_cap_a])
        assert np.isfinite(want.max_work[0])


# ------------------------ (c) the window scorer against the XLA body
@pytest.mark.parametrize("case", list(CAPTURE_CASES))
def test_score_spec_rows_matches_the_compiled_reference(case):
    max_candidates = CAPTURE_CASES[case][2]
    a_n, p_n = _lanes(max_candidates)
    _, _, r_windows, _ = _spec_runs(*CAPTURE_CASES[case])
    for raws, want in r_windows:
        buf = torch.from_numpy(_stacked(raws, a_n, p_n))
        got = ref.score_spec_rows(buf, a_n, a_n, p_n).numpy()[:len(raws)]
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        fin = np.isfinite(want[:, 1])
        np.testing.assert_array_equal(np.isfinite(got[:, 1]), fin)
        g, w = got[fin], want[fin]
        np.testing.assert_allclose(g[:, 2:], w[:, 2:], rtol=SPEC_RTOL,
                                   atol=0)
        scale = np.abs(w[:, 2:]).max(1)
        assert (np.abs(g[:, 1] - w[:, 1]) <= SPEC_RTOL * scale).all()


def test_score_spec_stacks_mixed_edge_buckets():
    """A window whose rows have different edge buckets scores each row as
    it scores alone, pad rows select slot 0 at -inf, and both modes agree
    (they run the same body)."""
    a_n, p_n = _lanes(12)
    _, _, _, t_windows = _spec_runs(*CAPTURE_CASES["phase11"])
    rows = [raw for raws in t_windows for raw in raws]
    by_eb = {}
    for row, eb in rows:
        by_eb.setdefault(eb, (row, eb))
    assert len(by_eb) >= 2, sorted(by_eb)
    mixed = list(by_eb.values()) + rows[:2]
    if layout.bucket_events(len(mixed)) == len(mixed):
        mixed.append(rows[2])                       # leave pad rows
    alone = np.concatenate([launch.score_spec([raw], a_lanes=a_n,
                                              b_lanes=a_n, p_n=p_n,
                                              device="cpu")
                            for raw in mixed])
    for mode in launch.SPEC_MODES:
        together = launch.score_spec(mixed, a_lanes=a_n, b_lanes=a_n,
                                     p_n=p_n, mode=mode, device="cpu")
        np.testing.assert_array_equal(together, alone)
    buf = torch.from_numpy(_stacked(mixed, a_n, p_n))
    assert buf.shape[0] > len(mixed)                # pad rows present
    pad = ref.score_spec_rows(buf, a_n, a_n, p_n)[len(mixed):]
    assert (pad[:, 0] == 0).all() and torch.isneginf(pad[:, 1]).all()
    with pytest.raises(ValueError, match="mode"):
        launch.score_spec(mixed, a_lanes=a_n, b_lanes=a_n, p_n=p_n,
                          mode="pmap", device="cpu")


def test_score_spec_rows_selection_rule():
    """The first maximum wins a tie; no valid, feasible or improving slot
    gives slot 0 at -inf."""
    a_n, p_n = _lanes(12)
    _, _, _, t_windows = _spec_runs(*CAPTURE_CASES["phase11"])
    for row, eb in (raw for raws in t_windows for raw in raws):
        base = ref.score_spec_rows(torch.from_numpy(row[None].copy()), a_n,
                                   a_n, p_n)[0]
        k = int(base[0])
        if k > 0 and np.isfinite(base[1].item()):
            break
    else:
        pytest.fail("no row selects a slot past 0")
    offs = layout.spec_offsets(eb, a_n, a_n, p_n)
    o_sc, o_ia, o_ib, o_ms = offs[4], offs[5], offs[6], offs[7]
    tie = row.copy()                    # the winner's pair also in slot 0
    for o in (o_ia, o_ib):
        tie[o] = tie[o + k]
    for q in range(4):
        tie[offs[3] + q * p_n] = tie[offs[3] + q * p_n + k]
    none = row.copy()
    none[o_ms + 5] = 0                  # no valid slot
    infeasible = row.copy()
    infeasible[o_sc + layout.SC.mem_cap_a] = -1.0
    out = ref.score_spec_rows(torch.from_numpy(np.stack(
        [tie, none, infeasible])), a_n, a_n, p_n)
    assert out[0, 0] == 0 and out[0, 1] == base[1]
    for r in (1, 2):
        assert out[r, 0] == 0 and torch.isneginf(out[r, 1])


@pytest.mark.parametrize("case", SCATTER_CASES)
def test_spec_flow_equals_bincount_on_scatter_cases(case):
    """The plain version's flow matrix on the adversarial scatter rows
    equals ``np.bincount`` (each bin summed in edge order from 0.0) bit for
    bit, every row of the window alike."""
    a_n, p_n = _lanes(12)
    raws = _scatter_cases()[case]
    assert len(raws) == 2
    g_n = layout.spec_groups(a_n, a_n)[2]
    buf = _stacked(raws, a_n, p_n)
    eb = layout.spec_edge_bucket(buf.shape[1], a_n, a_n, p_n)
    flow = ref.spec_flow(torch.from_numpy(buf), a_n, a_n, p_n).numpy()
    for k in range(buf.shape[0]):
        want = np.bincount(buf[k, :eb].astype(np.int64),
                           weights=buf[k, eb:2 * eb], minlength=g_n * g_n)
        np.testing.assert_array_equal(
            flow[k].reshape(-1).view(np.int64), want.view(np.int64))
    if case == "order":         # the two bins differ only by the order
        x_ab, x_ba = (int(b) for b in raws[0][0][raws[0][1] - 6::3][:2])
        f = flow[0].reshape(-1)
        assert f[x_ab] != f[x_ba]
    assert eb == {"eb 512": 512, "eb 1024": 1024, "eb 2048": 2048,
                  "straddle": 512}.get(case, raws[0][1])


def test_score_spec_through_the_padded_staging_stride():
    """Rows of an odd length (lanes 5 and 8) land in the launcher's staging
    buffer at an even stride; the window scored through it equals the plain
    version on the same rows laid out contiguously."""
    rng = np.random.default_rng(7)
    raws = spec_cases.random_rows(rng, 5, 64, 5, 8, 32)
    row_len = raws[0][0].size
    assert row_len % 2 == 1
    view = launch.staging(torch.device("cpu"), torch.float64).window(
        8, row_len)
    assert view.shape == (8, row_len)
    assert view.strides[0] == 8 * kernel.spec_stride(row_len) \
        == 8 * (row_len + 1)
    got = launch.score_spec(raws, a_lanes=5, b_lanes=8, p_n=32,
                            device="cpu")
    want = ref.score_spec_rows(torch.from_numpy(_stacked(raws, 5, 32, 8)),
                               5, 8, 32).numpy()[:len(raws)]
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    assert np.isfinite(got[:, 2:]).all()


# ------------------------------------------------- (d) trajectories
@pytest.mark.parametrize("mode,fill,window", SPEC_CASES)
def test_spec_matches_host_engine_and_reference(mode, fill, window):
    want, got, _, _ = _spec_runs("phase11", R_PARAMS, 12, mode, fill,
                                 window)
    host = _host("phase11", R_PARAMS, 12)
    assert host.transfers > 0
    _assert_same_trajectory(got, host)
    _assert_same_trajectory(got, want)
    assert got.spec_windows == want.spec_windows > 0
    assert got.spec_rollbacks == want.spec_rollbacks
    assert got.spec_trace == want.spec_trace
    if fill == "disjoint":
        assert got.spec_rollbacks == 0
    else:
        assert got.spec_rollbacks > 0


@pytest.mark.parametrize("case", ["memory16", "phase11-mc3"])
def test_spec_matches_host_engine_memory_and_few_candidates(case):
    phase_name, params, mc = CAPTURE_CASES[case][:3]
    want, got, _, _ = _spec_runs(*CAPTURE_CASES[case])
    host = _host(phase_name, params, mc)
    _assert_same_trajectory(got, host)
    _assert_same_trajectory(got, want)


@pytest.mark.parametrize("seed,mem_cap", [(3, 2.0e8), (2, 2.4e8)])
def test_spec_restores_memory_feasibility_like_host_engine(seed, mem_cap):
    """Ranks that start over their memory cap carry infinite work, so the
    feasibility-restoring move scores +inf: the port's spec path commits it
    as the host engine does (the JAX package's spec path refuses it,
    ROADMAP.md queue 3, and is not compared here)."""
    phase = _memory_phase(seed, mem_cap)
    a0 = r_initial_assignment(phase)
    tph, tparams, ta = _port(phase, RParams(), a0)
    host = ccm_lb(tph, ta, tparams, device="cpu", **KW)
    assert np.isinf(host.max_work[0]) and np.isfinite(host.max_work[-1])
    for fill in ("disjoint", "greedy"):
        got = ccm_lb(tph, ta, tparams, device="cpu", spec_window=8,
                     spec_fill=fill, **KW)
        _assert_same_trajectory(got, host)


# ------------------------------------------------ (e) rollback property
@functools.lru_cache(maxsize=None)
def _rollback_run(seed):
    """Greedy fill with n_iter=1 (one run_spec call, so window ids in the
    trace are strictly increasing and contiguous runs ARE windows)."""
    phase = _phase(seed)
    a0 = r_initial_assignment(phase)
    tph, tparams, ta = _port(phase, R_PARAMS, a0)
    kw = dict(n_iter=1, k_rounds=2, fanout=4, seed=seed, device="cpu")
    res = ccm_lb(tph, ta, tparams, spec_window=8, spec_fill="greedy",
                 spec_trace=True, **kw)
    host = ccm_lb(tph, ta, tparams, **kw)
    return res, host


@pytest.mark.parametrize("seed", range(8))
def test_spec_rollback_never_committed_seeded(seed):
    res, host = _rollback_run(seed)
    np.testing.assert_array_equal(host.assignment, res.assignment)
    assert host.transfer_log == res.transfer_log
    trace = res.spec_trace
    wids = [e[0] for e in trace]
    assert wids == sorted(wids)
    windows = {}
    for wid, kind, r, p in trace:
        windows.setdefault(wid, []).append((kind, r, p))
    for wid, entries in windows.items():
        rolled = {(r, p) for kind, r, p in entries if kind == "rollback"}
        landed = {(r, p) for kind, r, p in entries
                  if kind in ("transfer", "commit")}
        assert not (rolled & landed), (wid, rolled & landed)
        kinds = [kind for kind, _, _ in entries]
        if "rollback" in kinds:
            first = kinds.index("rollback")
            assert all(k == "rollback" for k in kinds[first:]), entries
            assert wid < max(windows)
    for i, (wid, kind, r, p) in enumerate(trace):
        if kind == "rollback":
            assert any(e[2] == r and e[3] == p for e in trace[i + 1:]), \
                (wid, r, p)
    assert res.transfers == sum(1 for e in trace if e[1] == "transfer")
    assert res.spec_rollbacks == sum(1 for e in trace
                                     if e[1] == "rollback")
    assert res.spec_windows == len(windows)


def test_spec_greedy_sweep_exercises_rollback():
    assert sum(_rollback_run(s)[0].spec_rollbacks for s in range(8)) > 0


# ------------------------------------------------------- (f) fleet mode
def _t_phase(seed):
    return random_phase(seed, num_ranks=8, num_tasks=160, num_blocks=24,
                        num_comms=640, mem_cap=1e12)


def test_fleet_matches_solo_runs():
    n = 3
    phases = [_t_phase(20 + i) for i in range(n)]
    a0s = [initial_assignment(p) for p in phases]
    params = CCMParams(delta=1e-9)
    kw = dict(n_iter=3, k_rounds=2, fanout=4, max_candidates=12)
    launch.reset_stats()
    fleet = ccm_lb_many(phases, a0s, params, seed=5, device="cpu",
                        spec_trace=True, **kw)
    windows = launch.STATS["spec"]["calls"]
    assert 0 < windows <= sum(r.spec_windows for r in fleet)
    assert launch.STATS["spec"]["rows"] > windows     # shared launches
    for i in range(n):
        solo = ccm_lb(phases[i], a0s[i], params, seed=5 + i, device="cpu",
                      **kw)
        np.testing.assert_array_equal(fleet[i].assignment, solo.assignment)
        assert fleet[i].transfer_log == solo.transfer_log
        np.testing.assert_allclose(fleet[i].max_work, solo.max_work)
        assert fleet[i].engine_used and fleet[i].spec_rollbacks == 0
        assert fleet[i].spec_trace


def test_fleet_explicit_seeds_window_and_scan_mode():
    phases = [_t_phase(30), _t_phase(31)]
    a0s = [initial_assignment(p) for p in phases]
    params = CCMParams(delta=1e-9)
    kw = dict(n_iter=2, k_rounds=2, fanout=4)
    for mode in launch.SPEC_MODES:
        fleet = ccm_lb_many(phases, a0s, params, seeds=[9, 9], window=4,
                            mode=mode, device="cpu", **kw)
        for i in range(2):
            solo = ccm_lb(phases[i], a0s[i], params, seed=9, device="cpu",
                          **kw)
            np.testing.assert_array_equal(fleet[i].assignment,
                                          solo.assignment)
            assert fleet[i].transfer_log == solo.transfer_log


# ----------------------------------------------------- (g) knob checks
def test_spec_knob_validation():
    phase = _t_phase(40)
    a0 = initial_assignment(phase)
    p = CCMParams(delta=1e-9)
    cpu = dict(device="cpu")
    with pytest.raises(ValueError, match="spec_window"):
        ccm_lb(phase, a0, p, spec_window=0, **cpu)
    with pytest.raises(ValueError, match="use_engine"):
        ccm_lb(phase, a0, p, use_engine=False, spec_window=4, **cpu)
    with pytest.raises(ValueError, match="mutually"):
        ccm_lb(phase, a0, p, spec_window=4, batch_lock_events=8, **cpu)
    with pytest.raises(ValueError, match="fill"):
        ccm_lb(phase, a0, p, spec_window=4, spec_fill="bogus", **cpu)
    with pytest.raises(ValueError, match="mode"):
        ccm_lb(phase, a0, p, spec_window=4, spec_mode="pmap", **cpu)
    with pytest.raises(ValueError, match="replicate"):
        ccm_lb(phase, a0, p, spec_window=4, replicate=True, **cpu)
    with pytest.raises(ValueError, match="float64"):
        ccm_lb(phase, a0, p, spec_window=4, dtype=torch.float32, **cpu)
    with pytest.raises(ValueError, match="float64"):
        ccm_lb_many([phase], [a0], p, dtype=torch.float32, **cpu)
    with pytest.raises(ValueError, match="mode"):
        ccm_lb_many([phase], [a0], p, mode="pmap", **cpu)
    with pytest.raises(ValueError, match="window"):
        ccm_lb_many([phase], [a0], p, window=0, **cpu)
    with pytest.raises(ValueError, match="instance"):
        ccm_lb_many([], [], p, **cpu)
    with pytest.raises(ValueError, match="seed"):
        ccm_lb_many([phase], [a0], p, seeds=[1, 2], **cpu)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ccm_lb_many([phase], [a0], p)       # the default is the card
    # float32 with the default spec_window=1 still runs
    ccm_lb(phase, a0, p, n_iter=1, dtype=torch.float32, **cpu)


def test_window_kernel_geometry():
    """Where the window kernel keeps its flow matrix, its shared memory
    (five mbarriers in 48 bytes, the row's tail rounded to even, four
    staging buffers of 256 edges' bins and volumes, F where it fits, the
    slice sums, the warps' winners, each warp's list of 256 edges, run
    buffer of 32 and counts), its row stride, and the limits its wrapper
    checks before a launch (the C side refuses the same)."""
    for lanes, in_smem in ((8, True), (16, True), (32, True), (64, True),
                           (128, False), (256, False)):
        assert kernel.spec_f_in_smem(lanes, lanes, 32) is in_smem
        kernel.check_spec_shapes(8, 256, lanes, lanes, 32, in_smem)
    g_n = layout.spec_groups(16, 16)[2]
    assert kernel.spec_smem_bytes(16, 16, 32, True) \
        - kernel.spec_smem_bytes(16, 16, 32, False) == 8 * g_n * g_n
    tail = layout.spec_offsets(0, 16, 16, 32)[-1]
    assert tail == 454
    # per warp: its list and run buffer, and a row of the split's counts
    lists = 8 * 8 * (256 + 32) + 4 * 8 * (256 + 8 + 1)
    assert kernel.spec_smem_bytes(16, 16, 32, True) == 48 + 8 * (
        454 + 2 * 4 * 256 + g_n * g_n + 4 * g_n + 4 * 8) + lists == 57000
    assert layout.spec_offsets(0, 5, 8, 32)[-1] == 321     # odd: + 1
    assert kernel.spec_smem_bytes(5, 8, 32, False) == 48 + 8 * (
        322 + 2048 + 4 * layout.spec_groups(5, 8)[2] + 32) + lists
    # lanes 64 opt in past the default 48 KB and fit the card's 227 KB
    assert 48 * 1024 < kernel.spec_smem_bytes(64, 64, 32, True) \
        <= kernel._build.MAX_SMEM_BYTES
    assert [kernel.spec_stride(n) for n in (453, 454, 455)] == [454, 454,
                                                                456]
    with pytest.raises(ValueError, match="shared memory"):
        kernel.check_spec_shapes(8, 256, 128, 128, 32, True)
    with pytest.raises(ValueError, match="empty"):
        kernel.check_spec_shapes(0, 256, 16, 16, 32, True)
    with pytest.raises(ValueError, match="odd edge bucket"):
        kernel.check_spec_shapes(8, 255, 16, 16, 32, True)
    buf = torch.zeros((2, layout.spec_offsets(32, 8, 8, 32)[-1]),
                      dtype=torch.float64)
    buf[0, 0] = layout.spec_groups(8, 8)[2] ** 2    # a bin off F
    with pytest.raises(IndexError):
        kernel.score_spec_rows(buf, 8, 8, 32)
    with pytest.raises(ValueError):
        kernel.score_spec_rows(buf.float(), 8, 8, 32)


# --------------------------------------------------------- on the card
@pytest.mark.cuda
def test_cuda_window_kernel_equals_plain_version_on_the_card():
    """Runs only where there is a card (``chip_smoke.py`` runs the full
    check): the window kernel against its plain version bit for bit, with
    the flow matrix in shared memory and in global scratch, on captured
    windows, the adversarial scatter rows and rows of an odd length, and
    the launcher's card route against its CPU route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a_n, p_n = _lanes(12)
    _, _, _, t_windows = _spec_runs(*CAPTURE_CASES["phase11"])
    windows = [(raws, a_n, a_n, p_n) for raws in t_windows[:20]]
    windows += [(raws, a_n, a_n, p_n) for raws in _scatter_cases().values()]
    windows.append((spec_cases.random_rows(np.random.default_rng(7), 5, 64,
                                           5, 8, 32), 5, 8, 32))
    for raws, a_n, b_n, p_n in windows:
        buf = torch.from_numpy(_stacked(raws, a_n, p_n, b_n))
        want = ref.score_spec_rows(buf, a_n, b_n, p_n)
        for f_global in (False, True):
            before = kernel.SPEC_LAUNCHES["float64"]
            got = kernel.score_spec_rows(buf.cuda(), a_n, b_n, p_n,
                                         f_global=f_global).cpu()
            assert kernel.SPEC_LAUNCHES["float64"] == before + 1
            assert torch.equal(got.view(torch.int64),
                               want.view(torch.int64))
        card = launch.score_spec(raws, a_lanes=a_n, b_lanes=b_n, p_n=p_n,
                                 device="cuda")
        np.testing.assert_array_equal(card, want.numpy()[:len(raws)])
