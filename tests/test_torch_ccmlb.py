"""Port parity, the whole slice: ``repro_torch.core.ccm_lb(device="cpu")``
against the JAX package's ``repro.core.ccm_lb`` from the same phase,
parameters and start assignment.

Tolerance: none.  The float64 port must reproduce the reference's
assignment, transfer log, transfer count and max-work trace exactly
(``backend="numpy"``, and ``backend="pallas"`` in interpret mode).  The
float32 port (the counterpart of ``backend="pallas_compiled"``) is held to
assignment identity with the float64 reference on the phases where that
holds, and to the reference's float32 path exactly (assignment, transfer
log and count) on one where both leave the float64 trajectory."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import CCMParams as RParams
from repro.core import ccm_lb as r_ccm_lb
from repro.core.problem import initial_assignment as r_initial_assignment
from repro.core.problem import random_phase as r_random_phase
from repro.core.problem import scaling_phase as r_scaling_phase
from repro_torch.convert import from_reference
from repro_torch.core import CCMParams, ccm_lb, initial_assignment
from repro_torch.core import scaling_phase
from repro_torch.kernels.ccm_scorer import launch


def _memory_phase(ranks):
    """A phase on which the memory constraint binds: the scaling family's
    per-rank shape with a 2.4e8-byte cap, so a few ranks start over it."""
    return r_random_phase(1, num_ranks=ranks, num_tasks=25 * ranks,
                          num_blocks=3 * ranks, num_comms=50 * ranks,
                          mem_cap=2.4e8)


def _both(phase, **kw):
    params = RParams()
    a0 = r_initial_assignment(phase)
    want = r_ccm_lb(phase, a0, params, backend=kw.pop("backend", "numpy"),
                    **kw)
    tph, tparams, ta = from_reference(dataclasses.asdict(phase),
                                      dataclasses.asdict(params), a0)
    return ccm_lb(tph, ta, tparams, device="cpu", **kw), want, (tph, ta,
                                                                tparams)


def _assert_same_run(got, want):
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert got.transfer_log == want.transfer_log
    assert got.transfers == want.transfers
    assert got.max_work == want.max_work
    assert got.iter_transfers == want.iter_transfers


@pytest.mark.parametrize("ranks,kw", [
    (16, {}), (16, dict(batch_lock_events=8)),
    (64, {}), (64, dict(batch_lock_events=8)),
    (16, dict(replicate=True)),
    (16, dict(use_engine=False)), (16, dict(quiesce_after=1, n_iter=6)),
])
def test_ccm_lb_f64_matches_reference_on_scaling_phase(ranks, kw):
    got, want, _ = _both(r_scaling_phase(ranks), **kw)
    assert want.transfers > 0
    _assert_same_run(got, want)


@pytest.mark.parametrize("ranks,kw", [
    (64, {}), (64, dict(batch_lock_events=8)), (32, dict(replicate=True))])
def test_ccm_lb_f64_matches_reference_with_memory_binding(ranks, kw):
    got, want, _ = _both(_memory_phase(ranks), **kw)
    assert np.isinf(want.max_work[0])       # ranks start over the cap
    assert np.isfinite(want.max_work[-1])
    _assert_same_run(got, want)


def test_ccm_lb_f64_matches_reference_pallas_interpret(monkeypatch):
    """The JAX package's Pallas backend (interpret mode) needs
    ``jax.experimental.enable_x64``, which jax 0.9 removed; scope a shim to
    this test (the JAX package itself is left as it is)."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)
    got, want, _ = _both(r_scaling_phase(16), backend="pallas")
    _assert_same_run(got, want)


@pytest.mark.parametrize("phase,batch", [
    ("scaling16", 1), ("scaling16", 8), ("memory64", 8)])
def test_ccm_lb_f32_assignment_identity(phase, batch):
    ph = r_scaling_phase(16) if phase == "scaling16" else _memory_phase(64)
    _, want, (tph, ta, tparams) = _both(ph, batch_lock_events=batch)
    got = ccm_lb(tph, ta, tparams, device="cpu", dtype=torch.float32,
                 batch_lock_events=batch)
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert got.transfers == want.transfers


@pytest.mark.parametrize("kw", [
    {}, dict(batch_lock_events=4), dict(max_clusters_per_rank=3)])
def test_ccm_lb_f32_matches_reference_float32_path(kw):
    """The float32 port against the reference's own float32 path
    (``backend="pallas_compiled"``), exactly: on this phase both leave the
    float64 trajectory at transfer 85 (124 transfers against 117), in the
    same way."""
    ph = r_random_phase(3, num_ranks=16, num_tasks=192, num_blocks=48,
                        num_comms=320, mem_cap=2.4e8)
    _, want, (tph, ta, tparams) = _both(ph, backend="pallas_compiled", **kw)
    got = ccm_lb(tph, ta, tparams, device="cpu", dtype=torch.float32, **kw)
    assert want.transfers > 0
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert got.transfer_log == want.transfer_log
    assert got.transfers == want.transfers


def test_scorer_calls_and_engine_variants_agree():
    """incremental=False (rebuild reference) and profiling change nothing;
    each run makes scorer calls, and batching makes fewer of them."""
    ph = scaling_phase(16)
    a0 = initial_assignment(ph)
    calls = {}
    runs = {}
    for name, kw in (("solo", {}), ("rebuild", dict(incremental=False)),
                     ("batch8", dict(batch_lock_events=8, profile=True))):
        launch.reset_stats()
        runs[name] = ccm_lb(ph, a0, CCMParams(), device="cpu", **kw)
        calls[name] = launch.STATS["calls"]
    for name in ("rebuild", "batch8"):
        _assert_same_run(runs[name], runs["solo"])
    assert 0 < calls["batch8"] < calls["solo"]
    assert set(runs["batch8"].stage_timings[0]) == {
        "clusters", "gossip", "work_lists", "score", "commit"}


def test_ccm_lb_entry_point_checks():
    ph = scaling_phase(4)
    a0 = initial_assignment(ph)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ccm_lb(ph, a0, CCMParams())         # default device is cuda
    spec = ccm_lb(ph, a0, CCMParams(), device="cpu", spec_window=4)
    _assert_same_run(spec, ccm_lb(ph, a0, CCMParams(), device="cpu"))
    assert spec.spec_windows > 0
    with pytest.raises(ValueError, match="float64"):
        ccm_lb(ph, a0, CCMParams(), device="cpu", spec_window=4,
               dtype=torch.float32)
    with pytest.raises(ValueError):
        ccm_lb(ph, a0, CCMParams(), device="cpu", batch_lock_events=4,
               replicate=True)
    with pytest.raises(ValueError):
        ccm_lb(ph, a0, CCMParams(), device="cpu", batch_lock_events=2,
               use_engine=False)
