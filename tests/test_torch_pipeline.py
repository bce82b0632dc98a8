"""Port parity, the multi-phase pipeline and its carry-over:
``repro_torch.core.ccm_lb_pipeline(device="cpu")`` and the pieces it is
built on (``same_topology``, ``CCMState.retarget``, ``warm_start_assignment``,
``ccm_lb(carry=, csr=)``, ``QuiesceTracker.rebind``)
against the JAX package's, on the instances of ``tests/test_pipeline.py``.

Tolerance: none.  Every phase's assignment, transfer log, transfer count
and work traces, and every ``PhaseRun`` flag (``warm_started``,
``csr_reused``, ``carried_tasks``, ``engine_carried``), must equal the
reference's (``backend="numpy"``) bit for bit.  The port's own checks
(carry on against off, a ``spec_window`` pipeline against the host engine,
``retarget`` against a fresh build) are exact too."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import CCMParams as RParams
from repro.core import ccm_lb_pipeline as r_pipeline
from repro.core import random_phase as r_random_phase
from repro.core import same_topology as r_same_topology
from repro.core import warm_start_assignment as r_warm_start
from repro.core.pipeline import PipelinePhase as RPipelinePhase
from repro.core.problem import initial_assignment as r_initial_assignment
from repro.runtime.elastic import RankJoin as RRankJoin
from repro_torch.convert import from_reference
from repro_torch.core import (CCMParams, CCMState, PipelinePhase, ccm_lb,
                              ccm_lb_pipeline,
                              initial_assignment, same_topology,
                              warm_start_assignment)
from repro_torch.core.quiesce import phase_values_equal
from repro_torch.runtime import RankJoin

PARAMS = dict(delta=1e-9)


def _drifting_phases(seed, n_phases, ranks=10, tasks=200, drift=0.06):
    """``tests/test_pipeline.py``'s instances: a reference phase whose task
    loads random-walk by a lognormal factor a phase."""
    base = r_random_phase(seed, num_ranks=ranks, num_tasks=tasks,
                          num_blocks=tasks // 8, num_comms=2 * tasks,
                          mem_cap=5e8)
    rng = np.random.default_rng(seed + 100)
    phases = [base]
    for _ in range(n_phases - 1):
        prev = phases[-1]
        phases.append(dataclasses.replace(
            prev, task_load=prev.task_load
            * rng.lognormal(0.0, drift, prev.num_tasks)))
    return phases


def _port_phase(ref_phase):
    """The port's copy of a reference phase (fields copied, not shared)."""
    ph, _, _ = from_reference(dataclasses.asdict(ref_phase), {}, [])
    return ph


def _port_params(**kw):
    return CCMParams(**dataclasses.asdict(RParams(**kw)))


def _same_result(got, want, iters=True):
    """Equal runs; ``iters=False`` for a fleet instance, which keeps no
    per-iteration transfer counts."""
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert got.transfer_log == want.transfer_log
    assert got.transfers == want.transfers
    assert got.max_work == want.max_work
    assert got.total_work == want.total_work
    assert got.imbalance == want.imbalance
    if iters:
        assert got.iter_transfers == want.iter_transfers


def _same_pipeline(got, want):
    assert len(got.runs) == len(want.runs)
    for g, w in zip(got.runs, want.runs):
        _same_result(g.result, w.result)
        assert (g.warm_started, g.csr_reused, g.carried_tasks,
                g.engine_carried) == (w.warm_started, w.csr_reused,
                                      w.carried_tasks, w.engine_carried)
        assert g.result.state.phase.num_ranks \
            == w.result.state.phase.num_ranks


def _both(ref_phases, params=PARAMS, **kw):
    """(port pipeline on the CPU, reference pipeline) of the same phases.
    ``params`` is one dict of CCMParams fields or a list of them."""
    if isinstance(params, dict):
        rp, tp = RParams(**params), _port_params(**params)
    else:
        rp = [RParams(**p) for p in params]
        tp = [_port_params(**p) for p in params]
    want = r_pipeline(ref_phases, rp, **kw)
    got = ccm_lb_pipeline([_port_phase(p) for p in ref_phases], tp,
                          device="cpu", **kw)
    return got, want


# ------------------------------------------------------------ pipelines
@pytest.mark.parametrize("seed", range(3))
def test_pipeline_matches_reference_and_hand_chaining(seed):
    """The reference test's hand-chaining instance: the port's pipeline
    equals the reference's, and the port's own hand-chained ``ccm_lb``
    calls (seed + k, previous output as the next start)."""
    phases = _drifting_phases(seed, n_phases=3)
    got, want = _both(phases, n_iter=2, seed=seed)
    _same_pipeline(got, want)
    assert [r.csr_reused for r in got.runs] == [False, True, True]
    assert [r.warm_started for r in got.runs] == [False, True, True]
    a = initial_assignment(_port_phase(phases[0]), "home")
    for k, ph in enumerate(phases):
        ref = ccm_lb(_port_phase(ph), a, _port_params(**PARAMS), n_iter=2,
                     seed=seed + k, device="cpu")
        _same_result(got.runs[k].result, ref)
        a = ref.assignment


def test_pipeline_repeated_phases_match_reference():
    base = _drifting_phases(7, n_phases=1)[0]
    got, want = _both([base] * 4, n_iter=2, seed=0)
    _same_pipeline(got, want)
    assert all(r.carried_tasks == base.num_tasks for r in got.runs[1:])
    assert all(r.csr_reused for r in got.runs[1:])


def test_pipeline_cold_mode_matches_reference():
    phases = _drifting_phases(2, n_phases=3)
    got, want = _both(phases, n_iter=2, seed=5, warm_start=False,
                      reuse_csr=False)
    _same_pipeline(got, want)
    assert not any(r.csr_reused or r.warm_started for r in got.runs)


def test_pipeline_per_phase_params_match_reference():
    phases = _drifting_phases(3, n_phases=2)
    plist = [dict(delta=1e-9), dict(alpha=1.0, beta=2e-9, delta=1e-9)]
    got, want = _both(phases, plist, n_iter=2, seed=1)
    _same_pipeline(got, want)
    with pytest.raises(ValueError, match="params sequence"):
        ccm_lb_pipeline([_port_phase(p) for p in phases],
                        [_port_params(**PARAMS)], n_iter=1, device="cpu")


def test_pipeline_membership_joins_match_reference():
    """A RankJoin at phase 1 expands that phase and every later one; the
    port's expanded phases, warm starts and runs equal the reference's."""
    phases = _drifting_phases(0, n_phases=3)
    want = r_pipeline(phases, RParams(**PARAMS), n_iter=2, seed=0,
                      membership=(RRankJoin(iteration=1, count=2),))
    got = ccm_lb_pipeline([_port_phase(p) for p in phases],
                          _port_params(**PARAMS), n_iter=2, seed=0,
                          device="cpu",
                          membership=(RankJoin(iteration=1, count=2),))
    _same_pipeline(got, want)
    assert [r.result.state.phase.num_ranks for r in got.runs] == [10, 12, 12]
    for g, w in zip(got.runs, want.runs):
        for f in ("rank_mem_base", "rank_mem_cap", "rank_speed"):
            np.testing.assert_array_equal(getattr(g.result.state.phase, f),
                                          getattr(w.result.state.phase, f))
    assert np.isin(got.final_assignment, [10, 11]).sum() > 0
    with pytest.raises(ValueError, match="iteration"):
        ccm_lb_pipeline([_port_phase(p) for p in phases],
                        _port_params(**PARAMS), n_iter=2, device="cpu",
                        membership=(RankJoin(iteration=5),))


@pytest.mark.parametrize("phases", ["identical", "drifting"])
def test_carry_engine_matches_reference(phases):
    """``carry_engine=True`` against the reference's: identical phases keep
    the tracker's caches (``tests/test_quiesce.py``'s instance: 8 ranks, 14
    tasks a rank), drifting ones retarget the state and reset them; the
    flags and every run are equal, and equal to the uncarried pipeline."""
    if phases == "identical":
        ph = r_random_phase(9, num_ranks=8, num_tasks=112, num_blocks=16,
                            num_comms=224, mem_cap=1e12)
        seq = [ph, ph, ph]
        params = dict(alpha=1.0, beta=1e-9, gamma=1e-11, delta=1e-9)
        kw = dict(n_iter=3, fanout=3, seed=4)
    else:
        seq = _drifting_phases(1, n_phases=3)
        params = PARAMS
        kw = dict(n_iter=2, seed=2)
    got, want = _both(seq, params, carry_engine=True, **kw)
    _same_pipeline(got, want)
    assert [r.engine_carried for r in got.runs] == [False, True, True]
    plain, _ = _both(seq, params, **kw)
    for g, p in zip(got.runs, plain.runs):
        _same_result(g.result, p.result)


def test_spec_window_pipeline_equals_host_engine_pipeline():
    """The port's own check: ``spec_window=8`` passed through
    ``**lb_kwargs`` scores every phase's stage 2 through the window scorer
    and gives the pipeline of the host engine, bit for bit (carried
    engines included)."""
    phases = [_port_phase(p) for p in _drifting_phases(4, n_phases=3)]
    params = _port_params(**PARAMS)
    host = ccm_lb_pipeline(phases, params, n_iter=2, seed=3, device="cpu")
    for carry in (False, True):
        spec = ccm_lb_pipeline(phases, params, n_iter=2, seed=3,
                               device="cpu", spec_window=8,
                               carry_engine=carry)
        for s, h in zip(spec.runs, host.runs):
            _same_result(s.result, h.result)
            assert s.result.spec_windows > 0
        assert [r.engine_carried for r in spec.runs] == [False, carry, carry]


def test_pipeline_replicate_threads_through_lb_kwargs():
    """``replicate`` reaches every phase's ``ccm_lb`` (``**lb_kwargs``), as
    in the reference."""
    phases = _drifting_phases(5, n_phases=2, ranks=6, tasks=60)
    got, want = _both(phases, dict(alpha=1.0, beta=0.0, gamma=0.0,
                                   delta=0.0), n_iter=3, seed=0,
                      replicate=True)
    _same_pipeline(got, want)


def test_pipeline_defaults_to_the_card(monkeypatch):
    """No fallback: without ``device`` the pipeline runs on CUDA, which
    raises when no card is present."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    phases = [_port_phase(p) for p in _drifting_phases(6, n_phases=2)]
    with pytest.raises(RuntimeError, match="cuda"):
        ccm_lb_pipeline(phases, _port_params(**PARAMS), n_iter=1)


# --------------------------------------------------------- unit pieces
def test_same_topology_matches_reference():
    a = _drifting_phases(4, n_phases=2)
    cases = [
        (a[0], a[1]), (a[0], a[0]),
        (a[0], dataclasses.replace(a[0], comm_vol=a[0].comm_vol * 2.0)),
        (a[0], dataclasses.replace(a[0],
                                   comm_src=np.roll(a[0].comm_src, 1))),
        (a[0], dataclasses.replace(
            a[0], task_block=np.where(a[0].task_block == 0, -1,
                                      a[0].task_block))),
        (a[0], _drifting_phases(4, n_phases=1, tasks=160)[0]),
    ]
    got = [same_topology(_port_phase(x), _port_phase(y)) for x, y in cases]
    assert got == [r_same_topology(x, y) for x, y in cases]
    assert got == [True, True, True, False, False, False]
    p = _port_phase(a[0])
    assert same_topology(p, p)


def test_warm_start_assignment_matches_reference():
    """Positional and id-mapped warm starts, the out-of-range clip (a
    phase with fewer ranks, as crash recovery builds), a count mismatch
    without ids, and an empty previous phase."""
    prev = _drifting_phases(5, n_phases=1, ranks=6, tasks=30)[0]
    prev_a = r_initial_assignment(prev, "round_robin")
    keep = np.arange(10, 30)
    nxt = dataclasses.replace(
        prev,
        task_load=np.concatenate([prev.task_load[keep], np.ones(5)]),
        task_mem=np.concatenate([prev.task_mem[keep], np.zeros(5)]),
        task_overhead=np.concatenate([prev.task_overhead[keep],
                                      np.zeros(5)]),
        task_block=np.concatenate([prev.task_block[keep],
                                   np.full(5, -1, np.int64)]),
        comm_src=np.zeros(0, np.int64), comm_dst=np.zeros(0, np.int64),
        comm_vol=np.zeros(0))
    fewer = dataclasses.replace(
        prev, rank_mem_base=prev.rank_mem_base[:4],
        rank_mem_cap=prev.rank_mem_cap[:4], rank_speed=prev.rank_speed[:4],
        block_home=np.minimum(prev.block_home, 3))
    empty = dataclasses.replace(
        prev, task_load=np.zeros(0), task_mem=np.zeros(0),
        task_overhead=np.zeros(0), task_block=np.zeros(0, np.int64),
        comm_src=np.zeros(0, np.int64), comm_dst=np.zeros(0, np.int64),
        comm_vol=np.zeros(0))
    next_ids = np.concatenate([keep, np.arange(100, 105)])
    cases = [
        (prev, prev_a, prev, {}),
        (prev, prev_a, nxt, dict(prev_ids=np.arange(30), next_ids=next_ids)),
        (prev, prev_a, nxt, {}),
        (prev, prev_a, fewer, {}),
        (prev, prev_a, fewer, dict(mode="round_robin")),
        (prev, prev_a, nxt, dict(next_ids=next_ids)),
        (empty, np.zeros(0, np.int64), nxt,
         dict(prev_ids=np.zeros(0, np.int64), next_ids=next_ids)),
    ]
    carried = []
    for p0, a, p1, kw in cases:
        out, n = warm_start_assignment(_port_phase(p0), a, _port_phase(p1),
                                       **kw)
        want, n_want = r_warm_start(p0, a, p1, **kw)
        np.testing.assert_array_equal(out, want)
        assert out.dtype == want.dtype and n == n_want
        carried.append(n)
    assert carried[:4] == [30, 20, 0, 20] and carried[-1] == 0
    with pytest.raises(ValueError, match="one id per task"):
        PipelinePhase(_port_phase(prev), task_ids=np.arange(5))
    with pytest.raises(ValueError, match="one id per task"):
        RPipelinePhase(prev, task_ids=np.arange(5))


def test_pipeline_with_task_ids_matches_reference():
    """Phases matched by persistent ids (the id-mapped warm start inside
    the pipeline)."""
    ph = _drifting_phases(8, n_phases=2)
    ids = [np.arange(200), np.arange(200)[::-1].copy()]
    want = r_pipeline([RPipelinePhase(p, i) for p, i in zip(ph, ids)],
                      RParams(**PARAMS), n_iter=2, seed=1)
    got = ccm_lb_pipeline([PipelinePhase(_port_phase(p), i)
                           for p, i in zip(ph, ids)],
                          _port_params(**PARAMS), n_iter=2, seed=1,
                          device="cpu")
    _same_pipeline(got, want)


def test_retarget_equals_a_fresh_build():
    """``CCMState.retarget`` recomputes every value array with the
    operations of ``build``: array for array equal to a fresh build on the
    new phase (bit for bit), with ``version`` bumped and the per-state
    caches cleared."""
    seq = [_port_phase(p) for p in _drifting_phases(3, n_phases=2)]
    seq.append(dataclasses.replace(seq[1], comm_vol=seq[1].comm_vol * 1.5,
                                   task_mem=seq[1].task_mem * 0.7))
    params = _port_params(**PARAMS)
    a0 = initial_assignment(seq[0])
    st = CCMState.build(seq[0], a0, params)
    csr0 = st.csr
    st.max_work()                                    # fill the work cache
    for ph in seq[1:]:
        v = st.version
        st.retarget(ph, params)
        fresh = CCMState.build(ph, a0, params)
        assert st.version == v + 1 and not st._work_cache
        for f in ("load", "vol", "mem_task", "mem_overhead_max",
                  "block_count", "hom_cache", "shared_cache", "task_count",
                  "assignment"):
            got, want = getattr(st, f), getattr(fresh, f)
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
        assert [st.work(r) for r in range(ph.num_ranks)] \
            == [fresh.work(r) for r in range(ph.num_ranks)]
        assert st.csr is csr0                       # the bundle is carried
        assert phase_values_equal(st.phase, ph)
    assert not phase_values_equal(seq[0], seq[1])
    with pytest.raises(ValueError, match="same_topology"):
        st.retarget(_port_phase(_drifting_phases(3, n_phases=1,
                                                 tasks=160)[0]), params)


def test_carried_run_leaves_the_previous_log_alone():
    """Listeners are removed after every run: carrying phase 1's result
    into phase 2 neither grows phase 1's transfer log nor fires phase 1's
    tracker, and the carried run's log equals an uncarried run's."""
    p1, p2 = [_port_phase(p) for p in _drifting_phases(0, n_phases=2)]
    params = _port_params(**PARAMS)
    first = ccm_lb(p1, initial_assignment(p1), params, n_iter=2, seed=0,
                   device="cpu")
    log1 = list(first.transfer_log)
    n_listeners = len(first.state._transfer_listeners)
    carried = ccm_lb(p2, first.assignment, params, n_iter=2, seed=1,
                     device="cpu", carry=first)
    fresh = ccm_lb(p2, first.assignment, params, n_iter=2, seed=1,
                   device="cpu")
    assert carried.engine_carried and not fresh.engine_carried
    assert carried.transfers > 0
    assert first.transfer_log == log1
    assert carried.transfer_log == fresh.transfer_log
    _same_result(carried, fresh)
    # the engine's own segment hook is all that stays registered
    assert len(carried.state._transfer_listeners) == n_listeners == 1


def test_carry_is_refused_where_it_cannot_hold():
    """``ccm_lb`` builds afresh when the carry does not fit: another dtype
    or device, another start, another topology, another knob."""
    p1, p2 = [_port_phase(p) for p in _drifting_phases(1, n_phases=2)]
    params = _port_params(**PARAMS)
    first = ccm_lb(p1, initial_assignment(p1), params, n_iter=1,
                   device="cpu")
    other_topology = _port_phase(_drifting_phases(2, n_phases=1)[0])
    for ph, a, kw in ((p2, first.assignment, dict(dtype=torch.float32)),
                      (p2, initial_assignment(p2), {}),
                      (other_topology, first.assignment, {}),
                      (p2, first.assignment, dict(incremental=False))):
        res = ccm_lb(ph, a, params, n_iter=1, device="cpu", carry=first,
                     **kw)
        assert not res.engine_carried
    res = ccm_lb(p2, first.assignment, params, n_iter=1, device="cpu",
                 carry=first)
    assert res.engine_carried


def test_carried_tracker_is_refused_for_another_replicate():
    """A tracker that summarizes without replication is not reused by a
    ``replicate=True`` run: the engine is carried, the tracker is built
    afresh, and the run equals an uncarried ``replicate=True`` run."""
    p1, p2 = [_port_phase(p) for p in _drifting_phases(5, n_phases=2,
                                                       ranks=6, tasks=60)]
    params = _port_params(alpha=1.0, beta=0.0, gamma=0.0, delta=0.0)
    first = ccm_lb(p1, initial_assignment(p1), params, n_iter=2, seed=0,
                   device="cpu")
    carried = ccm_lb(p2, first.assignment, params, n_iter=3, seed=1,
                     device="cpu", carry=first, replicate=True)
    fresh = ccm_lb(p2, first.assignment, params, n_iter=3, seed=1,
                   device="cpu", replicate=True)
    assert carried.engine_carried
    assert carried.tracker is not first.tracker
    assert carried.tracker.replicate
    _same_result(carried, fresh)


@pytest.mark.cuda
def test_cuda_pipeline_equals_cpu_pipeline():
    """On the card: a carried, ``reuse_csr`` pipeline scores every phase
    through the pair kernel and equals the CPU's, phase for phase."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.ccm_scorer import kernel
    phases = [_port_phase(p) for p in _drifting_phases(0, n_phases=3)]
    params = _port_params(**PARAMS)
    cpu = ccm_lb_pipeline(phases, params, n_iter=2, seed=0, device="cpu")
    kernel.reset_launches()
    gpu = ccm_lb_pipeline(phases, params, n_iter=2, seed=0, device="cuda",
                          carry_engine=True)
    assert kernel.PAIR_LAUNCHES["float64"] > 0
    for g, c in zip(gpu.runs, cpu.runs):
        _same_result(g.result, c.result)
    assert [r.engine_carried for r in gpu.runs] == [False, True, True]
