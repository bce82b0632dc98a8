"""Port parity, the asynchronous balancer and its runtime:
``repro_torch.core.ccm_lb_async(device="cpu")`` with fault injection and
membership joins, the grant tokens of ``core/locks.py`` and
``repro_torch.runtime`` (elastic frames, faults, stragglers), against the
JAX package's, on the instances of ``tests/test_async_sim.py``,
``tests/test_async_protocol.py`` and the async cases of
``tests/test_memory_pressure.py``.

Tolerance: none.  Each run is compared with the reference's run on the
same inputs (``backend="numpy"``): assignment, transfer log, transfer
count, work traces, the event trace (``collect_trace=True``), the message
and protocol counters, ``FaultStats`` field for field, the recovery log,
the dead and joined ranks.  Where a reference test asserts a property
(log replay, nothing stranded on a dead rank, one live lock a rank), the
port's run is held to it too."""
import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

from repro.core import CCMParams as RParams
from repro.core import FaultSpec as RFaultSpec
from repro.core import LivelockError as RLivelockError
from repro.core import RankJoin as RRankJoin
from repro.core import ccm_lb_async as r_ccm_lb_async
from repro.core import random_phase as r_random_phase
from repro.core.async_sim import RecoveryOOMError as RRecoveryOOMError
from repro.core.locks import LockManager as RLockManager
from repro.core.problem import Phase as RPhase
from repro.core.problem import initial_assignment as r_initial_assignment
from repro.core.problem import scaling_phase as r_scaling_phase
from repro.runtime import elastic as r_elastic
from repro.runtime.fault import RankDeath as RRankDeath
from repro.runtime.straggler import StragglerTracker as RStragglerTracker
from repro_torch.convert import from_reference
from repro_torch.core import (CCMParams, CCMState, FaultSpec, LivelockError,
                              RankJoin, ccm_lb, ccm_lb_async, make_latency,
                              run_ccm_lb)
from repro_torch.core.async_sim import (EVENT_KINDS, FAIL, GRANT, RELEASE,
                                        TIMEOUT, RecoveryOOMError, _run_gossip,
                                        _Sim)
from repro_torch.core.ccmlb import iteration_summaries
from repro_torch.core.gossip import build_peer_networks
from repro_torch.core.locks import LockManager
from repro_torch.runtime import (FaultInjector, NodeFailure, RankDeath,
                                 StragglerTracker, expand_phase,
                                 run_with_restarts, survivor_resize)

PARAMS = dict(delta=1e-9)
FAULT_LAT = ("uniform", 0.1, 2.0)


def _port(ref_phase, a0=None):
    ph, _, a = from_reference(dataclasses.asdict(ref_phase), {},
                              [] if a0 is None else a0)
    return ph if a0 is None else (ph, a)


def _port_params(**kw):
    return CCMParams(**dataclasses.asdict(RParams(**kw)))


def _replay(a0, transfer_log):
    """Replay the mutation log; every entry's source rank must match."""
    a = np.array(a0, copy=True)
    for tasks, r_from, r_to in transfer_log:
        idx = list(tasks)
        assert (a[idx] == r_from).all(), (tasks, r_from, r_to)
        a[idx] = r_to
    return a


def _same_run(got, want):
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert got.transfer_log == want.transfer_log
    assert got.transfers == want.transfers
    assert got.max_work == want.max_work
    assert got.total_work == want.total_work
    assert got.imbalance == want.imbalance
    assert got.iter_transfers == want.iter_transfers
    for f in ("events", "messages", "sim_time", "gossip_dropped",
              "lock_conflicts", "yields", "grant_chains", "max_grant_chain",
              "timeouts", "retries_exhausted", "recovery_log", "dead_ranks",
              "joined_ranks", "memo_hits", "gossip_noop_merges"):
        assert getattr(got, f) == getattr(want, f), f
    if want.fault_stats is None:
        assert got.fault_stats is None
    else:
        assert dataclasses.asdict(got.fault_stats) \
            == dataclasses.asdict(want.fault_stats)
    assert got.state.phase.num_ranks == want.state.phase.num_ranks


def _both(ref_phase, a0, params=PARAMS, *, fault=None, membership=(),
          on_event=None, **kw):
    """(port run on the CPU, reference run) of one async configuration;
    ``fault`` is a dict of FaultSpec fields, ``membership`` RankJoin
    argument tuples, ``on_event`` a probe of the port's run."""
    want = r_ccm_lb_async(
        ref_phase, a0, RParams(**params),
        fault=None if fault is None else RFaultSpec(**fault),
        membership=tuple(RRankJoin(*j) for j in membership), **kw)
    ph, a = _port(ref_phase, a0)
    got = ccm_lb_async(
        ph, a, _port_params(**params), device="cpu",
        fault=None if fault is None else FaultSpec(**fault),
        membership=tuple(RankJoin(*j) for j in membership),
        on_event=on_event, **kw)
    return got, want


def _contended_instance():
    """``tests/test_async_protocol.py``'s contended instance: half the
    ranks start empty, so requests collide under latency."""
    phase = r_random_phase(1, num_ranks=16, num_tasks=400, num_blocks=48,
                           num_comms=800, mem_cap=1e12)
    return phase, (np.arange(phase.num_tasks) % 8).astype(np.int64)


# ------------------------------------------------- zero latency == sync
@pytest.mark.parametrize("ranks", [16, 64])
def test_zero_latency_equals_sync_and_reference(ranks):
    """At zero latency the port's async driver equals the port's sync
    ``ccm_lb`` bit for bit (the scaling instances), and the reference's
    async run, messages and all."""
    phase = r_scaling_phase(ranks)
    a0 = r_initial_assignment(phase)
    kw = dict(n_iter=4, k_rounds=2, fanout=4, seed=0)
    got, want = _both(phase, a0, collect_trace=True, **kw)
    _same_run(got, want)
    ph, a = _port(phase, a0)
    sync = ccm_lb(ph, a, _port_params(**PARAMS), device="cpu", **kw)
    np.testing.assert_array_equal(got.assignment, sync.assignment)
    assert got.transfer_log == sync.transfer_log
    assert got.max_work == sync.max_work
    assert got.imbalance == sync.imbalance
    assert got.lock_conflicts == got.yields == got.grant_chains == 0
    assert got.sim_time == 0.0 and got.messages > 0


@pytest.mark.parametrize("kw", [
    dict(n_iter=3, seed=2, use_engine=False),
    dict(n_iter=3, seed=1, fanout=2, k_rounds=1),
    dict(n_iter=3, seed=5, fanout=6, k_rounds=3),
], ids=["scalar", "fanout2", "fanout6"])
def test_zero_latency_other_configs(kw):
    phase = r_random_phase(3, num_ranks=12, num_tasks=240, num_blocks=30,
                           num_comms=480, mem_cap=1e12)
    a0 = r_initial_assignment(phase)
    got, want = _both(phase, a0, **kw)
    _same_run(got, want)
    ph, a = _port(phase, a0)
    sync = ccm_lb(ph, a, _port_params(**PARAMS), device="cpu", **kw)
    assert got.transfer_log == sync.transfer_log
    assert got.max_work == sync.max_work


def test_async_gossip_equals_sync_epidemic():
    """Stage 1a alone: the event-queue epidemic at zero latency delivers
    the port's synchronous epidemic, payload objects and all."""
    phase = _port(r_random_phase(2, num_ranks=24, num_tasks=96,
                                 num_blocks=12, num_comms=96, mem_cap=1e12))
    params = _port_params(**PARAMS)
    state = CCMState.build(phase, np.arange(96) % 24, params)
    _, summaries = iteration_summaries(state, phase, None)
    ref = build_peer_networks(summaries, k_rounds=2, fanout=4, seed=123)
    sim = _Sim(make_latency(0.0), np.random.default_rng(0), 10 ** 6, None)
    info = {r: {r: summaries[r]} for r in range(phase.num_ranks)}
    assert _run_gossip(sim, summaries, info, k_rounds=2, fanout=4,
                       seed=123, deadline=None) == 0
    assert {r: set(m) for r, m in info.items()} \
        == {r: set(m) for r, m in ref.items()}
    for r in info:
        for p, s in info[r].items():
            assert s is ref[r][p]


# -------------------------------------------------------------- latency
@pytest.mark.parametrize("latency", [0.5, ("uniform", 0.5, 1.5),
                                     ("exp", 0.7)],
                         ids=["const", "uniform", "exp"])
def test_latency_runs_equal_reference(latency):
    """Constant, uniform and exponential latency on ``ccmlb_async``'s
    16-rank scaling instance: event for event the reference's run."""
    phase = r_scaling_phase(16)
    a0 = r_initial_assignment(phase)
    got, want = _both(phase, a0, n_iter=4, k_rounds=2, fanout=4, seed=0,
                      latency=latency, collect_trace=True)
    _same_run(got, want)
    assert got.lock_conflicts > 0 and got.sim_time > 0
    for a, b in zip(got.max_work, got.max_work[1:]):
        assert b <= a + 1e-9


def test_gossip_timeout_equals_reference():
    phase = r_random_phase(4, num_ranks=16, num_tasks=320, num_blocks=36,
                           num_comms=640, mem_cap=1e12)
    a0 = r_initial_assignment(phase)
    kw = dict(n_iter=2, seed=3, latency=("uniform", 0.5, 1.5))
    full, _ = _both(phase, a0, **kw)
    cut, want = _both(phase, a0, gossip_timeout=1.0, collect_trace=True,
                      **kw)
    _same_run(cut, want)
    assert full.gossip_dropped == 0 < cut.gossip_dropped
    assert cut.messages < full.messages


def test_make_latency_specs():
    rng = np.random.default_rng(0)
    assert make_latency(None)(rng, 0, 1) == 0.0
    assert make_latency("zero")(rng, 0, 1) == 0.0
    assert make_latency(2.5)(rng, 0, 1) == 2.5
    assert 1.0 <= make_latency(("uniform", 1.0, 2.0))(rng, 0, 1) <= 2.0
    assert make_latency(("exp", 0.5))(rng, 0, 1) >= 0.0
    assert make_latency(lambda rng, s, d: 0.25)(rng, 3, 4) == 0.25
    for bad in (-1.0, ("uniform", 2.0, 1.0), ("exp", -1.0), "fast", ()):
        with pytest.raises(ValueError):
            make_latency(bad)


def test_run_ccm_lb_refuses_mismatched_knobs():
    phase = _port(r_random_phase(7, num_ranks=8, num_tasks=80,
                                 num_blocks=10, num_comms=160,
                                 mem_cap=1e12))
    a0 = np.arange(80) % 8
    params = _port_params(**PARAMS)
    for kw, msg in ((dict(async_mode=True, batch_lock_events=8),
                     "batch_lock_events"),
                    (dict(async_mode=True, spec_window=4), "spec_window"),
                    (dict(latency=("uniform", 0.5, 1.5)), "latency"),
                    (dict(gossip_timeout=1.0), "gossip_timeout"),
                    (dict(fault=FaultSpec(drop=0.1)), "fault"),
                    (dict(membership=(RankJoin(0),)), "membership")):
        with pytest.raises(ValueError, match=msg):
            run_ccm_lb(phase, a0, params, device="cpu", **kw)
    sync = run_ccm_lb(phase, a0, params, device="cpu", n_iter=2)
    asy = run_ccm_lb(phase, a0, params, device="cpu", n_iter=2,
                     async_mode=True)
    assert sync.transfer_log == asy.transfer_log


def test_async_defaults_to_the_card(monkeypatch):
    """No fallback: without ``device`` the async driver runs on CUDA,
    which raises when no card is present."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    phase = _port(r_scaling_phase(8))
    with pytest.raises(RuntimeError, match="cuda"):
        ccm_lb_async(phase, np.arange(phase.num_tasks) % 8,
                     _port_params(**PARAMS), n_iter=1)


# ------------------------------------------------------ protocol safety
@pytest.mark.parametrize("seed", range(10))
def test_protocol_safety_seeded(seed):
    """``tests/test_async_protocol.py``'s seeded sweep: the port's run
    equals the reference's, and holds at most one live lock a rank after
    every event (the ``on_event`` probe, in-flight releases discounted)
    and replays its log."""
    latencies = (0.0, 0.2, ("uniform", 0.1, 0.6), ("uniform", 0.5, 1.5),
                 ("exp", 0.7))
    phase = r_random_phase(seed, num_ranks=8, num_tasks=160, num_blocks=20,
                           num_comms=320, mem_cap=1e12)
    a0 = r_initial_assignment(phase, "home" if seed % 2 else "round_robin")
    pending = set()
    events = [0]

    def probe(time, kind, src, dst, locks, state):
        assert isinstance(locks, LockManager)
        events[0] += 1
        if kind == GRANT:
            pending.add((dst, src))
        elif kind == RELEASE:
            pending.discard((src, dst))
        for h in range(locks.n_ranks):
            live = [t for t in locks.held_by(h) if (h, t) not in pending]
            assert len(live) <= 1, (h, live, time)

    got, want = _both(phase, a0, n_iter=3, seed=seed,
                      latency=latencies[seed % len(latencies)],
                      collect_trace=True, on_event=probe)
    _same_run(got, want)
    assert events[0] > 0
    np.testing.assert_array_equal(_replay(a0, got.transfer_log),
                                  got.assignment)


def test_contended_branches_and_retry_cap_equal_reference():
    """The contended instance fires conflicts, yields and grant chains of
    length >= 2; with ``max_retries=0`` every yield is a counted drop.
    Both runs equal the reference's."""
    phase, a0 = _contended_instance()
    kw = dict(seed=3, fanout=6, latency=("uniform", 0.5, 1.5))
    got, want = _both(phase, a0, n_iter=4, collect_trace=True, **kw)
    _same_run(got, want)
    assert got.lock_conflicts > 0 and got.yields > 0
    assert got.max_grant_chain >= 2
    capped, want = _both(phase, a0, n_iter=3, max_retries=0, **kw)
    _same_run(capped, want)
    assert capped.retries_exhausted == capped.yields > 0


# ---------------------------------------------------------- fault suite
def _run_faulted(fault, *, n_iter=3, max_retries=4, membership=()):
    """The contended instance under ``fault`` on both packages, with the
    fault-tolerant safety probe on the port's run: at most one live lock
    a rank (grants consumed less releases landed, slack for timeout
    aborts), no transfer to a dead rank; the log replays."""
    phase, a0 = _contended_instance()
    dead = set()
    pending = Counter()
    slack = Counter()
    hooked = [False]

    def on_transfer(tasks, r_from, r_to):
        assert r_to not in dead, (r_from, r_to)

    def probe(time, kind, src, dst, locks, state):
        if not hooked[0]:
            hooked[0] = True
            state.add_transfer_listener(on_transfer)
        if kind == FAIL:
            dead.add(dst)
            for key in [k for k in pending if dst in k]:
                del pending[key]
            slack.pop(dst, None)
            return
        if kind == GRANT:
            pending[(dst, src)] += 1
        elif (kind == RELEASE and locks.locked_by[dst] != src
                and pending[(src, dst)] > 0):
            pending[(src, dst)] -= 1
        elif kind == TIMEOUT:
            slack[dst] += 1
        for h in range(locks.n_ranks):
            live = [t for t in locks.held_by(h) if pending[(h, t)] == 0]
            assert len(live) <= 1 + slack[h], (h, live, time)

    kw = dict(n_iter=n_iter, seed=3, fanout=6, latency=FAULT_LAT,
              max_retries=max_retries, collect_trace=True)
    want = r_ccm_lb_async(phase, a0, RParams(**PARAMS),
                          fault=RFaultSpec(**fault),
                          membership=tuple(RRankJoin(*j)
                                           for j in membership), **kw)
    ph, a = _port(phase, a0)
    got = ccm_lb_async(ph, a, _port_params(**PARAMS), device="cpu",
                       fault=FaultSpec(**fault), on_event=probe,
                       membership=tuple(RankJoin(*j) for j in membership),
                       **kw)
    _same_run(got, want)
    np.testing.assert_array_equal(_replay(a0, got.transfer_log),
                                  got.assignment)
    return got


def test_inactive_fault_spec_is_a_bitwise_noop():
    phase, a0 = _contended_instance()
    kw = dict(n_iter=3, seed=3, fanout=6, latency=FAULT_LAT,
              collect_trace=True)
    plain, want = _both(phase, a0, **kw)
    _same_run(plain, want)
    ph, a = _port(phase, a0)
    res = ccm_lb_async(ph, a, _port_params(**PARAMS), device="cpu",
                       fault=FaultSpec(), **kw)
    assert not FaultSpec().active()
    _same_run(res, plain)
    assert res.fault_stats is None and res.dead_ranks is None


@pytest.mark.parametrize("fault,fired", [
    (dict(drop=0.05, seed=11), "dropped"),
    (dict(dup=0.10, seed=12), "duplicated"),
    (dict(reorder=0.15, reorder_scale=2.0, seed=13), "reordered"),
    (dict(drop=0.03, dup=0.05, reorder=0.05, seed=14), "dropped"),
    (dict(drop=0.15, req_timeout=2.0, seed=21), "dropped"),
    (dict(dup=0.5, seed=22), "dup_requests"),
    (dict(corrupt=0.15, seed=43), "corrupt_quarantined"),
], ids=["drop", "dup", "reorder", "combined", "lossy", "dup-storm",
        "corrupt"])
def test_message_faults_equal_reference(fault, fired):
    """Drop, duplicate, reorder and corrupt: the port's run and its
    ``FaultStats`` equal the reference's, the hardening path of each fault
    class fires, and corruption is always quarantined."""
    res = _run_faulted(fault, max_retries=2 if "req_timeout" in fault
                       else 4)
    fs = res.fault_stats
    assert getattr(fs, fired) > 0
    if fs.dropped:
        assert res.timeouts > 0
    assert fs.corrupted == fs.corrupt_quarantined
    assert res.transfers > 0


def test_retry_cap_zero_under_faults():
    res = _run_faulted(dict(drop=0.1, req_timeout=2.0, seed=23),
                       max_retries=0)
    assert res.timeouts > 0 and res.retries_exhausted > 0


@pytest.mark.parametrize("kill,dead", [
    (((3, 1, 0.5), (7, 1, 3.0)), [3, 7]),
    (((3, 1, 0.5, 1),), [3]),
], ids=["stage2", "stage1"])
def test_kill_and_recovery_equal_reference(kill, dead):
    """Ranks killed in stage 2 and mid-epidemic (stage 1): locks
    reclaimed, nothing stranded on a dead rank, the recovery migrations in
    the transfer log; recovery log and FaultStats equal the reference's."""
    res = _run_faulted(dict(kill=kill, seed=24 if len(kill) > 1 else 44),
                       n_iter=4)
    assert res.dead_ranks == dead
    assert res.fault_stats.killed == len(dead)
    assert not np.isin(res.assignment, dead).any()
    assert res.fault_stats.recovered_tasks > 0
    for tasks, r_from, r_to in res.recovery_log:
        assert r_from in dead and r_to not in dead
        assert (tasks, r_from, r_to) in res.transfer_log


def test_kill_under_message_loss():
    res = _run_faulted(dict(drop=0.05, kill=((5, 1, 1.0),), seed=25),
                       n_iter=4)
    assert res.dead_ranks == [5] and res.timeouts > 0
    assert not np.isin(res.assignment, [5]).any()


@pytest.mark.parametrize("stage", [2, 1])
def test_all_ranks_dead_raises_rank_death(stage):
    phase, a0 = _contended_instance()
    kill = tuple((r, 0, 0.5) if stage == 2 else (r, 0, 0.1, 1)
                 for r in range(phase.num_ranks))
    kw = dict(n_iter=2, seed=3, latency=FAULT_LAT)
    with pytest.raises(RRankDeath):
        r_ccm_lb_async(phase, a0, RParams(**PARAMS),
                       fault=RFaultSpec(kill=kill, seed=26), **kw)
    ph, a = _port(phase, a0)
    with pytest.raises(RankDeath):
        ccm_lb_async(ph, a, _port_params(**PARAMS), device="cpu",
                     fault=FaultSpec(kill=kill, seed=26), **kw)
    assert issubclass(RankDeath, NodeFailure)


def test_pause_and_partition_equal_reference():
    res = _run_faulted(dict(pause=((2, 0, 0.0, 8.0), (9, 1, 0.0, 5.0)),
                            seed=27))
    assert res.fault_stats.paused_deferrals > 0
    res = _run_faulted(dict(partition=((tuple(range(8)),
                                        tuple(range(8, 16)), 0, 0.0,
                                        15.0),), seed=41))
    assert res.fault_stats.partitioned_dropped > 0 and res.transfers > 0


def test_partition_after_gossip_skips_equal_reference():
    """A split opening only after gossip drains: the DECIDE-time check
    skips doomed requests (counted), as in the reference."""
    phase, a0 = _contended_instance()
    kw = dict(n_iter=2, seed=3, fanout=6, latency=FAULT_LAT)
    ref, _ = _both(phase, a0, collect_trace=True, **kw)
    t_open = min(t for t, _, k, _, _ in ref.events if k == "DECIDE") - 1e-3
    got, want = _both(phase, a0, collect_trace=True,
                      fault=dict(partition=((tuple(range(8)),
                                             tuple(range(8, 16)), 0, t_open,
                                             1e9),), seed=42), **kw)
    _same_run(got, want)
    assert got.fault_stats.partition_skips > 0


def test_livelock_error_payload_equals_reference():
    phase, a0 = _contended_instance()
    kw = dict(n_iter=2, seed=3, latency=FAULT_LAT, max_events=50)
    with pytest.raises(RLivelockError) as ei:
        r_ccm_lb_async(phase, a0, RParams(**PARAMS),
                       fault=RFaultSpec(drop=0.05, seed=28), **kw)
    want = ei.value
    ph, a = _port(phase, a0)
    with pytest.raises(LivelockError) as ei:
        ccm_lb_async(ph, a, _port_params(**PARAMS), device="cpu",
                     fault=FaultSpec(drop=0.05, seed=28), **kw)
    e = ei.value
    assert isinstance(e, RuntimeError) and str(e) == str(want)
    assert (e.max_events, e.processed, e.queued, e.sim_time,
            e.iteration) == (want.max_events, want.processed, want.queued,
                             want.sim_time, want.iteration) \
        == (50, 51, e.queued, e.sim_time, 0)
    assert dataclasses.asdict(e.fault_stats) \
        == dataclasses.asdict(want.fault_stats)
    assert {k: v for k, v in dataclasses.asdict(e.stats).items()
            if k not in ("memo", "_chain_run")} \
        == {k: v for k, v in dataclasses.asdict(want.stats).items()
            if k not in ("memo", "_chain_run")}


def test_faultspec_validation_messages():
    for spec, msg in (
            (FaultSpec(kill=((3, 0, 0.5), (3, 1, 0.5))), "a rank dies once"),
            (FaultSpec(pause=((2, 1, 0.0, 5.0), (2, 1, 4.0, 9.0))),
             "merge them into one window"),
            (FaultSpec(kill=((3, 0, 0.5, 7),)), "stage must be 1"),
            (FaultSpec(kill=((3, 0),)), r"expected \(rank, iteration"),
            (FaultSpec(partition=(((0, 1, 2), (2, 3), 0, 0.0, 5.0),)),
             "both sides of a split"),
            (FaultSpec(partition=(((0, 1), (2, 99), 0, 0.0, 5.0),)),
             r"out of range \[0, 16\)"),
            (FaultSpec(partition=(((), (2, 3), 0, 0.0, 5.0),)),
             "must be non-empty"),
            (FaultSpec(partition=(((0, 1), (2, 3), 0, 5.0, 1.0),)),
             "0 <= start <= end"),
            (FaultSpec(corrupt=1.5), "not in"),
            (FaultSpec(backoff=0.5), "backoff"),
            (FaultSpec(req_timeout=0.0), "req_timeout")):
        with pytest.raises(ValueError, match=msg):
            spec.validate(16, 4)
    FaultSpec(pause=((2, 1, 0.0, 4.0), (2, 1, 4.0, 9.0))).validate(16, 4)
    assert FaultSpec(partition=(((0,), (1,), 0, 0.0, 1.0),)).active()
    assert FaultSpec(corrupt=0.01).active()
    assert EVENT_KINDS[FAIL] == "FAIL"


# ----------------------------------------------------------- membership
def test_join_and_crash_then_join_equal_reference():
    """Two ranks join at iteration 1 and attract work; a crash at
    iteration 1 then a join at iteration 2: the dead rank stays empty,
    the joiner takes work, the logs replay end to end."""
    res = _run_faulted({}, membership=((1, 2),))
    assert res.joined_ranks == [16, 17] and res.state.phase.num_ranks == 18
    assert np.isin(res.assignment, res.joined_ranks).sum() > 0
    res = _run_faulted(dict(kill=((3, 1, 0.5),), seed=46), n_iter=4,
                       membership=((2, 1),))
    assert res.dead_ranks == [3] and res.joined_ranks == [16]
    assert not (res.assignment == 3).any()
    assert res.fault_stats.recovered_tasks > 0


def test_membership_validation():
    phase, a0 = _contended_instance()
    ph, a = _port(phase, a0)
    with pytest.raises(ValueError, match="iteration out of range"):
        ccm_lb_async(ph, a, _port_params(**PARAMS), n_iter=2, device="cpu",
                     membership=(RankJoin(iteration=5),))
    with pytest.raises(ValueError, match="iteration"):
        RankJoin(iteration=-1)
    with pytest.raises(ValueError, match="count"):
        RankJoin(iteration=0, count=0)


# ------------------------------------------------------ memory pressure
def _mem_phase(task_load, task_mem, mem_cap, n_ranks, task_block=None,
               block_size=(), block_home=()):
    """``tests/test_memory_pressure.py``'s comm-free phases."""
    k = len(task_load)
    return RPhase(
        task_load=np.asarray(task_load, np.float64),
        task_mem=np.asarray(task_mem, np.float64),
        task_overhead=np.zeros(k),
        task_block=(np.full(k, -1, np.int64) if task_block is None
                    else np.asarray(task_block, np.int64)),
        block_size=np.asarray(block_size, np.float64),
        block_home=np.asarray(block_home, np.int64),
        comm_src=np.zeros(0, np.int64), comm_dst=np.zeros(0, np.int64),
        comm_vol=np.zeros(0), rank_mem_base=np.zeros(n_ranks),
        rank_mem_cap=(np.asarray(mem_cap, np.float64) if np.ndim(mem_cap)
                      else np.full(n_ranks, float(mem_cap))))


def _hot_block_phase():
    """``tests/test_memory_pressure.py``'s replication instance: only a
    block split (a replication move) lowers the maximum work."""
    ph = _mem_phase([1.5] * 4 + [6.0] * 6 + [0.5], [1.0] * 11, 1e6, 2,
                    task_block=[0] * 4 + [-1] * 7, block_size=[10.0],
                    block_home=[0])
    return ph, np.array([0] * 4 + [0] * 3 + [1] * 3 + [0], np.int64)


LOAD_ONLY = dict(alpha=1.0, beta=0.0, gamma=0.0, delta=0.0)


def test_async_replicate_equals_sync_and_reference():
    phase, a0 = _hot_block_phase()
    got, want = _both(phase, a0, LOAD_ONLY, n_iter=4, seed=0,
                      replicate=True)
    _same_run(got, want)
    ph, a = _port(phase, a0)
    sync = ccm_lb(ph, a, _port_params(**LOAD_ONLY), n_iter=4, seed=0,
                  replicate=True, device="cpu")
    assert got.transfer_log == sync.transfer_log
    assert got.max_work == sync.max_work


def test_recovery_spills_and_oom_equal_reference():
    """A dead rank's tasks spill to the survivor with room (counted), and
    where no survivor has room recovery raises the structured OOM error,
    with the reference's payload."""
    ph = _mem_phase([0.1, 1.0, 1.0, 1.0, 1.0], [0.05, 1.0, 1.0, 1.0, 1.0],
                    [0.1, 100.0, 100.0], 3)
    got, want = _both(ph, np.array([0, 2, 2, 2, 2]), LOAD_ONLY, n_iter=3,
                      seed=0, fault=dict(kill=((2, 0, 0.5),), seed=7))
    _same_run(got, want)
    assert got.dead_ranks == [2] and got.fault_stats.recovery_spills >= 1
    final = CCMState.build(got.state.phase, got.assignment,
                           _port_params(**LOAD_ONLY))
    assert final.memory_feasible(0) and final.memory_feasible(1)
    ph = _mem_phase([0.1, 1.0, 1.0], [0.05, 5.0, 5.0], [1.0, 100.0], 2)
    a0 = np.array([0, 1, 1])
    with pytest.raises(RRecoveryOOMError) as ei:
        r_ccm_lb_async(ph, a0, RParams(**LOAD_ONLY), n_iter=3, seed=0,
                       fault=RFaultSpec(kill=((1, 0, 0.5),), seed=7))
    want = ei.value
    p, a = _port(ph, a0)
    with pytest.raises(RecoveryOOMError) as ei:
        ccm_lb_async(p, a, _port_params(**LOAD_ONLY), n_iter=3, seed=0,
                     device="cpu", fault=FaultSpec(kill=((1, 0, 0.5),),
                                                   seed=7))
    assert (ei.value.tasks, ei.value.dead_rank, ei.value.overflow_bytes) \
        == (want.tasks, want.dead_rank, want.overflow_bytes)
    assert ei.value.overflow_bytes > 0


def test_recovery_without_pressure_equals_reference():
    phase = r_random_phase(5, num_ranks=6, num_tasks=48, num_blocks=6,
                           num_comms=90, mem_cap=1e12)
    a0 = r_initial_assignment(phase, "home")
    kw = dict(n_iter=3, seed=0, fault=dict(kill=((4, 1, 0.5),), seed=3))
    got, want = _both(phase, a0, **kw)
    _same_run(got, want)
    off, want = _both(phase, a0, dict(delta=1e-9, memory_constraint=False),
                      **kw)
    _same_run(off, want)
    assert got.fault_stats.recovery_spills == 0
    assert got.recovery_log == off.recovery_log


def test_join_relieves_memory_pressure():
    ph = _mem_phase([0.0] * 4, [0.4] * 4, 1.0, 2)
    params = dict(LOAD_ONLY, mem_headroom=0.3)
    got, want = _both(ph, np.array([0, 0, 1, 1]), params, n_iter=4, seed=0,
                      membership=((1, 1, None, 10.0),))
    _same_run(got, want)
    assert got.joined_ranks == [2] and (got.assignment == 2).any()
    final = CCMState.build(got.state.phase, got.assignment,
                           _port_params(**params))
    assert all(final.memory_feasible(r) for r in range(3))


# ---------------------------------------------------------------- locks
def test_lock_tokens_equal_reference():
    """The grant-token surface on one sequence of calls: every return
    value and the lock table after each call equal the reference's."""
    calls = [("request", 1, 0, 10), ("request", 2, 0, 11),
             ("request", 3, 0, None), ("request", 0, 2, 12),
             ("holds_grant", 1, 0, 10), ("holds_grant", 1, 0, 99),
             ("dequeue", 2, 0, 99), ("dequeue", 2, 0, 11),
             ("request", 2, 0, 13), ("held_by", 1), ("quiescent",),
             ("must_yield", 2, 0), ("release", 1, 0),
             ("holds_grant", 3, 0, None), ("purge_requester", 2),
             ("request", 2, 3, 14), ("request", 1, 3, 15),
             ("reclaim", 3), ("release", 3, 0), ("release", 0, 2),
             ("quiescent",)]
    got, want = LockManager(4), RLockManager(4)
    for call in calls:
        out = getattr(got, call[0])(*call[1:])
        assert out == getattr(want, call[0])(*call[1:]), call
        assert got.locked_by == want.locked_by, call
        assert got.grant_id == want.grant_id, call
        assert {t: list(q) for t, q in got.queue.items()} \
            == {t: list(q) for t, q in want.queue.items()}, call
    assert got.quiescent()
    with pytest.raises(RuntimeError, match="held by"):
        got.release(1, 0)


# -------------------------------------------------------------- runtime
def test_elastic_frames_equal_reference():
    rs, want = survivor_resize(8, [2, 5]), r_elastic.survivor_resize(8,
                                                                     [2, 5])
    np.testing.assert_array_equal(rs.survivors, want.survivors)
    np.testing.assert_array_equal(rs.old_to_new, want.old_to_new)
    assert rs.n_new == want.n_new == 6
    for bad in ([9], range(8)):
        with pytest.raises(ValueError):
            survivor_resize(8, bad)
    phase = r_random_phase(3, num_ranks=6, num_tasks=60, num_blocks=6,
                           num_comms=90, mem_cap=1e9)
    for kw in (dict(), dict(count=3, mem_cap=2e9, speed=0.5)):
        got = expand_phase(_port(phase), **kw)
        want = r_elastic.expand_phase(phase, **kw)
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(getattr(got, f.name),
                                          getattr(want, f.name), f.name)
    with pytest.raises(ValueError):
        expand_phase(_port(phase), 0)


def test_straggler_tracker_and_restarts_equal_reference():
    rng = np.random.default_rng(0)
    got, want = StragglerTracker(6), RStragglerTracker(6)
    np.testing.assert_array_equal(got.speed_factors(), want.speed_factors())
    for _ in range(4):
        t = rng.lognormal(0.0, 0.5, 6)
        got.update(t)
        want.update(t)
        np.testing.assert_array_equal(got.speed_factors(),
                                      want.speed_factors())
        np.testing.assert_array_equal(got.stragglers(), want.stragglers())
    inj = FaultInjector(fail_at_steps=(1, 3))
    steps = iter(range(10))

    def train_once():
        for _ in range(2):
            inj.maybe_fail(next(steps))

    st = run_with_restarts(train_once, max_restarts=3)
    assert (st.restarts, st.completed) == (2, True)

    def always_fail():
        raise RankDeath("gone")

    st = run_with_restarts(always_fail, max_restarts=2)
    assert (st.restarts, st.completed) == (3, False)


@pytest.mark.cuda
def test_cuda_async_equals_cpu():
    """On the card: a uniform-latency async run and a crash-then-join run
    score through the pair kernel and equal the CPU's event for event."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.ccm_scorer import kernel
    phase, a0 = _contended_instance()
    ph, a = _port(phase, a0)
    params = _port_params(**PARAMS)
    for kw in (dict(latency=("uniform", 0.5, 1.5)),
               dict(latency=FAULT_LAT, fault=FaultSpec(kill=((3, 1, 0.5),),
                                                       seed=46),
                    membership=(RankJoin(2, 1),))):
        cpu = ccm_lb_async(ph, a, params, n_iter=4, seed=3, fanout=6,
                           device="cpu", collect_trace=True, **kw)
        kernel.reset_launches()
        gpu = ccm_lb_async(ph, a, params, n_iter=4, seed=3, fanout=6,
                           device="cuda", collect_trace=True, **kw)
        assert kernel.PAIR_LAUNCHES["float64"] > 0
        _same_run(gpu, cpu)
