"""Port parity, the evaluation engine: ``repro_torch.core.engine.PhaseEngine``
(``device="cpu"``) against the JAX package's NumPy engine
(``repro.core.engine.PhaseEngine(backend="numpy")``) on the same states.

Tolerance: none for float64 — the flow matrices, the packed tiles and the
host combine are the same numpy operations and the scorer is bitwise, so
scores and feasibility must be bitwise-equal
(``np.testing.assert_array_equal``).  Float32 scoring is held against the
JAX package's float32 tier (``backend="pallas_compiled"``, interpret mode)
bitwise on solo events, where both combine against the float64 scalars."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import CCMParams as RParams
from repro.core import CCMState as RState
from repro.core.clusters import build_clusters as r_build_clusters
from repro.core.engine import ExchangeEvent as RExchangeEvent
from repro.core.engine import PhaseEngine as RPhaseEngine
from repro.core.problem import Phase as RPhase
from repro.core.problem import initial_assignment as r_initial_assignment
from repro.core.problem import random_phase as r_random_phase
from repro_torch.convert import from_reference
from repro_torch.core import CCMState, ExchangeEvent, PhaseEngine
from repro_torch.kernels.ccm_scorer import launch


def _states(seed, ranks, tasks, mem_cap, mem_constraint, phase=None):
    ph = phase if phase is not None else r_random_phase(
        seed, num_ranks=ranks, num_tasks=tasks,
        num_blocks=max(2, tasks // 8), num_comms=2 * tasks, mem_cap=mem_cap)
    params = RParams(alpha=1.0, beta=1e-9, gamma=1e-11, delta=1e-9,
                     memory_constraint=mem_constraint)
    a0 = (r_initial_assignment(ph, "home" if seed % 2 else "round_robin")
          if phase is None else np.zeros(ph.num_tasks, np.int64))
    tph, tparams, ta = from_reference(dataclasses.asdict(ph),
                                      dataclasses.asdict(params), a0)
    return RState.build(ph, a0, params), CCMState.build(tph, ta, tparams)


def _random_events(seed, r_state, n_cand=5):
    """A random batch of rank-disjoint events, all candidate pairs each."""
    rng = np.random.default_rng(seed)
    clusters = r_build_clusters(r_state)
    n = r_state.phase.num_ranks
    perm = rng.permutation(n)
    empty = np.zeros(0, np.int64)
    events = []
    for k in range(int(rng.integers(1, n // 2 + 1))):
        r_a, r_b = int(perm[2 * k]), int(perm[2 * k + 1])
        cand_a = [empty] + clusters[r_a][:n_cand]
        cand_b = [empty] + clusters[r_b][:n_cand]
        pairs = [(ia, ib) for ia in range(len(cand_a))
                 for ib in range(len(cand_b)) if ia or ib]
        events.append((r_a, r_b, cand_a, cand_b, pairs))
    return events


def _score_both(r_state, t_state, events, dtype=torch.float64,
                backend="numpy"):
    want = RPhaseEngine(r_state, backend=backend).batch_exchange_eval_multi(
        [RExchangeEvent(*e) for e in events])
    got = PhaseEngine(t_state, device="cpu", dtype=dtype) \
        .batch_exchange_eval_multi([ExchangeEvent(*e) for e in events])
    return got, want


# (seed, ranks, tasks, mem_cap, memory_constraint): tight caps make the
# eq. 9 barrier bind; tiny phases give ranks with one task or no clusters
CASES = [(0, 8, 120, 4e8, True), (1, 8, 120, 1e12, True),
         (2, 6, 20, 3e8, True), (3, 9, 90, 3e8, False),
         (4, 4, 8, 1e12, True), (5, 7, 60, 2e8, True)]


@pytest.mark.parametrize("seed,ranks,tasks,cap,mc", CASES)
def test_batch_exchange_eval_multi_bitwise_vs_numpy_engine(seed, ranks,
                                                           tasks, cap, mc):
    r_state, t_state = _states(seed, ranks, tasks, cap, mc)
    events = _random_events(seed, r_state)
    got, want = _score_both(r_state, t_state, events)
    assert len(got) == len(want) == len(events)
    for (wa, wb, fe), (wa2, wb2, fe2) in zip(got, want):
        np.testing.assert_array_equal(wa, wa2)
        np.testing.assert_array_equal(wb, wb2)
        np.testing.assert_array_equal(fe, fe2)
    # the same events one at a time: padding to the batch never changes a
    # score (solo tiles are unpadded)
    eng = PhaseEngine(t_state, device="cpu")
    for e, res in zip(events, got):
        solo = eng.batch_exchange_eval(*e)
        for x, y in zip(solo, res):
            np.testing.assert_array_equal(x, y)


def test_empty_candidates_and_single_task_phase():
    r_state, t_state = _states(3, 4, 40, 1e12, True)
    empty = np.zeros(0, np.int64)
    launch.reset_stats()
    [(wa, wb, fe)] = PhaseEngine(t_state, device="cpu") \
        .batch_exchange_eval_multi([ExchangeEvent(0, 1, [empty], [empty],
                                                  [])])
    assert wa.shape == wb.shape == fe.shape == (0,)
    assert launch.STATS["calls"] == 0           # nothing to score
    one = RPhase(
        task_load=np.array([2.0]), task_mem=np.array([8.0]),
        task_overhead=np.array([1.0]), task_block=np.array([0]),
        block_size=np.array([16.0]), block_home=np.array([0]),
        comm_src=np.array([0]), comm_dst=np.array([0]),
        comm_vol=np.array([3.0]),
        rank_mem_base=np.zeros(2), rank_mem_cap=np.full(2, 1e9))
    r_state, t_state = _states(0, 0, 0, 0, True, phase=one)
    cand_a = [empty, np.array([0])]
    got, want = _score_both(r_state, t_state,
                            [(0, 1, cand_a, [empty], [(1, 0)])])
    assert got[0][2][0]
    for x, y in zip(got[0], want[0]):
        np.testing.assert_array_equal(x, y)
    assert launch.STATS["calls"] == 1
    assert dict(launch.STATS["shapes"]) == {(1, 2, 1): 1}


@pytest.mark.parametrize("seed", [0, 5])
def test_f32_solo_events_bitwise_vs_pallas_compiled_tier(seed):
    r_state, t_state = _states(seed, 8, 120, 4e8, True)
    for e in _random_events(seed, r_state)[:2]:
        got, want = _score_both(r_state, t_state, [e], dtype=torch.float32,
                                backend="pallas_compiled")
        for x, y in zip(got[0], want[0]):
            np.testing.assert_array_equal(x, y)


def test_launch_stats_count_calls_and_shapes():
    r_state, t_state = _states(1, 8, 120, 1e12, True)
    events = _random_events(11, r_state)
    launch.reset_stats()
    PhaseEngine(t_state, device="cpu").batch_exchange_eval_multi(
        [ExchangeEvent(*e) for e in events])
    a_n = max(len(e[2]) for e in events)
    b_n = max(len(e[3]) for e in events)
    assert launch.STATS["calls"] == 1
    assert dict(launch.STATS["shapes"]) == {(len(events), a_n, b_n): 1}
    assert launch.STATS["seconds"] > 0


def test_engine_device_and_dtype_checks():
    _, t_state = _states(0, 4, 30, 1e12, True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PhaseEngine(t_state)                # default device is cuda
        with pytest.raises(RuntimeError):
            PhaseEngine(t_state, device="cuda")
    with pytest.raises(ValueError):
        PhaseEngine(t_state, device="cpu", dtype=torch.float16)
    with pytest.raises(ValueError):
        PhaseEngine(t_state, device="meta")
