"""Port parity, problem and CCM model: ``repro_torch.core.problem`` /
``ccm`` / ``csr`` against the JAX package's ``repro.core`` on the same
inputs.

Tolerance: none.  The phase generators draw the same ``default_rng``
streams and the CCM model is the same host numpy arithmetic, so every
field, work, memory high, soft cap and exchange evaluation must be
bitwise-equal (``np.testing.assert_array_equal``, which also matches inf
and NaN positions)."""
import dataclasses

import numpy as np
import pytest

from repro.core import CCMParams as RParams
from repro.core import CCMState as RState
from repro.core import exchange_eval as r_exchange_eval
from repro.core.ccm import effective_mem_cap as r_effective_mem_cap
from repro.core.csr import PhaseCSR as RPhaseCSR
from repro.core.problem import initial_assignment as r_initial_assignment
from repro.core.problem import random_phase as r_random_phase
from repro.core.problem import scaling_phase as r_scaling_phase
from repro_torch.convert import from_reference
from repro_torch.core import (CCMParams, CCMState, PhaseCSR,
                              effective_mem_cap, exchange_eval,
                              initial_assignment, random_phase,
                              scaling_phase)

PHASE_KW = [
    dict(key=0, num_ranks=6, num_tasks=72, num_blocks=10, num_comms=150,
         mem_cap=5e8),
    dict(key=3, num_ranks=9, num_tasks=90, num_blocks=0, num_comms=40,
         mem_cap=1e12),
    dict(key=7, num_ranks=4, num_tasks=40, num_blocks=6, num_comms=0,
         mem_cap=3e7, load_imbalance=0.5),
]


def _assert_phase_equal(got, want):
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), err_msg=f.name)
        assert getattr(got, f.name).dtype == getattr(want, f.name).dtype


@pytest.mark.parametrize("kw", PHASE_KW)
def test_random_phase_field_equal(kw):
    kw = dict(kw)
    key = kw.pop("key")
    _assert_phase_equal(random_phase(key, **kw), r_random_phase(key, **kw))


@pytest.mark.parametrize("ranks", [4, 16, 64])
def test_scaling_phase_and_initial_assignment_field_equal(ranks):
    got, want = scaling_phase(ranks), r_scaling_phase(ranks)
    _assert_phase_equal(got, want)
    for mode in ("home", "round_robin"):
        np.testing.assert_array_equal(initial_assignment(got, mode),
                                      r_initial_assignment(want, mode))
    with pytest.raises(ValueError):
        initial_assignment(got, "nowhere")


def test_convert_carries_reference_state():
    ph = r_random_phase(5, num_ranks=5, num_tasks=30, num_blocks=4,
                        num_comms=60)
    params = RParams(beta=2e-9, mem_headroom=0.1)
    a0 = r_initial_assignment(ph)
    tph, tparams, ta = from_reference(dataclasses.asdict(ph),
                                      dataclasses.asdict(params), a0)
    _assert_phase_equal(tph, ph)
    assert dataclasses.asdict(tparams) == dataclasses.asdict(params)
    np.testing.assert_array_equal(ta, a0)
    ta[0] += 1                                  # a copy, not a view
    assert ta[0] != a0[0]
    with pytest.raises(ValueError):
        from_reference(dict(dataclasses.asdict(ph), extra=1),
                       dataclasses.asdict(params), a0)


def test_csr_bundle_equal():
    ph = r_random_phase(2, num_ranks=7, num_tasks=80, num_blocks=9,
                        num_comms=170)
    tph, _, _ = from_reference(dataclasses.asdict(ph),
                               dataclasses.asdict(RParams()),
                               r_initial_assignment(ph))
    got, want = PhaseCSR.from_phase(tph), RPhaseCSR.from_phase(ph)
    for name in ("task_edges", "block_tasks"):
        np.testing.assert_array_equal(getattr(got, name).indptr,
                                      getattr(want, name).indptr)
        np.testing.assert_array_equal(getattr(got, name).indices,
                                      getattr(want, name).indices)


def _pair_states(seed, mem_cap, mem_constraint, headroom):
    ph = r_random_phase(seed, num_ranks=6, num_tasks=60, num_blocks=8,
                        num_comms=130, mem_cap=mem_cap)
    params = RParams(memory_constraint=mem_constraint, mem_headroom=headroom)
    a0 = r_initial_assignment(ph, "home" if seed % 2 else "round_robin")
    tph, tparams, ta = from_reference(dataclasses.asdict(ph),
                                      dataclasses.asdict(params), a0)
    return (RState.build(ph, a0, params),
            CCMState.build(tph, ta, tparams))


def _assert_state_equal(r_st, t_st):
    n = r_st.phase.num_ranks
    np.testing.assert_array_equal(t_st.all_work(), r_st.all_work())
    np.testing.assert_array_equal(
        [t_st.max_memory(r) for r in range(n)],
        [r_st.max_memory(r) for r in range(n)])
    for name in ("load", "vol", "block_count", "mem_task",
                 "mem_overhead_max", "hom_cache", "shared_cache"):
        np.testing.assert_array_equal(getattr(t_st, name),
                                      getattr(r_st, name), err_msg=name)
    assert t_st.imbalance() == r_st.imbalance()


# (mem_cap, memory_constraint, mem_headroom): memory pressure binds in the
# first two (random_phase's block bytes put several ranks over 3e7)
PRESSURE = [(3e7, True, 0.0), (6e7, True, 0.2), (1e12, True, 0.0),
            (3e7, False, 0.0)]


@pytest.mark.parametrize("cap,mc,headroom", PRESSURE)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ccm_state_and_exchange_eval_bitwise(seed, cap, mc, headroom):
    r_st, t_st = _pair_states(seed, cap, mc, headroom)
    _assert_state_equal(r_st, t_st)
    rng = np.random.default_rng(100 + seed)
    n = r_st.phase.num_ranks
    for _ in range(12):
        r_a, r_b = rng.choice(n, 2, replace=False)
        ta = np.flatnonzero(r_st.assignment == r_a)
        tb = np.flatnonzero(r_st.assignment == r_b)
        ta = ta[rng.random(ta.size) < 0.4]
        tb = tb[rng.random(tb.size) < 0.3]
        want = r_exchange_eval(r_st, ta, tb, int(r_a), int(r_b))
        got = exchange_eval(t_st, ta, tb, int(r_a), int(r_b))
        assert (got.work_a_after, got.work_b_after, got.feasible) == \
            (want.work_a_after, want.work_b_after, want.feasible)
        # the update formulae must keep both states in lockstep
        r_st.swap(ta, int(r_a), tb, int(r_b))
        t_st.swap(ta, int(r_a), tb, int(r_b))
        _assert_state_equal(r_st, t_st)


@pytest.mark.parametrize("headroom", [0.0, 0.25])
def test_effective_mem_cap_bitwise(headroom):
    caps = np.array([0.0, 1.0, 3e7, 2.4e8, 1e12, np.inf, 7.5e-3])
    got = effective_mem_cap(caps, CCMParams(mem_headroom=headroom))
    want = r_effective_mem_cap(caps, RParams(mem_headroom=headroom))
    np.testing.assert_array_equal(got, want)
    assert effective_mem_cap(2.4e8) == r_effective_mem_cap(2.4e8)
