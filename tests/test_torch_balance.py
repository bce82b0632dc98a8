"""Port parity, the planners: ``repro_torch.balance`` (``device="cpu"``)
against the JAX package's ``repro.balance`` (``backend="numpy"``) on the
same numpy inputs, at the reference benchmark's configurations
(``benchmarks/expert_placement.py``: zipf(1.4) router counts over (4, E)
on 16 devices, one device at half speed; ``tests/test_balance.py``: stage
plans of three archs on 4 stages, 256 lognormal(0, 1.2) sequence costs on
8 ranks).

Tolerance: none.  Phases are equal field for field; every plan's
assignment, permutations, ``ServingPlan`` arrays, imbalances and max work
(stage plans: assignment, stage FLOPs, imbalance, cut bytes, contiguity;
seqpack: assignment, makespans, imbalances) equal the reference's bit for
bit.  The reference divides FLOPs by another chip's peak and budgets HBM
for it; the port defaults to the H100's, so each test gives both the
reference's figures, read off the reference (its phase's loads, its
signature's default): the peak as ``phase_from_router_stats``'s keyword or
as the planner modules' ``PEAK_FLOPS``, the budget as a keyword.
``apply_expert_permutation`` preserves the MoE layer's function within
the reference test's ``atol=2e-2``."""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.balance import plan_expert_placement as r_plan
from repro.balance import plan_expert_placement_sequence as r_plan_seq
from repro.balance import plan_pipeline_stages as r_stages
from repro.balance import plan_pipeline_stages_schedule as r_stages_sched
from repro.balance import rebalance_sequences as r_seqpack
from repro.balance import rebalance_sequences_stream as r_seqpack_stream
from repro.balance.expert_placement import \
    apply_expert_permutation as r_apply_perm
from repro.balance.expert_placement import \
    phase_from_router_stats as r_phase_from_stats
from repro.balance.pipeline_stages import _stage_phase as r_stage_phase
from repro.balance.pipeline_stages import layer_flops as r_layer_flops
from repro_torch import configs
from repro_torch.balance import (apply_expert_permutation,
                                 phase_from_router_stats,
                                 plan_expert_placement,
                                 plan_expert_placement_sequence,
                                 plan_pipeline_stages,
                                 plan_pipeline_stages_schedule,
                                 rebalance_sequences,
                                 rebalance_sequences_stream)
from repro_torch.balance.expert_placement import all_to_all_bytes
from repro_torch.balance import expert_placement as placement_mod
from repro_torch.balance import pipeline_stages as stages_mod
from repro_torch.balance.pipeline_stages import PEAK_FLOPS, layer_flops
from repro_torch.core.problem import Phase
from repro_torch.kernels.ccm_scorer import launch
from repro_torch.models import moe

QWEN = "qwen3-moe-30b-a3b"
SCOUT = "llama4-scout-17b-a16e"
STAGE_ARCHS = ("recurrentgemma-9b", "gemma2-27b", QWEN)
# the reference stage planners' default HBM budget, used on both sides
REF_HBM = inspect.signature(r_stages).parameters["hbm_budget_bytes"].default


def _zipf_counts(rng, e_n, l_n=4, tokens=32768):
    counts = rng.zipf(1.4, (l_n, e_n)).astype(np.float64)
    return counts / counts.sum(1, keepdims=True) * tokens


def _drifting(rng, base, n, sigma=0.15):
    """``n`` router-count windows whose per-expert counts random-walk by a
    lognormal factor a window, each renormalised to the first's total."""
    out = [base]
    for _ in range(n - 1):
        nxt = out[-1] * rng.lognormal(0.0, sigma, base.shape)
        out.append(nxt / nxt.sum(1, keepdims=True) * base.sum(1)[:, None])
    return out


def _mode(values):
    vals, n = np.unique(values, return_counts=True)
    return float(vals[np.argmax(n)])


def _ref_expert_peak(cfg_r, counts):
    """The reference's peak FLOP/s, read off its own phase's loads."""
    ph = r_phase_from_stats(counts, cfg_r, 16, hbm_budget_bytes=REF_HBM)
    flops = counts.reshape(-1) * 6.0 * cfg_r.d_model * cfg_r.moe_d_ff
    return _mode(flops[ph.task_load > 0] / ph.task_load[ph.task_load > 0])


def _ref_stage_peak(cfg_r, tokens=4096):
    ph = r_stage_phase(cfg_r, 4, tokens, REF_HBM)
    flops = np.array([r_layer_flops(cfg_r, k, tokens)
                      for k in cfg_r.layer_kinds()])
    return _mode(flops / ph.task_load)


def _same_fields(got, want):
    for f in dataclasses.fields(Phase):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if w is None:
            assert g is None, f.name
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, f.name
        assert np.array_equal(g, w), f.name


def _same_plan(got, want):
    np.testing.assert_array_equal(got.assignment, want.assignment)
    np.testing.assert_array_equal(got.permutations, want.permutations)
    for name in ("imbalance_before", "imbalance_after", "max_work_before",
                 "max_work_after", "replicated_blocks"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.lb_result.transfer_log == want.lb_result.transfer_log
    gs, ws = got.serving, want.serving
    for name in ("replicas", "routing_shares", "hbm_bytes"):
        g, w = getattr(gs, name), getattr(ws, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert gs.hbm_budget_bytes == ws.hbm_budget_bytes
    assert gs.replicated_experts == ws.replicated_experts
    assert gs.within_budget() == ws.within_budget()


def _same_stage_plan(got, want):
    np.testing.assert_array_equal(got.assignment, want.assignment)
    np.testing.assert_array_equal(got.stage_flops, want.stage_flops)
    assert got.imbalance == want.imbalance
    assert got.cut_bytes == want.cut_bytes
    assert got.contiguous == want.contiguous


def _same_pack(got, want):
    np.testing.assert_array_equal(got.assignment, want.assignment)
    for f in ("makespan_before", "makespan_after", "imbalance_before",
              "imbalance_after"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("shards", [1, 2])
def test_phase_from_router_stats_equals_the_reference(shards):
    cfg_r, cfg = r_configs.get_config(QWEN), configs.get_config(QWEN)
    counts = _zipf_counts(np.random.default_rng(0), cfg.num_experts)
    counts[1, 3] = 0.0                       # an expert no token reached
    peak = _ref_expert_peak(cfg_r, counts)
    speed = np.linspace(0.5, 1.5, 16)
    want = r_phase_from_stats(counts, cfg_r, 16, hbm_budget_bytes=REF_HBM,
                              rank_speed=speed, shards_per_expert=shards)
    got = phase_from_router_stats(counts, cfg, 16, hbm_budget_bytes=REF_HBM,
                                  rank_speed=speed, shards_per_expert=shards,
                                  peak_flops=peak)
    _same_fields(got, want)
    # at the H100's peak only the loads change, by the ratio of the peaks
    h100 = phase_from_router_stats(counts, cfg, 16, hbm_budget_bytes=REF_HBM,
                                   rank_speed=speed, shards_per_expert=shards)
    np.testing.assert_allclose(h100.task_load * PEAK_FLOPS / peak,
                               want.task_load, rtol=1e-12)
    assert np.array_equal(h100.comm_vol, want.comm_vol)


def _expert_cases():
    """(label, arch, counts, kwargs) as the reference benchmark draws them
    (one generator, in its order), plus the replicated qwen run."""
    rng = np.random.default_rng(0)
    qwen = _zipf_counts(rng, 128)
    scout = _zipf_counts(rng, 16)
    straggler = _zipf_counts(rng, 128)
    speed = np.ones(16)
    speed[0] = 0.5
    return [("qwen", QWEN, qwen, {}), ("scout", SCOUT, scout, {}),
            ("straggler", QWEN, straggler, dict(rank_speed=speed)),
            ("qwen-replicated", QWEN, qwen,
             dict(shards_per_expert=2, replicate=True))]


EXPERT_CASES = _expert_cases()


@pytest.mark.parametrize("case", range(len(EXPERT_CASES)),
                         ids=[c[0] for c in EXPERT_CASES])
def test_expert_placement_equals_the_reference(case, monkeypatch):
    label, arch, counts, kw = EXPERT_CASES[case]
    cfg_r, cfg = r_configs.get_config(arch), configs.get_config(arch)
    monkeypatch.setattr(placement_mod, "PEAK_FLOPS",
                        _ref_expert_peak(cfg_r, counts))
    want = r_plan(counts, cfg_r, 16, hbm_budget_bytes=REF_HBM, seed=0, **kw)
    got = plan_expert_placement(counts, cfg, 16, hbm_budget_bytes=REF_HBM,
                                seed=0, device="cpu", **kw)
    _same_plan(got, want)
    assert got.imbalance_after <= got.imbalance_before
    for perm in got.permutations:
        assert sorted(perm.tolist()) == list(range(cfg.num_experts))
    if kw.get("replicate"):
        assert got.replicated_blocks > 0 and got.serving.within_budget()
    assert all_to_all_bytes(counts, got.assignment, 16, cfg.d_model) \
        == float((counts.reshape(-1) * (1.0 - 1.0 / 16)).sum()
                 * cfg.d_model * 2.0)


def test_expert_placement_sequence_equals_the_reference(monkeypatch):
    """4 drifting windows of qwen router counts, warm-started and cold,
    against the reference; the port's ``spec_window=8`` run (the window
    kernel's plain version here) against its synchronous one."""
    cfg_r, cfg = r_configs.get_config(QWEN), configs.get_config(QWEN)
    rng = np.random.default_rng(3)
    seq = _drifting(rng, _zipf_counts(rng, 128, l_n=2), 4)
    monkeypatch.setattr(placement_mod, "PEAK_FLOPS",
                        _ref_expert_peak(cfg_r, seq[0]))
    sync = None
    for warm in (True, False):
        want = r_plan_seq(seq, cfg_r, 16, hbm_budget_bytes=REF_HBM,
                          warm_start=warm)
        got = plan_expert_placement_sequence(
            seq, cfg, 16, hbm_budget_bytes=REF_HBM, warm_start=warm,
            device="cpu")
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            _same_plan(g, w)
        sync = got if warm else sync
    spec = plan_expert_placement_sequence(
        seq, cfg, 16, hbm_budget_bytes=REF_HBM, device="cpu",
        spec_window=8)
    for g, w in zip(spec, sync):
        _same_plan(g, w)


@pytest.mark.parametrize("arch", STAGE_ARCHS)
def test_stage_phase_equals_the_reference(arch):
    cfg_r, cfg = r_configs.get_config(arch), configs.get_config(arch)
    want = r_stage_phase(cfg_r, 4, 4096, REF_HBM)
    got = stages_mod._stage_phase(cfg, 4, 4096, REF_HBM,
                                  peak_flops=_ref_stage_peak(cfg_r))
    _same_fields(got, want)


@pytest.mark.parametrize("arch", STAGE_ARCHS)
def test_stage_plan_equals_the_reference(arch, monkeypatch):
    cfg_r, cfg = r_configs.get_config(arch), configs.get_config(arch)
    want = r_stages(cfg_r, 4)
    monkeypatch.setattr(stages_mod, "PEAK_FLOPS", _ref_stage_peak(cfg_r))
    got = plan_pipeline_stages(cfg, 4, hbm_budget_bytes=REF_HBM,
                               device="cpu")
    _same_stage_plan(got, want)
    assert got.contiguous, got.assignment
    assert got.imbalance < 0.25
    assert sorted(set(got.assignment.tolist())) == [0, 1, 2, 3]
    for kind in set(cfg.layer_kinds()):
        assert layer_flops(cfg, kind, 4096) == r_layer_flops(cfg_r, kind,
                                                             4096)


@pytest.mark.parametrize("arch", STAGE_ARCHS)
def test_stage_plan_does_not_depend_on_the_peak(arch, monkeypatch):
    """With ``alpha=1`` and beta derived from the loads every work term
    scales with 1 / peak, so the plan is the same at the reference's peak
    and the H100's (the stage FLOPs scale, nothing else moves)."""
    cfg_r, cfg = r_configs.get_config(arch), configs.get_config(arch)
    peak = _ref_stage_peak(cfg_r)
    at_h100 = plan_pipeline_stages(cfg, 4, hbm_budget_bytes=REF_HBM,
                                   device="cpu")
    monkeypatch.setattr(stages_mod, "PEAK_FLOPS", peak)
    at_ref = plan_pipeline_stages(cfg, 4, hbm_budget_bytes=REF_HBM,
                                  device="cpu")
    np.testing.assert_array_equal(at_h100.assignment, at_ref.assignment)
    assert at_h100.cut_bytes == at_ref.cut_bytes
    assert at_h100.contiguous == at_ref.contiguous
    np.testing.assert_allclose(at_h100.stage_flops * PEAK_FLOPS / peak,
                               at_ref.stage_flops, rtol=1e-12)
    assert at_h100.imbalance == pytest.approx(at_ref.imbalance, rel=1e-12)


@pytest.mark.parametrize("arch", STAGE_ARCHS)
def test_stage_plan_is_the_initial_split(arch):
    """Pins a fault of the reference, copied by the port: on these archs
    the stage planner's CCM-LB run never locks a peer (stage 1 scores no
    move positive, since a layer moved off a stage pays the activation
    transfer), so it makes no scorer call and no transfer, and the plan is
    the initial equal-count split it started from."""
    cfg_r, cfg = r_configs.get_config(arch), configs.get_config(arch)
    l_n = len(cfg.layer_kinds())
    split = np.minimum((np.arange(l_n) * 4) // l_n, 3)
    launch.reset_stats()
    got = plan_pipeline_stages(cfg, 4, device="cpu")
    assert launch.STATS["calls"] == 0
    np.testing.assert_array_equal(got.assignment, split)
    np.testing.assert_array_equal(r_stages(cfg_r, 4).assignment, split)


def test_stage_plan_schedule_equals_the_reference(monkeypatch):
    cfg_r, cfg = r_configs.get_config(QWEN), configs.get_config(QWEN)
    schedule = [2048, 4096, 8192, 4096]
    want = r_stages_sched(cfg_r, 4, schedule)
    monkeypatch.setattr(stages_mod, "PEAK_FLOPS", _ref_stage_peak(cfg_r))
    got = plan_pipeline_stages_schedule(cfg, 4, schedule,
                                        hbm_budget_bytes=REF_HBM,
                                        device="cpu")
    assert len(got) == len(want) == len(schedule)
    for g, w in zip(got, want):
        _same_stage_plan(g, w)
        assert g.contiguous


@pytest.mark.parametrize("straggler", [False, True])
def test_seqpack_equals_the_reference(straggler):
    costs = np.random.default_rng(0).lognormal(0, 1.2, 256)
    speed = None
    if straggler:
        speed = np.ones(8)
        speed[0] = 0.5
    want = r_seqpack(costs, 8, rank_speed=speed, seed=0)
    got = rebalance_sequences(costs, 8, rank_speed=speed, seed=0,
                              device="cpu")
    _same_pack(got, want)
    assert got.makespan_after <= got.makespan_before
    if straggler:
        loads = np.bincount(got.assignment, weights=costs, minlength=8)
        assert loads[0] < loads[1:].mean() * 0.75
    else:
        assert got.imbalance_after < 0.1


def test_seqpack_stream_equals_the_reference():
    rng = np.random.default_rng(1)
    batches = [rng.lognormal(0, 1.2, 128) for _ in range(3)]
    for warm in (True, False):
        want = r_seqpack_stream(batches, 8, warm_start=warm)
        got = rebalance_sequences_stream(batches, 8, warm_start=warm,
                                         device="cpu")
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _same_pack(g, w)


def test_expert_permutation_is_function_preserving():
    """The port's smoke-config MoE layer: permuting the expert weights and
    the router's columns keeps the output (``atol=2e-2``) and permutes the
    expert counts exactly."""
    cfg = configs.get_smoke_config(QWEN)
    gen = torch.Generator().manual_seed(0)
    params = moe.init_moe(gen, cfg, device="cpu")
    x = torch.randn((2, 16, cfg.d_model), generator=gen).to(torch.bfloat16)
    y0, stats0 = moe.moe_forward(params, x, cfg, cfg.act)
    perm = np.random.default_rng(0).permutation(cfg.num_experts)
    p2 = apply_expert_permutation(params, perm)
    assert p2["router"].dtype == params["router"].dtype
    y1, stats1 = moe.moe_forward(p2, x, cfg, cfg.act)
    np.testing.assert_allclose(y0.float().numpy(), y1.float().numpy(),
                               atol=2e-2)
    assert torch.equal(stats0["expert_counts"][torch.as_tensor(perm)],
                       stats1["expert_counts"])
    # a tensor perm gives the same params
    p3 = apply_expert_permutation(params, torch.as_tensor(perm))
    assert all(torch.equal(p2[k], p3[k]) for k in p2 if k != "shared")


def test_expert_permutation_equals_the_reference_bitwise():
    rng = np.random.default_rng(4)
    e, d, f = 8, 16, 12
    arrays = {"w_gate": rng.normal(size=(e, d, f)).astype(np.float32),
              "w_up": rng.normal(size=(e, d, f)).astype(np.float32),
              "w_down": rng.normal(size=(e, f, d)).astype(np.float32),
              "router": rng.normal(size=(d, e)).astype(np.float32)}
    perm = rng.permutation(e)
    want = r_apply_perm(arrays, perm)
    got = apply_expert_permutation(
        {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}, perm)
    for k, w in want.items():
        assert np.array_equal(got[k].numpy(), np.asarray(w)), k


def test_planners_raise_without_a_card(monkeypatch):
    """Every planner's default device is the card: with none, each raises
    before it plans."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config(SCOUT)
    counts = _zipf_counts(np.random.default_rng(0), 16, l_n=2)
    calls = [
        lambda: plan_expert_placement(counts, cfg, 16,
                                      hbm_budget_bytes=REF_HBM),
        lambda: plan_expert_placement_sequence([counts, counts], cfg, 16,
                                               hbm_budget_bytes=REF_HBM),
        lambda: plan_pipeline_stages(cfg, 4),
        lambda: plan_pipeline_stages_schedule(cfg, 4, [1024, 2048]),
        lambda: rebalance_sequences(np.ones(16), 4),
        lambda: rebalance_sequences_stream([np.ones(16)], 4),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.cuda
def test_cuda_plans_equal_cpu_plans():
    """On the card: sequence packing (whose params hold a numpy bool, which
    the launcher must pass to the kernel as an int) and an expert placement
    launch the pair kernel and equal their CPU plans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.ccm_scorer import kernel
    costs = np.random.default_rng(0).lognormal(0, 1.2, 256)
    cfg = configs.get_config(SCOUT)
    counts = _zipf_counts(np.random.default_rng(0), 16)
    kernel.reset_launches()
    _same_pack(rebalance_sequences(costs, 8, device="cuda"),
               rebalance_sequences(costs, 8, device="cpu"))
    _same_plan(plan_expert_placement(counts, cfg, 16, hbm_budget_bytes=8e10,
                                     device="cuda"),
               plan_expert_placement(counts, cfg, 16, hbm_budget_bytes=8e10,
                                     device="cpu"))
    assert kernel.PAIR_LAUNCHES["float64"] > 0
