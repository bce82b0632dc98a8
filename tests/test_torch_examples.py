"""Port parity, the examples: each module of ``repro_torch.examples``, run
with ``device="cpu"``, against the JAX package's library functions called
with the arguments of the reference example (``examples/*.py``), never
against the script itself (``serve_batched.py`` and ``train_moe_ccm.py``
raise under jax 0.9: ``make_local_mesh`` builds Explicit axes, ROADMAP
queue 3).

Tolerances:
- quickstart, async, pipeline: none (float64 and host numpy on both
  sides: assignments, transfer logs, traces and counters equal; the MILP's
  status, objective and node count equal);
- assembly, with analytic durations (the measured run is timed, so it is
  not reproducible): makespans, imbalances, off-home copies and homing
  waves equal;
- serve: the reference's init carried across by ``convert.py`` in float32
  (as ``tests/test_torch_serve.py``: in bf16 the two packages round at
  other places and the MoE router can flip a near tie), greedy tokens
  equal;
- train, at a cut config: the reference's ``train_loop`` (float32, on the
  Auto-axis mesh of ``tests/test_torch_serve.py``) and the port's from the
  same handed-over weights, losses within ``rtol=1e-5`` (as
  ``tests/test_torch_train.py``'s five steps); a run failing at step 3 and
  restarted from its step-2 checkpoint within 1e-3 of the uninterrupted
  run.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro import configs as r_configs
from repro.assembly import run_assembly_comparison as r_assembly
from repro.balance import rebalance_sequences_stream as r_stream
from repro.checkpoint import CheckpointManager as RCheckpointManager
from repro.core import CCMParams as RParams
from repro.core import CCMState as RState
from repro.core import FaultSpec as RFaultSpec
from repro.core import RankJoin as RRankJoin
from repro.core import ccm_lb as r_ccm_lb
from repro.core import ccm_lb_async as r_ccm_lb_async
from repro.core import ccm_lb_pipeline as r_pipeline
from repro.core import random_phase as r_random_phase
from repro.core.milp import build_fwmp_reduced as r_build_fwmp_reduced
from repro.core.milp import solve_milp as r_solve_milp
from repro.core.problem import initial_assignment as r_initial_assignment
from repro.launch.serve import serve_batch as r_serve_batch
from repro.launch.train import train_loop as r_train_loop
from repro.models.layers import split_lp_tree
from repro.models.model import build_model as r_build_model
from repro.optim import adamw_init as r_adamw_init
from repro_torch import configs
from repro_torch.assembly import plan_assembly_homing
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import lm_params_from_reference
from repro_torch.examples import (assembly_e2e, async_balancer,
                                  pipeline_phases, quickstart, serve_batched,
                                  train_moe_ccm)
from repro_torch.launch.steps import make_optimizer

ROOT = Path(__file__).resolve().parents[1]
MESH = jax.make_mesh((1, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)


def _reference_example(name):
    """The reference example's module, loaded from ``examples/`` for its
    helpers (``drifting_phases``, ``CONFIG_100M``), never run."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_trace(got, want):
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert got.transfer_log == want.transfer_log
    assert got.transfers == want.transfers
    assert got.max_work == want.max_work
    assert got.imbalance == want.imbalance


# ----------------------------------------------------------------- quickstart
@pytest.fixture(scope="module")
def quick():
    return quickstart.run("cpu")


def test_quickstart_matches_reference(quick):
    """The initial work, CCM-LB on the 16-rank phase (assignment, transfer
    log, max-work trace), the 12-seed best and the MILP, bit for bit."""
    phase = r_random_phase(0, num_ranks=16, num_tasks=400, num_blocks=48,
                           num_comms=800, mem_cap=3e8)
    params = RParams(alpha=1.0, beta=1e-9, gamma=1e-11, delta=1e-9)
    a0 = r_initial_assignment(phase, "home")
    st0 = RState.build(phase, a0, params)
    assert quick.initial_max_work == st0.max_work()
    assert quick.initial_imbalance == st0.imbalance()
    want = r_ccm_lb(phase, a0, params, n_iter=4, k_rounds=2, fanout=4, seed=1)
    _same_trace(quick.result, want)
    assert quick.mean_load == phase.task_load.sum() / phase.num_ranks

    small = r_random_phase(7, num_ranks=4, num_tasks=14, num_blocks=4,
                           num_comms=16, mem_cap=5e8)
    a0s = r_initial_assignment(small)
    best = min(r_ccm_lb(small, a0s, params, n_iter=4, fanout=3,
                        seed=s).max_work[-1] for s in range(12))
    assert quick.best == best
    milp = r_solve_milp(r_build_fwmp_reduced(small, params), max_nodes=2000,
                        time_limit_s=60)
    assert (quick.milp.status, quick.milp.objective, quick.milp.nodes) == (
        milp.status, milp.objective, milp.nodes)
    assert milp.status == "optimal" and quick.best >= milp.objective


# ------------------------------------------------------------ async balancer
ASYNC_TAGS = ("sync", "async latency=0", "async latency=0.5",
              "async latency=('uniform', 0.5, 1.5)", "contended",
              "contended+deadline", "lossy+dup", "rank 3 killed @it1",
              "split-brain healed", "2 ranks join @it1")
ASYNC_FIELDS = ("transfers", "max_work", "imbalance", "iter_transfers",
                "messages", "lock_conflicts", "yields", "grant_chains",
                "max_grant_chain", "timeouts", "retries_exhausted",
                "gossip_dropped", "dead_ranks", "joined_ranks")


@pytest.fixture(scope="module")
def async_runs():
    """(the port example's runs, the reference's runs of the same calls)."""
    got = async_balancer.run("cpu")
    phase = r_random_phase(1, num_ranks=16, num_tasks=400, num_blocks=48,
                           num_comms=800, mem_cap=1e12)
    params = RParams(delta=1e-9)
    a0 = r_initial_assignment(phase)
    lb = dict(n_iter=4, k_rounds=2, fanout=4, seed=0)
    lat = ("uniform", 0.5, 1.5)
    a1 = (np.arange(phase.num_tasks) % 8).astype(np.int64)
    contended = dict(n_iter=4, seed=3, fanout=6, latency=lat)
    want = {
        "sync": r_ccm_lb(phase, a0, params, **lb),
        "async latency=0": r_ccm_lb_async(phase, a0, params, **lb),
        "async latency=0.5": r_ccm_lb_async(phase, a0, params, latency=0.5,
                                            **lb),
        "async latency=('uniform', 0.5, 1.5)": r_ccm_lb_async(
            phase, a0, params, latency=lat, **lb),
        "contended": r_ccm_lb_async(phase, a1, params, **contended),
        "contended+deadline": r_ccm_lb_async(phase, a1, params,
                                             gossip_timeout=1.0, **contended),
        "lossy+dup": r_ccm_lb_async(
            phase, a0, params, latency=lat, fault=RFaultSpec(
                drop=0.03, dup=0.1, req_timeout=3.0, seed=7), **lb),
        "rank 3 killed @it1": r_ccm_lb_async(
            phase, a0, params, latency=lat,
            fault=RFaultSpec(kill=((3, 1, 0.5),), seed=9), **lb),
        "split-brain healed": r_ccm_lb_async(
            phase, a0, params, latency=lat, fault=RFaultSpec(
                partition=((tuple(range(8)), tuple(range(8, 16)), 0, 0.0,
                            15.0),), seed=11),
            n_iter=8, k_rounds=2, fanout=4, seed=0, quiesce_after=2),
        "2 ranks join @it1": r_ccm_lb_async(
            phase, a0, params, latency=lat,
            membership=(RRankJoin(iteration=1, count=2),), **lb),
    }
    return got, want


@pytest.mark.parametrize("tag", ASYNC_TAGS)
def test_async_balancer_matches_reference(async_runs, tag):
    """Every run of the five parts: assignment, transfer log, protocol and
    message counters, ``FaultStats``, dead and joined ranks, stale gossip,
    equal to the reference's (``backend="numpy"``)."""
    got, want = async_runs[0][tag], async_runs[1][tag]
    assert list(async_runs[0]) == list(ASYNC_TAGS)
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert got.transfer_log == want.transfer_log
    for f in ASYNC_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    if want.fault_stats is None:
        assert got.fault_stats is None
    else:
        assert dataclasses.asdict(got.fault_stats) \
            == dataclasses.asdict(want.fault_stats)
    assert got.state.phase.num_ranks == want.state.phase.num_ranks


# ---------------------------------------------------------- pipeline phases
@pytest.fixture(scope="module")
def pipe():
    return pipeline_phases.run("cpu")


def test_drifting_phases_equal_the_reference_examples(pipe):
    ref_phases = _reference_example("pipeline_phases").drifting_phases()
    assert len(pipe.phases) == len(ref_phases) == 6
    for got, want in zip(pipe.phases, ref_phases):
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(getattr(got, f.name),
                                          getattr(want, f.name), f.name)


@pytest.mark.parametrize("mode", ["cold", "warm"])
def test_pipeline_phases_match_reference(pipe, mode):
    """Phase by phase: the assignment, transfer log, transfers, imbalance,
    whether the CSR was reused and the start warm."""
    phases = _reference_example("pipeline_phases").drifting_phases()
    kw = dict(warm_start=False, reuse_csr=False) if mode == "cold" else {}
    want = r_pipeline(phases, RParams(delta=1e-9), n_iter=3,
                      batch_lock_events=8, **kw)
    got = getattr(pipe, mode)
    assert got.total_transfers == want.total_transfers
    for g, w in zip(got.runs, want.runs, strict=True):
        _same_trace(g.result, w.result)
        assert (g.csr_reused, g.warm_started) == (w.csr_reused,
                                                  w.warm_started)


def test_seqpack_stream_matches_reference(pipe):
    rng = np.random.default_rng(3)
    batches = [rng.lognormal(0.0, 0.8, 256) for _ in range(5)]
    want = r_stream(batches, n_ranks=16, seed=0)
    assert [(r.imbalance_before, r.imbalance_after) for r in pipe.stream] \
        == [(r.imbalance_before, r.imbalance_after) for r in want]
    for g, w in zip(pipe.stream, want, strict=True):
        np.testing.assert_array_equal(g.assignment, w.assignment)


# ---------------------------------------------------------------- assembly
def test_assembly_e2e_analytic_matches_reference():
    """With analytic durations and no cost model: the A/B/C makespans,
    the imbalance before and after, the off-home slab copies and the
    homing waves equal the reference's ``run_assembly_comparison``."""
    got = assembly_e2e.run("cpu", durations="analytic")
    assert got.model is None and got.metrics is None
    run = got.run
    want = r_assembly(n_unknowns=1536, num_ranks=8, durations="analytic",
                      cost_model=None, seed=2, task_limit_u=32)
    assert (run.makespan_baseline, run.makespan_overdecomposed,
            run.makespan_ccmlb) == (want.makespan_baseline,
                                    want.makespan_overdecomposed,
                                    want.makespan_ccmlb)
    assert (run.imbalance_before, run.imbalance_after) == (
        want.imbalance_before, want.imbalance_after)
    assert run.n_off_home_ranks == want.n_off_home_ranks
    np.testing.assert_array_equal(run.lb_result.assignment,
                                  want.lb_result.assignment)
    assert (run.homing is None) == (want.homing is None)
    if want.homing is not None:
        assert len(run.homing.waves) == len(want.homing.waves)
        assert run.homing.est_time_s == want.homing.est_time_s
    assert run.speedup_ccmlb == want.speedup_ccmlb


def test_assembly_e2e_stops_before_homing_when_asked():
    """Tolerance: none.  ``run(home=False)`` returns the balanced target
    run with no homing plan; planning its homing then gives the whole
    run's plan, and the placement is the same."""
    whole = assembly_e2e.run("cpu", durations="analytic").run
    part = assembly_e2e.run("cpu", durations="analytic", home=False).run
    assert part.homing is None
    np.testing.assert_array_equal(part.lb_result.assignment,
                                  whole.lb_result.assignment)
    done = plan_assembly_homing(part)
    assert (done.homing is None) == (whole.homing is None)
    if whole.homing is not None:
        assert len(done.homing.waves) == len(whole.homing.waves)
        assert done.homing.est_time_s == whole.homing.est_time_s
    assert done.makespan_ccmlb == whole.makespan_ccmlb


def test_assembly_e2e_refuses_other_durations():
    with pytest.raises(ValueError, match="durations"):
        assembly_e2e.run("cpu", durations="predicted")


# ------------------------------------------------------------------- serve
def _prompt_rng(arch):
    """The example's generator as it stands when it draws ``arch``'s
    prompts (one generator, seeded 0, for the four archs in turn)."""
    rng = np.random.default_rng(0)
    for before in serve_batched.ARCHS[:serve_batched.ARCHS.index(arch)]:
        rng.integers(0, configs.get_smoke_config(before).vocab_size, (4, 24))
    return rng


@pytest.mark.parametrize("arch", serve_batched.ARCHS)
def test_serve_batched_matches_reference(arch):
    """The example's loop body on the reference's init (float32, carried
    across) and the prompts the example draws for ``arch``: greedy tokens
    equal to the reference's ``serve_batch``."""
    r_model = r_build_model(r_configs.get_smoke_config(arch), MESH)
    values, _ = split_lp_tree(r_model.init(jax.random.key(0)))
    values = jax.tree.map(lambda a: a.astype(jnp.float32), values)
    cfg = configs.get_smoke_config(arch)
    params = lm_params_from_reference(jax.tree.map(np.asarray, values), cfg)
    got = serve_batched.serve_one(cfg, "cpu", torch.float32,
                                  rng=_prompt_rng(arch), params=params)
    prompts = _prompt_rng(arch).integers(0, cfg.vocab_size,
                                         (4, 24)).astype(np.int32)
    want = np.asarray(r_serve_batch(r_model, values, prompts, max_new=16))
    assert got.tokens.shape == (4, 16)
    np.testing.assert_array_equal(got.tokens, want)


def test_serve_batched_runs_every_family_on_the_cpu(capsys):
    """The example's ``main`` as it stands but for ``--device cpu`` (bf16,
    the port's own init): four families, 4 x 16 tokens each, in the
    vocabulary, a line printed for each."""
    served = serve_batched.main(["--device", "cpu"])
    assert capsys.readouterr().out.count("4 reqs x 16 tokens") == 4
    assert [s.arch for s in served] == [
        configs.get_smoke_config(a).name for a in serve_batched.ARCHS]
    for s, arch in zip(served, serve_batched.ARCHS):
        assert s.tokens.shape == (4, 16) and s.tokens.dtype == np.int32
        assert 0 <= s.tokens.min() and s.tokens.max() < \
            configs.get_smoke_config(arch).vocab_size
        assert s.seconds > 0


# ------------------------------------------------------------------- train
# CONFIG_100M cut: 2 layers, narrow
TRAIN_CUT = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                 head_dim=16, d_ff=128, vocab_size=512, num_experts=8,
                 moe_d_ff=32)
TRAIN_RUN = dict(steps=6, seq_len=32, global_batch=2, ckpt_every=2,
                 rebalance_every=2)


def test_config_100m_is_the_reference_examples():
    want = _reference_example("train_moe_ccm").CONFIG_100M
    assert dataclasses.asdict(train_moe_ccm.CONFIG_100M) \
        == dataclasses.asdict(want)
    assert train_moe_ccm.CONFIG_100M.param_count() == want.param_count()


def test_train_moe_ccm_restart_lands_on_the_uninterrupted_run(tmp_path):
    """At the cut config, a run failing at step 3 restores its step-2
    checkpoint under ``run_with_restarts`` and its losses from there lie
    within 1e-3 of the uninterrupted run's; every run re-places the
    experts every 2 steps."""
    cfg = dataclasses.replace(train_moe_ccm.CONFIG_100M, **TRAIN_CUT)
    whole = train_moe_ccm.run("cpu", cfg=cfg, ckpt_dir=str(tmp_path / "a"),
                              **TRAIN_RUN)
    failed = train_moe_ccm.run("cpu", cfg=cfg, ckpt_dir=str(tmp_path / "b"),
                               fail_at=3, **TRAIN_RUN)
    assert whole.stats.restarts == 0 and whole.stats.completed
    assert failed.stats.restarts == 1 and failed.stats.completed
    assert failed.log.restored_from == [2]
    assert len(failed.losses) == TRAIN_RUN["steps"] - 2
    np.testing.assert_allclose(failed.losses, whole.losses[2:], rtol=1e-3)
    assert len(whole.log.replacements) == TRAIN_RUN["steps"] // 2


def test_train_moe_ccm_matches_reference_train_loop(tmp_path):
    """The reference's ``train_loop`` and the example's run at the cut
    config from the same float32 weights (the reference's seed-0 init,
    handed to each as a step-0 checkpoint with zero moments): every loss
    within ``rtol=1e-5``."""
    r_cfg = dataclasses.replace(
        _reference_example("train_moe_ccm").CONFIG_100M, **TRAIN_CUT)
    cfg = dataclasses.replace(train_moe_ccm.CONFIG_100M, **TRAIN_CUT)
    values, _ = split_lp_tree(r_build_model(r_cfg, MESH).init(
        jax.random.key(0)))
    values = jax.tree.map(lambda a: a.astype(jnp.float32), values)
    RCheckpointManager(str(tmp_path / "ref"), async_write=False).save(
        0, (values, r_adamw_init(values)))
    params = lm_params_from_reference(jax.tree.map(np.asarray, values), cfg)
    CheckpointManager(tmp_path / "port", async_write=False).save(
        0, (params, make_optimizer(params).state_leaves()))
    _, _, want = r_train_loop(r_cfg, MESH, ckpt_dir=str(tmp_path / "ref"),
                              lr=1e-3, log_every=20, **TRAIN_RUN)
    got = train_moe_ccm.run("cpu", cfg=cfg, ckpt_dir=str(tmp_path / "port"),
                            dtype=torch.float32, **TRAIN_RUN)
    assert got.log.restored_from == [0]
    np.testing.assert_allclose(got.losses, want, rtol=1e-5)


# ------------------------------------------------------------------ device
@pytest.mark.parametrize("run", [
    quickstart.run, async_balancer.run, pipeline_phases.run, assembly_e2e.run,
    serve_batched.run, lambda: train_moe_ccm.run(steps=1)],
    ids=["quickstart", "async_balancer", "pipeline_phases", "assembly_e2e",
         "serve_batched", "train_moe_ccm"])
def test_examples_run_on_the_card_by_default(run):
    """Without ``device`` every example asks for the card, and raises
    where torch sees none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    with pytest.raises(RuntimeError, match="cuda|CUDA"):
        run()
