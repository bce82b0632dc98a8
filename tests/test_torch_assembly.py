"""Port parity, the paper's application: ``repro_torch.assembly`` and the
assembly tile (``repro_torch.kernels.assembly``) against the JAX package's
``repro.assembly`` and ``repro.kernels.assembly`` on the same inputs.

Tolerances, per test:
- the problem, the homing plans and the analytic whole slice: none (host
  numpy copies; bitwise);
- the tile: ``rtol=1e-5, atol=1e-4``.  The port's plain version keeps the
  reference's order of operations (``r_q``, ``w_q`` and ``0.05 * r_q`` are
  Python doubles rounded once to float32, ``3 * d * r_q`` left to right,
  the squares summed x, y, z, q accumulated in order), so what is left is
  the cos implementation (XLA's against torch's) and the Pallas body's
  five zero lanes, which add exactly;
- the ``mxu_distance`` expansion: max relative error ``|diff| / (|ref| +
  1e-3) < 2e-2`` against the direct distance, the reference's own bound.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.assembly import build_problem as r_build_problem
from repro.assembly import run_assembly_comparison as r_run
from repro.assembly.execute import analytic_durations as r_analytic
from repro.assembly.execute import execute_task as r_execute_task
from repro.assembly.execute import tile_kernel as r_tile_kernel
from repro.assembly.homing import plan_homing as r_plan_homing
from repro.kernels.assembly.ops import assembly_tile as r_assembly_tile
from repro_torch.assembly import (balance_assembly, build_problem,
                                  plan_assembly_homing,
                                  run_assembly_comparison)
from repro_torch.assembly.execute import (TILE_BLOCK, analytic_durations,
                                          execute_task, measure_durations,
                                          tile_kernel)
from repro_torch.assembly.homing import plan_homing
from repro_torch.kernels import _build
from repro_torch.kernels.assembly import kernel, ref
from repro_torch.kernels.assembly.ops import assembly_tile

QUADS = (4, 16, 64, 192)


def _assert_same_plan(got, want):
    """Field by field: the two packages' ``HomingPlan`` are distinct
    classes, so dataclass equality would not compare them."""
    assert (got is None) == (want is None)
    if got is not None:
        assert got.waves == want.waves
        assert got.detours == want.detours
        assert got.total_bytes == want.total_bytes
        assert got.est_time_s == want.est_time_s


def _tile_inputs(case):
    """(pr, pc, couple) numpy inputs: random points in the cavity's box and
    a 70% mask; ``coincident`` repeats half the row points as columns."""
    rng = np.random.default_rng({"96x160": 0, "13x7": 1, "coincident": 2}[
        case])
    nr, nc = {"96x160": (96, 160), "13x7": (13, 7), "coincident": (40, 40)}[
        case]
    pr = rng.uniform(0.0, 2.0, (nr, 3)).astype(np.float32)
    pc = rng.uniform(0.0, 2.0, (nc, 3)).astype(np.float32)
    if case == "coincident":
        pc[:20] = pr[:20]
    return pr, pc, rng.random((nr, nc)) < 0.7


def test_problem_is_field_equal():
    """Tolerance: none.  Geometry, layout, every task's fields, the
    features and the CCM phase are bitwise the reference's."""
    want = r_build_problem(1024, 8, task_limit_u=64)
    got = build_problem(1024, 8, task_limit_u=64)
    for f in ("points", "region", "elem_type"):
        np.testing.assert_array_equal(getattr(got.geom, f),
                                      getattr(want.geom, f))
    for f in ("rank_rows", "slab_cols"):
        assert len(getattr(got, f)) == len(getattr(want, f))
        for a, b in zip(getattr(got, f), getattr(want, f)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.slab_home, want.slab_home)
    np.testing.assert_array_equal(got.slab_bytes, want.slab_bytes)
    assert got.num_tasks == want.num_tasks > 0
    for a, b in zip(got.tasks, want.tasks):
        for f in ("task_id", "slab", "home_rank", "elem_pair", "quad_order",
                  "n_interactions"):
            assert getattr(a, f) == getattr(b, f)
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.cols, b.cols)
    np.testing.assert_array_equal(got.features(), want.features())
    durs = analytic_durations(got)
    np.testing.assert_array_equal(durs, r_analytic(want))
    p_got = got.to_phase(durs, mem_cap_bytes=3e7)
    p_want = want.to_phase(durs, mem_cap_bytes=3e7)
    for f in ("task_load", "task_mem", "task_overhead", "task_block",
              "block_size", "block_home", "comm_src", "comm_dst", "comm_vol",
              "rank_mem_base", "rank_mem_cap", "rank_speed"):
        np.testing.assert_array_equal(getattr(p_got, f), getattr(p_want, f))


@pytest.mark.parametrize("q", QUADS)
@pytest.mark.parametrize("case", ["96x160", "13x7", "coincident"])
def test_tile_matches_reference(case, q):
    """Tolerance ``rtol=1e-5, atol=1e-4`` (module docstring): the port's
    ``tile_kernel`` on CPU tensors against the application's
    ``execute.tile_kernel`` and the Pallas kernel in interpret mode."""
    pr, pc, couple = _tile_inputs(case)
    got = tile_kernel(torch.tensor(pr), torch.tensor(pc),
                      torch.tensor(couple), q)
    assert got.dtype == torch.float32 and got.shape == couple.shape
    app = r_tile_kernel(jnp.asarray(pr), jnp.asarray(pc),
                        jnp.asarray(couple), q)
    pallas = r_assembly_tile(jnp.asarray(pr), jnp.asarray(pc),
                             jnp.asarray(couple), quad_order=q, block_r=32,
                             block_c=64, interpret=True)
    for name, want in (("execute.tile_kernel", app), ("pallas", pallas)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-4, err_msg=name)
    assert (got.numpy()[~couple] == 0).all()


@pytest.mark.parametrize("q", QUADS)
def test_mxu_distance_mode(q):
    """Tolerance: relative error ``< 2e-2`` against the direct distance, on
    the reference's own test shape (64 x 64 uniform points, all coupled);
    the reference's Pallas ``mxu_distance`` run agrees with the port's to
    ``atol=1e-2`` (the two sum the expansion in different orders)."""
    rng = np.random.default_rng(q)
    pr = rng.uniform(0.0, 1.0, (64, 3)).astype(np.float32)
    pc = rng.uniform(0.0, 1.0, (64, 3)).astype(np.float32)
    couple = np.ones((64, 64), bool)
    t = [torch.tensor(a) for a in (pr, pc, couple)]
    out = assembly_tile(*t, quad_order=q, mxu_distance=True).numpy()
    direct = assembly_tile(*t, quad_order=q).numpy()
    rel = np.abs(out - direct) / (np.abs(direct) + 1e-3)
    assert rel.max() < 2e-2
    pallas = r_assembly_tile(jnp.asarray(pr), jnp.asarray(pc),
                             jnp.asarray(couple), quad_order=q,
                             mxu_distance=True, block_r=32, block_c=32,
                             interpret=True)
    np.testing.assert_allclose(out, np.asarray(pallas), atol=1e-2)


def test_execute_task_and_cpu_durations():
    """Tolerance ``rtol=1e-5, atol=1e-4`` on the tile of the heaviest task;
    measured durations on the CPU are positive and one per task."""
    want_p = r_build_problem(512, 4, task_limit_u=64)
    got_p = build_problem(512, 4, task_limit_u=64)
    i = max(range(got_p.num_tasks), key=lambda k: got_p.tasks[k].quad_order)
    np.testing.assert_allclose(execute_task(got_p, got_p.tasks[i], "cpu"),
                               r_execute_task(want_p, want_p.tasks[i]),
                               rtol=1e-5, atol=1e-4)
    small = build_problem(256, 2, task_limit_u=32)
    d = measure_durations(small, repeats=1, device="cpu")
    assert d.shape == (small.num_tasks,) and (d > 0).all()


def _homing_instance(seed):
    rng = np.random.default_rng(seed)
    n = 24
    slab_bytes = rng.uniform(1e6, 5e6, n)
    home = rng.integers(0, 8, n)
    loc = rng.integers(0, 8, n)
    node_used = np.zeros(4)
    for s in range(n):
        node_used[loc[s] // 2] += slab_bytes[s]
    return slab_bytes, home, loc, node_used


def _plan_both(slab_bytes, home, loc, **kw):
    """Both planners on copies of ``loc``: (port plan or error, reference
    plan or error, port's relocated ``loc``, reference's)."""
    out = []
    for fn in (plan_homing, r_plan_homing):
        where = np.array(loc, copy=True)
        try:
            out.append((fn(slab_bytes, home, where, **kw), where))
        except RuntimeError as err:
            out.append((str(err), where))
    (got, loc_got), (want, loc_want) = out
    return got, want, loc_got, loc_want


@pytest.mark.parametrize("seed,slack", [(0, 2), (1, 2), (2, 2), (3, 1),
                                        (4, 1), (5, 0.5)])
def test_homing_plan_is_equal(seed, slack):
    """Tolerance: none.  The same waves, detours and bytes, and the same
    relocated slabs, on random instances; with less headroom (``slack``
    slabs above the fullest node) the same queued waves, or the same
    error."""
    slab_bytes, home, loc, node_used = _homing_instance(seed)
    got, want, loc_got, loc_want = _plan_both(
        slab_bytes, home, loc, ranks_per_node=2,
        node_mem_cap=node_used.max() + slab_bytes.max() * slack,
        node_mem_used=node_used)
    if isinstance(want, str):
        assert got == want
    else:
        _assert_same_plan(got, want)
    np.testing.assert_array_equal(loc_got, loc_want)


@pytest.mark.parametrize("spare,want_err", [
    (0.0, None), (0.5e6, "homing infeasible: no node has headroom")])
def test_homing_detour_and_failure_are_equal(spare, want_err):
    """Tolerance: none.  The swap deadlock of the reference's test takes
    the same detour through the third node; when that node has no room
    either, both raise the same error."""
    got, want, _, _ = _plan_both(
        np.array([1e6, 1e6]), np.array([0, 2]), np.array([2, 0]),
        ranks_per_node=2, node_mem_cap=1.5e6 - spare,
        node_mem_used=np.array([1e6, 1e6, spare]))
    if want_err is None:
        _assert_same_plan(got, want)
        assert got.detours >= 1
    else:
        assert got == want == want_err


def test_whole_slice_analytic_is_bitwise():
    """Tolerance: none.  ``run_assembly_comparison(2048, 8, analytic)`` on
    the CPU: assignment, transfer log, makespans A/B/C, imbalances and the
    homing plan equal the reference's."""
    want = r_run(2048, 8, durations="analytic", seed=0)
    got = run_assembly_comparison(2048, 8, durations="analytic", seed=0,
                                  device="cpu")
    np.testing.assert_array_equal(got.lb_result.assignment,
                                  want.lb_result.assignment)
    assert got.lb_result.transfer_log == want.lb_result.transfer_log
    for f in ("makespan_baseline", "makespan_overdecomposed",
              "makespan_ccmlb", "imbalance_before", "imbalance_after",
              "n_off_home_ranks"):
        assert getattr(got, f) == getattr(want, f), f
    _assert_same_plan(got.homing, want.homing)
    assert got.speedup_ccmlb == want.speedup_ccmlb
    assert set(got.stage_seconds) == {"build", "durations", "predict",
                                      "ccm_lb", "homing", "baseline"}


class _FlatModel:
    """A cost model that predicts one duration for every task, as a model
    trained on launch-bound card timings nearly does."""

    def predict(self, features):
        return np.full(len(features), 7e-5, np.float32)


def test_homing_fault_is_reproduced():
    """Tolerance: none.  With flat predictions at 8192 unknowns on 32
    ranks, CCM-LB spreads slab copies until the reference's homing planner
    cannot bring them home; the port raises the same error at the same
    point (ROADMAP queue 3)."""
    with pytest.raises(RuntimeError, match="homing did not converge"):
        r_run(8192, 32, durations="analytic", cost_model=_FlatModel(), seed=2)
    part = balance_assembly(8192, 32, durations="analytic",
                            cost_model=_FlatModel(), seed=2, device="cpu")
    assert part.homing is None and part.n_off_home_ranks > 0
    with pytest.raises(RuntimeError, match="homing did not converge"):
        plan_assembly_homing(part)


def test_balance_then_homing_is_the_whole_run():
    """Tolerance: none.  ``balance_assembly`` then ``plan_assembly_homing``
    give ``run_assembly_comparison``'s result; before homing the run has no
    plan."""
    kw = dict(durations="analytic", seed=0, device="cpu")
    whole = run_assembly_comparison(2048, 8, **kw)
    part = balance_assembly(2048, 8, **kw)
    assert part.homing is None
    np.testing.assert_array_equal(part.lb_result.assignment,
                                  whole.lb_result.assignment)
    for f in ("makespan_baseline", "makespan_overdecomposed",
              "makespan_ccmlb", "imbalance_before", "imbalance_after",
              "n_off_home_ranks"):
        assert getattr(part, f) == getattr(whole, f), f
    done = plan_assembly_homing(part)
    _assert_same_plan(done.homing, whole.homing)
    assert done.speedup_ccmlb == whole.speedup_ccmlb
    assert set(done.stage_seconds) == set(whole.stage_seconds)


def test_entry_points_default_to_the_card(monkeypatch):
    """With no card, ``device=None`` raises instead of running on the CPU."""
    from repro_torch.costmodel import train_cost_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = build_problem(256, 2, task_limit_u=32)
    for call in (lambda: measure_durations(p),
                 lambda: execute_task(p, p.tasks[0]),
                 lambda: run_assembly_comparison(256, 2),
                 lambda: train_cost_model(np.ones((4, 8)), np.ones(4))):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_wrapper_rejects_tensors_off_the_card():
    """Tensors not all on the CPU must be on one CUDA device; anything else
    raises instead of falling back."""
    pr, pc, couple = (torch.tensor(a) for a in _tile_inputs("13x7"))
    with pytest.raises(ValueError):
        assembly_tile(pr.to("meta"), pc, couple, quad_order=4)
    with pytest.raises(ValueError):
        kernel.assembly_tile_fwd(pr, pc, couple, quad_order=4)


@pytest.mark.parametrize("q", (1, 3) + QUADS + (300, 5000))
@pytest.mark.parametrize("nr,nc", [(1, 1), (13, 7), (96, 96), (96, 160),
                                   (512, 512), (1, 4000)])
def test_launch_geometry_fits_the_card_and_covers_the_tile(nr, nc, q):
    """``kernel.launch_geometry``, the launch of ``csrc/assembly_tile.cu``,
    for several block shapes: within an H100's limits (threads a block,
    grid rows, shared memory), its blocks' tiles cover every entry exactly
    once with enough threads for every lane, and the lanes an entry and
    the segment depend on Q alone (the block shape only bounds the tile,
    and neither changes the result)."""
    first = None
    for block_r, block_c in ((TILE_BLOCK, TILE_BLOCK), (128, 128), (32, 64),
                             (3, 5), (1, 1)):
        g = kernel.launch_geometry(nr, nc, q, block_r, block_c)
        tile_r, tile_c = g.tile
        assert 1 <= tile_r <= min(block_r, nr)
        assert 1 <= tile_c <= min(block_c, nc)
        assert g.lanes & (g.lanes - 1) == 0
        assert 1 <= g.lanes <= min(q, kernel.MAX_LANES)
        assert tile_r * tile_c * g.lanes <= kernel.MAX_THREADS
        assert g.threads % 32 == 0
        assert 0 <= g.threads - tile_r * tile_c * g.lanes < 32
        assert (g.grid[0] - 1) * tile_c < nc <= g.grid[0] * tile_c
        assert (g.grid[1] - 1) * tile_r < nr <= g.grid[1] * tile_r
        assert g.grid[1] <= 65535
        assert 1 <= g.segment <= min(q, kernel.SEGMENT)
        assert g.smem_bytes <= _build.MAX_SMEM_BYTES
        first = first or (g.lanes, g.segment)
        assert (g.lanes, g.segment) == first


@pytest.mark.parametrize("q", QUADS)
def test_launch_geometry_fills_the_card_on_application_tasks(q):
    """A 96 x 96 task at the application's 16 x 16 tiles: about sqrt(Q)
    lanes an entry (2, 4, 8, 8 at Q 4, 16, 64, 192, the fastest measured on
    an H100), and at Q >= 16 at least a block for each of the card's 132
    SMs, in one wave (at most the 64 warps an SM can hold); the constants
    are the kernel source's."""
    src = kernel.SOURCE.read_text()
    assert re.search(r"constexpr int MAX_THREADS = (\d+);", src).group(1) \
        == str(kernel.MAX_THREADS)
    g = kernel.launch_geometry(96, 96, q, TILE_BLOCK, TILE_BLOCK)
    assert g.lanes == {4: 2, 16: 4, 64: 8, 192: 8}[q]
    blocks = g.grid[0] * g.grid[1]
    if q >= 16:
        assert 132 <= blocks and blocks * g.threads // 32 <= 132 * 64


def test_port_imports_no_jax():
    """Every module of ``repro_torch``, imported in a fresh interpreter,
    loads no ``jax``, ``jaxlib`` or ``repro`` module."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert len(mods) > 20, mods\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(src)})
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version_on_the_card():
    """Runs only where there is a card (``chip_smoke.py`` runs the full
    check).  Tolerance ``rtol=1e-5, atol=1e-4`` against the plain version;
    block shapes (32, 64) and (128, 128) give equal outputs, as do the
    application's 96 x 96 tasks at its own 16 x 16 tiles; a 5000-step
    ladder (20 segments, over 48 KB of shared memory) holds too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for case in ("96x160", "13x7", "coincident"):
        t = [torch.tensor(a, device="cuda") for a in _tile_inputs(case)]
        for q in QUADS:
            before = kernel.LAUNCHES["float32"]
            got = assembly_tile(*t, quad_order=q, block_r=32, block_c=64)
            assert kernel.LAUNCHES["float32"] == before + 1
            torch.testing.assert_close(got, ref.reference_tile(*t, q),
                                       rtol=1e-5, atol=1e-4)
            assert torch.equal(got, assembly_tile(*t, quad_order=q))
    # the application's tasks: 96 x 96 at every quad order through its own
    # launch (16 x 16 tiles), exactly equal to (128, 128) tiles
    rng = np.random.default_rng(3)
    pr, pc = (torch.tensor(rng.uniform(0.0, 2.0, (96, 3)), dtype=torch.float32,
                           device="cuda") for _ in range(2))
    couple = torch.tensor(rng.random((96, 96)) < 0.7, device="cuda")
    for q in QUADS:
        got = tile_kernel(pr, pc, couple, q)
        torch.testing.assert_close(got, ref.reference_tile(pr, pc, couple, q),
                                   rtol=1e-5, atol=1e-4)
        assert torch.equal(got, assembly_tile(pr, pc, couple, quad_order=q))
    # a ladder of 20 segments, past 48 KB of shared memory (the opt-in)
    t = [torch.tensor(a, device="cuda") for a in _tile_inputs("13x7")]
    assert kernel.launch_geometry(13, 7, 5000).smem_bytes > 48 * 1024
    torch.testing.assert_close(assembly_tile(*t, quad_order=5000),
                               ref.reference_tile(*t, 5000), rtol=1e-5,
                               atol=1e-4)
