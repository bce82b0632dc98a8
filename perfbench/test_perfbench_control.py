"""``correct`` has to come out false when what is judged is wrong: the
control (the plain reference computed one precision lower, put in the
program's place) and the faults a serving cell can have, planted under the
timed path: half of the batch left out, a served token altered where it is
produced.  (No cell trains, so none has a state to leave unchanged, and no
cell runs on more than one chip, so no exchange between chips can be left
out.)

On the CPU the tiny cells run; the test marked ``cuda`` runs the control
of each cell of ``BENCHMARK.json`` at its own size on the card."""
from __future__ import annotations

import pytest
import torch

from perfbench import faults, harness, judge, testing
from perfbench.drivers import Cell
from perfbench.trace import Tracer


def _cell(name: str, device: str = "cpu", seed: int = testing.SEED,
          seconds: float = 0.5) -> Cell:
    configs, traffic, cells = testing.docs()
    if name in testing.TINY_LIMITS:
        w = {c["name"]: c for c in cells}[name]
        config = {d["name"]: d for d in configs}[w["config"]]
        mix = {d["name"]: d for d in traffic}[w["traffic"]]
    else:
        w = harness.workload(harness.manifest(), name)
        config = harness.config_doc(w["config"])
        mix = harness.traffic_doc(w["traffic"])
    return Cell(name=name, config=config, traffic=mix,
                cfg=harness.program_config(config), seed=seed,
                seconds=seconds, trace=False, device=device)


def _limits(name: str) -> dict:
    return testing.TINY_LIMITS.get(name) or judge.load_limits(
        harness.BENCH_DIR, name)


def _correct(name: str, numbers: dict) -> bool:
    checks = judge.Checks(_limits(name))
    for key, value in numbers.items():
        checks.add(key, value)
    return checks.correct


def _numbers(cell: Cell, control: bool = False) -> dict:
    drv = harness.driver(cell.traffic["kind"])
    state = drv.setup(cell)
    drv.measure(state, cell, Tracer(False))
    return drv.control(state, cell) if control else drv.judge(state, cell)


@pytest.mark.parametrize("name", sorted(testing.TINY_CELLS))
def test_sound_and_control(name):
    assert _correct(name, _numbers(_cell(name)))
    assert not _correct(name, _numbers(_cell(name), control=True))


@pytest.mark.parametrize("name", sorted(testing.TINY_CELLS))
@pytest.mark.parametrize("fault", ["altered_token", "half_batch_served"])
def test_serve_faults_fail(fault, name):
    remove = faults.plant(fault)
    try:
        assert not _correct(name, _numbers(_cell(name)))
    finally:
        remove()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rwkv6-serve-longdoc"])
def test_control_fails_at_the_cells_size(card, name):
    cell = _cell(name, device="cuda", seed=2 ** 31 + 101, seconds=5.0)
    assert not _correct(name, _numbers(cell, control=True))
