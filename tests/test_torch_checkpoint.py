"""The port's checkpoints (``repro_torch.checkpoint``) and their restore
onto a device (``runtime.elastic.resume_on_mesh``): the tests of
``tests/test_checkpoint_fault.py`` that the JAX package holds its own
``checkpoint`` to, ported to torch trees (roundtrip, atomic renames, GC,
the structure check, the in-flight registry), and the trainer's
(params, AdamW state) checkpoint resumed on the CPU.  Everything is exact.
"""
import time

import numpy as np
import pytest
import torch

import repro_torch.checkpoint.checkpoint as ckpt
from repro_torch import configs
from repro_torch.checkpoint import (CheckpointManager, latest_step, restore,
                                    save, tree_leaves)
from repro_torch.launch import train
from repro_torch.runtime.elastic import resume_on_mesh


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 16), generator=g),
            "b": {"c": torch.arange(5, dtype=torch.int32),
                  "d": torch.tensor(3.5),
                  "e": [torch.randn(3, generator=g).to(torch.bfloat16)]}}


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_save_restore_roundtrip(tmp_path):
    """Every leaf back with its value, shape and dtype (bfloat16 too)."""
    tree = _tree()
    save(tmp_path, 7, tree)
    assert latest_step(tmp_path) == 7
    _equal(restore(tmp_path, 7, tree), tree)


def test_checkpoint_atomic_no_partial_visible(tmp_path):
    """A tmp dir must never be picked up as a checkpoint."""
    (tmp_path / ".tmp_step_00000009").mkdir(parents=True)
    assert latest_step(tmp_path) is None
    save(tmp_path, 3, _tree())
    assert latest_step(tmp_path) == 3


def test_manager_gc_keeps_last(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*"))
    assert steps == [3, 4]
    restored, step = mgr.restore(_tree())
    assert step == 4
    _equal(restored, _tree(4))


@pytest.mark.parametrize("bad", ["fewer leaves", "other shape",
                                 "other dtype"])
def test_structure_change_rejected(tmp_path, bad):
    """Another leaf count (as the reference checks), or a leaf of another
    shape or dtype, raises instead of restoring."""
    save(tmp_path, 1, _tree())
    example = _tree()
    if bad == "fewer leaves":
        example = {"a": torch.zeros((8, 16))}
    elif bad == "other shape":
        example["a"] = torch.zeros((16, 8))
    else:
        example["b"]["c"] = torch.zeros(5, dtype=torch.int64)
    with pytest.raises(ValueError, match="structure changed"):
        restore(tmp_path, 1, example)


def test_latest_step_waits_for_interrupted_async_save(tmp_path, monkeypatch):
    """An async save still in flight when its manager is abandoned (the
    crash-restart path) is visible to a FRESH reader: ``latest_step`` joins
    the registered writer thread instead of returning None."""
    orig_save = ckpt.save

    def slow_save(*args, **kwargs):
        time.sleep(0.5)  # the reader races ahead of the rename
        return orig_save(*args, **kwargs)

    monkeypatch.setattr(ckpt, "save", slow_save)
    mgr = CheckpointManager(tmp_path, async_write=True)
    mgr.save(3, _tree())
    assert latest_step(tmp_path) == 3
    fresh = CheckpointManager(tmp_path, async_write=True)
    assert fresh.latest() == 3
    restored, step = fresh.restore(_tree())
    assert step == 3
    _equal(restored, _tree())


def test_async_save_copies_before_the_next_update(tmp_path):
    """The manager copies the tree to the host before handing it to the
    writer, so an in-place update right after ``save`` (the trainer's next
    step) does not leak into the checkpoint."""
    tree = _tree()
    want = {k: v for k, v in _tree().items()}
    mgr = CheckpointManager(tmp_path, async_write=True)
    mgr.save(1, tree)
    tree["a"].add_(1.0)
    mgr.wait()
    _equal(restore(tmp_path, 1, tree), want)


def test_resume_on_mesh_restores_params_moments_and_step(tmp_path):
    """``resume_on_mesh(cfg, "cpu", dir)`` gives back the model, the params,
    AdamW's state (steps, m, v) and the step of the trainer's latest
    checkpoint, exactly; with ``with_opt=False`` it reads a params-only
    checkpoint."""
    cfg = configs.get_smoke_config("qwen3-moe-30b-a3b")
    params, opt, _ = train.train_loop(cfg, steps=4, seq_len=16,
                                      global_batch=2, ckpt_dir=str(tmp_path),
                                      ckpt_every=2, log_every=100,
                                      device="cpu")
    model, got, opt_state, step = resume_on_mesh(cfg, "cpu", tmp_path)
    assert step == 4 and model.device == torch.device("cpu")
    _equal(got, params)
    want = opt.state_leaves()
    assert int(opt_state[0]) == 4 == opt.steps
    _equal(opt_state[1:], want[1:])
    assert any(float(t.abs().max()) > 0 for t in opt_state[1:])
    save(tmp_path / "params", 9, params)
    _, got, none, step = resume_on_mesh(cfg, "cpu", tmp_path / "params",
                                        with_opt=False)
    assert none is None and step == 9
    _equal(got, params)
    with pytest.raises(ValueError, match="structure changed"):
        resume_on_mesh(cfg, "cpu", tmp_path / "params")
    np.testing.assert_array_equal(sorted(p.name for p in tmp_path.glob(
        "step_*")), ["step_00000002", "step_00000004"])
