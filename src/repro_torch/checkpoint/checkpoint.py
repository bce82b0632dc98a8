"""Atomic, manifest-driven checkpointing with async write-behind, after the
JAX package's ``checkpoint/checkpoint.py``, with torch's own serialisation.

Layout: <dir>/step_<n>/ with one ``.pt`` file per flattened leaf (a CPU
tensor, written by ``torch.save``; bfloat16 needs no raw-integer view) +
manifest.json (step, each leaf's name, shape and dtype, extra metadata).
Writes go to a temp dir that is os.rename'd into place — a crashed writer
can never corrupt the latest checkpoint, which is what the fault-tolerance
restart loop (repro_torch.runtime.fault) depends on.  Restore puts the
leaves on a device of the caller's choice (the elastic path,
``runtime.elastic.resume_on_mesh``) and checks that the example tree has
the saved structure.

A tree is nested dicts (keys sorted), lists and tuples of tensors;
:func:`tree_leaves` flattens it.  Async saves are tracked in a module-level
in-flight registry keyed by the checkpoint directory: readers
(``latest_step``/``restore``) join any pending writer threads for that
directory before listing or loading, so a restart that builds a FRESH
``CheckpointManager`` never reads the directory mid-write and silently
replays from step 0.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Iterable, List, Optional

import torch


def tree_leaves(tree) -> List[Any]:
    """The leaves of a tree: dict keys sorted, list and tuple items in
    order (as ``jax.tree.leaves`` orders them)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_unflatten(example, leaves: List[Any]):
    """``example``'s structure holding ``leaves`` (in ``tree_leaves``
    order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(example)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def save(ckpt_dir, step: int, tree: Any, *, extra: Optional[dict] = None
         ) -> Path:
    return save_leaves(ckpt_dir, step, tree_leaves(tree), extra=extra)


def save_leaves(ckpt_dir, step: int, leaves: Iterable[Any], *,
                extra: Optional[dict] = None) -> Path:
    """Write ``leaves`` (in ``tree_leaves`` order) as the checkpoint of
    ``step``, one at a time: an iterator that makes each leaf when asked
    (a mesh's gather) holds one leaf in host memory at a time."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, leaf in enumerate(leaves):
        t = torch.as_tensor(leaf).detach().cpu()
        name = f"leaf_{i:05d}"
        torch.save(t.clone(), tmp / f"{name}.pt")
        manifest["leaves"].append({"name": name, "shape": list(t.shape),
                                   "dtype": _dtype_name(t.dtype)})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


# directory -> in-flight async writer threads; readers join them so a save
# started by one CheckpointManager is never invisible to another (or to the
# module-level functions) in the same process
_INFLIGHT: dict = {}
_INFLIGHT_LOCK = threading.Lock()


def _register_and_start(ckpt_dir, thread: threading.Thread):
    """Register an async writer and start it under the registry lock, so a
    reader snapshotting the registry can never observe a registered-but-
    unstarted thread (join() on one raises) nor miss a started one.  Dead
    writers are pruned here, keeping the registry bounded over long runs."""
    key = str(Path(ckpt_dir).resolve())
    with _INFLIGHT_LOCK:
        alive = [t for t in _INFLIGHT.get(key, ()) if t.is_alive()]
        alive.append(thread)
        _INFLIGHT[key] = alive
        thread.start()


def wait_for_inflight(ckpt_dir):
    """Block until every pending async save targeting ``ckpt_dir`` (from any
    CheckpointManager in this process) has completed."""
    key = str(Path(ckpt_dir).resolve())
    with _INFLIGHT_LOCK:
        threads = list(_INFLIGHT.get(key, ()))
    for t in threads:
        t.join()
    with _INFLIGHT_LOCK:
        alive = [t for t in _INFLIGHT.get(key, ()) if t.is_alive()]
        if key in _INFLIGHT:
            _INFLIGHT[key] = alive


def latest_step(ckpt_dir) -> Optional[int]:
    wait_for_inflight(ckpt_dir)
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def restore(ckpt_dir, step: int, example_tree: Any, device=None,
            place=None) -> Any:
    """Restore into the structure of ``example_tree`` (its leaves give the
    structure; their values are not read), each leaf on ``device`` (the
    CPU by default), or, with ``place``, each leaf ``place(i, leaf)`` of
    the i-th whole leaf memory-mapped from its file (a mesh rank's shard:
    only its pages are read).  Raises ``ValueError`` when the saved tree
    has another number of leaves, or a leaf another shape or dtype, than
    the example has a tensor leaf."""
    wait_for_inflight(ckpt_dir)
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat = tree_leaves(example_tree)
    if len(flat) != len(manifest["leaves"]):
        raise ValueError(f"tree structure changed: {len(manifest['leaves'])} "
                         f"leaves saved, {len(flat)} in the example")
    loaded = []
    for i, (meta, example) in enumerate(zip(manifest["leaves"], flat)):
        if isinstance(example, torch.Tensor) and (
                list(example.shape) != meta["shape"]
                or _dtype_name(example.dtype) != meta["dtype"]):
            raise ValueError(f"tree structure changed: {meta['name']} saved "
                             f"as {meta['shape']} {meta['dtype']}, the "
                             f"example has {list(example.shape)} "
                             f"{_dtype_name(example.dtype)}")
        t = torch.load(d / f"{meta['name']}.pt", map_location="cpu",
                       weights_only=True, mmap=place is not None)
        if place is not None:
            loaded.append(place(i, t))
        else:
            loaded.append(t if device is None else t.to(device))
    return tree_unflatten(example_tree, loaded)


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; optional async write-behind."""

    def __init__(self, ckpt_dir, keep: int = 3, async_write: bool = True):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        # copy to the host BEFORE handing off: the trainer updates its
        # tensors in place on the next step
        host = [torch.as_tensor(t).detach().to("cpu", copy=True)
                for t in tree_leaves(tree)]

        def work():
            save(self.dir, step, host, extra=extra)
            self._gc()

        self.wait()
        if self.async_write:
            self._thread = threading.Thread(target=work, daemon=True)
            _register_and_start(self.dir, self._thread)
        else:
            work()

    def save_leaves(self, step: int, leaves: Iterable[Any],
                    extra: Optional[dict] = None):
        """Write ``leaves`` synchronously, one at a time
        (:func:`save_leaves`), after any save in flight."""
        self.wait()
        save_leaves(self.dir, step, leaves, extra=extra)
        self._gc()

    def _gc(self):
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.dir.glob("step_*"))
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def latest(self) -> Optional[int]:
        return latest_step(self.dir)

    def restore(self, example_tree: Any, device=None,
                step: Optional[int] = None, place=None):
        self.wait()
        step = step if step is not None else self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoint to restore in {self.dir}")
        return restore(self.dir, step, example_tree, device, place), step
