"""Port parity, the mesh's layout: ``repro_torch.sharding`` and
``models.model.param_axes`` against the JAX package's ``sharding.py`` and
its ``LP`` leaves, and the mesh's restart and entry points over gloo.

- Every leaf of every config (full size, shapes only) carries the
  reference's logical axes, and resolves to the reference's
  ``spec_for`` on meshes (1, 1), (2, 2), (16, 16) and (2, 16, 16): the
  reference side on ``jax.sharding.AbstractMesh`` (no devices), the port on
  ``sharding.AbstractMesh``.  A scan leaf of the reference leads with a
  ``"layers"`` axis, which maps to no mesh axis; the port keeps one leaf a
  layer, so its spec is the reference's without that entry.
- One spawn of two processes (gloo, a ``FileStore`` under ``tmp_path``)
  runs every two-rank check, this file run as a script: a ``(1, 2)`` run
  of ``launch.train`` writes a checkpoint that ``resume_on_mesh`` restores
  onto ``(2, 1)``, equal to the saved state bit for bit; and serving and
  training ``qwen3-moe-smoke`` through ``--mesh 1,2`` in float32 equal the
  port's one-device runs (tokens identical, losses within rtol 1e-5); and
  the reference's parameters carried onto the ``(1, 2)`` mesh
  (``convert.params_onto``) gather back to ``lm_params_from_reference``'s
  whole tree bit for bit; ``build_model`` refuses a device of another type
  than the mesh's; on ``(2, 1)`` the loss of a plain (whole) batch equals
  one device's, and that of ``local_batch``'s rows equals one device's on
  each half, the halves' losses averaged (each half runs its experts at
  the capacity of its own tokens; rtol 1e-5, token and expert counts
  exact); serving 4 then 3 requests equals one device.
- A checkpoint's leaves are written one at a time, each before the next
  is made (``CheckpointManager.save_leaves``, which a mesh's save
  streams its gathered leaves through).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
MESHES = [(1, 1), (2, 2), (16, 16), (2, 16, 16)]
ARCH = "qwen3-moe-30b-a3b"


def _names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                      "model")


def _reference_axes(arch):
    """The reference's LP tree of ``arch`` (shapes only), laid out as the
    port's params: one entry a layer, the scan's leading axis dropped."""
    import functools

    import jax
    from repro import configs as r_configs
    from repro.models import encdec as r_encdec
    from repro.models import transformer as r_tf
    from repro.models.layers import is_lp

    cfg = r_configs.get_config(arch)
    init = r_encdec.init_encdec if cfg.arch_type == "encdec" \
        else r_tf.init_lm
    tree = jax.eval_shape(functools.partial(init, cfg=cfg),
                          jax.random.key(0))

    def leaves(t, drop):
        if is_lp(t):
            ax, shape = t.axes, tuple(t.value.shape)
            if drop:
                assert ax[0] == "layers"
                return ax[1:], shape[1:], ax, shape
            return ax, shape, ax, shape
        return {k: leaves(v, drop) for k, v in t.items()}

    if cfg.arch_type == "encdec":
        out = {k: leaves(tree[k], False) for k in tree
               if k not in ("enc_scan", "dec_scan")}
        out["enc_blocks"] = [leaves(tree["enc_scan"]["b0"], True)] \
            * cfg.num_layers
        out["dec_blocks"] = [leaves(tree["dec_scan"]["b0"], True)] \
            * cfg.num_decoder_layers
        return cfg, out
    n_periods, tail = r_tf.split_layers(cfg)
    period = cfg.pattern_period
    blocks = [leaves(tree["scan"][f"b{j % period}"], True)
              for j in range(n_periods * period)]
    blocks += [leaves(tree["tail"][f"t{i}"], False)
               for i in range(len(tail))]
    out = {k: leaves(tree[k], False) for k in tree
           if k not in ("scan", "tail")}
    out["blocks"] = blocks
    return cfg, out


def _pairs(port, ref, path=""):
    if isinstance(port, dict):
        assert set(port) == set(ref), path
        for k in port:
            yield from _pairs(port[k], ref[k], f"{path}/{k}")
    elif isinstance(port, list):
        assert len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            yield from _pairs(p, r, f"{path}[{i}]")
    else:
        yield path, port, ref


@pytest.mark.parametrize("arch", [
    "whisper-large-v3", "llama3.2-3b", "gemma2-27b", "smollm-360m",
    "tinyllama-1.1b", "llava-next-mistral-7b", "qwen3-moe-30b-a3b",
    "llama4-scout-17b-a16e", "rwkv6-7b", "recurrentgemma-9b"])
def test_param_axes_and_specs_match_reference(arch):
    from jax.sharding import AbstractMesh as RAbstract
    from repro.sharding import MeshAxes as RAxes
    from repro.sharding import spec_for as r_spec_for

    from repro_torch import configs, sharding
    from repro_torch.models.model import abstract_params, param_axes

    r_cfg, ref = _reference_axes(arch)
    cfg = configs.get_config(arch)
    shapes = sharding.tree_map(lambda t: tuple(t.shape),
                               abstract_params(cfg))
    axes = param_axes(cfg)
    n = 0
    for mesh_shape in MESHES:
        names = _names(mesh_shape)
        r_mesh = RAbstract(mesh_shape, names)
        mesh = sharding.AbstractMesh(tuple(zip(names, mesh_shape)))
        r_axes, p_axes = RAxes.for_mesh(r_mesh), sharding.MeshAxes.for_mesh(
            mesh)
        assert p_axes.batch == r_axes.batch
        for (path, ax, (r_ax, r_shape, r_full_ax, r_full_shape)), (
                _, shape, _) in zip(_pairs(axes, ref), _pairs(shapes, ref)):
            assert tuple(ax) == tuple(r_ax), (path, ax, r_ax)
            assert tuple(shape) == tuple(r_shape), (path, shape, r_shape)
            want = tuple(r_spec_for(r_mesh, r_axes, r_full_ax, r_full_shape))
            if len(r_full_ax) > len(ax):
                assert want[0] is None
                want = want[1:]
            got = sharding.spec_for(mesh, p_axes, ax, shape)
            assert got == want, (mesh_shape, path, got, want)
            n += 1
    assert n > 0


def test_placements_and_local_shapes():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch import sharding
    mesh = sharding.AbstractMesh((("pod", 2), ("data", 16), ("model", 16)))
    spec = (("pod", "data"), None, "model")
    assert sharding.placements_for(mesh, spec) == (Shard(0), Shard(0),
                                                   Shard(2))
    assert sharding.placements_for(mesh, (None, None)) == (
        Replicate(),) * 3
    assert sharding.local_shape(mesh, spec, (64, 3, 32)) == (2, 3, 2)
    x = torch.zeros((2, 3, 2))
    assert sharding.constrain(x, mesh, spec, (64, 3, 32)) is x
    with pytest.raises(ValueError):
        sharding.constrain(x, mesh, spec, (64, 3, 64))


# ------------------------------------------------------ the two-rank spawn
def _rank(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import configs
    from repro_torch.checkpoint import tree_leaves
    from repro_torch.launch import serve, train
    from repro_torch.launch.steps import tree_leaves_specs
    from repro_torch.models.model import local_batch
    from repro_torch.runtime.elastic import resume_on_mesh

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    res = {}
    cfg = configs.get_smoke_config(ARCH)
    common = ["--arch", ARCH, "--smoke", "--device", "cpu", "--dtype",
              "float32"]
    # serving and training through --mesh 1,2 against one device
    want = serve.main(common + ["--batch", "2", "--prompt-len", "12",
                                "--max-new", "5"])
    got = serve.main(common + ["--batch", "2", "--prompt-len", "12",
                               "--max-new", "5", "--mesh", "1,2"])
    res["serve_equal"] = bool((want == got).all())
    targs = ["--steps", "3", "--seq-len", "16", "--global-batch", "2"]
    _, _, l_one = train.main(common + targs)
    _, _, l_mesh = train.main(common + targs + ["--mesh", "1,2"])
    res["losses"] = [l_one, l_mesh]
    # a (1, 2) checkpoint restored onto (2, 1)
    ckpt = os.path.join(os.path.dirname(out), "ckpt")
    mesh_a = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data",
                                                             "model"))
    params, opt, _ = train.train_loop(
        cfg, steps=2, seq_len=16, global_batch=2, ckpt_dir=ckpt,
        ckpt_every=2, device="cpu", mesh=mesh_a, dtype=torch.float32,
        log_every=100)
    model_a = train.build_model(cfg, device="cpu", dtype=torch.float32,
                                mesh=mesh_a)
    specs = tree_leaves_specs(model_a.ctx.specs)
    state = opt.state_leaves()
    saved = [model_a.ctx.gather(t.detach(), s) for t, s in
             zip(tree_leaves(params) + state[1:], specs * 3)]
    mesh_b = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data",
                                                             "model"))
    model_b, p_b, o_b, step = resume_on_mesh(cfg, mesh_b, ckpt,
                                             dtype=torch.float32)
    specs_b = tree_leaves_specs(model_b.ctx.specs)
    back = [model_b.ctx.gather(t, s) for t, s in
            zip(tree_leaves(p_b) + o_b[1:], specs_b * 3)]
    res["resume_step"] = [int(step), int(o_b[0])]
    res["resume_equal"] = len(saved) == len(back) and all(
        torch.equal(a, b) for a, b in zip(saved, back))
    res["resume_shapes_differ"] = any(
        tuple(a.shape) != tuple(b.shape) for a, b in zip(
            tree_leaves(params), tree_leaves(p_b)))
    # the reference's parameters carried onto the (1, 2) mesh
    import jax
    from repro import configs as r_configs
    from repro.models.layers import split_lp_tree
    from repro.models.transformer import init_lm as r_init_lm

    from repro_torch.convert import lm_params_from_reference, params_onto
    values = jax.tree.map(np.asarray, split_lp_tree(r_init_lm(
        jax.random.key(0), r_configs.get_smoke_config(ARCH)))[0])
    model_c = train.build_model(cfg, device="cpu", mesh=mesh_a)
    local = params_onto(model_c, values)
    whole = lm_params_from_reference(values, cfg)
    res["onto_mesh_equal"] = all(
        torch.equal(model_c.ctx.gather(t, s), w) for t, s, w in zip(
            tree_leaves(local), tree_leaves_specs(model_c.ctx.specs),
            tree_leaves(whole), strict=True))
    res["onto_mesh_sharded"] = sum(t.numel() for t in tree_leaves(local)) \
        < sum(t.numel() for t in tree_leaves(whole))
    # a mesh's device type and build_model's device (the card by default)
    # must agree
    try:
        train.build_model(cfg, mesh=mesh_a)
        res["device_mismatch_raises"] = False
    except ValueError:
        res["device_mismatch_raises"] = True
    # the rows' layout travels with the batch and the caches: on (2, 1) a
    # plain batch is the whole batch on every rank, local_batch's rows are
    # each rank's half; serving 4 then 3 requests (rows split, then whole)
    from repro_torch.launch.steps import to_device
    one = train.build_model(cfg, device="cpu", dtype=torch.float32)
    p_one = one.init(torch.Generator().manual_seed(0))
    model_d = train.build_model(cfg, device="cpu", dtype=torch.float32,
                                mesh=mesh_b)
    p_d = model_d.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    glob = {k: rng.integers(0, cfg.vocab_size, (4, 16))
            for k in ("tokens", "targets")}
    halves = [{k: v[i:i + 2] for k, v in glob.items()} for i in (0, 2)]
    with torch.no_grad():
        runs = [one.loss_fn(p_one, to_device(glob, "cpu")),
                model_d.loss_fn(p_d, to_device(glob, "cpu")),
                model_d.loss_fn(p_d, to_device(
                    local_batch(model_d, glob), "cpu"))]
        split = [one.loss_fn(p_one, to_device(h, "cpu")) for h in halves]
    res["layout_losses"] = [float(loss) for loss, _ in runs]
    res["layout_tokens"] = [int(m["tokens"]) for _, m in runs]
    res["layout_counts"] = [m["expert_counts"].tolist() for _, m in runs]
    # each rank's half runs the experts at its own capacity, as the
    # reference's shard_map does: the mean of the halves' losses (equal
    # token counts; the aux loss is the mean of the shards'), their counts
    # summed
    res["split_loss"] = float(sum(loss for loss, _ in split) / 2)
    res["split_counts"] = sum(m["expert_counts"] for _, m in split).tolist()
    res["serve_sizes_equal"] = []
    for b in (4, 3):
        prompts = rng.integers(0, cfg.vocab_size, (b, 12))
        res["serve_sizes_equal"].append(bool((
            serve.serve_batch(model_d, p_d, prompts, 4)
            == serve.serve_batch(one, p_one, prompts, 4)).all()))
    if rank == 0:
        Path(out).write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh2")
    out = tmp / "result.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, __file__, str(tmp / "store"), str(out)], env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


def test_resume_onto_another_mesh(two_ranks):
    assert two_ranks["resume_step"] == [2, 2]
    assert two_ranks["resume_shapes_differ"]
    assert two_ranks["resume_equal"]


def test_serve_on_mesh_matches_one_device(two_ranks):
    assert two_ranks["serve_equal"]


def test_reference_params_onto_mesh(two_ranks):
    assert two_ranks["onto_mesh_sharded"]
    assert two_ranks["onto_mesh_equal"]


def test_train_on_mesh_matches_one_device(two_ranks):
    one, mesh = two_ranks["losses"]
    np.testing.assert_allclose(mesh, one, rtol=1e-5)


def test_build_model_refuses_another_device_than_the_mesh(two_ranks):
    import inspect

    from repro_torch.launch.mesh import make_production_mesh
    assert two_ranks["device_mismatch_raises"]
    assert inspect.signature(make_production_mesh).parameters[
        "device_type"].default == "cuda"


def test_batch_layout_travels_with_the_rows(two_ranks):
    one, whole, rows = two_ranks["layout_losses"]
    np.testing.assert_allclose(whole, one, rtol=1e-5)
    np.testing.assert_allclose(rows, two_ranks["split_loss"], rtol=1e-5)
    assert two_ranks["layout_tokens"] == [4 * 16] * 3
    counts = two_ranks["layout_counts"]
    assert counts[1] == counts[0]
    assert counts[2] == two_ranks["split_counts"]
    assert two_ranks["serve_sizes_equal"] == [True, True]


def test_checkpoint_leaves_are_written_one_at_a_time(tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    leaves = [torch.full((3,), float(i)) for i in range(4)]
    made = []

    def stream():
        for i, t in enumerate(leaves):
            if i:           # the leaf before was written before this one
                assert (tmp_path / ".tmp_step_00000007"
                        / f"leaf_{i - 1:05d}.pt").exists()
            made.append(i)
            yield t

    mgr = CheckpointManager(tmp_path)
    mgr.save_leaves(7, stream())
    assert made == [0, 1, 2, 3]
    back, step = mgr.restore([torch.empty(3)] * 4)
    assert step == 7
    assert all(torch.equal(a, b) for a, b in zip(back, leaves, strict=True))


if __name__ == "__main__":
    import torch.multiprocessing as mp
    mp.spawn(_rank, args=(2, sys.argv[1], sys.argv[2]), nprocs=2)
