"""Port parity, expert parallelism: ``models.moe.moe_forward`` on gloo
meshes against the JAX package's ``moe_forward`` (``shard_map``) on the
same mesh shapes, and the mesh's gradients and cross-rank re-placement
against one device.

This file, run as a script, is both sides, started together by one
module fixture:
- the reference, in a subprocess with ``XLA_FLAGS=
  --xla_force_host_platform_device_count=4`` set before jax starts, on
  ``jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) *
  2)`` (the workaround of ``tests/test_torch_serve.py``);
- the port, one spawn of four gloo processes (a ``FileStore`` under
  ``tmp_path``), every mesh a slice of one (replica, data, model) mesh
  over the four ranks.

Inputs are numpy draws (seed 0) of ``qwen3-moe-smoke``'s MoE layer in
float32 (8 experts, top 2, d 64, f 32; capacity factor 8, so no token is
dropped) and a (4, 8, 64) batch.  Checks:
- (1, 2), (2, 2), (1, 4): ``y`` within rtol 1e-5, atol 1e-5 of the
  reference's, ``expert_counts`` exactly equal, ``aux_loss`` within 1e-6;
- (1, 2): the gradients of ``sum(y * g) + aux / 2`` with respect to the
  router, the three expert weights and x, gathered, against the port's
  one-device autograd within rtol 1e-5, atol 1e-6 (the mesh sums the
  experts' partial outputs and gradients in another order); (2, 2) the
  same for ``sum(y * g)`` (its aux loss is the mean of the data shards',
  as the reference's, not the batch's);
- (1, 4): a slot permutation that moves experts between all four ranks,
  applied by ``launch.train.permute_experts`` to a trained model's shards
  and AdamW moments, equal bit for bit to the one-device permutation of the
  gathered weights and moments; and a ``train_loop`` with a re-placement
  every step plans on the mesh's model axis (4 ranks).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-moe-30b-a3b"
MESHES = [(1, 2), (2, 2), (1, 4)]
# the aux loss's weight in each mesh's objective: on (2, 2) the aux loss
# is the mean of each data shard's (as the reference's pmean), which is not
# the whole batch's, so that objective leaves it out
GRAD_MESHES = {(1, 2): 0.5, (2, 2): 0.0}
B, S = 4, 8


def inputs(cfg):
    rng = np.random.default_rng(0)
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff

    def w(*shape, fan):
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    params = {"router": w(d, e, fan=d), "w_gate": w(e, d, f, fan=d),
              "w_up": w(e, d, f, fan=d), "w_down": w(e, f, d, fan=f)}
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    g = rng.standard_normal((B, S, d)).astype(np.float32)
    return params, x, g


def reference(out: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro import configs as r_configs
    from repro.models.moe import moe_forward
    from repro.sharding import MeshAxes

    cfg = r_configs.get_smoke_config(ARCH)
    params, x, _ = inputs(cfg)
    res = {}
    for shape in MESHES:
        n = shape[0] * shape[1]
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:n])
        y, st = moe_forward({k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(x), cfg, mesh, MeshAxes.for_mesh(mesh),
                            cfg.act)
        key = f"{shape[0]}x{shape[1]}"
        res[f"y_{key}"] = np.asarray(y)
        res[f"counts_{key}"] = np.asarray(st["expert_counts"])
        res[f"aux_{key}"] = np.asarray(st["aux_loss"])
    np.savez(out, **res)


def _rank(rank: int, world: int, store: str, out: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import configs, sharding
    from repro_torch.checkpoint import tree_leaves
    from repro_torch.checkpoint.checkpoint import tree_unflatten
    from repro_torch.launch import train
    from repro_torch.launch.steps import (make_optimizer, make_train_step,
                                         tree_leaves_specs)
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamW

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    cfg = configs.get_smoke_config(ARCH)
    params, x, g = inputs(cfg)
    full = {k: torch.tensor(v) for k, v in params.items()}
    xt, gt = torch.tensor(x), torch.tensor(g)
    res = {}

    def mesh_of(shape):
        rep = world // (shape[0] * shape[1])
        m = init_device_mesh("cpu", (rep,) + shape,
                             mesh_dim_names=("rep", "data", "model"))
        return m["data", "model"]

    meshes = {shape: mesh_of(shape) for shape in MESHES}
    for shape, mesh in meshes.items():
        key = f"{shape[0]}x{shape[1]}"
        axes = sharding.MeshAxes.for_mesh(mesh)
        specs = {k: sharding.spec_for(mesh, axes, moe.moe_axes(cfg)[k],
                                      tuple(v.shape))
                 for k, v in full.items()}
        ctx = sharding.MeshCtx(mesh, axes, specs)
        entry = ctx.batch_entry(B)
        bspec = (entry, None, None)
        local = {k: sharding.shard(v, mesh, specs[k]).clone()
                 .requires_grad_() for k, v in full.items()}
        x_loc = sharding.shard(xt, mesh, bspec).clone().requires_grad_()
        p = dict(local, router=ctx.gather(local["router"], specs["router"]))
        y, st = moe.moe_forward(p, x_loc, cfg, cfg.act, ctx=ctx, spec=specs)
        with torch.no_grad():
            res[f"y_{key}"] = ctx.gather(y.detach(), bspec).numpy()
        res[f"counts_{key}"] = st["expert_counts"].numpy()
        res[f"aux_{key}"] = st["aux_loss"].detach().numpy()
        if shape in GRAD_MESHES:
            loss = (y * sharding.shard(gt, mesh, bspec)).sum() \
                + st["aux_loss"] * GRAD_MESHES[shape]
            loss.backward()
            with torch.no_grad():
                for k, v in local.items():
                    res[f"grad_{k}_{key}"] = ctx.gather(v.grad,
                                                        specs[k]).numpy()
                res[f"grad_x_{key}"] = ctx.gather(x_loc.grad, bspec).numpy()
    # one device: the same function with no mesh
    for w_aux in sorted(set(GRAD_MESHES.values())):
        one = {k: v.clone().requires_grad_() for k, v in full.items()}
        x_one = xt.clone().requires_grad_()
        y, st = moe.moe_forward(one, x_one, cfg, cfg.act)
        ((y * gt).sum() + st["aux_loss"] * w_aux).backward()
        for k, v in one.items():
            res[f"grad_{k}_one_{w_aux}"] = v.grad.numpy()
        res[f"grad_x_one_{w_aux}"] = x_one.grad.numpy()

    # a cross-rank re-placement on (1, 4): one train step for moments
    mesh = meshes[(1, 4)]
    model = build_model(cfg, device="cpu", dtype=torch.float32, mesh=mesh)
    params_m = model.init(torch.Generator().manual_seed(0))
    opt = make_optimizer(params_m, ctx=model.ctx)
    step = make_train_step(model)
    batch = {"tokens": np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)), "targets": np.random.default_rng(2)
        .integers(0, cfg.vocab_size, (2, 16))}
    step(params_m, opt, batch)
    specs = tree_leaves_specs(model.ctx.specs)

    def whole():
        with torch.no_grad():
            state = opt.state_leaves()
            return [model.ctx.gather(t.detach(), s).clone() for t, s in zip(
                tree_leaves(params_m) + state[1:], specs * 3)]

    before = whole()
    perm = np.array([7, 5, 3, 1, 6, 4, 2, 0])      # every rank's slots move
    perms = [perm] * cfg.num_layers
    train.permute_experts(params_m, opt, perms, cfg, ctx=model.ctx)
    after = whole()
    # the one-device permutation of the same (gathered) state
    n = len(specs)
    full_p = tree_unflatten(
        build_model(cfg, device="cpu", dtype=torch.float32).init(
            torch.Generator().manual_seed(0)),
        [t.clone() for t in before[:n]])
    opt_1 = AdamW(tree_leaves(full_p), 1e-3)
    opt_1.load_state_leaves([torch.tensor(1, dtype=torch.int32)]
                            + [t.clone() for t in before[n:]])
    train.permute_experts(full_p, opt_1, perms, cfg)
    want = tree_leaves(full_p) + opt_1.state_leaves()[1:]
    res["replace_equal"] = np.array(all(torch.equal(a, b)
                                        for a, b in zip(after, want)))
    res["replace_moved"] = np.array(not all(
        torch.equal(a, b) for a, b in zip(after, before)))
    # re-placement inside training plans on the model axis's 4 ranks
    log = train.TrainLog()
    train.train_loop(cfg, steps=2, seq_len=16, global_batch=2, device="cpu",
                     mesh=mesh, dtype=torch.float32, rebalance_every=1,
                     log=log, log_every=100)
    res["replacements"] = np.array(len(log.replacements))
    if rank == 0:
        np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "reference", str(tmp / "ref.npz")],
        env=ref_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True), subprocess.Popen(
        [sys.executable, __file__, "port", str(tmp / "store"),
         str(tmp / "port.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    return (dict(np.load(tmp / "ref.npz")), dict(np.load(tmp / "port.npz")))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ep_matches_reference(runs, shape):
    ref, port = runs
    key = f"{shape[0]}x{shape[1]}"
    np.testing.assert_allclose(port[f"y_{key}"], ref[f"y_{key}"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(port[f"counts_{key}"], ref[f"counts_{key}"])
    np.testing.assert_allclose(port[f"aux_{key}"], ref[f"aux_{key}"],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", GRAD_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ep_gradients_match_one_device(runs, shape):
    _, port = runs
    key = f"{shape[0]}x{shape[1]}"
    for name in ("router", "w_gate", "w_up", "w_down", "x"):
        np.testing.assert_allclose(port[f"grad_{name}_{key}"],
                                   port[f"grad_{name}_one_"
                                        f"{GRAD_MESHES[shape]}"],
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_cross_rank_replacement_moves_experts_and_moments(runs):
    _, port = runs
    assert bool(port["replace_moved"])
    assert bool(port["replace_equal"])
    assert int(port["replacements"]) == 2


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        reference(sys.argv[2])
    else:
        import torch.multiprocessing as mp
        mp.spawn(_rank, args=(4, sys.argv[2], sys.argv[3]), nprocs=4)
