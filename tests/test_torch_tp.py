"""Port parity, tensor parallelism of the dense products: every family's
smoke config in float32 on gloo meshes (1, 2), (1, 4) and (2, 2), held to
the port's one-device run and to the JAX package's jitted functions under
GSPMD on a host mesh of the same shape.

This file, run as a script, is both sides, started together by one module
fixture:
- the reference, in a subprocess with ``XLA_FLAGS=
  --xla_force_host_platform_device_count=4`` set before jax starts: each
  family's weights (``init`` at key 0, cast to float32) are written first,
  in the port's layout (``convert``), for the port to load; then, on
  ``jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) *
  2, devices=jax.devices()[:n])`` with the weights placed by the
  reference's ``shardings_for_lp_tree``, its jitted prefill and
  teacher-forced decode steps, its greedy tokens (``serve_batch``'s loop
  on the same compiled steps) and the jitted ``value_and_grad`` of its
  loss;
- the port, one spawn of four gloo processes (a ``FileStore`` under
  ``tmp_path``), every mesh a slice of one (replica, data, model) mesh
  over the four ranks, the same weights sharded by ``shard_params``.

Families: qwen3-moe (the experts split over the model axis besides),
gemma2 (local and global layers, soft-caps, tied head; also under
``window_kv_cache``, whose ring the reference pads and sees past the
window: ROADMAP queue 3, so that variant is held to the one-device run
alone), rwkv6, recurrentgemma (its 5-layer ragged tail, one kv head),
whisper, llava and smollm (3 heads, which ``spec_for`` replicates).
Inputs are numpy draws (seed 0): 4 prompts of 16 tokens (whisper: 128
frames; llava: 8 media positions first), 4 teacher-forced decode steps, 4
greedy tokens, and a loss batch whose first 2 targets a row are masked.

Limits, float32 throughout:
- prefill and decode logits: ``rtol=1e-5, atol=1e-5`` of the one-device
  run's and of the reference's; greedy tokens identical;
- the loss: ``rtol=1e-5``; every gradient leaf, gathered whole, within
  1e-4 of the one-device (reference) leaf's largest |value|.  On a mesh
  whose data axis has 2 ranks the one-device run is each data shard's
  rows run alone, losses and gradients averaged: the MoE's aux loss is the
  mean of its shards' (the reference's ``pmean``) and its capacity that
  of a shard's tokens;
- a train step's loss on (1, 2) gathers nothing over the model axis
  (``roofline.Counter``, its bytes by axis), and the loss and backward sum
  partial products over it;
- a planted fault, qwen's q heads reading the kv head of the next head's
  rank (``attention.rank_heads``' offset shifted by one), fails the
  logits' limit on (1, 4).
"""
import concurrent.futures
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-moe-30b-a3b", "gemma2-27b", "rwkv6-7b", "recurrentgemma-9b",
         "whisper-large-v3", "llava-next-mistral-7b", "smollm-360m"]
RING = "gemma2-27b+ring"              # window_kv_cache: the port alone
MESHES = [(1, 2), (1, 4), (2, 2)]
B, P, NEW = 4, 16, 4
RTOL = ATOL = 1e-5
GRAD_REL = 1e-4


def _key(shape):
    return f"{shape[0]}x{shape[1]}"


def _cfg(name):
    import dataclasses

    from repro_torch import configs
    arch, _, variant = name.partition("+")
    cfg = configs.get_smoke_config(arch)
    return dataclasses.replace(cfg, window_kv_cache=True) if variant \
        else cfg


def inputs(cfg):
    """The prompts (with their teacher-forced continuation), the stub
    front end's inputs and the loss batch (numpy)."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, P + NEW)).astype(np.int32)
    media = None
    if cfg.arch_type == "encdec":
        media = {"audio_embed": (rng.standard_normal(
            (B, 8 * P, cfg.d_model)) * 0.1).astype(np.float32)}
    elif cfg.frontend == "vision":
        media = {"media_embed": (rng.standard_normal(
            (B, cfg.num_media_positions, cfg.d_model)) * 0.1).astype(
            np.float32)}
    targets = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    targets[:, :2] = -1
    batch = {"tokens": tokens[:, :P], "targets": targets, **(media or {})}
    return tokens, media, batch


# ------------------------------------------------------------ the reference
def reference(out: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from jax.sharding import PartitionSpec as PS
    from repro import configs as r_configs
    from repro.launch.serve import pad_caches as r_pad_caches
    from repro.models.layers import split_lp_tree
    from repro.models.model import build_model as r_build_model
    from repro.sharding import shardings_for_lp_tree

    from repro_torch.checkpoint import tree_leaves
    from repro_torch.convert import (encdec_params_from_reference,
                                     lm_params_from_reference)

    def port_leaves(cfg, tree):
        tree = jax.tree.map(np.asarray, tree)
        conv = encdec_params_from_reference if cfg.arch_type == "encdec" \
            else lm_params_from_reference
        return [t.numpy() for t in tree_leaves(conv(tree, cfg))]

    inits = {}
    weights = {}
    for arch in ARCHS:
        cfg = r_configs.get_smoke_config(arch)
        mesh = jax.make_mesh((1, 1), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:1])
        lp = r_build_model(cfg, mesh).init(jax.random.key(0))
        inits[arch] = lp
        values = jax.tree.map(lambda a: a.astype(jnp.float32),
                              split_lp_tree(lp)[0])
        for i, w in enumerate(port_leaves(cfg, values)):
            weights[f"{arch}|{i}"] = w
    tmp = out + ".weights.tmp.npz"
    np.savez(tmp, **weights)
    os.replace(tmp, out + ".weights.npz")

    def case(arch, shape):
        """Every result of ``arch`` on a ``shape`` mesh."""
        cfg = r_configs.get_smoke_config(arch)
        tokens, media, batch = inputs(cfg)
        start = P + (cfg.num_media_positions if cfg.frontend == "vision"
                     else 0)
        key = f"{arch}|{_key(shape)}"
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:shape[0] * shape[1]])
        model = r_build_model(cfg, mesh)
        lp = inits[arch]
        values = jax.device_put(
            jax.tree.map(lambda a: a.astype(jnp.float32),
                         split_lp_tree(lp)[0]),
            shardings_for_lp_tree(mesh, model.axes, lp))

        def put(a):
            return jax.device_put(jnp.asarray(a), NamedSharding(
                mesh, PS("data", *([None] * (a.ndim - 1)))))
        pre = {"tokens": put(tokens[:, :P]),
               **{k: put(v) for k, v in (media or {}).items()}}
        first, logits0 = jax.jit(model.prefill_fn)(values, pre)
        first = r_pad_caches(first, start + NEW)
        decode = jax.jit(model.decode_fn)
        caches, rows = first, [np.asarray(logits0[:, 0])]
        for i in range(NEW):                  # teacher-forced steps
            caches, logits = decode(values, caches,
                                    put(tokens[:, P + i:P + i + 1]),
                                    jnp.int32(start + i))
            rows.append(np.asarray(logits[:, 0]))
        out = {f"{key}|logits": np.stack(rows)}
        # the greedy tokens as its serve_batch makes them, on the same
        # compiled step (the caches are immutable arrays)
        caches, logits, greedy = first, logits0, []
        for i in range(NEW):
            greedy.append(np.asarray(jnp.argmax(logits[:, -1], axis=-1),
                                     np.int32))
            caches, logits = decode(values, caches, put(greedy[-1][:, None]),
                                    jnp.int32(start + i))
        out[f"{key}|tokens"] = np.stack(greedy, axis=1)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            model.loss_fn, has_aux=True))(
            values, {k: put(v) for k, v in batch.items()})
        out[f"{key}|loss"] = np.asarray(loss)
        for i, g in enumerate(port_leaves(cfg, grads)):
            out[f"{key}|grad{i}"] = g
        return out

    # the cases compile in parallel (XLA compiles each on one thread)
    res = {}
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for got in pool.map(lambda c: case(*c),
                            [(a, m) for a in ARCHS for m in MESHES]):
            res.update(got)
    np.savez(out, **res)


# ------------------------------------------------------------------ the port
def _rank(rank: int, world: int, store: str, ref_out: str) -> None:
    """The port's side: reads the weights the reference wrote beside
    ``ref_out`` and writes its results there (``.port.npz``)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import roofline, sharding
    from repro_torch.checkpoint import tree_leaves
    from repro_torch.checkpoint.checkpoint import tree_unflatten
    from repro_torch.launch import serve
    from repro_torch.launch.steps import (sync_grads, to_device,
                                          tree_leaves_specs)
    from repro_torch.models import attention
    from repro_torch.models.model import (abstract_params, build_model,
                                          local_batch, shard_params)

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    torch.set_num_threads(1)
    weights = np.load(ref_out + ".weights.npz")

    def mesh_of(shape):
        rep = world // (shape[0] * shape[1])
        m = init_device_mesh("cpu", (rep,) + shape,
                             mesh_dim_names=("rep", "data", "model"))
        return m["data", "model"]

    meshes = {shape: mesh_of(shape) for shape in MESHES}

    @torch.inference_mode()
    def steps(model, params, tokens, media):
        """Prefill and teacher-forced decode logits (B, V) each, and the
        greedy tokens, every row gathered."""
        cfg, ctx = model.cfg, model.ctx
        pre = to_device(local_batch(model, {"tokens": tokens[:, :P],
                                            **(media or {})}), "cpu")
        caches, logits = model.prefill_fn(params, pre)
        start = serve.decode_start(cfg, P)
        caches = serve.pad_caches(caches, start + NEW, cfg)
        caches = serve.lay_out_caches(model, caches, pre, B, start + NEW,
                                      media)
        out = [logits]
        entry = None if ctx is None else ctx.batch_entry(B)
        for i in range(NEW):
            tok = torch.as_tensor(tokens[:, P + i:P + i + 1],
                                  dtype=torch.int64)
            if ctx is not None:
                tok = sharding.shard(tok, ctx.mesh, (entry, None))
            caches, logits = model.decode_fn(params, caches, tok, start + i)
            out.append(logits)
        if ctx is not None:
            out = [ctx.gather(t, (entry, None, None)) for t in out]
        greedy = serve.serve_batch(model, params, tokens[:, :P], NEW, media)
        return np.stack([t[:, 0].numpy() for t in out]), greedy

    def loss_grads(model, params, batch, count=False):
        """(loss, every gradient leaf gathered whole, the count's stats)."""
        params = sharding.tree_map(
            lambda t: t.detach().clone().requires_grad_(True), params)
        local = to_device(local_batch(model, batch), "cpu")
        with roofline.Counter() as fwd:
            loss, _ = model.loss_fn(params, local)
        with roofline.Counter() as bwd:
            loss.backward()
        sync_grads(params, model.ctx, local)
        grads = [t.grad for t in tree_leaves(params)]
        if model.ctx is not None:
            grads = [model.ctx.gather(g, s) for g, s in zip(
                grads, tree_leaves_specs(model.ctx.specs), strict=True)]
        return float(loss), [g.numpy() for g in grads], (fwd.stats(),
                                                          bwd.stats())

    res = {}
    for name in ARCHS + [RING]:
        arch = name.partition("+")[0]
        cfg = _cfg(name)
        tokens, media, batch = inputs(cfg)
        template = abstract_params(cfg, torch.float32)
        n = len(tree_leaves(template))
        full = tree_unflatten(template, [torch.tensor(weights[f"{arch}|{i}"])
                                         for i in range(n)])
        if rank == 0:                     # the one-device runs
            one = build_model(cfg, device="cpu", dtype=torch.float32)
            logits, greedy = steps(one, full, tokens, media)
            res[f"{name}|one|logits"], res[f"{name}|one|tokens"] = \
                logits, greedy
            loss, grads, _ = loss_grads(one, full, batch)
            res[f"{name}|one|loss"] = np.asarray(loss)
            for i, g in enumerate(grads):
                res[f"{name}|one|grad{i}"] = g
            halves = [loss_grads(one, full, {k: v[j:j + B // 2]
                                             for k, v in batch.items()})
                      for j in (0, B // 2)]
            res[f"{name}|halves|loss"] = np.asarray(
                (halves[0][0] + halves[1][0]) / 2)
            for i, (a, b) in enumerate(zip(halves[0][1], halves[1][1])):
                res[f"{name}|halves|grad{i}"] = (a + b) / 2
        for shape, mesh in meshes.items():
            key = f"{name}|{_key(shape)}"
            model = build_model(cfg, device="cpu", dtype=torch.float32,
                                mesh=mesh)
            params = shard_params(model, full)
            res[f"{key}|logits"], res[f"{key}|tokens"] = steps(
                model, params, tokens, media)
            loss, grads, stats = loss_grads(model, params, batch)
            res[f"{key}|loss"] = np.asarray(loss)
            for i, g in enumerate(grads):
                res[f"{key}|grad{i}"] = g
            fwd, bwd = (st["collective_bytes_by_axis"].get("model", {})
                        for st in stats)
            res[f"{key}|model_gather"] = np.asarray(fwd.get("all-gather", 0))
            res[f"{key}|model_sum"] = np.asarray(sum(
                d.get(k, 0) for d in (fwd, bwd)
                for k in ("all-reduce", "reduce-scatter")))
    # the planted fault: qwen's q heads read the next head's kv head
    cfg = _cfg("qwen3-moe-30b-a3b")
    tokens, media, _ = inputs(cfg)
    template = abstract_params(cfg, torch.float32)
    full = tree_unflatten(template, [
        torch.tensor(weights[f"qwen3-moe-30b-a3b|{i}"])
        for i in range(len(tree_leaves(template)))])
    model = build_model(cfg, device="cpu", dtype=torch.float32,
                        mesh=meshes[(1, 4)])
    right = attention.rank_heads

    def shifted(cfg, tp):
        lo, n, _, kv_n = right(cfg, tp)
        g = cfg.num_heads // cfg.num_kv_heads
        return lo, n, (lo + n) % cfg.num_heads // g, kv_n
    attention.rank_heads = shifted
    try:
        res["planted|logits"], _ = steps(model, shard_params(model, full),
                                         tokens, media)
    finally:
        attention.rank_heads = right
    if rank == 0:
        np.savez(ref_out + ".port.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   JAX_PLATFORMS="cpu")
    ref_out, port_out = str(tmp / "ref.npz"), str(tmp / "port.npz")
    ref = subprocess.Popen([sys.executable, __file__, "reference", ref_out],
                           env=ref_env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    procs = [ref]
    try:
        deadline = time.monotonic() + 300
        while not os.path.exists(ref_out + ".weights.npz"):
            assert ref.poll() is None, ref.communicate()[1][-4000:]
            assert time.monotonic() < deadline, "no weights from the reference"
            time.sleep(0.5)
        # the port loads the reference's weights, written in its layout
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "port", str(tmp / "store"),
             ref_out], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
        for p in procs:
            _, err = p.communicate(timeout=900)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return dict(np.load(ref_out)), dict(np.load(ref_out + ".port.npz"))


def _close_leaves(port, key, want_key, n_leaves):
    for i in range(n_leaves):
        got, want = port[f"{key}|grad{i}"], want_key(i)
        scale = float(np.abs(want).max()) or 1.0
        err = float(np.abs(got - want).max())
        assert err <= GRAD_REL * scale, (i, got.shape, err, scale)


def _n_leaves(d, key):
    return sum(1 for k in d if k.startswith(f"{key}|grad"))


PORT_CASES = [(a, m) for a in ARCHS + [RING] for m in MESHES]
REF_CASES = [(a, m) for a in ARCHS for m in MESHES]


def _id(case):
    return f"{case[0]}-{_key(case[1])}"


@pytest.mark.parametrize("case", PORT_CASES, ids=_id)
def test_logits_and_tokens_match_one_device(runs, case):
    _, port = runs
    name, shape = case
    key = f"{name}|{_key(shape)}"
    np.testing.assert_allclose(port[f"{key}|logits"],
                               port[f"{name}|one|logits"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(port[f"{key}|tokens"],
                                  port[f"{name}|one|tokens"])


@pytest.mark.parametrize("case", REF_CASES, ids=_id)
def test_logits_and_tokens_match_reference(runs, case):
    ref, port = runs
    key = f"{case[0]}|{_key(case[1])}"
    np.testing.assert_allclose(port[f"{key}|logits"], ref[f"{key}|logits"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(port[f"{key}|tokens"], ref[f"{key}|tokens"])


@pytest.mark.parametrize("case", PORT_CASES, ids=_id)
def test_loss_and_gradients_match_one_device(runs, case):
    """Every leaf's gradient after ``steps.sync_grads``: a leaf replicated
    over the model axis whose input passed ``ModelAxis.enter`` is summed
    once, not again over the axis, and a model-sharded leaf holds its
    shard's whole gradient."""
    _, port = runs
    name, shape = case
    key = f"{name}|{_key(shape)}"
    one = "halves" if shape[0] > 1 else "one"
    np.testing.assert_allclose(port[f"{key}|loss"], port[f"{name}|{one}|loss"],
                               rtol=RTOL)
    n = _n_leaves(port, key)
    assert n == _n_leaves(port, f"{name}|{one}") > 0
    _close_leaves(port, key, lambda i: port[f"{name}|{one}|grad{i}"], n)


@pytest.mark.parametrize("case", REF_CASES, ids=_id)
def test_loss_and_gradients_match_reference(runs, case):
    ref, port = runs
    key = f"{case[0]}|{_key(case[1])}"
    np.testing.assert_allclose(port[f"{key}|loss"], ref[f"{key}|loss"],
                               rtol=RTOL)
    n = _n_leaves(port, key)
    assert n == _n_leaves(ref, key) > 0
    _close_leaves(port, key, lambda i: ref[f"{key}|grad{i}"], n)


@pytest.mark.parametrize("name", ARCHS + [RING])
def test_train_step_gathers_no_leaf_over_the_model_axis(runs, name):
    """On (1, 2) (no data axis to gather over) the loss makes no
    all-gather on the model axis, and the loss and its backward sum
    partial products over it: no dense leaf is gathered whole, the
    products are split.  (The backward's only model-axis gathers are the
    RG-LRU gates' reduce-scatters' gradients.)"""
    _, port = runs
    key = f"{name}|1x2"
    assert int(port[f"{key}|model_gather"]) == 0
    assert int(port[f"{key}|model_sum"]) > 0


def test_planted_wrong_head_offset_fails(runs):
    """The logits' limit catches q heads that read the wrong kv head (the
    offset of ``rank_heads`` shifted by one head: qwen's smoke config at
    4 model ranks has one q head a rank and two a kv head)."""
    _, port = runs
    got, want = port["planted|logits"], port["qwen3-moe-30b-a3b|one|logits"]
    assert got.shape == want.shape
    assert not np.allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch,m,want", [
    ("qwen3-moe-30b-a3b", 16, [(2 * r, 2, r // 4, 1) for r in range(16)]),
    ("gemma2-27b", 16, [(2 * r, 2, r, 1) for r in range(16)]),
    ("llava-next-mistral-7b", 16, [(2 * r, 2, r // 2, 1) for r in range(16)]),
    ("whisper-large-v3", 4, [(5 * r, 5, 5 * r, 5) for r in range(4)]),
    ("tinyllama-1.1b", 4, [(8 * r, 8, r, 1) for r in range(4)]),
])
def test_rank_heads_at_published_width(arch, m, want):
    """Each rank's q heads and the kv heads they use, at the published
    configs' widths: a local group that differs from the model's where
    the kv heads do not divide the axis (qwen's 2 q heads a rank read one
    of its 4 kv heads at 16 ranks)."""
    from repro_torch import configs
    from repro_torch.models.attention import rank_heads

    class Axis:
        size = m

        def start(self, n):
            return self.rank * n

    cfg = configs.get_config(arch)
    got = []
    for r in range(m):
        axis = Axis()
        axis.rank = r
        got.append(rank_heads(cfg, axis))
    assert got == want


def test_rank_heads_refuses_a_split_it_cannot_make():
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.attention import rank_heads

    class Axis:
        size, rank = 2, 0

        def start(self, n):
            return self.rank * n

    # 12 q heads in groups of 4: a rank's 6 q heads straddle two groups
    cfg = dataclasses.replace(configs.get_smoke_config("tinyllama-1.1b"),
                              num_heads=12, num_kv_heads=3)
    with pytest.raises(ValueError, match="do not split"):
        rank_heads(cfg, Axis())


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        reference(sys.argv[2])
    else:
        import torch.multiprocessing as mp
        mp.spawn(_rank, args=(4, sys.argv[2], sys.argv[3]), nprocs=4)
