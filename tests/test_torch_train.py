"""Port parity, the training path: ``repro_torch``'s schedule, data
pipeline, loss and its gradients, train step, trainer and expert
re-placement against the JAX package's, on the CPU, where the kernels run
their plain versions (autograd differentiates them).

The reference is built on a (1, 1) mesh made with ``jax.make_mesh(...,
axis_types=(AxisType.Auto,) * 2)`` (its own ``make_local_mesh`` raises on
jax 0.9, ROADMAP queue 3) and jitted once per arch; its float32 smoke-config
weights are carried across with ``convert.lm_params_from_reference``; token
and target batches come from numpy seeds.  Tolerances, float32 throughout:
- the schedule and the data pipeline: bit for bit;
- the loss and its metrics: ``rtol=1e-5``; every gradient leaf within 1e-4
  of its largest |value| (both sides differentiate the same float32
  arithmetic; sums run in another order);
- five train steps: losses ``rtol=1e-5``, final params within 1e-4 of each
  leaf's largest |value|;
- what the port alone must keep equal (chunked cross-entropy, the remat
  policies, a restarted run, a re-placed model): as stated at each test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro import configs as r_configs
from repro.data.pipeline import make_batch as r_make_batch
from repro.launch.steps import make_train_step as r_make_train_step
from repro.models.layers import split_lp_tree
from repro.models.model import build_model as r_build_model
from repro.optim import adamw_init as r_adamw_init
from repro.optim.schedule import warmup_cosine as r_warmup_cosine
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager, tree_leaves
from repro_torch.convert import lm_params_from_reference
from repro_torch.data.pipeline import SyntheticLMData, make_batch
from repro_torch.launch import train
from repro_torch.launch.steps import (make_optimizer, make_train_step,
                                      to_device)
from repro_torch.models.model import build_model
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime.fault import FaultInjector, run_with_restarts

MESH = jax.make_mesh((1, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
# every decoder arch the port serves
ARCHS = ["qwen3-moe-30b-a3b", "tinyllama-1.1b", "llama3.2-3b", "smollm-360m",
         "gemma2-27b", "llama4-scout-17b-a16e", "rwkv6-7b",
         "recurrentgemma-9b"]
B, S = 2, 24


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    targets = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    targets[0, :3] = -1                       # masked targets
    return {"tokens": tokens, "targets": targets}


def _reference(arch):
    r_model = r_build_model(r_configs.get_smoke_config(arch), MESH)
    values, _ = split_lp_tree(r_model.init(jax.random.key(0)))
    return r_model, jax.tree.map(lambda a: a.astype(jnp.float32), values)


def _port(arch, values, cfg=None):
    cfg = cfg or configs.get_smoke_config(arch)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    params = lm_params_from_reference(jax.tree.map(np.asarray, values), cfg)
    return model, params


def _grads(model, params, batch):
    """(loss, metrics, gradient leaves) of the port's loss."""
    params = jax.tree.map(lambda t: t.clone().requires_grad_(True), params)
    loss, metrics = model.loss_fn(params, to_device(batch, "cpu"))
    loss.backward()
    return loss.detach(), metrics, [t.grad for t in tree_leaves(params)]


def _close_leaves(got, want, rel):
    """Every leaf within ``rel`` of the reference leaf's largest |value|."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = torch.as_tensor(np.asarray(w))
        scale = float(w.abs().max()) or 1.0
        err = float((g.detach() - w).abs().max())
        assert err <= rel * scale, (i, tuple(w.shape), err, scale)


# ------------------------------------------------------------- exact copies
@pytest.mark.parametrize("lr,warmup,total", [(3e-4, 10, 100), (1e-2, 3, 30),
                                             (3e-4, 1, 10), (2.5e-3, 0, 40),
                                             (1e-3, 7, 7)])
def test_warmup_cosine_is_the_reference_bit_for_bit(lr, warmup, total):
    """The learning rate at steps 0 to total + 5 equals the reference's
    schedule (called on an int32 step, as jnp evaluates it op by op) bit
    for bit."""
    ref, got = r_warmup_cosine(lr, warmup, total), warmup_cosine(lr, warmup,
                                                                 total)
    want = np.array([np.float32(ref(jnp.int32(n)))
                     for n in range(total + 6)])
    have = np.array([got(n) for n in range(total + 6)], np.float32)
    np.testing.assert_array_equal(have.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "gemma2-27b"])
@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (11, 40)])
def test_make_batch_is_the_reference_bit_for_bit(arch, seed, step):
    """Tokens and targets equal the reference's for several (seed, step)
    pairs; the document-length draw too."""
    cfg = configs.get_smoke_config(arch)
    r_cfg = r_configs.get_smoke_config(arch)
    got = make_batch(cfg, 48, 3, step, seed=seed)
    want = r_make_batch(r_cfg, 48, 3, step, seed=seed)
    assert set(got) == set(want) == {"tokens", "targets"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    from repro.data.pipeline import SyntheticLMData as RData
    rng_a, rng_b = (np.random.default_rng(seed) for _ in range(2))
    np.testing.assert_array_equal(
        SyntheticLMData(cfg.vocab_size, 48, 3).doc_lengths(rng_a),
        RData(cfg.vocab_size, 48, 3).doc_lengths(rng_b))


# ------------------------------------------------------- loss and gradients
@pytest.fixture(scope="module", params=ARCHS)
def loss_pair(request):
    """(arch, the reference's loss, metrics and gradients, the port's model
    and params) on one float32 batch, the reference jitted once."""
    arch = request.param
    r_model, values = _reference(arch)
    model, params = _port(arch, values)
    batch = _batch(model.cfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        r_model.loss_fn, has_aux=True))(
        values, jax.tree.map(jnp.asarray, batch))
    return arch, (loss, metrics, grads), model, params, batch


def test_lm_loss_and_gradients_match_reference(loss_pair):
    """The loss, ``ce_loss``, ``tokens`` and (MoE) ``moe_aux_loss`` and
    ``expert_counts`` (periods, E) within ``rtol=1e-5``; every gradient
    leaf within 1e-4 of its largest |value|."""
    arch, (r_loss, r_metrics, r_grads), model, params, batch = loss_pair
    loss, metrics, grads = _grads(model, params, batch)
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-5)
    assert set(metrics) == set(r_metrics)
    for k, want in r_metrics.items():
        got = metrics[k].detach().numpy()
        assert got.shape == np.shape(want), k
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   err_msg=k)
    if model.cfg.is_moe:
        periods = model.cfg.num_layers // model.cfg.pattern_period
        assert metrics["expert_counts"].shape == (periods,
                                                  model.cfg.num_experts)
    want = tree_leaves(lm_params_from_reference(
        jax.tree.map(np.asarray, r_grads), model.cfg))
    _close_leaves(grads, want, 1e-4)


@pytest.mark.parametrize("chunk", [5, 8])
def test_chunked_cross_entropy_equals_whole(chunk):
    """``ce_chunk > 0`` (chunks that divide the sequence and one that does
    not) gives the loss and gradients of ``ce_chunk = 0``: the same terms
    summed in another order, so ``rtol=1e-6`` on the loss and 1e-6 of each
    leaf's largest |value|."""
    arch = "gemma2-27b"               # tied head and a final soft-cap
    _, values = _reference(arch)
    cfg = configs.get_smoke_config(arch)
    model, params = _port(arch, values)
    whole = _grads(model, params, _batch(cfg))
    cut = dataclasses.replace(cfg, ce_chunk=chunk)
    model_c, params_c = _port(arch, values, cut)
    chunked = _grads(model_c, params_c, _batch(cfg))
    np.testing.assert_allclose(float(chunked[0]), float(whole[0]), rtol=1e-6)
    assert int(chunked[1]["tokens"]) == int(whole[1]["tokens"]) == B * S - 3
    _close_leaves(chunked[2], whole[2], 1e-6)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "recurrentgemma-9b"])
def test_remat_policies_give_equal_gradients(arch):
    """``remat`` full, ``dots`` and ``none``, and ``remat=False``, give the
    same loss and gradients bit for bit: a recomputed period repeats the
    same CPU arithmetic.  recurrentgemma's period has three blocks and a
    tail outside it."""
    _, values = _reference(arch)
    cfg = configs.get_smoke_config(arch)
    runs = []
    for remat, policy in ((True, "full"), (True, "dots"), (True, "none"),
                          (False, "full")):
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        model, params = _port(arch, values, c)
        runs.append(_grads(model, params, _batch(cfg)))
    for loss, _, grads in runs[1:]:
        assert float(loss) == float(runs[0][0])
        for g, g0 in zip(grads, runs[0][2]):
            assert torch.equal(g, g0)


# --------------------------------------------------------------- train step
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "tinyllama-1.1b"])
def test_train_step_matches_reference_over_five_steps(arch):
    """Five steps of the port's ``make_train_step`` and of the reference's
    from the same weights (the trainer's lr 3e-4, warm-up 2 of 5, weight
    decay 0.1): losses within ``rtol=1e-5``, final params within 1e-4 of
    each leaf's largest |value|.  (AdamW moves an element by about lr a
    step whatever its gradient's size, so where a gradient is near 0 the
    two sides' rounding decides the step's sign: the params' tolerance
    scales with lr, and at lr 1e-2 it would be 30 times this one.)"""
    r_model, values = _reference(arch)
    cfg = configs.get_smoke_config(arch)
    r_step = jax.jit(r_make_train_step(r_model, lr=3e-4, warmup_steps=2,
                                       total_steps=5))
    r_params, r_opt = values, r_adamw_init(values)
    model, params = _port(arch, values)
    opt = make_optimizer(params, lr=3e-4, warmup_steps=2, total_steps=5)
    step = make_train_step(model)
    for i in range(5):
        batch = make_batch(cfg, 32, 2, i)
        r_params, r_opt, r_m = r_step(r_params, r_opt,
                                      jax.tree.map(jnp.asarray, batch))
        m = step(params, opt, batch)
        np.testing.assert_allclose(float(m["loss"]), float(r_m["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")
    want = tree_leaves(lm_params_from_reference(
        jax.tree.map(np.asarray, r_params), cfg))
    _close_leaves(tree_leaves(params), want, 1e-4)
    assert opt.steps == 5 == int(r_opt.step)


def test_moe_training_reduces_loss_and_reports_stats():
    """The port of ``tests/test_system.py:30`` (which fails on the reference
    under jax 0.9): smoke qwen, 30 steps at lr 1e-2 with 3 warm-up steps,
    the mean of the last five losses 0.1 below the first five's; the
    expert counts (periods, E) count every token top_k times a period."""
    cfg = configs.get_smoke_config("qwen3-moe-30b-a3b")
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(0))
    opt = make_optimizer(params, lr=1e-2, warmup_steps=3, total_steps=30)
    step = make_train_step(model)
    losses = []
    for i in range(30):
        m = step(params, opt, make_batch(cfg, 64, 4, i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses
    counts = m["expert_counts"].numpy()
    assert counts.shape == (cfg.num_layers, cfg.num_experts)
    assert counts.sum() == cfg.num_layers * 4 * 64 * cfg.top_k


# ------------------------------------------------------------------ trainer
def test_train_loop_reduces_loss(tmp_path):
    """The port of ``tests/test_system.py:21``: tinyllama smoke, 40 steps
    of ``train_loop`` at lr 3e-3, the last five losses 0.2 below the first
    five's; the log holds a time and launch counts (all 0: no kernel runs
    on the CPU) for every step.  The run starts from the reference's seed-0
    weights (bf16, as its trainer inits them), handed over as a step-0
    checkpoint with zero moments: the 0.2 is a property of that start (the
    reference's own run drops 0.34 from it; the port's seed-0 weights, drawn
    by torch, drop 0.16, and its seed 1 0.32)."""
    cfg = configs.get_smoke_config("tinyllama-1.1b")
    r_model = r_build_model(r_configs.get_smoke_config("tinyllama-1.1b"),
                            MESH)
    values, _ = split_lp_tree(r_model.init(jax.random.key(0)))
    params = lm_params_from_reference(jax.tree.map(np.asarray, values), cfg)
    opt0 = make_optimizer(params)
    CheckpointManager(tmp_path, async_write=False).save(
        0, (params, opt0.state_leaves()))
    log = train.TrainLog()
    _, opt, losses = train.train_loop(cfg, steps=40, seq_len=64,
                                      global_batch=4, lr=3e-3, log_every=100,
                                      device="cpu", log=log,
                                      ckpt_dir=str(tmp_path), ckpt_every=100)
    assert log.restored_from == [0]
    assert len(losses) == 40 and opt.steps == 40
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses
    assert log.steps == list(range(40)) and len(log.step_s) == 40
    assert all(n == 0 for rec in log.launches for n in rec.values())


def test_restart_reproduces_uninterrupted_run(tmp_path):
    """A run killed at step 5 (after the step-3 checkpoint) and restarted
    by ``run_with_restarts`` restores step 3 and reproduces the
    uninterrupted run's losses from there bit for bit (deterministic data,
    atomic checkpoints of params and AdamW state, CPU arithmetic)."""
    cfg = configs.get_smoke_config("qwen3-moe-30b-a3b")
    common = dict(steps=9, seq_len=32, global_batch=2, ckpt_every=3,
                  log_every=100, seed=0, device="cpu")
    _, _, ref_losses = train.train_loop(cfg, ckpt_dir=str(tmp_path / "ref"),
                                        **common)
    inj = FaultInjector(fail_at_steps=(5,))
    log = train.TrainLog()
    parts = []

    def once():
        parts.append(train.train_loop(cfg, ckpt_dir=str(tmp_path / "ft"),
                                      fault=inj, log=log, **common)[2])

    stats = run_with_restarts(once)
    assert stats.completed and stats.restarts == 1
    assert log.restored_from == [3]
    np.testing.assert_array_equal(parts[-1], ref_losses[3:])


def test_train_main_on_cpu(tmp_path, capsys):
    """The CLI trains smoke qwen on the CPU with a re-placement on 4 expert
    ranks and checkpoints."""
    train.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu",
                "--steps", "6", "--seq-len", "32", "--global-batch", "2",
                "--rebalance-every", "3", "--expert-ranks", "4",
                "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"])
    out = capsys.readouterr().out
    assert "[train] done: restarts=0" in out
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000003", "step_00000006"]


# ------------------------------------------------------------ re-placement
def _trained(steps=3):
    """Smoke qwen in float32 after a few steps (the moments are not 0), its
    optimizer, step function and config."""
    cfg = configs.get_smoke_config("qwen3-moe-30b-a3b")
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(0))
    opt = make_optimizer(params, lr=1e-2, warmup_steps=1, total_steps=10)
    step = make_train_step(model)
    for i in range(steps):
        step(params, opt, make_batch(cfg, 32, 2, i))
    return model, params, opt, step


def _copy(params, opt):
    """A deep copy of params and optimizer (the moments follow the copied
    params)."""
    new = jax.tree.map(lambda t: t.detach().clone(), params)
    new_opt = make_optimizer(new, lr=1e-2, warmup_steps=1, total_steps=10)
    new_opt.load_state_leaves([t.clone() for t in opt.state_leaves()])
    return new, new_opt


def _perms(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(cfg.num_experts)
                     for _ in range(cfg.num_layers)])


def _loss(model, params, batch):
    with torch.no_grad():
        return float(model.loss_fn(params, to_device(batch, "cpu"))[0])


def test_replacement_preserves_the_loss():
    """Permuting the experts and the router's columns is function
    preserving: the loss after equals the loss before to ``rtol=1e-6``
    (the expert sums into each token run in another order)."""
    model, params, opt, _ = _trained()
    batch = make_batch(model.cfg, 32, 2, 7)
    before = _loss(model, params, batch)
    train.permute_experts(params, opt, _perms(model.cfg), model.cfg)
    np.testing.assert_allclose(_loss(model, params, batch), before,
                               rtol=1e-6)


def _permuted_after_step(moments: bool):
    """(one step on the permuted model and optimizer, the permuted result
    of one step on the unpermuted model), params as leaf lists; the
    permutation moves AdamW's moments only when ``moments``."""
    model, params, opt, step = _trained()
    cfg = model.cfg
    perms = _perms(cfg)
    batch = make_batch(cfg, 32, 2, 3)
    a, opt_a = _copy(params, opt)
    train.permute_experts(a, opt_a if moments else None, perms, cfg)
    step(a, opt_a, batch)
    b, opt_b = _copy(params, opt)
    step(b, opt_b, batch)
    train.permute_experts(b, opt_b, perms, cfg)
    return ([t.detach() for t in tree_leaves(a)],
            [t.detach() for t in tree_leaves(b)])


def test_step_after_replacement_commutes_with_the_permutation():
    """One step after permuting params and AdamW's moments equals the
    permuted result of one step on the unpermuted model: every leaf within
    1e-5 of its largest |value| (only sums run in another order)."""
    got, want = _permuted_after_step(moments=True)
    _close_leaves(got, [w.numpy() for w in want], 1e-5)


def test_reference_fault_unpermuted_moments_change_the_step():
    """The reference's fault, pinned (ROADMAP queue 3): permuting the
    params alone, as ``repro/launch/train.py:104-116`` does, leaves each
    slot with another expert's moments, and the next step's expert weights
    then differ from the permuted unpermuted step by far more than the
    1e-5 the test above holds (more than 1e-3 of their largest |value|)."""
    got, want = _permuted_after_step(moments=False)
    worst = max(float((g - w).abs().max() / w.abs().max())
                for g, w in zip(got, want) if g.dim() == 3)
    assert worst > 1e-3, worst


def test_train_loop_replaces_experts_on_four_ranks():
    """``rebalance_every`` with ``expert_ranks=4``: the loop plans on the
    router counts every 4 steps and logs each re-placement's imbalance
    before and after (no pair-kernel launch on the CPU)."""
    cfg = configs.get_smoke_config("qwen3-moe-30b-a3b")
    log = train.TrainLog()
    train.train_loop(cfg, steps=8, seq_len=32, global_batch=2, lr=1e-2,
                     rebalance_every=4, expert_ranks=4, log_every=100,
                     device="cpu", log=log)
    assert [r["step"] for r in log.replacements] == [4, 8]
    for rec in log.replacements:
        assert rec["imbalance_before"] >= 0 and rec["pair_launches"] == 0
