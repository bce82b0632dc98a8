"""Port parity, the cost model: ``repro_torch.costmodel`` and
``repro_torch.optim`` against the JAX package's ``repro.costmodel`` and
``repro.optim`` on the same inputs (made with numpy).

Initialisation and dropout draw from a ``torch.Generator`` in the port and
from JAX keys in the reference, so parity is shown with the reference's
weights carried across (``convert.fnn_from_reference``) and, for training,
``dropout=0``.  Tolerances are stated per test; they cover float32
summation order (XLA's matmuls and means against torch's), nothing else.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.assembly import build_problem as r_build_problem
from repro.assembly.execute import analytic_durations as r_analytic
from repro.costmodel import StandardScaler as RScaler
from repro.costmodel import dynamic_data_reduce as r_reduce
from repro.costmodel import losses as r_losses
from repro.costmodel.network import FNNConfig as RFNNConfig
from repro.costmodel.network import fnn_apply, fnn_init
from repro.costmodel.train import CostModel as RCostModel
from repro.costmodel.train import _train_step as r_train_step
from repro.costmodel.train import evaluate_cost_model as r_evaluate
from repro.optim import adamw_init, adamw_update
from repro_torch.assembly import build_problem, run_assembly_comparison
from repro_torch.assembly.execute import analytic_durations
from repro_torch.convert import fnn_from_reference
from repro_torch.costmodel import (StandardScaler, dynamic_data_reduce,
                                   losses, train_cost_model)
from repro_torch.costmodel.network import FNN, FNNConfig, dropout, leaky_relu
from repro_torch.costmodel.train import (CostModel, evaluate_cost_model,
                                         make_optimizer, train_step)
from repro_torch.optim import AdamW

HIDDEN = (32, 32, 32, 32)


def _reference_fnn(seed, in_dim=16, hidden=HIDDEN, dropout_p=0.0):
    """The reference's FNN with a non-trivial batch-norm state, as numpy."""
    cfg = RFNNConfig(in_dim=in_dim, hidden=hidden, dropout=dropout_p)
    params, bn = fnn_init(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    bn = {"layers": [{"mean": jnp.asarray(rng.normal(0, 0.5, h), jnp.float32),
                      "var": jnp.asarray(rng.uniform(0.5, 2.0, h),
                                         jnp.float32)}
                     for h in hidden]}
    return cfg, params, bn


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("seed", [0, 1])
def test_fnn_eval_matches_reference(seed):
    """Tolerance ``rtol=1e-5, atol=1e-5``: eval mode (running statistics),
    weights carried across."""
    cfg, params, bn = _reference_fnn(seed)
    net = fnn_from_reference(_np(params), _np(bn), dataclasses.asdict(cfg))
    x = np.random.default_rng(10 + seed).normal(0, 1, (64, 16)).astype(
        np.float32)
    want, _ = fnn_apply(params, bn, jnp.asarray(x), cfg, train=False)
    with torch.no_grad():
        got = net(torch.tensor(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_training_steps_match_reference():
    """Three AdamW steps with ``dropout=0`` on one batch, weights carried
    across.  Tolerance ``rtol=1e-4`` on the loss of every step, on the
    weights, batch-norm scales and biases and on the running statistics
    (``atol=1e-6`` beside it for entries near zero).  The pre-norm bias
    ``b`` is held to the bound of its step instead: batch norm cancels it,
    so its gradient is rounding noise in both packages, which AdamW's
    normalised step turns into moves of up to ``lr`` in either direction;
    the test checks that it stays within ``3 * lr`` of zero in both.  The
    running mean carries ``b`` (it averages ``x @ w + b``) with weight
    ``1 - momentum = 0.1`` per step, so it is held to ``atol = 0.1 * 3 *
    lr`` on top of ``rtol=1e-4``."""
    cfg, params, bn = _reference_fnn(0)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (128, 16)).astype(np.float32)
    y = rng.normal(-10, 1, 128).astype(np.float32)
    net = fnn_from_reference(_np(params), _np(bn), dataclasses.asdict(cfg))
    opt_t = make_optimizer(net)
    opt = adamw_init(params)
    key = jax.random.key(0)
    for _ in range(3):
        params, bn, opt, loss = r_train_step(params, bn, opt, jnp.asarray(x),
                                             jnp.asarray(y), key, cfg, 0.3)
        got = train_step(net, opt_t, torch.tensor(x), torch.tensor(y), 0.3)
        np.testing.assert_allclose(float(got), float(loss), rtol=1e-4)
    for layer, p, st in zip(net.layers, params["layers"], bn["layers"]):
        for name in ("w", "bn_scale", "bn_bias"):
            np.testing.assert_allclose(getattr(layer, name).detach().numpy(),
                                       np.asarray(p[name]), rtol=1e-4,
                                       atol=1e-6)
        for b in (layer.b.detach().numpy(), np.asarray(p["b"])):
            assert np.abs(b).max() <= 3 * 1e-3
        np.testing.assert_allclose(layer.mean.numpy(), np.asarray(st["mean"]),
                                   rtol=1e-4, atol=0.1 * 3 * 1e-3)
        np.testing.assert_allclose(layer.var.numpy(), np.asarray(st["var"]),
                                   rtol=1e-4, atol=1e-6)
    for name in ("out_w", "out_b"):
        np.testing.assert_allclose(getattr(net, name).detach().numpy(),
                                   np.asarray(params[name]), rtol=1e-4,
                                   atol=1e-6)


def test_running_variance_is_the_biased_one():
    """Tolerance ``rtol=1e-6``: one training forward moves the running
    variance towards the *biased* batch variance (as the reference does,
    and unlike ``torch.nn.BatchNorm1d``)."""
    cfg = FNNConfig(in_dim=3, hidden=(4,), dropout=0.0)
    net = FNN(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.tensor(np.random.default_rng(0).normal(0, 2, (5, 3)),
                     dtype=torch.float32)
    h = (x @ net.layers[0].w + net.layers[0].b).detach()
    net(x, train=True)
    want = 0.9 * 1.0 + (1 - 0.9) * h.var(0, unbiased=False)
    torch.testing.assert_close(net.layers[0].var, want, rtol=1e-6, atol=0)
    assert not torch.allclose(want, 0.9 + 0.1 * h.var(0, unbiased=True))


def test_dropout_keep_rate_and_scale():
    """Tolerance: the keep rate within 5 standard deviations of ``1 - p``
    over 10^5 draws; kept entries are scaled by exactly ``1/(1-p)``."""
    p, n = 0.3, 100_000
    h = torch.full((n,), 2.0)
    out = dropout(h, p, torch.Generator().manual_seed(0))
    kept = out != 0
    rate = kept.float().mean().item()
    assert abs(rate - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n)
    assert torch.equal(out[kept], torch.full_like(out[kept], 2.0 / (1 - p)))


def test_leaky_relu_eq31():
    np.testing.assert_allclose(leaky_relu(torch.tensor([-2.0, 0.0, 3.0])),
                               [-0.02, 0.0, 3.0])


@pytest.mark.parametrize("fn", ["rmse", "mae", "under_penalized_rmse"])
def test_losses_match_reference(fn):
    """Tolerance ``rtol=1e-6`` (float32 means)."""
    rng = np.random.default_rng(0)
    pred = rng.normal(0, 1, 1000).astype(np.float32)
    truth = rng.normal(0, 1, 1000).astype(np.float32)
    want = getattr(r_losses, fn)(jnp.asarray(pred), jnp.asarray(truth))
    got = getattr(losses, fn)(torch.tensor(pred), torch.tensor(truth))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("weight_decay,clip_norm,grad_scale", [
    (0.0, 1.0, 1.0), (1e-4, 1.0, 0.01), (1e-2, 0.0, 1.0)])
def test_adamw_matches_reference(weight_decay, clip_norm, grad_scale):
    """Tolerance ``rtol=1e-6, atol=1e-9`` after five steps on fixed
    gradients, with the global-norm clip active (``grad_scale=1``),
    inactive (``0.01``) and off (``clip_norm=0``)."""
    rng = np.random.default_rng(1)
    shapes = [(5, 3), (3,), (7,)]
    p0 = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(0, 1, s) * grad_scale).astype(np.float32)
              for s in shapes] for _ in range(5)]
    params = [jnp.asarray(a) for a in p0]
    state = adamw_init(params)
    tp = [torch.nn.Parameter(torch.tensor(a)) for a in p0]
    opt = AdamW(tp, 1e-2, weight_decay=weight_decay, clip_norm=clip_norm)
    for g in grads:
        params, state = adamw_update([jnp.asarray(a) for a in g], state,
                                     params, 1e-2, weight_decay=weight_decay,
                                     clip_norm=clip_norm)
        for t, a in zip(tp, g):
            t.grad = torch.tensor(a)
        opt.step()
    for t, want in zip(tp, params):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-9)


def test_scaler_and_reduction_are_bitwise():
    """Tolerance: none (numpy copies, the same ``default_rng`` draws)."""
    rng = np.random.default_rng(0)
    x = rng.normal(5.0, 3.0, (500, 6))
    x[:, 2] = 1.0                                  # a constant column
    np.testing.assert_array_equal(StandardScaler().fit_transform(x),
                                  RScaler().fit_transform(x))
    vals = np.concatenate([rng.uniform(0, 0.1, 900), rng.uniform(0.5, 1, 100)])
    for target, seed in ((300, 0), (650, 3), (2000, 0)):
        np.testing.assert_array_equal(
            dynamic_data_reduce(vals, target, seed=seed),
            r_reduce(vals, target, seed=seed))


def test_predict_and_evaluate_match_reference():
    """Tolerance ``rtol=1e-5``: the same FNN (weights carried across) and
    scaler predict the same durations on assembly features, as float32,
    and the float32 metrics agree to ``rtol=1e-4``."""
    p = r_build_problem(1024, 8, task_limit_u=64)
    feats, durs = p.features(), r_analytic(p)
    aug = np.concatenate([feats, np.log1p(np.abs(feats))], axis=1)
    scaler = RScaler().fit(aug)
    cfg, params, bn = _reference_fnn(0, in_dim=aug.shape[1])
    bn = {"layers": [{"mean": jnp.zeros(h), "var": jnp.ones(h)}
                     for h in HIDDEN]}
    params["out_b"] = jnp.full((1,), -12.0, jnp.float32)
    want_m = RCostModel(cfg, params, bn, scaler)
    net = fnn_from_reference(_np(params), _np(bn), dataclasses.asdict(cfg))
    got_m = CostModel(FNNConfig(**dataclasses.asdict(cfg)), net,
                      StandardScaler(scaler.mean, scaler.std))
    got, want = got_m.predict(feats), want_m.predict(feats)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5)
    e_got, e_want = evaluate_cost_model(got_m, feats, durs), \
        r_evaluate(want_m, feats, durs)
    assert e_got.keys() == e_want.keys()
    for k in e_got:
        np.testing.assert_allclose(e_got[k], e_want[k], rtol=1e-4)


def test_cost_model_in_the_loop():
    """The port's counterpart of the reference's test: train the FNN on one
    configuration (on the CPU), balance another with its predictions.
    Limits as the reference's: rel-err median < 0.3, C <= 1.05 B, and the
    imbalance falls."""
    train_p = build_problem(1536, 8, seed=1, task_limit_u=32)
    feats = train_p.features()
    durs = analytic_durations(train_p)
    noisy = durs * np.random.default_rng(0).lognormal(0, 0.1, durs.shape)
    model, hist = train_cost_model(feats, noisy, epochs=150, batch_size=128,
                                   reduce_to=1600, seed=0, device="cpu")
    assert len(hist["loss"]) == 150 and hist["loss"][-1] < hist["loss"][0]
    assert evaluate_cost_model(model, feats, durs)["rel_err_median"] < 0.3
    run = run_assembly_comparison(n_unknowns=1536, num_ranks=8,
                                  durations="analytic", cost_model=model,
                                  seed=2, task_limit_u=32, device="cpu")
    assert run.durations_pred.dtype == np.float32
    assert run.makespan_ccmlb <= run.makespan_overdecomposed * 1.05
    assert run.imbalance_after < run.imbalance_before
