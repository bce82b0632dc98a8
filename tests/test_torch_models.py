"""Port parity, the model stack's modules: ``repro_torch.configs`` and
``repro_torch.models.{layers,attention,moe,rwkv6,rglru}`` and ``convert``'s
LM weights, against the JAX package on the same inputs and weights (made
with numpy or carried across).

The reference's MoE runs under ``shard_map`` on a (1, 1) mesh made with
``jax.make_mesh(..., axis_types=(AxisType.Auto,) * 2)``: its own
``make_local_mesh`` raises on jax 0.9 (ROADMAP queue 3).  Tolerances, per
test: configs exact; the float32 modules ``atol=rtol=1e-5`` (the same
float32 operations; XLA's and torch's sin, cos, exp and sums differ in the
last bits), ``atol=rtol=1e-4`` for the rwkv6 and rglru blocks (a chunked
WKV6 and a sequential scan against XLA's chunked WKV6 and associative
scan: the same functions, summed in another order); bf16 to one bf16 ulp
(``atol=rtol=1e-2``); router statistics exact (counts) or ``rtol=1e-6``
(aux loss).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro import configs as r_configs
from repro.models import attention as r_attn
from repro.models import layers as r_layers
from repro.models import moe as r_moe
from repro.models import rglru as r_rglru
from repro.models import rwkv6 as r_rwkv6
from repro.models.layers import split_lp_tree
from repro.models.transformer import init_lm as r_init_lm
from repro.sharding import MeshAxes
from repro_torch import configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import attention, layers, moe, rglru, rwkv6
from repro_torch.models.transformer import init_lm

MESH = jax.make_mesh((1, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
AXES = MeshAxes.for_mesh(MESH)
F32 = dict(atol=1e-5, rtol=1e-5)
REC = dict(atol=1e-4, rtol=1e-4)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32), dtype=dtype)


def _np(x):
    return np.asarray(x.to(torch.float32) if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _values(tree):
    """A reference LP subtree as float32 numpy arrays."""
    vals, _ = split_lp_tree(tree)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), vals)


def _torch_tree(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, dtype) for k, v in tree.items()}
    return _t(tree, torch.float32 if tree.dtype == np.float32
              and dtype == torch.float32 else dtype)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", r_configs.ARCH_IDS)
def test_configs_are_field_equal(arch):
    """Tolerance: none.  ``CONFIG`` and ``SMOKE`` of every architecture."""
    assert configs.ARCH_IDS == r_configs.ARCH_IDS
    for get, r_get in ((configs.get_config, r_configs.get_config),
                       (configs.get_smoke_config, r_configs.get_smoke_config)):
        got, want = get(arch), r_get(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.param_count(), got.active_param_count(),
                [s.name for s in got.shapes()]) == (
            want.param_count(), want.active_param_count(),
            [s.name for s in want.shapes()])


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(dtype):
    """rms_norm, apply_rope, softcap and the activations, float32 math in
    both (rounded back to bf16 for bf16 inputs).  Tolerance 1e-5 (float32),
    one bf16 ulp (bfloat16)."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = F32 if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 40, 4, 16)).astype(np.float32) * 3
    w = rng.standard_normal((16,)).astype(np.float32) * 0.1
    pos = np.broadcast_to(np.arange(40) * 7, (2, 40))
    tx, jx = _t(x, tdt), jnp.asarray(x, jdt)
    np.testing.assert_allclose(
        _np(layers.rms_norm(tx, _t(w), 1e-6)),
        _np(r_layers.rms_norm(jx, jnp.asarray(w), 1e-6)), **tol)
    np.testing.assert_allclose(
        _np(layers.apply_rope(tx, torch.tensor(pos), 1e6)),
        _np(r_layers.apply_rope(jx, jnp.asarray(pos), 1e6)), **tol)
    np.testing.assert_allclose(_np(layers.softcap(tx, 5.0)),
                               _np(r_layers.softcap(jx, 5.0)), **tol)
    assert layers.softcap(tx, 0.0) is tx
    for name in ("silu", "gelu", "relu", "relu2"):
        np.testing.assert_allclose(_np(layers.activation(name)(tx)),
                                   _np(r_layers.activation(name)(jx)), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_reference(dtype):
    """``group_norm`` (the RWKV6 output norm; biased variance, eps 1e-5) on
    inputs with a mean and spread per group.  Tolerance 1e-5 (float32), one
    bf16 ulp (bfloat16)."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = F32 if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 7, 64)) * 3 + 2).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    b = rng.standard_normal((64,)).astype(np.float32)
    got = layers.group_norm(_t(x, tdt), _t(w), _t(b), num_groups=4)
    want = r_layers.group_norm(jnp.asarray(x, jdt), jnp.asarray(w),
                               jnp.asarray(b), num_groups=4)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# ---------------------------------------------------------------- attention
def _attn_case(arch):
    cfg = configs.get_smoke_config(arch)
    p = _values(r_attn.init_attention(jax.random.key(1),
                                      r_configs.get_smoke_config(arch),
                                      dtype=jnp.float32))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    return cfg, p, x


@pytest.mark.parametrize("arch,mask_kind", [("tinyllama-1.1b", "causal"),
                                            ("gemma2-27b", "local"),
                                            ("gemma2-27b", "causal")])
def test_attention_prefill_matches_reference(arch, mask_kind):
    """The port's prefill attention (the flash kernel's plain version) on
    the reference's weights, float32.  gemma2's smoke config has a window
    of 16 and a logit soft-cap.  Tolerance 1e-5."""
    cfg, p, x = _attn_case(arch)
    pos = np.broadcast_to(np.arange(x.shape[1]), x.shape[:2])
    got = attention.attention_forward_kv(
        _torch_tree(p), _t(x), cfg, mask_kind=mask_kind,
        positions=torch.tensor(pos))
    want = jax.jit(lambda p_, x_, pos_: r_attn.attention_forward_kv(
        p_, x_, r_configs.get_smoke_config(arch), mask_kind=mask_kind,
        positions=pos_))(p, jnp.asarray(x), jnp.asarray(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32)


@pytest.mark.parametrize("arch,mask_kind", [("tinyllama-1.1b", "causal"),
                                            ("gemma2-27b", "local")])
def test_attention_decode_matches_reference(arch, mask_kind):
    """One decode step at position 19 over a 24-slot cache, float32; the
    port writes the new row in place.  Tolerance 1e-5."""
    cfg, p, x = _attn_case(arch)
    rng = np.random.default_rng(2)
    shape = (2, 24, cfg.num_kv_heads, cfg.head_dim)
    ck, cv = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    tk, tv = _t(ck), _t(cv)
    got = attention.attention_decode(_torch_tree(p), _t(x[:, :1]), tk, tv, 19,
                                     cfg, mask_kind=mask_kind)
    want = jax.jit(lambda *a: r_attn.attention_decode(
        *a, r_configs.get_smoke_config(arch), mask_kind=mask_kind))(
        p, jnp.asarray(x[:, :1]), jnp.asarray(ck), jnp.asarray(cv),
        jnp.int32(19))
    assert got[1] is tk and got[2] is tv
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32)


# ---------------------------------------------------------------------- moe
def _moe_case(arch, capacity_factor=None, b=2, s=16, seed=0):
    r_cfg = r_configs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    if capacity_factor is not None:
        r_cfg = dataclasses.replace(r_cfg, capacity_factor=capacity_factor)
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    p = _values(r_moe.init_moe(jax.random.key(1), r_cfg, dtype=jnp.float32))
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return cfg, r_cfg, p, x


@pytest.mark.parametrize("case", ["qwen3", "qwen3-dropping", "llama4-shared",
                                  "qwen3-bf16"])
def test_moe_forward_matches_reference(case):
    """``moe_forward`` and its router stats on the reference's weights:
    qwen3's smoke config (no drops, capacity factor 8), the same at capacity
    factor 1.0 with 128 tokens (an expert gets more than its capacity, so
    tokens are dropped and the capacity selection decides which), llama4's
    (top-1 and a shared expert), and qwen3 with bf16 weights and inputs.
    Tolerance 1e-5 (float32) or one bf16 ulp of the output (bfloat16); the
    stats' counts exact, the aux loss ``rtol=1e-6``."""
    arch = "llama4-scout-17b-a16e" if case == "llama4-shared" \
        else "qwen3-moe-30b-a3b"
    cf = 1.0 if case == "qwen3-dropping" else None
    b, s = (2, 64) if case == "qwen3-dropping" else (2, 16)
    cfg, r_cfg, p, x = _moe_case(arch, cf, b, s)
    bf16 = case == "qwen3-bf16"
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 \
        else (torch.float32, jnp.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p)
    jp["router"] = jnp.asarray(p["router"])            # f32, as in init_moe
    tp = _torch_tree(p, tdt)
    tp["router"] = _t(p["router"])
    y, stats = moe.moe_forward(tp, _t(x, tdt), cfg, cfg.act)
    want_y, want_stats = jax.jit(lambda p_, x_: r_moe.moe_forward(
        p_, x_, r_cfg, MESH, AXES, r_cfg.act))(jp, jnp.asarray(x, jdt))
    assert y.dtype == tdt
    tol = dict(atol=1e-2, rtol=1e-2) if bf16 else F32
    np.testing.assert_allclose(_np(y), _np(want_y), **tol)
    np.testing.assert_array_equal(_np(stats["expert_counts"]),
                                  _np(want_stats["expert_counts"]))
    np.testing.assert_allclose(float(stats["aux_loss"]),
                               float(want_stats["aux_loss"]), rtol=1e-6)
    if case == "qwen3-dropping":
        cap = moe._capacity(cfg, b * s)
        assert cap == r_moe._capacity(r_cfg, b * s)
        assert stats["expert_counts"].max() > cap


def test_top_breaks_ties_like_jax():
    """Tolerance: none.  Many equal entries: the port's selection picks the
    same indices in the same order as ``jax.lax.top_k`` (lower index
    first)."""
    rng = np.random.default_rng(0)
    x = rng.integers(-2, 3, (16, 40)).astype(np.float32)
    x[3] = -1.0
    vals, idx = moe._top(torch.tensor(x), 12)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(x), 12)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


# -------------------------------------------------------- rwkv6 and rglru
def _randomized(p, rng, skip=()):
    """Replace the reference init's constant leaves (zeros, ones, -6) with
    random values, so that every term of the block is exercised."""
    out = {}
    for k, a in p.items():
        if k not in skip and np.ptp(a) == 0:
            a = (a + rng.standard_normal(a.shape) * 0.3).astype(np.float32)
        out[k] = a
    return out


def _rwkv_case(seed=0):
    arch = "rwkv6-7b"
    cfg, r_cfg = configs.get_smoke_config(arch), \
        r_configs.get_smoke_config(arch)
    rng = np.random.default_rng(seed)
    tm = _randomized(_values(r_rwkv6.init_time_mix(
        jax.random.key(1), r_cfg, dtype=jnp.float32)), rng)
    tm["w0"] = (-5.0 + rng.standard_normal(tm["w0"].shape)).astype(
        np.float32)
    cm = _randomized(_values(r_rwkv6.init_channel_mix(
        jax.random.key(2), r_cfg, dtype=jnp.float32)), rng)
    x = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    return cfg, r_cfg, tm, cm, x


def test_rwkv6_time_mix_matches_reference():
    """``time_mix_forward`` (prefill: the WKV6 entry point's plain chunked
    version, 37 tokens, a ragged length) and then ``time_mix_step`` (decode
    from the prefill's state and shift), float32 weights carried across
    with the LoRA, decay and bonus terms made non-trivial.  Tolerance
    ``atol=rtol=1e-4``."""
    cfg, r_cfg, tm, _, x = _rwkv_case()
    tp = _torch_tree(tm)
    out, (state, last) = rwkv6.time_mix_forward(tp, _t(x[:, :-1]), cfg)
    want, (w_state, w_last) = jax.jit(lambda p_, x_: r_rwkv6.time_mix_forward(
        p_, x_, r_cfg))(tm, jnp.asarray(x[:, :-1]))
    np.testing.assert_allclose(_np(out), _np(want), **REC)
    np.testing.assert_allclose(_np(state), _np(w_state), **REC)
    np.testing.assert_allclose(_np(last), _np(w_last), **REC)
    out, (state, last) = rwkv6.time_mix_step(tp, _t(x[:, -1:]), state, last,
                                             cfg)
    want, (w_state, w_last) = jax.jit(lambda p_, x_, s_, l_:
                                      r_rwkv6.time_mix_step(
                                          p_, x_, s_, l_, r_cfg))(
        tm, jnp.asarray(x[:, -1:]), w_state, w_last)
    np.testing.assert_allclose(_np(out), _np(want), **REC)
    np.testing.assert_allclose(_np(state), _np(w_state), **REC)
    np.testing.assert_allclose(_np(last), _np(w_last), **REC)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_channel_mix_matches_reference(dtype):
    """``channel_mix_forward`` without and with a decode carry.  Tolerance
    1e-5 (float32) or one bf16 ulp (bfloat16)."""
    cfg, _, _, cm, x = _rwkv_case(seed=1)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = F32 if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    tp = {k: _t(a, torch.float32 if k.startswith("mu") else tdt)
          for k, a in cm.items()}
    jp = {k: jnp.asarray(a, jnp.float32 if k.startswith("mu") else jdt)
          for k, a in cm.items()}
    for prev in (None, x[:, 0]):
        got = rwkv6.channel_mix_forward(
            tp, _t(x, tdt), None if prev is None else _t(prev, tdt))
        want = r_rwkv6.channel_mix_forward(
            jp, jnp.asarray(x, jdt),
            None if prev is None else jnp.asarray(prev, jdt))
        assert got[0].dtype == tdt
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(w), **tol)


def test_rglru_block_matches_reference():
    """``rglru_block_forward`` on recurrentgemma's smoke config, float32
    weights carried across (conv, gate biases and the decay made
    non-trivial): a 29-token prefill (the scan entry point's plain
    version), a decode step from its state (plain ``h = a h0 + b``), and a
    multi-token run from a state (h0 folded into the first step).  The
    gates alone as well.  Tolerance ``atol=rtol=1e-4``."""
    arch = "recurrentgemma-9b"
    cfg, r_cfg = configs.get_smoke_config(arch), \
        r_configs.get_smoke_config(arch)
    rng = np.random.default_rng(3)
    p = _randomized(_values(r_rglru.init_rglru_block(
        jax.random.key(1), r_cfg, dtype=jnp.float32)), rng)
    tp = _torch_tree(p)
    x = rng.standard_normal((2, 36, cfg.d_model)).astype(np.float32)
    fwd = jax.jit(lambda p_, x_, st: r_rglru.rglru_block_forward(
        p_, x_, r_cfg, state=st))
    got = rglru.rglru_block_forward(tp, _t(x[:, :29]), cfg)
    want = fwd(p, jnp.asarray(x[:, :29]), None)
    for g, w in zip((got[0],) + got[1], (want[0],) + tuple(want[1])):
        np.testing.assert_allclose(_np(g), _np(w), **REC)
    for lo, hi in ((29, 30), (30, 36)):
        got = rglru.rglru_block_forward(tp, _t(x[:, lo:hi]), cfg,
                                        state=got[1])
        want = fwd(p, jnp.asarray(x[:, lo:hi]), tuple(want[1]))
        for g, w in zip((got[0],) + got[1], (want[0],) + tuple(want[1])):
            np.testing.assert_allclose(_np(g), _np(w), **REC)
    y = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    log_a, b = rglru._gates(tp, _t(y), cfg)
    want_a, want_b = r_rglru._gates(p, jnp.asarray(y), r_cfg)
    np.testing.assert_allclose(_np(torch.exp(log_a)), _np(want_a), **F32)
    np.testing.assert_allclose(_np(b), _np(want_b), **F32)


# ------------------------------------------------------------------ convert
@pytest.fixture(scope="module")
def qwen_values():
    cfg = r_configs.get_smoke_config("qwen3-moe-30b-a3b")
    vals, _ = split_lp_tree(r_init_lm(jax.random.key(0), cfg))
    return jax.tree.map(np.asarray, vals)


def test_lm_params_from_reference_copies_every_layer(qwen_values):
    """Tolerance: none.  Each layer's block is the reference's scan slice,
    in bf16 and the reference's layouts; the port's own init draws the same
    shapes, dtypes and spreads (truncated normal, std within 10%)."""
    cfg = configs.get_smoke_config("qwen3-moe-30b-a3b")
    params = lm_params_from_reference(qwen_values, cfg)
    assert len(params["blocks"]) == cfg.num_layers
    for layer, block in enumerate(params["blocks"]):
        np.testing.assert_array_equal(
            _np(block["moe"]["w_gate"]),
            np.asarray(qwen_values["scan"]["b0"]["moe"]["w_gate"][layer],
                       np.float32))
        assert block["attn"]["w_q"].dtype == torch.bfloat16
        assert block["moe"]["router"].dtype == torch.float32
    own = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")

    def walk(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                walk(x, y)
        else:
            assert a.shape == b.shape and a.dtype == b.dtype
            sa, sb = a.float().std().item(), b.float().std().item()
            assert sa == sb == 0.0 or abs(sa / sb - 1) < 0.1, (sa, sb)

    walk(own, params)


def test_lm_params_from_reference_rejects_bad_trees(qwen_values):
    """A wrong shape, an unknown key, a missing key and a wrong period axis
    each raise."""
    cfg = configs.get_smoke_config("qwen3-moe-30b-a3b")

    def edited(fn):
        tree = jax.tree.map(lambda a: a, qwen_values)
        fn(tree)
        return tree

    bad = [
        edited(lambda t: t["scan"]["b0"]["attn"].__setitem__(
            "w_q", t["scan"]["b0"]["attn"]["w_q"][..., :8])),
        edited(lambda t: t["scan"]["b0"]["moe"].__setitem__(
            "w_extra", t["scan"]["b0"]["moe"]["w_up"])),
        edited(lambda t: t.pop("lm_head")),
        edited(lambda t: t.__setitem__("pos_embed", t["embed"])),
        edited(lambda t: t["scan"]["b0"].__setitem__(
            "norm_mlp", t["scan"]["b0"]["norm_mlp"][:1])),
    ]
    for tree in bad:
        with pytest.raises(ValueError):
            lm_params_from_reference(tree, cfg)


def test_run_stack_stats_match_reference(qwen_values):
    """The whole stack's router stats, float32 weights carried across: the
    aux loss summed over layers (``rtol=1e-6``) and the expert counts one
    row per layer (exact), as the reference's scan stacks them."""
    from repro.models.transformer import Ctx, run_stack as r_run_stack
    from repro_torch.models.transformer import run_stack
    r_cfg = r_configs.get_smoke_config("qwen3-moe-30b-a3b")
    cfg = configs.get_smoke_config("qwen3-moe-30b-a3b")
    values = jax.tree.map(lambda a: np.asarray(a, np.float32), qwen_values)
    params = lm_params_from_reference(values, cfg)
    params = jax.tree.map(lambda t: t.float(), params)
    x = np.random.default_rng(4).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12))
    _, stats, caches = run_stack(params, _t(x), torch.tensor(pos), cfg,
                                 collect_cache=True)
    _, want, _ = jax.jit(lambda p_, x_, pos_: r_run_stack(
        p_, x_, pos_, Ctx(r_cfg, MESH, AXES), r_cfg.block_pattern,
        r_cfg.num_layers, ()))(values, jnp.asarray(x), jnp.asarray(pos))
    assert len(caches) == cfg.num_layers
    np.testing.assert_array_equal(_np(stats["expert_counts"]),
                                  _np(want["expert_counts"]))
    np.testing.assert_allclose(float(stats["aux_loss"]),
                               float(want["aux_loss"]), rtol=1e-6)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-9b"])
def test_lm_params_from_reference_recurrent_archs(arch):
    """Tolerance: none.  The reference's rwkv6 and recurrentgemma trees
    (recurrentgemma's smoke config: one scanned period and a 2-layer
    ``tail``) carry across unchanged: every leaf of every layer equals the
    reference's scan slice or tail block, with the port's own init's keys,
    shapes and dtypes."""
    r_cfg = r_configs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    vals, _ = split_lp_tree(r_init_lm(jax.random.key(0), r_cfg))
    vals = jax.tree.map(np.asarray, vals)
    n_periods = cfg.num_layers // cfg.pattern_period
    assert ("tail" in vals) == (arch == "recurrentgemma-9b")
    params = lm_params_from_reference(vals, cfg)
    own = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert len(params["blocks"]) == cfg.num_layers
    for layer, (block, own_block) in enumerate(zip(params["blocks"],
                                                   own["blocks"])):
        if layer < n_periods * cfg.pattern_period:
            p, i = divmod(layer, cfg.pattern_period)
            want = jax.tree.map(lambda a: a[p], vals["scan"][f"b{i}"])
        else:
            want = vals["tail"][f"t{layer - n_periods * cfg.pattern_period}"]
        got_leaves = jax.tree_util.tree_leaves_with_path(block)
        want_leaves = dict(jax.tree_util.tree_leaves_with_path(want))
        own_leaves = dict(jax.tree_util.tree_leaves_with_path(own_block))
        assert len(got_leaves) == len(want_leaves) == len(own_leaves)
        for path, leaf in got_leaves:
            np.testing.assert_array_equal(_np(leaf), _np(want_leaves[path]))
            assert leaf.shape == own_leaves[path].shape
            assert leaf.dtype == own_leaves[path].dtype
