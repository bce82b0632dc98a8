"""Port parity, the vision front end (``llava-smoke``): ``repro_torch``'s
decoder LM with ``media_embed`` patch embeddings prepended to the prompt,
its loss over padded targets, its serving through ``launch/serve.py``
(decode positions offset by the media) and its ``make_batch`` branch,
against the JAX package's on the same weights (the reference's init,
carried across with ``convert.lm_params_from_reference``) and the same
embeddings and tokens (numpy), on the CPU, where the flash kernel runs its
plain version.

The reference is built on a (1, 1) mesh made with ``jax.make_mesh(...,
axis_types=(AxisType.Auto,) * 2)`` (ROADMAP queue 3).  Tolerances:
- float32 weights: logits and the loss ``rtol=atol=1e-4`` (the loss
  ``rtol=1e-5``); gradient leaves within 1e-4 of their largest |value|;
  greedy tokens identical;
- bf16 weights: the serving contract (normalised log-probs within
  ``atol=0.07, rtol=0.05``, argmax equal) against the reference's float32
  run on the same (bf16-valued) weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro import configs as r_configs
from repro.data.pipeline import make_batch as r_make_batch
from repro.launch.serve import pad_caches as r_pad_caches
from repro.launch.serve import serve_batch as r_serve_batch
from repro.models.layers import split_lp_tree
from repro.models.model import build_model as r_build_model
from repro_torch import configs
from repro_torch.checkpoint import tree_leaves
from repro_torch.convert import lm_params_from_reference
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.serve import pad_caches, serve_batch
from repro_torch.models.model import build_model

MESH = jax.make_mesh((1, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
ARCH = "llava-next-mistral-7b"
B, PROMPT, EXTRA = 2, 12, 4


def _contract(got, want):
    """The serving contract on (B, V) logits."""
    got = got - got.max(-1, keepdims=True)
    want = want - want.max(-1, keepdims=True)
    np.testing.assert_allclose(got, want, atol=0.07, rtol=0.05)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.fixture(scope="module")
def pair():
    """(reference model, its native (bf16) weights, the media embeddings
    (B, P_media, d) float32, tokens (B, PROMPT + EXTRA))."""
    r_model = r_build_model(r_configs.get_smoke_config(ARCH), MESH)
    values, _ = split_lp_tree(r_model.init(jax.random.key(0)))
    cfg = configs.get_smoke_config(ARCH)
    rng = np.random.default_rng(0)
    media = (rng.standard_normal((B, cfg.num_media_positions, cfg.d_model))
             * 0.1).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size,
                          (B, PROMPT + EXTRA)).astype(np.int32)
    return r_model, values, media, tokens


def _f32(values):
    return jax.tree.map(lambda a: a.astype(jnp.float32), values)


def _port(values, dtype):
    cfg = configs.get_smoke_config(ARCH)
    model = build_model(cfg, device="cpu", dtype=dtype)
    return model, lm_params_from_reference(jax.tree.map(np.asarray, values),
                                           cfg)


def _reference_steps(r_model, values, media, tokens):
    """The reference's prefill logits on media + prompt and its
    teacher-forced decode steps' logits (positions after the media)."""
    p_media = r_model.cfg.num_media_positions
    caches, logits = jax.jit(r_model.prefill_fn)(
        values, {"tokens": jnp.asarray(tokens[:, :PROMPT]),
                 "media_embed": jnp.asarray(media)})
    caches = r_pad_caches(caches, p_media + PROMPT + EXTRA)
    out = [np.asarray(logits[:, 0])]
    decode = jax.jit(r_model.decode_fn)
    for i in range(EXTRA):
        caches, logits = decode(values, caches,
                                jnp.asarray(tokens[:, PROMPT + i:][:, :1]),
                                jnp.int32(p_media + PROMPT + i))
        out.append(np.asarray(logits[:, 0]))
    return out


@torch.inference_mode()
def _port_steps(model, params, media, tokens):
    p_media = model.cfg.num_media_positions
    caches, logits = model.prefill_fn(
        params, {"tokens": torch.as_tensor(tokens[:, :PROMPT],
                                           dtype=torch.int64),
                 "media_embed": torch.as_tensor(media)})
    caches = pad_caches(caches, p_media + PROMPT + EXTRA, model.cfg)
    assert caches[0]["k"].shape[1] == p_media + PROMPT + EXTRA
    out = [logits[:, 0].float().numpy()]
    for i in range(EXTRA):
        tok = torch.as_tensor(tokens[:, PROMPT + i:][:, :1], dtype=torch.int64)
        caches, logits = model.decode_fn(params, caches, tok,
                                         p_media + PROMPT + i)
        out.append(logits[:, 0].float().numpy())
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_with_media_match_reference(pair, dtype):
    """Prefill on the media and the prompt, then 4 teacher-forced decode
    steps at positions past the media: float32 ``rtol=atol=1e-4``; bf16
    weights to the serving contract against the reference's float32 run."""
    r_model, values, media, tokens = pair
    want = _reference_steps(r_model, _f32(values), media, tokens)
    if dtype == "float32":
        model, params = _port(_f32(values), torch.float32)
    else:
        model, params = _port(values, torch.bfloat16)
    got = _port_steps(model, params, media, tokens)
    for step, (g, w) in enumerate(zip(got, want)):
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {step}")
        else:
            _contract(g, w)


def test_loss_with_padded_targets_matches_reference(pair):
    """``lm_loss`` with media: the targets padded with -1 over the media
    positions, so ``tokens`` counts only text targets (those >= 0); the
    loss and ``ce_loss`` within ``rtol=1e-5``, every gradient leaf within
    1e-4 of its largest |value|."""
    r_model, values, media, tokens = pair
    values = _f32(values)
    targets = np.random.default_rng(5).integers(
        0, r_model.cfg.vocab_size, tokens.shape).astype(np.int32)
    targets[0, :3] = -1
    (r_loss, r_metrics), r_grads = jax.jit(jax.value_and_grad(
        r_model.loss_fn, has_aux=True))(
        values, {"tokens": jnp.asarray(tokens), "media_embed":
                 jnp.asarray(media), "targets": jnp.asarray(targets)})
    model, params = _port(values, torch.float32)
    leaves = jax.tree.map(lambda t: t.clone().requires_grad_(True), params)
    loss, metrics = model.loss_fn(leaves, {
        "tokens": torch.as_tensor(tokens, dtype=torch.int64),
        "media_embed": torch.as_tensor(media),
        "targets": torch.as_tensor(targets, dtype=torch.int64)})
    loss.backward()
    assert int(metrics["tokens"]) == int(r_metrics["tokens"]) \
        == B * tokens.shape[1] - 3
    np.testing.assert_allclose(float(loss.detach()), float(r_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce_loss"].detach()),
                               float(r_metrics["ce_loss"]), rtol=1e-5)
    want = lm_params_from_reference(jax.tree.map(np.asarray, r_grads),
                                    model.cfg)
    for i, (g, w) in enumerate(zip(tree_leaves(leaves), tree_leaves(want),
                                   strict=True)):
        scale = float(w.abs().max()) or 1.0
        err = float((g.grad - w).abs().max())
        assert err <= 1e-4 * scale, (i, tuple(w.shape), err, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_batch_with_media_matches_reference(pair, dtype):
    """Greedy continuations of 6 new tokens through both ``serve_batch``es
    with ``media={"media_embed": ...}`` (decode positions start after the
    media): identical with float32 weights; with bf16 weights the first
    token (the prefill's argmax, part of the contract) is."""
    r_model, values, media, tokens = pair
    want = np.asarray(r_serve_batch(r_model, _f32(values), tokens[:, :PROMPT],
                                    6, {"media_embed": jnp.asarray(media)}))
    if dtype == "float32":
        model, params = _port(_f32(values), torch.float32)
    else:
        model, params = _port(values, torch.bfloat16)
    got = serve_batch(model, params, tokens[:, :PROMPT], 6,
                      {"media_embed": media})
    assert got.dtype == np.int32 and got.shape == (B, 6)
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got[:, 0], want[:, 0])


def test_decode_matches_full_forward():
    """The port against itself (bf16 weights from its own init): prefill on
    media + prompt plus decode steps reproduces the prefill of the whole
    sequence, to the serving contract."""
    cfg = configs.get_smoke_config(ARCH)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    media = torch.as_tensor(rng.standard_normal(
        (B, cfg.num_media_positions, cfg.d_model)) * 0.1,
        dtype=torch.bfloat16)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (B, PROMPT + EXTRA)))
    p_media = cfg.num_media_positions
    with torch.inference_mode():
        _, full = model.prefill_fn(params, {"media_embed": media,
                                            "tokens": tokens})
        caches, _ = model.prefill_fn(params, {"media_embed": media,
                                              "tokens": tokens[:, :PROMPT]})
        caches = pad_caches(caches, p_media + PROMPT + EXTRA, cfg)
        for i in range(EXTRA):
            caches, logits = model.decode_fn(
                params, caches, tokens[:, PROMPT + i:PROMPT + i + 1],
                p_media + PROMPT + i)
    _contract(logits[:, 0].float().numpy(), full[:, 0].float().numpy())


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5)])
def test_make_batch_is_the_reference_bit_for_bit(seed, step):
    """``media_embed`` (B, P_media, d), ``tokens`` and ``targets`` (B,
    seq_len - P_media) equal the reference's bit for bit."""
    cfg = configs.get_smoke_config(ARCH)
    got = make_batch(cfg, 40, 3, step, seed=seed)
    want = r_make_batch(r_configs.get_smoke_config(ARCH), 40, 3, step,
                        seed=seed)
    assert set(got) == set(want) == {"media_embed", "tokens", "targets"}
    assert got["tokens"].shape == (3, 40 - cfg.num_media_positions)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", [ARCH, "whisper-large-v3"])
def test_train_step_takes_the_front_end_batch(arch):
    """``launch.steps.make_train_step`` on ``make_batch``'s batches of the
    two stub front ends (float32 embeddings beside integer tokens, which
    ``to_device`` keeps apart): three AdamW steps on the CPU, float32
    weights, a finite loss that falls from the first step to the last, and
    the embeddings' gradient reaching the first block."""
    from repro_torch.launch.steps import make_optimizer, make_train_step
    cfg = configs.get_smoke_config(arch)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(0))
    opt = make_optimizer(params, lr=1e-2, warmup_steps=0, total_steps=10)
    step = make_train_step(model)
    batch = make_batch(cfg, 64, 2, 0)
    first = params.get("blocks", params.get("enc_blocks"))[0]
    before = first["attn"]["w_q"].detach().clone()
    losses = [float(step(params, opt, batch)["loss"]) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert not torch.equal(first["attn"]["w_q"].detach(), before)
