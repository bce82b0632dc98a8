"""Port parity, the encoder-decoder (``whisper-smoke``): ``repro_torch``'s
``models/encdec.py``, its serving through ``launch/serve.py`` and its
``make_batch`` branch against the JAX package's on the same weights (the
reference's init, carried across with
``convert.encdec_params_from_reference``) and the same frames and tokens
(numpy), on the CPU, where the flash kernel runs its plain version (the
encoder non-causal, the cross-attention non-causal with Sq != Skv).

The reference is built on a (1, 1) mesh made with ``jax.make_mesh(...,
axis_types=(AxisType.Auto,) * 2)`` (its own ``make_local_mesh`` raises on
jax 0.9, ROADMAP queue 3).  Tolerances:
- float32 weights: encoder output, caches, logits and the loss ``rtol=atol=
  1e-4`` (the same float32 arithmetic, sums in another order); gradient
  leaves within 1e-4 of their largest |value|; greedy tokens identical;
- bf16 weights: the serving contract (``tests/test_decode_parity.py``):
  normalised log-probs within ``atol=0.07, rtol=0.05`` and argmax equal,
  against the reference's float32 run on the same (bf16-valued) weights;
- the port against itself (decode against the full forward): the serving
  contract, as ``tests/test_decode_parity.py::test_encdec_decode_
  consistency`` holds the reference.
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
from repro.models import encdec as r_encdec
from repro.models.layers import split_lp_tree
from repro.models.model import build_model as r_build_model
from repro.models.transformer import Ctx
from repro.sharding import MeshAxes
from repro_torch import configs
from repro_torch.checkpoint import tree_leaves
from repro_torch.convert import encdec_params_from_reference
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.serve import pad_caches, serve_batch
from repro_torch.models import encdec
from repro_torch.models.model import build_model

MESH = jax.make_mesh((1, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
ARCH = "whisper-large-v3"
B, FRAMES, PROMPT, EXTRA = 2, 40, 8, 4


def _contract(got, want):
    """The serving contract on (B, V) logits."""
    got = got - got.max(-1, keepdims=True)
    want = want - want.max(-1, keepdims=True)
    np.testing.assert_allclose(got, want, atol=0.07, rtol=0.05)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.fixture(scope="module")
def pair():
    """(reference model, its float32 weights, the port's float32 model and
    weights, frames (B, FRAMES, d) float32, tokens (B, PROMPT + EXTRA))."""
    r_model = r_build_model(r_configs.get_smoke_config(ARCH), MESH)
    values, _ = split_lp_tree(r_model.init(jax.random.key(0)))
    values = jax.tree.map(lambda a: a.astype(jnp.float32), values)
    cfg = configs.get_smoke_config(ARCH)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    params = encdec_params_from_reference(jax.tree.map(np.asarray, values),
                                          cfg)
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((B, FRAMES, cfg.d_model)) * 0.1).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab_size,
                          (B, PROMPT + EXTRA)).astype(np.int32)
    return r_model, values, model, params, audio, tokens


def _r_batch(audio, tokens):
    return {"audio_embed": jnp.asarray(audio), "tokens": jnp.asarray(tokens)}


def _t_batch(audio, tokens):
    return {"audio_embed": torch.as_tensor(audio),
            "tokens": torch.as_tensor(tokens, dtype=torch.int64)}


def test_encoder_output_matches_reference(pair):
    """The encoder stack's normed output (non-causal flash with RoPE)."""
    r_model, values, model, params, audio, _ = pair
    ctx = Ctx(r_model.cfg, MESH, MeshAxes.for_mesh(MESH))
    want = jax.jit(lambda v, a: r_encdec.run_encoder(v, a, r_model.cfg,
                                                     ctx))(
        values, jnp.asarray(audio))
    with torch.inference_mode():
        got = encdec.run_encoder(params, torch.as_tensor(audio), model.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def _reference_steps(r_model, values, audio, tokens):
    """The reference's prefill (caches, logits) on the prompt and its
    teacher-forced decode steps' logits."""
    caches, logits = jax.jit(r_model.prefill_fn)(
        values, _r_batch(audio, tokens[:, :PROMPT]))
    first = jax.tree.map(np.asarray, caches)
    caches = r_pad_caches(caches, PROMPT + EXTRA)
    out = [np.asarray(logits[:, 0])]
    decode = jax.jit(r_model.decode_fn)
    for i in range(EXTRA):
        caches, logits = decode(values, caches,
                                jnp.asarray(tokens[:, PROMPT + i:][:, :1]),
                                jnp.int32(PROMPT + i))
        out.append(np.asarray(logits[:, 0]))
    return first, out


@torch.inference_mode()
def _port_steps(model, params, audio, tokens):
    caches, logits = model.prefill_fn(params,
                                      _t_batch(audio, tokens[:, :PROMPT]))
    first = [{k: v.clone() for k, v in c.items()} for c in caches]
    caches = pad_caches(caches, PROMPT + EXTRA, model.cfg)
    out = [logits[:, 0].float().numpy()]
    for i in range(EXTRA):
        tok = torch.as_tensor(tokens[:, PROMPT + i:][:, :1], dtype=torch.int64)
        caches, logits = model.decode_fn(params, caches, tok, PROMPT + i)
        out.append(logits[:, 0].float().numpy())
    return first, caches, out


def test_prefill_caches_and_decode_match_reference(pair):
    """The prefill's four caches (``sk``, ``sv`` at the prompt's length,
    ``ck``, ``cv`` at the encoder's) and logits, then 4 teacher-forced
    decode steps; the cross caches come out of decode unwritten."""
    r_model, values, model, params, audio, tokens = pair
    r_caches, want = _reference_steps(r_model, values, audio, tokens)
    caches, after, got = _port_steps(model, params, audio, tokens)
    assert len(caches) == model.cfg.num_decoder_layers
    for layer, cache in enumerate(caches):
        assert set(cache) == {"sk", "sv", "ck", "cv"}
        for key, t in cache.items():
            w = r_caches[key][layer]
            assert tuple(t.shape) == w.shape
            np.testing.assert_allclose(t.numpy(), w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"layer {layer} {key}")
        assert after[layer]["ck"].shape[1] == FRAMES
        assert after[layer]["sk"].shape[1] == PROMPT + EXTRA
        assert torch.equal(after[layer]["cv"], cache["cv"])
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {step}")


def test_bf16_decode_meets_the_serving_contract(pair):
    """bf16 weights and frames: prefill and decode logits against the
    reference's float32 run on the same values, to the serving contract."""
    r_model, _, _, _, audio, tokens = pair
    cfg = configs.get_smoke_config(ARCH)
    bf_values, _ = split_lp_tree(r_model.init(jax.random.key(0)))
    audio = np.asarray(jnp.asarray(audio, jnp.bfloat16), np.float32)
    _, want = _reference_steps(
        r_model, jax.tree.map(lambda a: a.astype(jnp.float32), bf_values),
        audio, tokens)
    model = build_model(cfg, device="cpu")
    params = encdec_params_from_reference(
        jax.tree.map(np.asarray, bf_values), cfg)
    _, _, got = _port_steps(model, params, audio, tokens)
    for g, w in zip(got, want):
        _contract(g, w)


def test_bf16_weights_float32_frames_meet_the_serving_contract(pair):
    """bf16 weights and float32 frames, as ``make_batch`` and ``stub_media``
    give them: the port's encoder casts the frames to bf16 and runs in bf16,
    where the reference's promotion runs it in float32.  Prefill and decode
    logits against the reference's float32 run on the same weight values
    and the unrounded frames, to the serving contract."""
    r_model, _, _, _, audio, tokens = pair
    cfg = configs.get_smoke_config(ARCH)
    bf_values, _ = split_lp_tree(r_model.init(jax.random.key(0)))
    _, want = _reference_steps(
        r_model, jax.tree.map(lambda a: a.astype(jnp.float32), bf_values),
        audio, tokens)
    model = build_model(cfg, device="cpu")
    params = encdec_params_from_reference(
        jax.tree.map(np.asarray, bf_values), cfg)
    assert params["embed"].dtype == torch.bfloat16
    _, _, got = _port_steps(model, params, audio, tokens)
    for g, w in zip(got, want):
        _contract(g, w)


def test_encdec_loss_and_gradients_match_reference(pair):
    """``encdec_loss`` on a batch with masked targets: the loss, ``ce_loss``
    and ``tokens`` within ``rtol=1e-5``; every gradient leaf within 1e-4 of
    its largest |value|."""
    r_model, values, model, params, audio, tokens = pair
    targets = np.random.default_rng(5).integers(
        0, model.cfg.vocab_size, tokens.shape).astype(np.int32)
    targets[0, :3] = -1
    (r_loss, r_metrics), r_grads = jax.jit(jax.value_and_grad(
        r_model.loss_fn, has_aux=True))(
        values, {**_r_batch(audio, tokens), "targets": jnp.asarray(targets)})
    leaves = jax.tree.map(lambda t: t.clone().requires_grad_(True), params)
    batch = {**_t_batch(audio, tokens),
             "targets": torch.as_tensor(targets, dtype=torch.int64)}
    loss, metrics = model.loss_fn(leaves, batch)
    loss.backward()
    loss, metrics = loss.detach(), {k: v.detach() for k, v in metrics.items()}
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce_loss"]),
                               float(r_metrics["ce_loss"]), rtol=1e-5)
    assert int(metrics["tokens"]) == int(r_metrics["tokens"])
    want = encdec_params_from_reference(jax.tree.map(np.asarray, r_grads),
                                        model.cfg)
    got = tree_leaves(leaves)
    for i, (g, w) in enumerate(zip(got, tree_leaves(want), strict=True)):
        scale = float(w.abs().max()) or 1.0
        err = float((g.grad - w).abs().max())
        assert err <= 1e-4 * scale, (i, tuple(w.shape), err, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_batch_matches_reference(pair, dtype):
    """Greedy continuations of 6 new tokens through both ``serve_batch``es
    with ``media={"audio_embed": ...}``: identical with float32 weights;
    with bf16 weights the first token (the argmax of the prefill logits,
    part of the serving contract) is."""
    r_model, values, _, _, audio, tokens = pair
    cfg = configs.get_smoke_config(ARCH)
    if dtype == "bfloat16":
        values, _ = split_lp_tree(r_model.init(jax.random.key(0)))
        audio = np.asarray(jnp.asarray(audio, jnp.bfloat16), np.float32)
    model = build_model(cfg, device="cpu", dtype=getattr(torch, dtype))
    params = encdec_params_from_reference(jax.tree.map(np.asarray, values),
                                          cfg)
    prompts = tokens[:, :PROMPT]
    got = serve_batch(model, params, prompts, 6, {"audio_embed": audio})
    want_values = jax.tree.map(lambda a: a.astype(jnp.float32), values)
    want = np.asarray(r_serve_batch(r_model, want_values, prompts, 6,
                                    {"audio_embed": jnp.asarray(audio)}))
    assert got.dtype == np.int32 and got.shape == (B, 6)
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got[:, 0], want[:, 0])


def test_decode_matches_full_forward():
    """The port against itself (bf16 weights and frames from the port's own
    init): prefill on the prompt plus decode steps reproduces the prefill
    of the whole sequence, to the serving contract."""
    cfg = configs.get_smoke_config(ARCH)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    audio = torch.as_tensor(rng.standard_normal((B, 32, cfg.d_model)) * 0.1,
                            dtype=torch.bfloat16)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (B, PROMPT + EXTRA)))
    with torch.inference_mode():
        _, full = model.prefill_fn(params, {"audio_embed": audio,
                                            "tokens": tokens})
        caches, _ = model.prefill_fn(params, {"audio_embed": audio,
                                              "tokens": tokens[:, :PROMPT]})
        caches = pad_caches(caches, PROMPT + EXTRA, cfg)
        for i in range(EXTRA):
            caches, logits = model.decode_fn(
                params, caches, tokens[:, PROMPT + i:PROMPT + i + 1],
                PROMPT + i)
    _contract(logits[:, 0].float().numpy(), full[:, 0].float().numpy())


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5)])
@pytest.mark.parametrize("seq_len", [64, 4000])
def test_make_batch_is_the_reference_bit_for_bit(seed, step, seq_len):
    """``audio_embed``, ``tokens`` and ``targets`` equal the reference's
    bit for bit; the decoder runs ``decoder_len`` tokens (8 at 64 frames,
    the 448-token cap at 4000)."""
    cfg = configs.get_smoke_config(ARCH)
    got = make_batch(cfg, seq_len, 2, step, seed=seed)
    want = r_make_batch(r_configs.get_smoke_config(ARCH), seq_len, 2, step,
                        seed=seed)
    assert set(got) == set(want) == {"audio_embed", "tokens", "targets"}
    assert got["tokens"].shape == (2, encdec.decoder_len(cfg, seq_len))
    assert encdec.decoder_len(cfg, seq_len) == r_encdec.decoder_len(
        r_configs.get_smoke_config(ARCH), seq_len)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_convert_refuses_a_wrong_tree(pair):
    """A reference tree with a missing key or a wrong layer count raises."""
    _, values, model, _, _, _ = pair
    tree = jax.tree.map(np.asarray, values)
    with pytest.raises(ValueError, match="keys"):
        encdec_params_from_reference(
            {k: v for k, v in tree.items() if k != "enc_norm"}, model.cfg)
    import dataclasses
    with pytest.raises(ValueError, match="layers"):
        encdec_params_from_reference(
            tree, dataclasses.replace(model.cfg, num_decoder_layers=3))

