"""Port parity, the serving path: ``repro_torch`` prefill, decode and
``serve_batch`` against the JAX package's on the same weights (the
reference's init, carried across with ``convert.lm_params_from_reference``)
and the same prompts (numpy), for ``qwen3-moe-smoke`` (MoE blocks: the
expert GEMM), ``tinyllama-smoke`` (dense blocks), ``rwkv6-smoke`` (rwkv6
blocks: WKV6), ``recurrentgemma-smoke`` (rglru blocks: the RG-LRU scan,
and local attention with a window of 16 that the 24-token prompt exceeds),
``gemma2-smoke`` (local attention with a window and both soft-caps),
``llama3.2-smoke``, ``smollm-smoke`` and ``llama4-smoke`` (MoE with a shared
expert), on the CPU, where the kernels run their plain versions; and
prompts of 1, 2, 3 and 17 tokens (shorter than rglru's conv width) for
recurrentgemma, rwkv6 and gemma2.

The reference is built on a (1, 1) mesh made with ``jax.make_mesh(...,
axis_types=(AxisType.Auto,) * 2)``: its own ``make_local_mesh`` raises on
jax 0.9 (ROADMAP queue 3).  Tolerances:
- float32 weights: logits ``rtol=atol=1e-4``, greedy tokens identical;
- bf16 weights: the repo's serving contract (``tests/test_decode_parity.py``):
  normalised log-probs within ``atol=0.07, rtol=0.05`` and argmax equal,
  against the reference's float32 run on the same (bf16-valued) weights,
  with the MoE's top-k selection pinned to the float32 run's.  Why not
  against the reference's bf16 run, unpinned: the two packages round bf16
  at different places (XLA keeps fused elementwise chains in float32, the
  flash kernel keeps scores in float32 where the reference's ``_sdpa``
  rounds them), and the discrete router turns those last-bit differences
  into a different expert for a few near-tied tokens.  On these inputs
  both packages' bf16 runs route some tokens unlike the float32 run, and
  unlike each other; the reference's bf16 run itself misses the contract
  against its own float32 run (qwen3, decode step 4; tinyllama's argmax
  at step 2, a top-two gap of 0.012).  The test checks that every flip is
  one that rounding explains, and holds the rest of the bf16 arithmetic to
  the contract.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro import configs as r_configs
from repro.launch.serve import pad_caches as r_pad_caches
from repro.launch.serve import serve_batch as r_serve_batch
from repro.models.layers import split_lp_tree
from repro.models.model import build_model as r_build_model
from repro_torch import configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import serve
from repro_torch.launch.serve import pad_caches, serve_batch
from repro_torch.models import moe
from repro_torch.models.model import build_model

MESH = jax.make_mesh((1, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
ARCHS = ["qwen3-moe-30b-a3b", "tinyllama-1.1b", "rwkv6-7b",
         "recurrentgemma-9b", "gemma2-27b", "llama3.2-3b", "smollm-360m",
         "llama4-scout-17b-a16e"]
B, PROMPT, EXTRA = 2, 24, 6
# bf16 runs whose argmax the strict contract cannot hold: llama4-smoke's
# port and reference (float32) runs part at a near tie (decode step 2, the
# reference's top two logits 0.034 apart, the step's largest logit error
# 0.042); test_bf16_argmax_differs_only_at_near_ties holds them
NEAR_TIE_BF16 = ["llama4-scout-17b-a16e"]


def _contract(got, want):
    """The serving contract on (B, V) logits."""
    got = got - got.max(-1, keepdims=True)
    want = want - want.max(-1, keepdims=True)
    np.testing.assert_allclose(got, want, atol=0.07, rtol=0.05)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _contract_near_ties(got, want):
    """The serving contract, but the argmax may differ where the
    reference's top two logits lie closer than twice the step's largest
    logit error (a tie that rounding can break either way)."""
    got = got - got.max(-1, keepdims=True)
    want = want - want.max(-1, keepdims=True)
    np.testing.assert_allclose(got, want, atol=0.07, rtol=0.05)
    top = np.sort(want, -1)
    gap = top[:, -1] - top[:, -2]
    err = np.abs(got - want).max(-1)
    differ = got.argmax(-1) != want.argmax(-1)
    assert not (differ & (gap > 2 * err)).any(), (gap, err, differ)


def _pair(arch, dtype):
    r_model = r_build_model(r_configs.get_smoke_config(arch), MESH)
    values, _ = split_lp_tree(r_model.init(jax.random.key(0)))
    if dtype == "float32":
        values = jax.tree.map(lambda a: a.astype(jnp.float32), values)
    cfg = configs.get_smoke_config(arch)
    model = build_model(cfg, device="cpu", dtype=getattr(torch, dtype))
    params = lm_params_from_reference(jax.tree.map(np.asarray, values), cfg)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, PROMPT + EXTRA)).astype(np.int32)
    return dtype, r_model, values, model, params, tokens


@pytest.fixture(scope="module", params=[
    (a, d) for a in ARCHS for d in ("float32", "bfloat16")
    if (a, d) not in [(n, "bfloat16") for n in NEAR_TIE_BF16]],
    ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """(reference model, its weights, the port's model and weights, tokens)
    for one arch and weight dtype."""
    return _pair(*request.param)


def _reference_logits(r_model, values, tokens):
    caches, logits = jax.jit(r_model.prefill_fn)(
        values, {"tokens": jnp.asarray(tokens[:, :PROMPT])})
    caches = r_pad_caches(caches, PROMPT + EXTRA)
    out = [np.asarray(logits[:, 0])]
    decode = jax.jit(r_model.decode_fn)
    for i in range(EXTRA):
        caches, logits = decode(values, caches,
                                jnp.asarray(tokens[:, PROMPT + i:][:, :1]),
                                jnp.int32(PROMPT + i))
        out.append(np.asarray(logits[:, 0]))
    return out


@torch.inference_mode()
def _port_logits(model, params, tokens):
    caches, logits = model.prefill_fn(
        params, {"tokens": torch.as_tensor(tokens[:, :PROMPT],
                                           dtype=torch.int64)})
    assert logits.dtype == torch.float32
    caches = pad_caches(caches, PROMPT + EXTRA)
    out = [logits[:, 0].numpy()]
    for i in range(EXTRA):
        tok = torch.as_tensor(tokens[:, PROMPT + i:][:, :1], dtype=torch.int64)
        caches, logits = model.decode_fn(params, caches, tok, PROMPT + i)
        out.append(logits[:, 0].numpy())
    return out


class _Routes:
    """Records the port's router logits and selections in order, or
    replays recorded selections (pins the top-k choice, keeps the run's own
    probabilities)."""

    def __init__(self, monkeypatch):
        self.calls, self.replay = [], None
        self._route = moe.route
        monkeypatch.setattr(moe, "route", self)

    def __call__(self, x_flat, router_w, top_k):
        probs, top_vals, top_idx = self._route(x_flat, router_w, top_k)
        if self.replay is not None:
            top_vals, top_idx = self.replay.pop(0)
        self.calls.append((x_flat.to(torch.float32) @ router_w, top_vals,
                           top_idx))
        return probs, top_vals, top_idx


def _unexplained_flips(calls, f32_calls, top_k):
    """Tokens whose top-k set differs from the float32 run's although the
    float32 run's k-th and (k+1)-th router logits lie further apart than
    twice the largest change of that token's logits: a flip that rounding
    cannot explain."""
    bad = []
    for i, ((lg, _, idx), (lg32, _, idx32)) in enumerate(zip(calls,
                                                             f32_calls)):
        flipped = (torch.sort(idx, -1)[0] != torch.sort(idx32, -1)[0]).any(-1)
        top = torch.sort(lg32, -1, descending=True)[0]
        gap = top[:, top_k - 1] - top[:, top_k]
        drift = (lg - lg32).abs().max(-1)[0]
        bad += [(i, t) for t in torch.nonzero(flipped & (gap > 2 * drift))
                .flatten().tolist()]
    return bad


def test_prefill_and_decode_match_reference(pair, monkeypatch):
    """Prefill on the prompt, then teacher-forced decode steps: the
    last-position logits of each against the reference's, float32 to
    ``rtol=atol=1e-4``; bf16 to the serving contract against the reference's
    float32 run, routing pinned to it, every unpinned flip explained by
    rounding (module docstring)."""
    _check_prefill_and_decode(pair, monkeypatch, _contract)


@pytest.mark.parametrize("arch", NEAR_TIE_BF16)
def test_bf16_argmax_differs_only_at_near_ties(arch, monkeypatch):
    """As above in bf16, where the port's argmax and the reference's part
    at a near tie (``NEAR_TIE_BF16``): the contract's log-prob tolerance
    holds, and an argmax may differ only at a near tie.  Its greedy
    continuation's first token is held as in ``test_serve_batch...``."""
    bf16_pair = _pair(arch, "bfloat16")
    test_serve_batch_matches_reference(bf16_pair)
    _check_prefill_and_decode(bf16_pair, monkeypatch, _contract_near_ties)


def _check_prefill_and_decode(pair, monkeypatch, contract):
    dtype, r_model, values, model, params, tokens = pair
    cfg = model.cfg
    if dtype == "float32":
        want = _reference_logits(r_model, values, tokens)
        for g, w in zip(_port_logits(model, params, tokens), want):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        return
    f32_values = jax.tree.map(lambda a: a.astype(jnp.float32), values)
    want = _reference_logits(r_model, f32_values, tokens)
    routes = _Routes(monkeypatch)
    f32_model = build_model(cfg, device="cpu", dtype=torch.float32)
    f32_params = lm_params_from_reference(
        jax.tree.map(np.asarray, f32_values), cfg)
    for g, w in zip(_port_logits(f32_model, f32_params, tokens), want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    f32_routes, routes.calls = routes.calls, []
    _port_logits(model, params, tokens)
    assert not _unexplained_flips(routes.calls, f32_routes, cfg.top_k)
    routes.replay = [(vals, idx) for _, vals, idx in f32_routes]
    routes.calls = []
    for g, w in zip(_port_logits(model, params, tokens), want):
        contract(g, w)


def test_serve_batch_matches_reference(pair):
    """Greedy continuations of 8 new tokens: identical with float32
    weights; with bf16 weights the first token (the argmax of the prefill
    logits, part of the serving contract) is."""
    dtype, r_model, values, model, params, tokens = pair
    prompts = tokens[:, :PROMPT]
    got = serve_batch(model, params, prompts, 8)
    want = r_serve_batch(r_model, values, prompts, 8)
    assert got.dtype == np.int32 and got.shape == (B, 8)
    if dtype == "float32":
        np.testing.assert_array_equal(got, np.asarray(want))
    else:
        np.testing.assert_array_equal(got[:, 0], np.asarray(want)[:, 0])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """The port against itself (``tests/test_decode_parity.py``'s pattern,
    bf16 weights from the port's own init): prefill on the prompt plus
    decode steps reproduces the prefill of the whole sequence, to the
    serving contract."""
    cfg = configs.get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, PROMPT + EXTRA)), dtype=torch.int64)
    with torch.inference_mode():
        _, full = model.prefill_fn(params, {"tokens": tokens})
        caches, logits = model.prefill_fn(params,
                                          {"tokens": tokens[:, :PROMPT]})
        caches = pad_caches(caches, PROMPT + EXTRA)
        for i in range(EXTRA):
            caches, logits = model.decode_fn(
                params, caches, tokens[:, PROMPT + i:PROMPT + i + 1],
                PROMPT + i)
    _contract(logits[:, 0].numpy(), full[:, 0].numpy())


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b",
                                  "gemma2-27b"])
def test_short_prompts_match_reference(arch):
    """Prompts of 1, 2, 3 and 17 tokens, float32 weights: the prefill
    logits and two teacher-forced decode steps against the reference's,
    ``rtol=atol=1e-4`` as above."""
    r_model = r_build_model(r_configs.get_smoke_config(arch), MESH)
    values, _ = split_lp_tree(r_model.init(jax.random.key(0)))
    values = jax.tree.map(lambda a: a.astype(jnp.float32), values)
    cfg = configs.get_smoke_config(arch)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    params = lm_params_from_reference(jax.tree.map(np.asarray, values), cfg)
    prefill, decode = jax.jit(r_model.prefill_fn), jax.jit(r_model.decode_fn)
    for n in (1, 2, 3, 17):
        tokens = np.random.default_rng(n).integers(
            0, cfg.vocab_size, (B, n + 2)).astype(np.int32)
        caches, logits = prefill(values, {"tokens": jnp.asarray(tokens[:, :n])})
        caches = r_pad_caches(caches, n + 2)
        want = [np.asarray(logits[:, 0])]
        for i in range(2):
            caches, logits = decode(values, caches,
                                    jnp.asarray(tokens[:, n + i:n + i + 1]),
                                    jnp.int32(n + i))
            want.append(np.asarray(logits[:, 0]))
        with torch.inference_mode():
            t_caches, t_logits = model.prefill_fn(
                params, {"tokens": torch.as_tensor(tokens[:, :n],
                                                   dtype=torch.int64)})
            t_caches = pad_caches(t_caches, n + 2)
            got = [t_logits[:, 0].numpy()]
            for i in range(2):
                t_caches, t_logits = model.decode_fn(
                    params, t_caches,
                    torch.as_tensor(tokens[:, n + i:n + i + 1],
                                    dtype=torch.int64), n + i)
                got.append(t_logits[:, 0].numpy())
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{arch}, {n}-token prompt")


def test_build_model_default_device_is_cuda():
    """The entry point runs on the card unless asked for the CPU: without a
    card, the default raises."""
    cfg = configs.get_smoke_config("qwen3-moe-30b-a3b")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(cfg)
    else:
        assert build_model(cfg).device.type == "cuda"


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "rwkv6-7b",
                                  "recurrentgemma-9b", "whisper-large-v3",
                                  "llava-next-mistral-7b"])
def test_serve_main_on_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --smoke --device cpu``; the
    encoder-decoder and the vision model with the stub front ends' random
    embeddings (the reference's ``main`` builds none for the
    encoder-decoder: ROADMAP queue 3)."""
    serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--max-new", "3"])
    out = capsys.readouterr().out
    name = configs.get_smoke_config(arch).name
    assert f"{name} on cpu: 2 requests x 3 new tokens" in out


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "whisper-large-v3",
                                  "llava-next-mistral-7b"])
def test_decode_start_counts_the_media(arch):
    """The first decode position: after the vision model's media positions
    and the prompt; after the prompt alone otherwise."""
    cfg = configs.get_smoke_config(arch)
    media = cfg.num_media_positions if cfg.frontend == "vision" else 0
    assert (cfg.frontend == "vision") == (arch == "llava-next-mistral-7b")
    assert media > 0 or arch != "llava-next-mistral-7b"
    assert serve.decode_start(cfg, PROMPT) == media + PROMPT


def test_serve_batch_refuses_vision_without_media():
    """The vision model's decode positions start after its media, so a call
    without ``media_embed`` would decode against unwritten cache slots:
    ``serve_batch`` raises instead."""
    cfg = configs.get_smoke_config("llava-next-mistral-7b")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    prompts = np.zeros((B, PROMPT), np.int32)
    for media in (None, {}, {"audio_embed": np.zeros((B, 8, cfg.d_model))}):
        with pytest.raises(ValueError, match="media_embed"):
            serve_batch(model, params, prompts, 2, media)


def test_stub_media_needs_frames_for_the_encoder_decoder():
    """``stub_media`` draws no empty encoder input: the encoder-decoder
    needs ``frames``; the vision model's media has the config's length."""
    rng = np.random.default_rng(0)
    whisper = configs.get_smoke_config("whisper-large-v3")
    for frames in (None, 0):
        with pytest.raises(ValueError, match="frames"):
            serve.stub_media(whisper, B, rng, frames)
    got = serve.stub_media(whisper, B, rng, 16)
    assert got["audio_embed"].shape == (B, 16, whisper.d_model)
    llava = configs.get_smoke_config("llava-next-mistral-7b")
    got = serve.stub_media(llava, B, rng)
    assert got["media_embed"].shape == (B, llava.num_media_positions,
                                        llava.d_model)
    assert serve.stub_media(configs.get_smoke_config("rwkv6-7b"), B,
                            rng) is None


def test_pad_caches_pads_only_kv():
    """recurrentgemma's caches: the local-attention layer's K/V grow to the
    target length with zeros; the rglru layers' ``h`` and ``conv`` state
    (no sequence axis) are the same tensors."""
    cfg = configs.get_smoke_config("recurrentgemma-9b")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.zeros((B, PROMPT), dtype=torch.int64)
    with torch.inference_mode():
        caches, _ = model.prefill_fn(params, {"tokens": tokens})
    padded = pad_caches(caches, PROMPT + EXTRA)
    for kind, cache, new in zip(cfg.layer_kinds(), caches, padded,
                                strict=True):
        assert set(new) == set(cache)
        if kind == "local_attn":
            assert new["k"].shape[1] == PROMPT + EXTRA
            assert torch.equal(new["v"][:, :PROMPT], cache["v"])
            assert not new["k"][:, PROMPT:].any()
        else:
            assert all(new[k] is cache[k] for k in cache)
