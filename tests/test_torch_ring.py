"""Port parity, the ring KV cache (``cfg.window_kv_cache``) on
``gemma2-smoke`` (window 16, alternating local and global layers, both
soft-caps): a 20-token prompt and 12 new tokens, so decode crosses the
window.  Under the ring, ``launch.serve.pad_caches`` turns each local
layer's prefill K/V into a ring of min(window, prompt + new) slots
(position p at slot p % slots) and pads only the global layers;
``attention_decode(ring=True)`` writes slot pos % slots and masks the slots
whose position is not yet written.

Held here, on the CPU, with float32 weights (the reference's init carried
across with ``convert.lm_params_from_reference``):
- the port's ring serve against its full-cache serve and against the
  reference's full-cache serve (logits ``rtol=atol=1e-4``, tokens equal);
- the port's ring decode against the reference's ``attention_decode(ring=
  True)`` on a ring built by hand with ``window`` slots, as
  ``tests/test_perf_variants.py::test_window_ring_cache_matches_full_cache``
  builds it (logits ``rtol=atol=1e-4``);
- the leaves' lengths;
- the reference's fault (ROADMAP queue 3): its ``launch/serve.py`` pads the
  local layers' caches to prompt + new tokens like the global ones, so its
  ring indexes modulo that length, not the window, and sees past the
  window.

The reference is built on a (1, 1) mesh made with ``jax.make_mesh(...,
axis_types=(AxisType.Auto,) * 2)`` (ROADMAP queue 3).
"""
import dataclasses

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
from repro_torch.launch.serve import pad_caches, serve_batch, to_ring
from repro_torch.models.model import build_model

MESH = jax.make_mesh((1, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
ARCH = "gemma2-27b"
B, PROMPT, EXTRA = 2, 20, 12


def _ring_cfg(cfg):
    return dataclasses.replace(cfg, window_kv_cache=True)


@pytest.fixture(scope="module")
def pair():
    """(reference full-cache model, its float32 weights, the port's
    full-cache and ring models and their weights, tokens)."""
    r_model = r_build_model(r_configs.get_smoke_config(ARCH), MESH)
    values, _ = split_lp_tree(r_model.init(jax.random.key(0)))
    values = jax.tree.map(lambda a: a.astype(jnp.float32), values)
    cfg = configs.get_smoke_config(ARCH)
    assert cfg.window_size < PROMPT + EXTRA and not cfg.window_kv_cache
    params = lm_params_from_reference(jax.tree.map(np.asarray, values), cfg)
    full = build_model(cfg, device="cpu", dtype=torch.float32)
    ring = build_model(_ring_cfg(cfg), device="cpu", dtype=torch.float32)
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, PROMPT + EXTRA)).astype(np.int32)
    return r_model, values, full, ring, params, tokens


def _reference_logits(r_model, values, tokens, caches_fn=r_pad_caches):
    """The reference's prefill on the prompt, its caches made by
    ``caches_fn`` (its serve's ``pad_caches`` by default), then
    teacher-forced decode: each step's logits."""
    caches, logits = jax.jit(r_model.prefill_fn)(
        values, {"tokens": jnp.asarray(tokens[:, :PROMPT])})
    caches = caches_fn(caches, PROMPT + EXTRA)
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
    caches = pad_caches(caches, PROMPT + EXTRA, model.cfg)
    out = [logits[:, 0].numpy()]
    for i in range(EXTRA):
        tok = torch.as_tensor(tokens[:, PROMPT + i:][:, :1], dtype=torch.int64)
        caches, logits = model.decode_fn(params, caches, tok, PROMPT + i)
        out.append(logits[:, 0].numpy())
    return out, caches


def test_ring_serve_matches_full_cache_serve(pair):
    """Teacher-forced logits of the port's ring decode against its
    full-cache decode and the reference's full-cache decode; greedy
    continuations of the port's ring ``serve_batch`` equal to its full-cache
    one and the reference's."""
    r_model, values, full, ring, params, tokens = pair
    want = _reference_logits(r_model, values, tokens)
    got_ring, _ = _port_logits(ring, params, tokens)
    got_full, _ = _port_logits(full, params, tokens)
    for step, (r, f, w) in enumerate(zip(got_ring, got_full, want)):
        np.testing.assert_allclose(r, f, rtol=1e-4, atol=1e-4,
                                   err_msg=f"ring vs full, step {step}")
        np.testing.assert_allclose(r, w, rtol=1e-4, atol=1e-4,
                                   err_msg=f"ring vs reference, step {step}")
    prompts = tokens[:, :PROMPT]
    ring_tokens = serve_batch(ring, params, prompts, EXTRA)
    np.testing.assert_array_equal(ring_tokens,
                                  serve_batch(full, params, prompts, EXTRA))
    np.testing.assert_array_equal(
        ring_tokens, np.asarray(r_serve_batch(r_model, values, prompts,
                                              EXTRA)))


def _hand_ring(cfg):
    """``caches_fn`` that turns the reference's prefill caches into its
    ring layout by hand: each local layer's K/V a ring of ``window`` slots,
    position p at slot p % window (``test_perf_variants.py``'s loop); the
    global layers padded by its ``pad_caches``."""
    w = cfg.window_size

    def fn(caches, total):
        caches = r_pad_caches(caches, total)
        for name, entry in caches["scan"].items():
            if cfg.block_pattern[int(name[1:])] != "local_attn":
                continue
            for kk in ("k", "v"):
                padded = entry[kk]                   # (P, B, S, hkv, hd)
                ringbuf = jnp.zeros(padded.shape[:2] + (w,)
                                    + padded.shape[3:], padded.dtype)
                for p in range(max(0, PROMPT - w), PROMPT):
                    ringbuf = ringbuf.at[:, :, p % w].set(padded[:, :, p])
                entry[kk] = ringbuf
        return caches

    return fn


def test_ring_decode_matches_reference_ring_decode(pair):
    """The port's ring decode against the reference's ``attention_decode(
    ring=True)`` (its model under ``window_kv_cache``) on a ring of
    ``window`` slots built by hand."""
    _, values, _, ring, params, tokens = pair
    r_ring = r_build_model(_ring_cfg(r_configs.get_smoke_config(ARCH)), MESH)
    want = _reference_logits(r_ring, values, tokens,
                             caches_fn=_hand_ring(r_ring.cfg))
    got, _ = _port_logits(ring, params, tokens)
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("new", [EXTRA, 2])
def test_ring_leaves_have_min_window_total_slots(pair, new):
    """After ``pad_caches`` under the ring, a local layer's K/V has
    min(window, prompt + new) slots (a ring shorter than the window while
    prompt + new is), a global layer's prompt + new; ``to_ring`` puts
    position p of the prompt at slot p % slots."""
    _, _, _, ring, params, tokens = pair
    cfg = ring.cfg
    total = PROMPT + new
    with torch.inference_mode():
        caches, _ = ring.prefill_fn(params, {"tokens": torch.as_tensor(
            tokens[:, :PROMPT], dtype=torch.int64)})
    padded = pad_caches(caches, total, cfg)
    slots = min(cfg.window_size, total)
    for kind, before, after in zip(cfg.layer_kinds(), caches, padded,
                                   strict=True):
        for key in ("k", "v"):
            want = slots if kind == "local_attn" else total
            assert after[key].shape[1] == want, (kind, key)
        if kind == "local_attn":
            for p in range(max(0, PROMPT - slots), PROMPT):
                assert torch.equal(after["k"][:, p % slots],
                                   before["k"][:, p])
    short = to_ring(caches[0]["v"], 32)
    assert torch.equal(short[:, :PROMPT], caches[0]["v"])
    assert not short[:, PROMPT:].any()


def test_reference_fault_window_kv_cache_serve_sees_past_the_window(pair):
    """The reference's serve path under ``window_kv_cache`` (its
    ``pad_caches`` pads the local layers to prompt + new slots, and its
    ring decode indexes modulo that length) parts from its own full-cache
    decode past the window, while the port's ring does not: at every
    decode step the reference's logits differ from its full-cache ones by
    more than 0.1, the port's by less than 1e-4."""
    r_model, values, _, ring, params, tokens = pair
    r_ring = r_build_model(_ring_cfg(r_configs.get_smoke_config(ARCH)), MESH)
    full = _reference_logits(r_model, values, tokens)
    faulty = _reference_logits(r_ring, values, tokens)
    got, _ = _port_logits(ring, params, tokens)
    np.testing.assert_allclose(faulty[0], full[0], rtol=1e-5, atol=1e-5)
    for step in range(1, EXTRA + 1):
        assert np.abs(faulty[step] - full[step]).max() > 0.1, step
        assert np.abs(got[step] - full[step]).max() < 1e-4, step
