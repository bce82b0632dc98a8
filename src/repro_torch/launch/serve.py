"""Serving launcher: batched prefill + greedy decode (after the JAX package's
``launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \\
      --smoke --device cpu --batch 4 --prompt-len 32 --max-new 32

serves every architecture of the configs: the decoder LMs (attention and
MoE blocks, ``rwkv6-7b``, ``recurrentgemma-9b``, ``gemma2-27b`` with its
ring cache under ``window_kv_cache``), the vision front end
(``llava-next-mistral-7b``: random ``media_embed`` patch embeddings before
the prompt) and the encoder-decoder (``whisper-large-v3``: random
``audio_embed`` frames, ``--prompt-len`` decoder tokens).  It runs on the
card by default (``--device cuda``); weights are random, drawn from a
seeded ``torch.Generator``, and the stub front ends' embeddings from numpy
seed 0.

On a mesh (``--mesh D,M``, under ``torchrun --nproc-per-node D*M``; rank
and world from the environment) each data group serves its rows of the
batch (all of them where the batch does not divide over the data axis),
the weights and caches laid out as ``models.model`` says, and every rank
returns the whole batch's tokens; rank 0 prints.

  torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
      --arch qwen3-moe-30b-a3b --smoke --device cpu --mesh 1,2
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import configs, sharding
from repro_torch.configs.base import BLOCK_LOCAL, ModelConfig
from repro_torch.launch.steps import to_device
from repro_torch.models import transformer as tf_lib
from repro_torch.models.model import (build_model, cache_specs,
                                      decode_layout, local_batch)

# self-attention caches grow to prompt + new tokens; cross-attention (ck/cv)
# stays at the encoder's length
_KV_KEYS = ("k", "v", "sk", "sv")


def _grown(leaf: torch.Tensor, target_len: int) -> torch.Tensor:
    """``leaf`` (..., S, Hkv, hd) padded with zeros to ``target_len``."""
    if leaf.shape[-3] >= target_len:
        return leaf
    shape = list(leaf.shape)
    shape[-3] = target_len
    grown = leaf.new_zeros(shape)
    grown[..., :leaf.shape[-3], :, :] = leaf
    return grown


def to_ring(leaf: torch.Tensor, slots: int) -> torch.Tensor:
    """A prefill's K or V (B, P, Hkv, hd) as a ring of ``slots`` slots:
    position p at slot p % slots, for the last ``slots`` positions of the
    prompt; slots not yet written are zeros (``attention_decode(ring=True)``
    masks them)."""
    p_len = leaf.shape[1]
    ring = leaf.new_zeros((leaf.shape[0], slots) + tuple(leaf.shape[2:]))
    pos = torch.arange(max(0, p_len - slots), p_len, device=leaf.device)
    ring[:, pos % slots] = leaf[:, pos]
    return ring


def pad_caches(caches, target_len: int, cfg: Optional[ModelConfig] = None):
    """Pad every layer's self-attention K/V cache along the sequence axis to
    ``target_len`` (zeros past the prompt).  Only the ``k``, ``v``, ``sk``
    and ``sv`` leaves are touched: recurrent state (``wkv``, the shifts,
    ``h``, ``conv``) has no sequence axis, and the encoder-decoder's cross
    caches (``ck``, ``cv``) stay at the encoder's length.

    With ``cfg`` under ``cfg.window_kv_cache``, each local layer's K/V
    becomes a ring (:func:`to_ring`) of min(window, ``target_len``) slots
    instead, so its decode memory is O(window).  (The reference pads those
    too, so its ring decode indexes a ring of ``target_len`` slots and sees
    past the window: ROADMAP queue 3.)"""
    kinds = (cfg.layer_kinds() if cfg is not None and cfg.window_kv_cache
             and cfg.arch_type != "encdec" else [None] * len(caches))
    out = []
    for kind, cache in zip(kinds, caches, strict=True):
        padded = dict(cache)
        for key in _KV_KEYS:
            if key not in cache:
                continue
            if kind == BLOCK_LOCAL:
                padded[key] = to_ring(cache[key],
                                      min(cfg.window_size, target_len))
            else:
                padded[key] = _grown(cache[key], target_len)
        out.append(padded)
    return out


def decode_start(cfg: ModelConfig, prompt_len: int) -> int:
    """The position of the first decode step after a ``prompt_len``-token
    prompt: the vision model's positions run over its P_media media
    positions first."""
    if cfg.frontend == "vision":
        return cfg.num_media_positions + prompt_len
    return prompt_len


@torch.inference_mode()
def serve_batch(model, params, prompts: np.ndarray, max_new: int,
                media: Optional[Dict] = None) -> np.ndarray:
    """prompts: (B, P) int -> (B, max_new) int32 greedy continuations.
    ``media``: the stub front ends' inputs, ``{"audio_embed": (B, S_enc,
    d)}`` for the encoder-decoder or ``{"media_embed": (B, P_media, d)}``
    for the vision front end (numpy arrays or tensors); the vision model's
    positions run over the media first, so its decode positions start at
    P_media + P, and it raises without ``media_embed``."""
    cfg = model.cfg
    if cfg.frontend == "vision" and "media_embed" not in (media or {}):
        raise ValueError(f"{cfg.name} serves after its media: pass "
                         "media={'media_embed': (B, P_media, d)}")
    b, p_len = prompts.shape
    batch = to_device(local_batch(model, {"tokens": prompts, **(media or {})}),
                      model.device)
    caches, logits = model.prefill_fn(params, batch)
    start = decode_start(cfg, p_len)
    caches = pad_caches(caches, start + max_new, cfg)
    caches = lay_out_caches(model, caches, batch, b, start + max_new, media)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    out: List[torch.Tensor] = []
    for i in range(max_new):
        out.append(tok[:, 0])
        caches, logits = model.decode_fn(params, caches, tok, start + i)
        tok = torch.argmax(logits[:, -1:], dim=-1)
    tokens = torch.stack(out, dim=1)
    if model.ctx is not None:
        tokens = model.ctx.gather(tokens, (model.ctx.batch_entry(b), None))
    return tokens.cpu().numpy().astype(np.int32)


def lay_out_caches(model, caches, batch, b: int, total: int, media=None):
    """On a mesh, the padded caches of a rank's rows (``batch``, the
    ``sharding.LocalBatch`` they were computed from) kept by the
    reference's ``cache_specs`` for ``b`` sequences of ``total``
    positions (the sequence over the model axis where it
    divides), as a ``sharding.LocalCaches`` that carries that layout to
    decode (``models.model.decode_layout``).  The recurrent state that
    the rank computed for its own heads or channels
    (``transformer.state_in_place``) is its model-axis shard already and
    is kept as it is.  The caches as they are without a mesh."""
    ctx = model.ctx
    if ctx is None:
        return caches
    s = total
    in_place = [()] * len(caches)
    if model.cfg.arch_type == "encdec":
        s = np.shape(media["audio_embed"])[1]
    else:
        in_place = tf_lib.lm_in_place(model.cfg, ctx)
    _, specs = cache_specs(model.cfg, b, s, ctx.mesh, ctx.axes, s_dec=total)
    specs = decode_layout(specs)

    def kept(k, v, spec, keep):
        if k in keep:
            spec = tuple(None if ctx.axes.model in sharding._entry_axes(e)
                         else e for e in spec)
        return sharding.shard(v, ctx.mesh, spec)
    return sharding.LocalCaches(
        [{k: kept(k, v, spec[k], keep) for k, v in c.items()}
         for c, spec, keep in zip(caches, specs, in_place, strict=True)],
        specs, sharded=batch.sharded)


def stub_media(cfg: ModelConfig, batch: int, rng: np.random.Generator,
               frames: Optional[int] = None
               ) -> Optional[Dict[str, np.ndarray]]:
    """The stub front end's inputs for ``batch`` requests, drawn from
    ``rng`` as ``data.pipeline.make_batch`` draws them (standard normal
    times 0.1, float32): ``audio_embed`` (batch, ``frames``, d) for the
    encoder-decoder, ``media_embed`` (batch, P_media, d) for the vision
    front end; None for a model without one.  The encoder-decoder needs
    ``frames``."""
    if cfg.arch_type == "encdec":
        if not frames:
            raise ValueError(f"{cfg.name}: stub_media needs frames > 0")
        return {"audio_embed": rng.standard_normal(
            (batch, frames, cfg.d_model)).astype(np.float32) * 0.1}
    if cfg.frontend == "vision":
        return {"media_embed": rng.standard_normal(
            (batch, cfg.num_media_positions, cfg.d_model)
        ).astype(np.float32) * 0.1}
    return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None, metavar="D,M",
                    help="serve on a D x M (data, model) mesh over the "
                    "world torchrun starts (NCCL on the card, gloo with "
                    "--device cpu)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_local_mesh, parse_mesh
        mesh = make_local_mesh(*parse_mesh(args.mesh), device=args.device)
    model = build_model(cfg, device=args.device,
                        dtype=getattr(torch, args.dtype), mesh=mesh)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    # the encoder-decoder's frames: 8 x the prompt, whose decoder_len
    # (models.encdec) is the prompt
    media = stub_media(cfg, args.batch, rng, frames=8 * args.prompt_len)
    t0 = time.perf_counter()
    tokens = serve_batch(model, params, prompts, args.max_new, media)
    dt = time.perf_counter() - t0
    if mesh is None or torch.distributed.get_rank() == 0:
        where = f"a {args.mesh} mesh" if mesh is not None else model.device
        print(f"[serve] {cfg.name} on {where}: {args.batch} requests x "
              f"{args.max_new} new tokens in {dt:.2f}s "
              f"({args.batch * args.max_new / dt:.1f} tok/s)")
        print(tokens[:, :16])
    return tokens


if __name__ == "__main__":
    main()
