"""Serving launcher: batched prefill + greedy decode (after the JAX package's
``launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \\
      --smoke --device cpu --batch 4 --prompt-len 32 --max-new 32

serves any decoder LM the port runs (attention and MoE blocks,
``rwkv6-7b``, ``recurrentgemma-9b``).  It runs on the card by default (``--device cuda``); weights are random, drawn
from a seeded ``torch.Generator``.
"""
from __future__ import annotations

import argparse
import time
from typing import List

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models.model import build_model

# self-attention caches grow to prompt + new tokens
_KV_KEYS = ("k", "v")


def pad_caches(caches, target_len: int):
    """Pad every layer's K/V cache along the sequence axis to
    ``target_len`` (zeros past the prompt).  Only the ``k`` and ``v``
    leaves are touched: recurrent state (``wkv``, the shifts, ``h``,
    ``conv``) has no sequence axis."""
    out = []
    for cache in caches:
        padded = dict(cache)
        for key in _KV_KEYS:
            leaf = cache.get(key)
            if leaf is not None and leaf.shape[-3] < target_len:
                shape = list(leaf.shape)
                shape[-3] = target_len
                grown = leaf.new_zeros(shape)
                grown[..., :leaf.shape[-3], :, :] = leaf
                padded[key] = grown
        out.append(padded)
    return out


@torch.inference_mode()
def serve_batch(model, params, prompts: np.ndarray,
                max_new: int) -> np.ndarray:
    """prompts: (B, P) int -> (B, max_new) int32 greedy continuations."""
    b, p_len = prompts.shape
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64,
                                       device=model.device)}
    caches, logits = model.prefill_fn(params, batch)
    caches = pad_caches(caches, p_len + max_new)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    out: List[torch.Tensor] = []
    for i in range(max_new):
        out.append(tok[:, 0])
        caches, logits = model.decode_fn(params, caches, tok, p_len + i)
        tok = torch.argmax(logits[:, -1:], dim=-1)
    return torch.stack(out, dim=1).cpu().numpy().astype(np.int32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    model = build_model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    tokens = serve_batch(model, params, prompts, args.max_new)
    dt = time.perf_counter() - t0
    print(f"[serve] {cfg.name} on {model.device}: {args.batch} requests x "
          f"{args.max_new} new tokens in {dt:.2f}s "
          f"({args.batch * args.max_new / dt:.1f} tok/s)")
    print(tokens[:, :16])


if __name__ == "__main__":
    main()
