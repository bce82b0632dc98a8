"""Batched serving across architecture families (KV cache, WKV state,
RG-LRU state) with greedy decode (the port's copy of
``examples/serve_batched.py``).

  PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]

Each family's smoke config, random weights from a seeded generator, 4
requests of 24-token prompts and 16 new tokens through
``launch.serve.serve_batch``.  On the card the prefill runs flash
attention, the MoE's expert GEMM, WKV6 and the RG-LRU scan as their
kernels; ``--device cpu`` runs their plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.serve import serve_batch
from repro_torch.models.model import Model, build_model

ARCHS = ("tinyllama-1.1b", "qwen3-moe-30b-a3b", "rwkv6-7b",
         "recurrentgemma-9b")


@dataclasses.dataclass
class Served:
    """One model served: the greedy tokens (B, new), the host seconds of
    ``serve_batch`` and the model and weights it ran."""
    arch: str
    tokens: np.ndarray
    seconds: float
    model: Model
    params: dict

    @property
    def tokens_per_s(self) -> float:
        return self.tokens.size / self.seconds


def serve_one(cfg: ModelConfig, device="cuda", dtype=torch.bfloat16, *,
              rng: np.random.Generator, params: Optional[dict] = None,
              batch: int = 4, prompt_len: int = 24,
              max_new: int = 16) -> Served:
    """``cfg`` built on ``device`` in ``dtype`` with ``params`` (the
    port's init from a generator seeded 0 when None), ``batch`` prompts of
    ``prompt_len`` tokens drawn from ``rng``, served greedily for
    ``max_new`` tokens."""
    model = build_model(cfg, device=device, dtype=dtype)
    if params is None:
        params = model.init(torch.Generator(device=model.device)
                            .manual_seed(0))
    prompts = rng.integers(0, cfg.vocab_size,
                           (batch, prompt_len)).astype(np.int32)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    out = serve_batch(model, params, prompts, max_new=max_new)
    return Served(cfg.name, out, time.time() - t0, model, params)


def run(device="cuda") -> List[Served]:
    rng = np.random.default_rng(0)
    served = []
    for arch in ARCHS:
        s = serve_one(configs.get_smoke_config(arch), device, rng=rng)
        dt = s.seconds
        print(f"{arch:24s} 4 reqs x 16 tokens in {dt:5.2f}s "
              f"({4 * 16 / dt:6.1f} tok/s)  first row: {s.tokens[0, :8]}")
        served.append(s)
    return served


def main(argv=None) -> List[Served]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the models run (cpu: the kernels' plain "
                    "versions)")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
