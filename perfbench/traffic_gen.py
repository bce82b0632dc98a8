"""The one general generator of traffic: it reads a traffic file's
parameters and makes a run's inputs from the seed, on the device, during
set-up.  A mix of another kind, or with other lengths, rates or batch
sizes, is another data file."""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from perfbench.yardstick.zipf import ZipfSampler


def sampler(traffic: dict, vocab: int, gen: torch.Generator, device):
    law = traffic["tokens"]
    if law["law"] != "zipf":
        raise ValueError(f"traffic {traffic['name']}: token law "
                         f"{law['law']!r} is not known")
    return ZipfSampler(vocab, float(law["exponent"]), gen, device)


def serve_lengths(traffic: dict, seed: int) -> List[int]:
    """The order of prompt lengths that every cycle of batches repeats: a
    permutation of ``prompt_lens`` drawn from the seed."""
    lens = [int(x) for x in traffic["prompt_lens"]]
    order = np.random.default_rng(seed).permutation(len(lens))
    return [lens[i] for i in order]


def serve_prompts(traffic: dict, vocab: int, seed: int, device,
                  n_batches: int) -> List[np.ndarray]:
    """The prompts of ``n_batches`` batches (``batch`` x the cycle's length,
    int32 numpy, as ``launch.serve.serve_batch`` takes them): batch i has
    the i-th length of the repeated order; every prompt its own draw."""
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = sampler(traffic, vocab, gen, device)
    order = serve_lengths(traffic, seed)
    b = int(traffic["batch"])
    return [draw.sample((b, order[i % len(order)])).to(torch.int32)
            .cpu().numpy() for i in range(n_batches)]
