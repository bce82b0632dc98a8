"""Zipf-distributed token ids, drawn on the device from a seeded generator.

Rank r (0-based) of a vocabulary of V has probability proportional to
(r + 1) ** -exponent, natural text's unigram law (exponent about 1); which
token id holds which rank is a permutation drawn from the same generator,
so every seed routes a different set of ids hot.  Ids are drawn by the
inverse CDF: one uniform draw and one sorted search per id, in float64."""
from __future__ import annotations

import torch


class ZipfSampler:
    def __init__(self, vocab: int, exponent: float, gen: torch.Generator,
                 device):
        if vocab < 1 or exponent <= 0:
            raise ValueError(f"ZipfSampler: vocab {vocab}, exponent "
                             f"{exponent}")
        self.vocab = vocab
        self.gen = gen
        self.device = torch.device(device)
        ranks = torch.arange(1, vocab + 1, dtype=torch.float64,
                             device=self.device)
        cdf = torch.cumsum(ranks ** -float(exponent), 0)
        self.cdf = cdf / cdf[-1]
        self.ids = torch.randperm(vocab, generator=gen, device=self.device)

    def sample(self, shape) -> torch.Tensor:
        """Token ids of ``shape``, int64 on the sampler's device."""
        u = torch.rand(tuple(shape), generator=self.gen, dtype=torch.float64,
                       device=self.device)
        rank = torch.searchsorted(self.cdf, u, right=True)
        return self.ids[torch.clamp(rank, max=self.vocab - 1)]
