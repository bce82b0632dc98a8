"""Deterministic synthetic LM data pipeline, the port's numpy copy of the
JAX package's ``data/pipeline.py`` (batches equal bit for bit).

Documents are variable-length Zipf-ish token runs with a learnable
(markov-flavored) structure so training loss actually decreases; batches are
built by packing documents into fixed-length rows.  Every batch is a pure
function of (seed, step, shard) — restart-safe by construction, which is what
the checkpoint/restart test relies on.  The encoder-decoder's and the vision
front end's batches wait for those models (ROADMAP queue 1, item 7.5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1
    shard: int = 0

    def doc_lengths(self, rng) -> np.ndarray:
        # log-normal document lengths (the seqpack balancer's raw material)
        return np.clip(rng.lognormal(5.0, 1.0, size=64).astype(np.int64),
                       16, 4 * self.seq_len)

    def _tokens(self, rng, n: int) -> np.ndarray:
        # order-1 structure: t_{i+1} = (a * t_i + b) % V on a small alphabet
        v = min(self.vocab_size, 251)
        a, b = 31, int(rng.integers(1, v))
        t0 = int(rng.integers(0, v))
        out = np.empty(n, np.int64)
        cur = t0
        for i in range(n):
            out[i] = cur
            cur = (a * cur + b) % v
        noise = rng.random(n) < 0.1
        out[noise] = rng.integers(0, v, noise.sum())
        return out

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 97 + self.shard)
        rows = self.global_batch // self.num_shards
        tokens = np.empty((rows, self.seq_len + 1), np.int64)
        for r in range(rows):
            buf = []
            total = 0
            while total <= self.seq_len:
                n = int(rng.lognormal(5.0, 1.0))
                n = max(16, min(n, self.seq_len + 1 - total)) \
                    if total + 16 <= self.seq_len else self.seq_len + 1 - total
                buf.append(self._tokens(rng, n))
                total += n
            tokens[r] = np.concatenate(buf)[: self.seq_len + 1]
        return {"tokens": tokens[:, :-1].astype(np.int32),
                "targets": tokens[:, 1:].astype(np.int32)}


def make_batch(cfg: ModelConfig, seq_len: int, global_batch: int, step: int,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """The batch of ``step``: ``{"tokens", "targets"}`` (B, S) int32.
    Raises for the encoder-decoder and the vision front end, as the model
    does."""
    if cfg.arch_type == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder is not ported yet (ROADMAP "
            "queue 1, item 7.5)")
    if cfg.frontend == "vision":
        raise NotImplementedError(
            f"{cfg.name}: the vision front end is not ported yet (ROADMAP "
            "queue 1, item 7.5)")
    return SyntheticLMData(cfg.vocab_size, seq_len, global_batch,
                           seed=seed).batch(step)
