"""Model FLOPs: the work a step needs, counted from the configuration
alone, once (a recomputation under remat is not counted).

Training counts 6 FLOPs a parameter and token of every dense product
(forward, and twice that backward), the active experts only, the output
head included and the embedding lookup not (it multiplies nothing), plus
attention's scores and weighted sums at the causal half, forward and
twice that backward.  Serving counts 2 FLOPs a parameter and token of the
prefill's products, the head at the last position only (the only logits
made), its attention, and each decode step's products and attention over
the positions cached."""
from __future__ import annotations

import importlib


def block(kind: str):
    """The per-token work of a block kind (``yardstick/blocks/<kind>.py``)."""
    return importlib.import_module(f"perfbench.yardstick.blocks.{kind}")


def layer_kinds(m):
    pattern = m["block_pattern"]
    return [pattern[i % len(pattern)] for i in range(m["num_layers"])]


def body_macs(m) -> int:
    """Multiply-accumulates of the layers' dense products, one token."""
    return sum(block(k).matmul_macs(m) for k in layer_kinds(m))


def head_macs(m) -> int:
    return m["d_model"] * m["vocab_size"]


def attention_flops(m, batch: int, q_len: int, kv_len: int,
                    causal: bool = True) -> int:
    """Forward FLOPs of every layer's attention over ``batch`` sequences."""
    return 2 * batch * sum(block(k).attention_macs(m, q_len, kv_len, causal)
                           for k in layer_kinds(m))


def train_step_flops(m, batch: int, seq: int) -> int:
    dense = 6 * (body_macs(m) + head_macs(m)) * batch * seq
    return dense + 3 * attention_flops(m, batch, seq, seq)


def prefill_flops(m, batch: int, prompt: int) -> int:
    return (2 * body_macs(m) * batch * prompt + 2 * head_macs(m) * batch
            + attention_flops(m, batch, prompt, prompt))


def decode_step_flops(m, batch: int, cached: int) -> int:
    """One token for each of ``batch`` sequences whose caches hold
    ``cached`` positions before it."""
    return (2 * (body_macs(m) + head_macs(m)) * batch
            + attention_flops(m, batch, 1, cached + 1, causal=False))


def serve_batch_flops(m, batch: int, prompt: int, new_tokens: int) -> int:
    """A prefill of ``prompt`` tokens and ``new_tokens`` - 1 decode steps
    (the first new token comes from the prefill's logits)."""
    return prefill_flops(m, batch, prompt) + sum(
        decode_step_flops(m, batch, prompt + i) for i in range(new_tokens - 1))
