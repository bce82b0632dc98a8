"""Uniform model API, after the JAX package's ``models/model.py``.

``build_model(cfg)`` returns a ``Model`` with init / loss / prefill /
decode closures for the decoder LMs the port runs (attention, MoE,
``rwkv6`` and ``rglru`` blocks).  There is no mesh: one device holds the model.  The
reference's ``input_specs`` / ``cache_specs`` serve its dry-run and are not
ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf_lib


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    dtype: torch.dtype
    init: Callable            # torch.Generator -> params
    loss_fn: Callable         # (params, batch) -> (loss, metrics)
    prefill_fn: Callable      # (params, batch) -> (caches, logits)
    decode_fn: Callable       # (params, caches, token, pos) -> (caches, logits)


def build_model(cfg: ModelConfig, device="cuda",
                dtype=torch.bfloat16) -> Model:
    """The model of ``cfg`` on ``device`` (the card unless the caller asks
    for the CPU) with weights in ``dtype``.  Raises for a CUDA device when
    no card is present, and for what the port does not run yet."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: device 'cuda' asked for, but torch "
                           "sees no CUDA card (pass device='cpu' to run the "
                           "plain versions on the CPU)")
    tf_lib.check_config(cfg)

    def init(gen: torch.Generator):
        return tf_lib.init_lm(gen, cfg, dtype=dtype, device=device)

    return Model(
        cfg, device, dtype, init=init,
        loss_fn=lambda p, b: tf_lib.lm_loss(p, b, cfg),
        prefill_fn=lambda p, b: tf_lib.lm_prefill(p, b, cfg),
        decode_fn=lambda p, c, t, pos: tf_lib.lm_decode(p, c, t, pos, cfg),
    )
