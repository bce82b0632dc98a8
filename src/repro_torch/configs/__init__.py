"""Config registry: ``get_config(arch)`` / ``get_smoke_config(arch)``.

All ten assigned architectures, copied from the JAX package's ``configs/``
(the tests assert every field equal).
"""
from __future__ import annotations

from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES_BY_NAME,
    TRAIN_4K,
    ModelConfig,
    ShapeConfig,
)

from repro_torch.configs import (  # noqa: E402
    gemma2_27b,
    llama3_2_3b,
    llama4_scout_17b_a16e,
    llava_next_mistral_7b,
    qwen3_moe_30b_a3b,
    recurrentgemma_9b,
    rwkv6_7b,
    smollm_360m,
    tinyllama_1_1b,
    whisper_large_v3,
)

_MODULES = {
    "whisper-large-v3": whisper_large_v3,
    "llama3.2-3b": llama3_2_3b,
    "gemma2-27b": gemma2_27b,
    "smollm-360m": smollm_360m,
    "tinyllama-1.1b": tinyllama_1_1b,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "rwkv6-7b": rwkv6_7b,
    "recurrentgemma-9b": recurrentgemma_9b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(_MODULES)}")
    return _MODULES[arch].CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(_MODULES)}")
    return _MODULES[arch].SMOKE


def get_shape(name: str) -> ShapeConfig:
    return SHAPES_BY_NAME[name]


def cells():
    """All runnable (arch, shape) dry-run cells, skips applied."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in cfg.shapes():
            yield arch, shape.name
