"""llava-next-mistral-7b [vlm] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000 — anyres tiling. [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The assignment specifies the transformer BACKBONE only; the vision frontend is
a STUB — ``input_specs()`` provides precomputed anyres patch embeddings that
occupy the first ``num_media_positions`` sequence slots.  Full attention ->
long_500k skipped.
"""
from repro_torch.configs.base import BLOCK_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    block_pattern=(BLOCK_ATTN,),
    frontend="vision",
    num_media_positions=1152,  # anyres grid of CLIP patch embeddings (stub)
    rope_theta=1000000.0,
    act="silu",
    skip_shapes=("long_500k",),
)

SMOKE = ModelConfig(
    name="llava-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=160,
    vocab_size=256,
    head_dim=16,
    block_pattern=(BLOCK_ATTN,),
    frontend="vision",
    num_media_positions=8,
    act="silu",
    skip_shapes=("long_500k",),
)
