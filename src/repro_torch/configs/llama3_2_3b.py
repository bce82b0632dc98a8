"""llama3.2-3b [dense] — 28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.

[hf:meta-llama/Llama-3.2-1B family; unverified].  Pure full attention ->
long_500k skipped (noted in DESIGN.md).
"""
from repro_torch.configs.base import BLOCK_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=128,
    block_pattern=(BLOCK_ATTN,),
    rope_theta=500000.0,
    act="silu",
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)

SMOKE = ModelConfig(
    name="llama3.2-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=160,
    vocab_size=256,
    head_dim=16,
    block_pattern=(BLOCK_ATTN,),
    rope_theta=500000.0,
    act="silu",
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)
