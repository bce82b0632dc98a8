"""smollm-360m [dense] — 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.

llama-arch small [hf:HuggingFaceTB/SmolLM-135M family; hf].  Full attention ->
long_500k skipped.
"""
from repro_torch.configs.base import BLOCK_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    head_dim=64,
    block_pattern=(BLOCK_ATTN,),
    act="silu",
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)

SMOKE = ModelConfig(
    name="smollm-smoke",
    family="dense",
    num_layers=2,
    d_model=60,
    num_heads=3,
    num_kv_heads=1,
    d_ff=160,
    vocab_size=256,
    head_dim=20,
    block_pattern=(BLOCK_ATTN,),
    act="silu",
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)
