"""tinyllama-1.1b [dense] — 22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.

llama2-arch small [arXiv:2401.02385; hf].  Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import BLOCK_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    head_dim=64,
    block_pattern=(BLOCK_ATTN,),
    act="silu",
    skip_shapes=("long_500k",),
)

SMOKE = ModelConfig(
    name="tinyllama-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_ff=176,
    vocab_size=256,
    head_dim=8,
    block_pattern=(BLOCK_ATTN,),
    act="silu",
    skip_shapes=("long_500k",),
)
