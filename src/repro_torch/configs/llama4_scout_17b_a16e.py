"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

The assignment line lists no local-attention note, so we conservatively treat
it as full attention -> long_500k skipped (DESIGN.md).
"""
from repro_torch.configs.base import BLOCK_MOE, ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    block_pattern=(BLOCK_MOE,),
    num_experts=16,
    top_k=1,
    moe_d_ff=8192,
    num_shared_experts=1,
    rope_theta=500000.0,
    act="silu",
    skip_shapes=("long_500k",),
)

SMOKE = ModelConfig(
    name="llama4-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    block_pattern=(BLOCK_MOE,),
    num_experts=4,
    top_k=1,
    moe_d_ff=64,
    num_shared_experts=1,
    capacity_factor=8.0,   # no-drop for smoke/parity tests
    act="silu",
    skip_shapes=("long_500k",),
)
