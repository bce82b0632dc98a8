"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) per-expert
d_ff=768 vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]

The paper's technique applies most directly here: experts are CCM shared
blocks, router statistics give task loads, dispatch volume gives comm edges
(see balance/expert_placement.py).  Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import BLOCK_MOE, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=6144,            # dense-equivalent (unused; all blocks are MoE)
    vocab_size=151936,
    head_dim=128,
    block_pattern=(BLOCK_MOE,),
    num_experts=128,
    top_k=8,
    moe_d_ff=768,
    rope_theta=1000000.0,
    act="silu",
    skip_shapes=("long_500k",),
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    block_pattern=(BLOCK_MOE,),
    num_experts=8,
    top_k=2,
    moe_d_ff=32,
    capacity_factor=8.0,   # no-drop for smoke/parity tests
    act="silu",
    skip_shapes=("long_500k",),
)
