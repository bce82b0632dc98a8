"""recurrentgemma-9b [hybrid] — Griffin. 38L d_model=4096 16H (GQA kv=1, MQA)
d_ff=12288 vocab=256000 — RG-LRU + local attention at 2:1. [arXiv:2402.19427]

38 layers = 12 full (rglru, rglru, local_attn) periods + 2 unrolled rglru
layers.  Recurrent state is O(1) in sequence length and local attention has a
fixed window -> `long_500k` RUNS for this arch.
"""
from repro_torch.configs.base import BLOCK_LOCAL, BLOCK_REC, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    block_pattern=(BLOCK_REC, BLOCK_REC, BLOCK_LOCAL),
    window_size=2048,
    rglru_conv_width=4,
    act="gelu",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    num_layers=5,          # exercises the ragged tail (1 period + 2 unrolled)
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    d_ff=160,
    vocab_size=256,
    head_dim=16,
    block_pattern=(BLOCK_REC, BLOCK_REC, BLOCK_LOCAL),
    window_size=16,
    rglru_conv_width=4,
    act="gelu",
    tie_embeddings=True,
)
