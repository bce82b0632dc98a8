"""rwkv6-7b [ssm] — Finch. 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536.

Data-dependent decay WKV6 recurrence. [arXiv:2404.05892; hf]

Attention-free constant-size state -> `long_500k` RUNS for this arch.
"""
from repro_torch.configs.base import BLOCK_RWKV, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,          # rwkv heads = d_model / rwkv_head_dim
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    head_dim=64,
    block_pattern=(BLOCK_RWKV,),
    rwkv_head_dim=64,
    act="relu",            # rwkv channel-mix uses squared relu
)

SMOKE = ModelConfig(
    name="rwkv6-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    block_pattern=(BLOCK_RWKV,),
    rwkv_head_dim=16,
    act="relu",
)
