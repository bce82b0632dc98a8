"""gemma2-27b [dense] — 46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.

Local+global alternating attention, attention/final logit softcaps.
[arXiv:2408.00118; hf].

`long_500k` RUNS for this arch: local layers have O(window) KV and global
layers at decode are linear in KV length (sequence-sharded cache); see
DESIGN.md shape-skip notes.
"""
from repro_torch.configs.base import BLOCK_ATTN, BLOCK_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,
    block_pattern=(BLOCK_LOCAL, BLOCK_ATTN),  # alternating sliding/global
    window_size=4096,
    logit_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma2-smoke",
    family="dense",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=192,
    vocab_size=256,
    head_dim=16,
    block_pattern=(BLOCK_LOCAL, BLOCK_ATTN),
    window_size=16,
    logit_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
)
