"""whisper-large-v3 [audio] — enc-dec, conv frontend stubbed per assignment.

32L d_model=1280 20H (GQA kv=20, i.e. MHA) d_ff=5120 vocab=51866.
[arXiv:2212.04356; unverified]

``seq_len`` is interpreted as the encoder frame count (the audio frontend is a
stub: ``input_specs`` provides precomputed frame embeddings); the decoder runs
min(448, seq_len // 8) text positions.  Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import BLOCK_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    num_decoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    block_pattern=(BLOCK_ATTN,),
    arch_type="encdec",
    frontend="audio",
    act="gelu",
    norm_eps=1e-5,
    skip_shapes=("long_500k",),
)

# Reduced config of the same family for CPU smoke tests.
SMOKE = ModelConfig(
    name="whisper-smoke",
    family="audio",
    num_layers=2,
    num_decoder_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    block_pattern=(BLOCK_ATTN,),
    arch_type="encdec",
    frontend="audio",
    act="gelu",
    norm_eps=1e-5,
    skip_shapes=("long_500k",),
)
