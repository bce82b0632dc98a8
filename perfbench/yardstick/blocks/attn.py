"""A full-attention block with a gated MLP."""


def projection_macs(m) -> int:
    d, h, hkv, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    return d * h * hd + 2 * d * hkv * hd + h * hd * d


def matmul_macs(m) -> int:
    return projection_macs(m) + 3 * m["d_model"] * m["d_ff"]


def attention_macs(m, q_len: int, kv_len: int, causal: bool = True) -> int:
    """Scores and weighted sums: 2 * H * hd a (query, key) pair; a causal
    square counts only the S (S + 1) / 2 pairs the mask keeps."""
    if causal:
        if q_len != kv_len:
            raise ValueError("causal attention counted for Sq == Skv only")
        pairs = q_len * (q_len + 1) // 2
    else:
        pairs = q_len * kv_len
    return 2 * m["num_heads"] * m["head_dim"] * pairs
