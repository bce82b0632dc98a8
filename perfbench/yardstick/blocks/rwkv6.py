"""An RWKV6 block: the time mix (r, k, v, g and output projections, the
token-shift LoRA of rank ``mix_lora`` for its five mixes and the decay LoRA
of rank ``decay_lora``) and the squared-ReLU channel mix (key, value and
receptance).  The WKV recurrence is no dense product; its work is the
kernel family's (``yardstick/kernels/wkv6.py``)."""


def matmul_macs(m) -> int:
    d, f = m["d_model"], m["d_ff"]
    mix, decay = m["mix_lora"], m["decay_lora"]
    time_mix = 5 * d * d + d * 5 * mix + 5 * mix * d + d * decay + decay * d
    channel_mix = d * f + f * d + d * d
    return time_mix + channel_mix


def attention_macs(m, q_len: int, kv_len: int, causal: bool = True) -> int:
    return 0
