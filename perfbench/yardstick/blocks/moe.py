"""An attention block whose MLP is a routed mixture of experts: the
attention projections, the router (d x E) and the top-k experts' three
products; shared experts, where the model has them, are dense MLPs."""
from perfbench.yardstick.blocks import attn


def matmul_macs(m) -> int:
    d = m["d_model"]
    experts = m["top_k"] * 3 * d * m["moe_d_ff"]
    shared = m.get("num_shared_experts", 0) * 3 * d * m["d_ff"]
    return attn.projection_macs(m) + d * m["num_experts"] + experts + shared


attention_macs = attn.attention_macs


def capacity(m, tokens: int) -> int:
    """The tokens an expert keeps at most out of ``tokens``: the
    configuration's capacity factor times its even share of the tokens'
    top-k choices, plus one, rounded up to a multiple of 8, at most all."""
    c = int(m["capacity_factor"] * tokens * m["top_k"] / m["num_experts"]) + 1
    c = (c + 7) // 8 * 8
    return max(1, min(c, tokens))
