"""The model stack of the port (decoder LMs with attention, MoE, rwkv6 and
rglru blocks)."""
