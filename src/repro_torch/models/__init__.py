"""The model stack of the port (decoder LMs with attention and MoE blocks)."""
