"""Per-token work of one layer, one module a block kind of the port's
``block_pattern`` (``moe``, ``attn``, ``rwkv6``), found by the kind's name.
Each gives ``matmul_macs(m)``, the multiply-accumulates of the layer's dense
products for one token in the forward pass (the active experts only), and
``attention_macs(m, q_len, kv_len, causal)``, those of its attention scores
and weighted sums for one sequence (0 for an attention-free kind).  ``m`` is
a configuration file's ``model`` table."""
