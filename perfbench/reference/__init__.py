"""The plain reference: each model family the benchmark serves, one module a
family named by a configuration's ``reference`` (``rwkv6_lm``, ``attn_lm``),
in plain PyTorch operations, float32 with TF32 off.  It imports nothing of
the program, neither ``repro_torch`` nor the JAX package, and takes only
what the benchmark makes (weights drawn from the seed, token ids).  The
control computes the same in a lower precision
(``precision.Precision("fp8")``)."""
