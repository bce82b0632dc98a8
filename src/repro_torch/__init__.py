"""PyTorch/CUDA port of the CCM-LB balancer, its assembly application and
the model stack's serving path (the JAX package ``repro`` is the
reference).  Host control flow stays numpy; the stage-2 scorer, the
assembly tile, flash attention, the expert GEMM, WKV6 and the RG-LRU scan
run as hand-written CUDA kernels on the card (``csrc/``)."""
