"""PyTorch/CUDA port of the CCM-LB balancer (the JAX package ``repro`` is
the reference).  Host control flow stays numpy; the stage-2 scorer runs as
a hand-written CUDA kernel on the card (``csrc/ccm_scorer.cu``)."""
