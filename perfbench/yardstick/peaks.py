"""Published peaks of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  A card set below
that limit runs slower under load; the run prints its ``power.limit``
beside every share of these peaks."""

#: dense bf16 / fp16 tensor-core FLOP/s
BF16_FLOPS = 989e12
#: float32 FLOP/s outside the tensor cores
FP32_FLOPS = 67e12
#: HBM3 bytes/s
HBM_BYTES_PER_S = 3.35e12
#: device memory, bytes
HBM_BYTES = 80e9


def bound_s(flops: float, nbytes: float, peak_flops: float = BF16_FLOPS,
            bandwidth: float = HBM_BYTES_PER_S) -> float:
    """The least time the card could take for ``flops`` operations and
    ``nbytes`` moved: the larger of the compute and the memory term."""
    return max(flops / peak_flops, nbytes / bandwidth)
