"""The capacity-batched expert GEMM: plain torch version (ref), CUDA kernel
wrapper (kernel) and the public entry point (ops)."""
from repro_torch.kernels.moe_gemm.ops import expert_gemm  # noqa: F401
from repro_torch.kernels.moe_gemm.ref import reference_expert_gemm  # noqa: F401
