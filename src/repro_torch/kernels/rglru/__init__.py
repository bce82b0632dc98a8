"""The RG-LRU scan: plain torch version (ref), CUDA kernel wrapper (kernel)
and the public entry point (ops)."""
from repro_torch.kernels.rglru.ops import rglru_scan_op  # noqa: F401
from repro_torch.kernels.rglru.ref import reference_rglru  # noqa: F401
