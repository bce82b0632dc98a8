"""WKV6, forward: plain torch versions (ref), CUDA kernel wrapper (kernel)
and the public entry point (ops)."""
from repro_torch.kernels.rwkv6.ops import wkv6  # noqa: F401
from repro_torch.kernels.rwkv6.ref import reference_wkv6  # noqa: F401
