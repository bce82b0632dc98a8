"""Flash attention, forward: plain torch version (ref), CUDA kernel wrapper
(kernel) and the public entry point (ops)."""
from repro_torch.kernels.flash.ops import flash_attention  # noqa: F401
from repro_torch.kernels.flash.ref import reference_attention  # noqa: F401
