"""The CCM stage-2 exchange scorer: layout, plain torch versions (ref),
CUDA kernel wrappers (kernel), the event launcher (launch) and the host
combine the fused pair scorer is held to (ops)."""
from repro_torch.kernels.ccm_scorer.layout import (  # noqa: F401
    AV, N_AV, N_OUT, N_PM, N_SC, OUT, PM, SC)
