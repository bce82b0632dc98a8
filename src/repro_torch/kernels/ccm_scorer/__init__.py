"""The CCM stage-2 exchange scorer: layout, plain torch version (ref),
CUDA kernel wrapper (kernel), event launcher (launch) and host combine
(ops)."""
from repro_torch.kernels.ccm_scorer.layout import (  # noqa: F401
    AV, N_AV, N_OUT, N_PM, N_SC, OUT, PM, SC)
