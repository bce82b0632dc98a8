"""The §VI-D task-duration cost model, ported (the JAX package's
``repro.costmodel`` is the reference)."""
from repro_torch.costmodel.losses import (mae, rmse,  # noqa: F401
                                          under_penalized_rmse)
from repro_torch.costmodel.network import FNN, FNNConfig  # noqa: F401
from repro_torch.costmodel.reduction import dynamic_data_reduce  # noqa: F401
from repro_torch.costmodel.scaler import StandardScaler  # noqa: F401
from repro_torch.costmodel.train import (CostModel,  # noqa: F401
                                         train_cost_model)
