"""The port's data pipeline (a numpy copy of the JAX package's
``repro.data``)."""
from repro_torch.data.pipeline import SyntheticLMData, make_batch  # noqa: F401
