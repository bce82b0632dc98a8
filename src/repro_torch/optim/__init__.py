"""Optimizers and schedules of the port (the JAX package's ``repro.optim``
is the reference)."""
from repro_torch.optim.adamw import AdamW, global_norm  # noqa: F401
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
