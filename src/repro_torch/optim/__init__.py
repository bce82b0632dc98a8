"""Optimizers of the port (the JAX package's ``repro.optim`` is the
reference); ``schedule.py`` is not ported yet."""
from repro_torch.optim.adamw import AdamW, global_norm  # noqa: F401
