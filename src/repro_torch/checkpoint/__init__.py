"""Checkpoints of the port (the JAX package's ``repro.checkpoint`` is the
reference)."""
from repro_torch.checkpoint.checkpoint import (CheckpointManager,  # noqa: F401
                                               latest_step, restore, save,
                                               tree_leaves)
