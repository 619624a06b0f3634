"""Atomic, asynchronous, self-describing checkpoints of tensor trees."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager, latest_step, restore, save)
