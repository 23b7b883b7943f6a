"""Checkpointing of the port (``repro.checkpoint``'s twin)."""

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
