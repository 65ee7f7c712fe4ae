"""Asynchronous atomic checkpointing."""

from repro_torch.checkpoint.manager import CheckpointCorruptionError, CheckpointManager

__all__ = ["CheckpointCorruptionError", "CheckpointManager"]
