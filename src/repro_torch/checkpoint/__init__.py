"""Fault-tolerant checkpoints of the port (:class:`CheckpointManager`)."""

from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
