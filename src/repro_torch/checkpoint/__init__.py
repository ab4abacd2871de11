"""Fault-tolerant checkpoints of the port (:class:`CheckpointManager`)."""

from .manager import CheckpointManager, PlacementError

__all__ = ["CheckpointManager", "PlacementError"]
