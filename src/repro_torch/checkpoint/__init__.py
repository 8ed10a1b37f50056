"""Fault-tolerant checkpointing: async save/restore + manager."""
from . import checkpointer, manager
from .manager import CheckpointManager
__all__ = ["checkpointer", "manager", "CheckpointManager"]
