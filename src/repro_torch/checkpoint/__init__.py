"""Checkpoints of the port, in the reference's on-disk layout."""
from .manager import CheckpointManager, load_pytree, save_pytree

__all__ = ["CheckpointManager", "load_pytree", "save_pytree"]
