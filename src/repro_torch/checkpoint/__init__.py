"""Checkpointing of the port: async save, integrity digests, verified restore."""
from .manager import CheckpointManager, latest_step, restore_pytree, save_pytree
