"""Checkpoints of the training state (reference: ``repro/ckpt``)."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
