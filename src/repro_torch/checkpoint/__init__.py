"""Checkpoint substrate of the port (``repro/checkpoint``)."""
from repro_torch.checkpoint.store import CheckpointStore

__all__ = ["CheckpointStore"]
