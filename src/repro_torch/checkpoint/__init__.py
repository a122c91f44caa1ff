"""SEARS-backed checkpointing: dedup + erasure-coded, k-of-n restore."""

from repro_torch.checkpoint.manager import SEARSCheckpointManager

__all__ = ["SEARSCheckpointManager"]
