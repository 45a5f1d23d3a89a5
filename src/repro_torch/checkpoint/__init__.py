"""Checkpointing of the port (mirrors ``repro.checkpoint``)."""

from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointManager,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
