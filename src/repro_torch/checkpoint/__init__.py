"""Checkpoints of the port (the JAX package's ``repro.checkpoint``)."""

from repro_torch.checkpoint.store import (CheckpointManager, latest_step,
                                          restore_checkpoint, save_checkpoint)
