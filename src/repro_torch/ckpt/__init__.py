"""Disk checkpoints of the port (the counterpart of ``repro.ckpt``)."""
from repro_torch.ckpt.checkpoint import (  # noqa: F401
    CheckpointError, Checkpointer, clean_stale_tmp, latest_step,
    load_checkpoint, save_checkpoint)
