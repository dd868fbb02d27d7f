"""Device-independent checkpointing with async save and restore onto any
device."""
from repro_torch.checkpoint.ckpt import (
    AsyncCheckpointer, latest_step, restore_checkpoint, save_checkpoint,
    tree_leaves,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer", "tree_leaves"]
