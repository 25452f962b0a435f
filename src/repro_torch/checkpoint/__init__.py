from repro_torch.checkpoint.store import (
    CheckpointCorruptError,
    is_valid_checkpoint,
    load_pytree,
    load_pytree_flat,
    save_pytree,
)

__all__ = [
    "CheckpointCorruptError",
    "is_valid_checkpoint",
    "load_pytree",
    "load_pytree_flat",
    "save_pytree",
]
