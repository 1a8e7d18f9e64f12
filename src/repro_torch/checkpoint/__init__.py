from .ckpt import (  # noqa: F401
    AsyncCheckpointer,
    host_copy,
    latest_checkpoint,
    prune_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)
