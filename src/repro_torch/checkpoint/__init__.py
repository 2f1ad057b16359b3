from repro_torch.checkpoint.store import (  # noqa: F401
    save_checkpoint, restore_checkpoint, latest_step, committed_steps,
    CheckpointCorruptError, AsyncCheckpointer)
