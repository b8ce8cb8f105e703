from repro_torch.checkpoint.checkpointer import (
    AsyncCheckpointer, latest_checkpoint, restore_checkpoint,
    save_checkpoint)
