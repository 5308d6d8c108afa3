from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                               latest_step, restore, save)

__all__ = ["CheckpointManager", "latest_step", "restore", "save"]
