"""AdamW and learning-rate schedules of the port."""

from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.schedules import make_schedule

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm",
           "make_schedule"]
