from .adamw import (AdamWConfig, adamw_init, adamw_update,
                    clip_by_global_norm, global_norm, make_schedule)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "global_norm", "make_schedule"]
