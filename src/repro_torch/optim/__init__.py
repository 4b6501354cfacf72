from .adamw import (AdamWConfig, adamw_init, adamw_update,
                    clip_by_global_norm, global_norm, make_schedule)
from .compression import (compress_grads, decompress_grads,
                          error_feedback_update, wire_bytes)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "compress_grads", "decompress_grads",
           "error_feedback_update", "global_norm", "make_schedule",
           "wire_bytes"]
