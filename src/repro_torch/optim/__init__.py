from .adamw import (OptState, adamw_init, adamw_update, clip_by_global_norm,
                    cosine_schedule)
from .compression import int8_compress, int8_decompress

__all__ = ["OptState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "int8_compress", "int8_decompress"]
