"""Optimizer substrate: AdamW, schedules, clipping, int8+EF compression."""
from .adamw import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)
from .compress import dequantize_int8, ef_compress, ef_init, quantize_int8

__all__ = [
    "AdamWConfig", "OptState", "adamw_init", "adamw_update",
    "cosine_schedule", "global_norm",
    "dequantize_int8", "ef_compress", "ef_init", "quantize_int8",
]
