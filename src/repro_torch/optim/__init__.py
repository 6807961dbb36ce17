"""The optimizer of the port: copies of ``repro.optim`` (AdamW, the LR
schedule, int8 gradient compression with error feedback)."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from repro_torch.optim.compression import compress_grads, dequantize_int8, init_error_fb, quantize_int8
from repro_torch.optim.schedules import cosine_warmup

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "compress_grads",
    "cosine_warmup",
    "dequantize_int8",
    "global_norm",
    "init_error_fb",
    "quantize_int8",
]
