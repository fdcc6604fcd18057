from repro_torch.optim.adamw import adamw_init, adamw_update, clip_by_global_norm
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.optim.grad_compress import (
    compress_state_init,
    compressed_psum,
    quantize_int8,
    dequantize_int8,
)

__all__ = [
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_schedule",
    "compress_state_init",
    "compressed_psum",
    "quantize_int8",
    "dequantize_int8",
]
