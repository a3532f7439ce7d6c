"""Optimizers (port of ``repro/optim``): AdamW over the port's trees,
global-norm clipping and int8 gradient compression."""
from repro_torch.optim.adam import AdamConfig, AdamState, adam_init, adam_update, adam_update_
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.compress import (
    ef_compress,
    ef_int8_roundtrip,
    int8_dequantize,
    int8_quantize,
)

__all__ = ["AdamConfig", "AdamState", "adam_init", "adam_update", "adam_update_",
           "clip_by_global_norm", "ef_compress", "ef_int8_roundtrip", "global_norm",
           "int8_dequantize", "int8_quantize"]
