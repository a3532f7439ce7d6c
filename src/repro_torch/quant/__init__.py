"""Affine quantization (port of ``repro/quant``): per-tensor and per-channel
quantizers with straight-through gradients, fractional bit counts and
min/max or percentile calibration."""
from repro_torch.quant.affine import (
    QuantParams,
    calibrate_minmax,
    calibrate_percentile,
    dequantize,
    fake_quant,
    merge_running,
    quantize,
    ste_round,
    ste_snap_levels,
)

__all__ = [
    "QuantParams",
    "calibrate_minmax",
    "calibrate_percentile",
    "dequantize",
    "fake_quant",
    "merge_running",
    "quantize",
    "ste_round",
    "ste_snap_levels",
]
