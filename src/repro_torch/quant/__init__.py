"""Affine quantization (port of ``repro/quant``)."""
from repro_torch.quant.affine import QuantParams, fake_quant, ste_snap_levels

__all__ = ["QuantParams", "fake_quant", "ste_snap_levels"]
