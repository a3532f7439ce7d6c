"""Analog execution core: noise models and ``analog_dot``."""
from repro_torch.core.analog import AnalogConfig, SiteQuant, analog_dot
from repro_torch.core.noise import NoiseSpec

__all__ = ["AnalogConfig", "NoiseSpec", "SiteQuant", "analog_dot"]
