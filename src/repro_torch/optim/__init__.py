"""Optimizers (port of ``repro/optim``): AdamW over the port's trees."""
from repro_torch.optim.adam import AdamConfig, AdamState, adam_init, adam_update

__all__ = ["AdamConfig", "AdamState", "adam_init", "adam_update"]
