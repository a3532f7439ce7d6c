"""The fault-tolerant training driver (port of ``repro/runtime``) and the
training and LM-calibration entry points (``python -m
repro_torch.runtime.train_lm`` / ``calibrate_lm``)."""
from repro_torch.runtime.driver import DriverConfig, SimulatedFailure, StragglerMonitor, TrainDriver

__all__ = ["DriverConfig", "SimulatedFailure", "StragglerMonitor", "TrainDriver"]
