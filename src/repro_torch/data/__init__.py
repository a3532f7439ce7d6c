"""Data (port of ``repro/data``): the deterministic synthetic token task."""
from repro_torch.data.pipeline import DataPipeline, TokenTaskConfig, markov_batch

__all__ = ["DataPipeline", "TokenTaskConfig", "markov_batch"]
