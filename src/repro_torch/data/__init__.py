"""Data (port of ``repro/data``): the deterministic synthetic token task and
the paper-validation datasets."""
from repro_torch.data.pipeline import DataPipeline, TokenTaskConfig, markov_batch
from repro_torch.data.synthetic import (
    make_entailment_dataset,
    make_image_dataset,
    make_tabular_dataset,
)

__all__ = [
    "DataPipeline",
    "TokenTaskConfig",
    "make_entailment_dataset",
    "make_image_dataset",
    "make_tabular_dataset",
    "markov_batch",
]
