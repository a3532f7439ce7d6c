"""Bucket-batched serving (port of ``repro/serving``, batch-synchronous)."""
from repro_torch.serving.engine import ServingEngine

__all__ = ["ServingEngine"]
