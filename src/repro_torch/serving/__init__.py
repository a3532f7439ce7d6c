"""Bucket-batched serving (port of ``repro/serving``): batch-synchronous
or continuous, over uniform-K and per-layer profile tiers."""
from repro_torch.serving.engine import ServingEngine

__all__ = ["ServingEngine"]
