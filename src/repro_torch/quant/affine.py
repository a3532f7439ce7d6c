"""Affine (uniform) quantization (paper Eq. 2); port of the parts of
``repro/quant/affine.py`` that serving uses.

Values in [x_min, x_max] map onto ``n_bins = ceil(2^B - 1)`` bins of width
``delta = range / n_bins``. ``torch.round`` rounds half to even, like
``jnp.round``. The port serves frozen models, so there is no straight-through
gradient here.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QuantParams:
    """Quantizer state for one tensor (or one channel axis of it).

    ``x_min``/``x_max`` are float32 tensors, scalars (per-tensor) or
    broadcastable vectors (per-channel). ``bits`` may be fractional.
    """

    x_min: torch.Tensor
    x_max: torch.Tensor
    bits: float = 8.0

    @property
    def n_bins(self) -> float:
        # ceil(2^B - 1) in float32, as the reference computes it
        return float(torch.ceil(torch.tensor(2.0) ** self.bits - 1.0))

    @property
    def delta(self) -> torch.Tensor:
        rng = self.x_max.to(torch.float32) - self.x_min.to(torch.float32)
        return rng / max(self.n_bins, 1.0)

    @property
    def zero_point(self) -> torch.Tensor:
        return torch.round(-self.x_min.to(torch.float32) / self.delta.clamp_min(1e-30))


def fake_quant(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """Quantize-dequantize: ``x`` up to ``delta/2`` inside the clip range."""
    delta = qp.delta.clamp_min(1e-30)
    code = torch.clamp(torch.round(x / delta) + qp.zero_point, 0.0, float(qp.n_bins))
    return (code - qp.zero_point) * qp.delta


def ste_snap_levels(e: torch.Tensor, quantum: float) -> torch.Tensor:
    """Snap energies to positive integer multiples of ``quantum``."""
    return torch.clamp_min(torch.round(e / quantum), 1.0) * quantum
