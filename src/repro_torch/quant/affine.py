"""Affine (uniform) quantization with straight-through gradients (paper
Eq. 2); port of ``repro/quant/affine.py``.

Values in [x_min, x_max] map onto ``n_bins = ceil(2^B - 1)`` bins of width
``delta = range / n_bins``. ``torch.round`` rounds half to even, like
``jnp.round``. Rounding passes its gradient straight through (paper §V),
and the clip to ``[0, n_bins]`` splits the gradient in half where a value
sits exactly on a bound, as ``jnp.clip`` does (``torch.clamp`` would pass
all of it).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

F32 = torch.float32


class _SteRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, grad):
        return grad


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round() with a straight-through gradient (paper §V, [57])."""
    return _SteRound.apply(x)


def ste_snap_levels(e: torch.Tensor, quantum: float) -> torch.Tensor:
    """Snap to positive integer multiples of ``quantum`` with a full
    straight-through gradient (gradient 1 even below one quantum, so learned
    energies can recover from the floor)."""
    snapped = torch.clamp_min(torch.round(e / quantum), 1.0) * quantum
    return e + (snapped - e).detach()


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: min(max(x, lo), hi), half the gradient at a tie."""
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


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
        rng = self.x_max.to(F32) - self.x_min.to(F32)
        return rng / max(self.n_bins, 1.0)

    @property
    def zero_point(self) -> torch.Tensor:
        return ste_round(-self.x_min.to(F32) / self.delta.clamp_min(1e-30))


def quantize(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """Map float x -> integer codes in [0, n_bins] (float32, for the STE)."""
    delta = qp.delta.clamp_min(1e-30)
    code = ste_round(x / delta) + qp.zero_point
    return _clip(code, 0.0, qp.n_bins)


def dequantize(code: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    return (code - qp.zero_point) * qp.delta


def fake_quant(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient: ``x`` up to
    ``delta/2`` inside the clip range."""
    return dequantize(quantize(x, qp), qp)


def calibrate_minmax(x: torch.Tensor, *, bits: float = 8.0,
                     channel_axis: Optional[int] = None) -> QuantParams:
    """Min/max calibration; per-channel if ``channel_axis`` is given (the
    stats along ``channel_axis`` kept, the rest reduced: the paper's
    per-channel weight quantization, Appendix A)."""
    if channel_axis is None:
        lo, hi = torch.amin(x), torch.amax(x)
    else:
        axes = tuple(i for i in range(x.dim()) if i != channel_axis % x.dim())
        lo = torch.amin(x, dim=axes, keepdim=True)
        hi = torch.amax(x, dim=axes, keepdim=True)
    # 0 representable, range non-degenerate
    lo = torch.clamp_max(lo, 0.0)
    hi = torch.maximum(hi, lo + 1e-8)
    return QuantParams(x_min=lo, x_max=hi, bits=bits)


def _percentile(flat: torch.Tensor, percentile: float) -> torch.Tensor:
    """``jnp.percentile``'s linear interpolation, step for step in float32:
    position ``q * (n - 1)`` between the order statistics at its floor and
    ceil. The order statistics come from ``torch.kthvalue``, which, unlike
    ``torch.quantile``, takes inputs above 2^24 elements."""
    n = flat.numel()
    # (percentile / 100) * (n - 1) as XLA compiles the reference's: the
    # division a product with the float32 reciprocal 0.01, the two constant
    # factors folded into one
    scale = torch.tensor(0.01, dtype=F32) * (torch.tensor(float(n), dtype=F32) - 1.0)
    pos = torch.tensor(percentile, dtype=F32) * scale
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    lo_i = int(min(max(float(low), 0.0), n - 1))
    hi_i = int(min(max(float(high), 0.0), n - 1))
    lo_v = torch.kthvalue(flat, lo_i + 1).values.cpu()
    hi_v = lo_v if hi_i == lo_i else torch.kthvalue(flat, hi_i + 1).values.cpu()
    return (lo_v * low_w + hi_v * high_w).to(flat.device)


def calibrate_percentile(x: torch.Tensor, *, bits: float = 8.0,
                         percentile: float = 99.99) -> QuantParams:
    """Percentile-clipped activation calibration (paper Appendix A): the
    range clipped at the two-sided ``percentile``; used where the noise
    scales with the activation range (thermal noise)."""
    flat = x.reshape(-1).to(F32)
    hi = _percentile(flat, percentile)
    lo = _percentile(flat, 100.0 - percentile)
    lo = torch.clamp_max(lo, 0.0)
    hi = torch.maximum(hi, lo + 1e-8)
    return QuantParams(x_min=lo, x_max=hi, bits=bits)


def merge_running(qp: QuantParams, new: QuantParams, momentum: float = 0.99) -> QuantParams:
    """Moving-average range tracking (paper Appendix A, weight noise)."""
    return QuantParams(
        x_min=momentum * qp.x_min + (1.0 - momentum) * new.x_min,
        x_max=momentum * qp.x_max + (1.0 - momentum) * new.x_max,
        bits=qp.bits,
    )
