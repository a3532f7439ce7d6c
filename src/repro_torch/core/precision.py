"""Noise bits: the analog-noise <-> bit-precision equivalence (paper §III);
port of ``repro/core/precision.py``.

``B_eps = log2( range / sqrt(12 * Var(eps_a)) + 1 )``          (Eq. 7)

with its thermal-noise form (Eq. 8) and the inverse map (bits -> the
equivalent noise variance). Pure float32 math on tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32)


def noise_bits(out_range, noise_var) -> torch.Tensor:
    """Eq. 7: the bits whose quantization noise variance equals
    ``noise_var`` for a uniform quantizer spanning ``out_range``."""
    noise_var = torch.clamp_min(_f32(noise_var), 1e-30)
    return torch.log2(_f32(out_range) / torch.sqrt(12.0 * noise_var) + 1.0)


def noise_var_from_bits(out_range, bits) -> torch.Tensor:
    """Inverse of Eq. 7, the quantization noise variance of a B-bit
    uniform quantizer (Eq. 6): ``(range / (2^B - 1))^2 / 12``."""
    n_bins = 2.0 ** _f32(bits) - 1.0
    delta = _f32(out_range) / torch.clamp_min(n_bins, 1e-9)
    return delta * delta / 12.0


def thermal_noise_bits(out_range, n_macs, w_range, x_range, sigma_t: float,
                       energy=1.0) -> torch.Tensor:
    """Eq. 8 with dynamic energy (§VI Table III): noise bits of a layer
    under thermal noise. ``out_range`` is the (l+1) activation range,
    ``w_range``/``x_range`` the layer-(l) weight/input ranges."""
    denom = (
        sigma_t * _f32(w_range) * _f32(x_range) * torch.sqrt(12.0 * _f32(n_macs))
        / torch.sqrt(_f32(energy))
    )
    return torch.log2(_f32(out_range) / torch.clamp_min(denom, 1e-30) + 1.0)


def empirical_noise_var(clean: torch.Tensor, noisy: torch.Tensor) -> torch.Tensor:
    """Monte-Carlo Var(eps_a) over a whole layer (§III)."""
    err = (noisy.to(F32) - clean.to(F32)).reshape(-1)
    return torch.mean(err * err)


def snr_noise_bits(snr) -> torch.Tensor:
    """The SNR connection (§III): ``B = log2(sqrt(SNR) + 1)`` for a uniform
    signal; for comparison only, not Table I."""
    return torch.log2(torch.sqrt(_f32(snr)) + 1.0)


def average_bits(per_layer_bits: dict, per_layer_macs: Optional[dict] = None, *,
                 weighted: bool = False) -> torch.Tensor:
    """Average noise bits over layers: the plain mean over layers (Table
    I's "Average Bits"), or with ``weighted`` the MAC-weighted mean
    ``sum_l B_l * n_l / sum_l n_l``, ``n_l = sum(per_layer_macs[l])``."""
    vals = torch.stack([_f32(per_layer_bits[k]).mean() for k in per_layer_bits])
    if not weighted:
        return torch.mean(vals)
    if per_layer_macs is None:
        raise ValueError("weighted=True requires per_layer_macs")
    w = torch.stack([torch.sum(_f32(per_layer_macs[k])) for k in per_layer_bits])
    return torch.sum(vals * w) / torch.sum(w)
