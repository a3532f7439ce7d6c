"""Redundant coding: dynamic precision by repeating operations (paper §IV);
port of ``repro/core/redundant.py``.

Time averaging (K clock cycles, Fig. 3a) and spatial averaging (K device
copies, Fig. 3b/3c) are statistically the same: signals add linearly,
noise in quadrature. ``time_averaged_dot`` and ``spatial_averaged_dot``
run the fused path, one ``analog_dot`` with ``n_repeats=K`` (K draws
averaged in the kernel, or one draw at K·E on the ``"torch"`` backend).
The ``*_explicit`` forms build the O(K) computation the hardware performs
and are test oracles for the 1/sqrt(K) law.

``key`` is a raw uint32 key ((2,), or (B, 2) stacked per request), as the
reference takes it; the seed words reach ``analog_dot`` on x's device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.analog import AnalogConfig, SiteQuant, analog_dot, fold_key, key_seed
from repro_torch.quant.affine import ste_snap_levels


def _dot(x, w, cfg, energy, key, sq, n_repeats=1):
    return analog_dot(x, w, cfg=cfg, energy=energy, seed=key_seed(key, x.device), sq=sq,
                      n_repeats=n_repeats)


def time_averaged_dot(x: torch.Tensor, w: torch.Tensor, *, cfg: AnalogConfig, base_energy, key,
                      k_repeats: int, sq: Optional[SiteQuant] = None) -> torch.Tensor:
    """Fig. 3a: the op for K clock cycles at the base energy, averaged;
    fused into one ``analog_dot`` with ``n_repeats=K``."""
    return _dot(x, w, cfg, base_energy, key, sq, n_repeats=k_repeats)


def spatial_averaged_dot(x: torch.Tensor, w: torch.Tensor, *, cfg: AnalogConfig, base_energy,
                         key, k_repeats: int, sq: Optional[SiteQuant] = None) -> torch.Tensor:
    """Fig. 3b: K spatial copies of W, averaged; statistically time
    averaging, so the same fused path."""
    return _dot(x, w, cfg, base_energy, key, sq, n_repeats=k_repeats)


def time_averaged_dot_explicit(x: torch.Tensor, w: torch.Tensor, *, cfg: AnalogConfig,
                               base_energy, key, k_repeats: int,
                               sq: Optional[SiteQuant] = None) -> torch.Tensor:
    """Test oracle: K independent draws at ``fold_in(key, i)``, averaged."""
    draws = [_dot(x, w, cfg, base_energy, fold_key(key, i), sq) for i in range(k_repeats)]
    return torch.mean(torch.stack(draws), dim=0)


def spatial_averaged_dot_explicit(x: torch.Tensor, w: torch.Tensor, *, cfg: AnalogConfig,
                                  base_energy, key, k_repeats: int,
                                  sq: Optional[SiteQuant] = None) -> torch.Tensor:
    """Test oracle: ``[x, x, ...] . [W; W; ...] / K`` on one K-fold array;
    each spatial copy of W reads its own device noise."""
    w_tiled = w.repeat(k_repeats, 1)  # (K*k, N)
    x_tiled = x.repeat(*((1,) * (x.dim() - 1)), k_repeats)  # (..., K*k)
    return _dot(x_tiled, w_tiled, cfg, base_energy, key, sq) / float(k_repeats)


def discrete_levels(energy: torch.Tensor, quantum: float) -> torch.Tensor:
    """Round energies to integer redundancy levels with an STE (paper §V)."""
    return ste_snap_levels(energy, quantum)
