"""Analog noise models (paper §IV Eqs. 9-11); port of ``repro/core/noise.py``.

Each model's noise std scales as ``1/sqrt(E)`` with ``E`` the energy per
MAC. Thermal/weight ``E`` is relative and unitless; shot-noise ``E`` is
optical energy in attojoules, ``photons/MAC = E / E_photon`` with
``E_photon = hc/lambda = 0.128 aJ`` at 1.55 um.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

PLANCK_J_S = 6.62607015e-34
LIGHTSPEED_M_S = 2.99792458e8
DEFAULT_WAVELENGTH_M = 1.55e-6
#: photon energy at 1.55um in attojoules (1 aJ = 1e-18 J): hc/lambda = 0.128 aJ.
PHOTON_ENERGY_AJ = PLANCK_J_S * LIGHTSPEED_M_S / DEFAULT_WAVELENGTH_M * 1e18

THERMAL = "thermal"
WEIGHT = "weight"
SHOT = "shot"
NONE = "none"
KINDS = (NONE, THERMAL, WEIGHT, SHOT)


@dataclasses.dataclass(frozen=True)
class NoiseSpec:
    """Which physical noise source limits the analog accelerator.

    ``sigma`` is sigma_t for thermal noise or sigma_w for weight noise;
    unused for shot noise, whose scale photon statistics fix.
    """

    kind: str = NONE
    sigma: float = 0.01
    photon_energy_aj: float = PHOTON_ENERGY_AJ

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown noise kind {self.kind!r}; expected one of {KINDS}")


def thermal_noise_std(n_macs, w_range, x_range, sigma_t: float, energy) -> torch.Tensor:
    """Eq. 9: sqrt(N) * (Wmax-Wmin) * (xmax-xmin) * sigma_t / sqrt(E).
    ``sqrt(N)`` is the float32 square root, as in the reference."""
    sqrt_n = float(np.sqrt(np.float32(n_macs)))
    return sqrt_n * w_range * x_range * sigma_t / torch.sqrt(energy)


def weight_noise_std(w_range, sigma_w: float, energy) -> torch.Tensor:
    """Eq. 10 per-weight perturbation std: (Wmax-Wmin) * sigma_w / sqrt(E)."""
    return w_range * sigma_w / torch.sqrt(energy)


def shot_noise_std(
    w_col_norms, x_row_norms, n_macs, energy_aj, photon_energy_aj: float = PHOTON_ENERGY_AJ
) -> torch.Tensor:
    """Eq. 11: ||W_i||2 ||x||2 / sqrt(N * photons_per_mac)."""
    photons = torch.as_tensor(energy_aj, dtype=torch.float32) / photon_energy_aj
    return w_col_norms * x_row_norms / torch.sqrt(photons * float(np.float32(n_macs)))
