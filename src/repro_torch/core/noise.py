"""Analog noise models (paper §IV Eqs. 9-11); port of ``repro/core/noise.py``.

Each model's noise std scales as ``1/sqrt(E)`` with ``E`` the energy per
MAC. Thermal/weight ``E`` is relative and unitless; shot-noise ``E`` is
optical energy in attojoules, ``photons/MAC = E / E_photon`` with
``E_photon = hc/lambda = 0.128 aJ`` at 1.55 um.

The ``"torch"`` backend (the reference's ``"jnp"``) draws its noise from
an explicit ``torch.Generator`` (``sample_output_noise``,
``perturb_weights``); the kernel and its plain version draw counter-based
Threefry gaussians (``kernels/prng.py``) instead.
"""
from __future__ import annotations

import dataclasses
import math

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


def standard_normal(gen: torch.Generator, shape, dtype=torch.float32, rows=None,
                    cols=None) -> torch.Tensor:
    """N(0, 1) of ``shape`` drawn from ``gen`` on its device. ``rows`` (r,
    data): data shard r's rows of the whole call's draw, whose flattened
    rows (every dim but the last) are ``data`` times ``shape``'s; ``cols``
    (t, tp): tensor shard t's window of the whole call's columns, ``tp``
    times ``shape``'s last dim. A generator's stream cannot skip, so the
    whole draw is made (data x tp the draws) and the shard's block taken:
    the bits of the same rows and columns of the one-device call."""
    shape = tuple(shape)
    if rows is None and cols is None:
        return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)
    r, data = rows or (0, 1)
    t, tp = cols or (0, 1)
    m, n = math.prod(shape[:-1]), shape[-1]
    whole = torch.randn((data * m, tp * n), generator=gen, device=gen.device, dtype=dtype)
    return whole[r * m:(r + 1) * m, t * n:(t + 1) * n].reshape(shape)


def sample_output_noise(gen: torch.Generator, shape, std, dtype=torch.float32,
                        rows=None, cols=None) -> torch.Tensor:
    """Reparameterized additive Gaussian output noise, ``std * N(0, 1)``,
    drawn from ``gen`` on its device; ``std`` broadcasts against ``shape``.
    The reparameterization (paper §V, [55]) makes the result differentiable
    with respect to ``std`` and so to the energies. ``rows``, ``cols``: as
    ``standard_normal``'s."""
    return standard_normal(gen, shape, dtype, rows, cols) * std


def perturb_weights(gen: torch.Generator, w, w_range, sigma_w: float, energy,
                    cols=None) -> torch.Tensor:
    """Eq. 10: elementwise Gaussian weight-read noise, drawn from ``gen``;
    ``w_range`` and ``energy`` broadcast per output channel (w's last axis).
    ``cols``: ``w`` is tensor shard t's columns of the whole weight, whose
    draw it takes its window of (``standard_normal``)."""
    std = weight_noise_std(w_range, sigma_w, energy)
    xi = standard_normal(gen, tuple(w.shape), cols=cols)
    return w.to(torch.float32) + xi * std


def noise_variance_for_layer(
    spec: NoiseSpec,
    *,
    n_macs,
    energy,
    w_range=None,
    x_range=None,
    w_col_norms=None,
    x_row_norm_sq_mean=None,
) -> torch.Tensor:
    """Analytic Var(eps_a) of a layer's output under each noise model (the
    noise-bits analysis, §III). Weight noise: the output variance of
    ``sum_j (W_ij + xi_j r sigma/sqrt(E)) x_j`` is ``(r sigma)^2/E ||x||^2``,
    at the mean squared input norm."""
    energy = torch.as_tensor(energy, dtype=torch.float32)
    if spec.kind == THERMAL:
        return thermal_noise_std(n_macs, w_range, x_range, spec.sigma, energy) ** 2
    if spec.kind == WEIGHT:
        return weight_noise_std(w_range, spec.sigma, energy) ** 2 * x_row_norm_sq_mean
    if spec.kind == SHOT:
        photons = energy / spec.photon_energy_aj
        return (w_col_norms**2) * x_row_norm_sq_mean / (n_macs * photons)
    return torch.zeros(())
