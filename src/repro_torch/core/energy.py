"""Energy accounting and the Eq.-14 penalty; port of ``repro/core/energy.py``.

Energies are learned in log-space (``E = exp(log_e)``): the noise std
scales as ``1/sqrt(E)``, so positivity is structural. MAC counts are
per-example (batch-independent); a budget is a target *average
energy/MAC*, so batch factors cancel.

Trees are nested dicts of float32 tensors (``repro_torch.tree``). Every
product and sum is taken in float32, leaf by leaf in the reference's leaf
order, as ``jax.numpy`` computes it. A leaf may be a tensor on any
device or a Python number; each pair is computed on the energy leaf's
device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.quant.affine import ste_snap_levels
from repro_torch.tree import leaves, map_leaves

F32 = torch.float32
EnergyTree = Dict[str, torch.Tensor]  # site -> scalar (per-layer) or (C,) (per-channel)
MacTree = Dict[str, torch.Tensor]  # site -> per-example MACs, the energy leaf's shape

# Digital per-MAC cost constants in aJ/MAC, for pricing digital tiers next
# to the analog energy tree in one ledger: the CMOS survey numbers
# (Horowitz, ISSCC'14: ~0.2 pJ per 8-bit MAC, ~1 pJ per fp16-class MAC at
# 45 nm) scaled ~6-7x down for a ~7 nm node. Order-of-magnitude constants:
# digital MACs sit 2-3 decades above the analog array's tens of aJ/MAC.
DIGITAL_INT8_AJ_PER_MAC = 30_000.0  # 30 fJ/MAC: int8 multiply-accumulate
DIGITAL_BF16_AJ_PER_MAC = 120_000.0  # 120 fJ/MAC: bf16 multiply-accumulate


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32, device=device)


def _device(x):
    return x.device if torch.is_tensor(x) else None


def to_energy(log_e: EnergyTree, *, discrete: bool = False, quantum: float = 1.0) -> EnergyTree:
    """Log-parameters -> positive energies; ``discrete`` snaps them to
    integer multiples (>= 1) of ``quantum`` (photon or repeat counts) with
    a straight-through gradient."""

    def one(_path, le):
        e = torch.exp(_f32(le))
        return ste_snap_levels(e, quantum) if discrete else e

    return map_leaves(one, log_e)


def total_energy(energies: EnergyTree, macs: MacTree) -> torch.Tensor:
    """``E_tot = sum_l E^(l) * n_mac^(l)`` per example, over any pair of
    trees of one structure (flat site dicts or nested LM trees)."""
    prods = map_leaves(
        lambda _p, e, m: torch.sum(_f32(e) * _f32(m, _device(e))), energies, macs
    )
    parts = leaves(prods)
    dev = parts[0].device
    return torch.sum(torch.stack([p.to(dev) for p in parts]))


def total_macs(macs: MacTree) -> torch.Tensor:
    parts = [torch.sum(_f32(m)) for m in leaves(macs)]
    dev = parts[0].device
    return torch.sum(torch.stack([p.to(dev) for p in parts]))


def avg_energy_per_mac(energies: EnergyTree, macs: MacTree) -> torch.Tensor:
    e_tot = total_energy(energies, macs)
    return e_tot / total_macs(macs).to(e_tot.device)


def apply_repeats(energies: EnergyTree, repeats) -> EnergyTree:
    """Each site's energy times its repeat count K: serving a site at K
    repeats spends ``K * E`` a MAC (the K draws average to noise/sqrt(K)).
    ``repeats`` matches ``energies``' structure with leaves that broadcast
    against the energy leaves (scalars, per-layer vectors, or the trees of
    ``lm.profile_repeat_tree``)."""
    return map_leaves(lambda _p, e, k: _f32(e) * _f32(k, _device(e)), energies, repeats)


def repeat_total_energy(energies: EnergyTree, macs: MacTree, repeats) -> torch.Tensor:
    """True served energy ``sum_l K_l * E_l * MACs_l`` (per example) of a
    per-layer repeat schedule over a per-site energy allocation."""
    return total_energy(apply_repeats(energies, repeats), macs)


def log_energy_penalty(energies: EnergyTree, macs: MacTree, target_e_per_mac: float,
                       lam: float) -> torch.Tensor:
    """Eq. 14: ``lam * max(log(E_tot) - log(E_max), 0)`` with
    ``E_max = target_e_per_mac * total_macs``."""
    e_tot = total_energy(energies, macs)
    budget = _f32(target_e_per_mac, e_tot.device) * total_macs(macs).to(e_tot.device)
    excess = torch.log(e_tot) - torch.log(budget)
    # torch.maximum, not clamp_min: at a tie it passes half the gradient,
    # as jnp.maximum does
    return lam * torch.maximum(excess, torch.zeros_like(excess))


def uniform_log_energies(macs: MacTree, e_per_mac: float) -> EnergyTree:
    """Uniform allocation: every site (and channel) at one energy/MAC."""
    le = float(torch.log(_f32(e_per_mac)))
    return map_leaves(
        lambda _p, m: torch.full(tuple(torch.as_tensor(m).shape), le, dtype=F32,
                                 device=_device(m)),
        macs,
    )


def dense_site_macs(batch_elems: int, k: int, m: int, *, per_channel: bool) -> torch.Tensor:
    """Per-example MACs of a dense site computing (B..., K) @ (K, M).

    ``batch_elems`` counts output vectors per example (the sequence length
    of an LM token stream). Per-layer: the scalar B*K*M; per-channel: an
    (M,) vector of B*K each."""
    if per_channel:
        return torch.full((m,), float(batch_elems * k), dtype=F32)
    return _f32(float(batch_elems) * k * m)


def describe(energies: EnergyTree, macs: MacTree) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total energy, average energy/MAC), for logging."""
    return total_energy(energies, macs), avg_energy_per_mac(energies, macs)
