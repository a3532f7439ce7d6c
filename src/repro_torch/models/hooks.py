"""Matmul hooks: where analog execution plugs into the model.

Port of ``repro/models/hooks.py``. ``MatmulHook`` runs plain matmuls;
``AnalogHook`` runs each named site through ``analog_dot`` with that
site's energy and noise stream and casts the float32 result back to the
activation dtype; ``PrefixHook`` namespaces the sites of a repeated
sublayer (griffin's ``rec_*`` sites become ``rec{i}_rec_*``). ``batched``
runs an expert-batched site, (E, ..., K) @ (E, K, N), one expert at a time.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core.analog import AnalogConfig, analog_dot


class MatmulHook:
    """Digital execution: plain matmuls in the model dtype."""

    def __call__(self, site: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, w.to(x.dtype))

    def batched(self, site: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Expert-batched matmul: (E, ..., K) @ (E, K, N)."""
        return torch.stack([torch.matmul(x[e], w[e].to(x.dtype)) for e in range(w.shape[0])])


@dataclasses.dataclass
class AnalogHook(MatmulHook):
    """Analog execution with per-site energies (paper §IV-V).

    ``energies`` maps site name -> this layer's energy (0-d or per-channel
    tensor); ``seeds`` maps site name -> its seed words, the layer's row of
    the forward's ``site_seed_table`` ((4,) for one key, (B, 4) with one
    stream per request row). ``n_repeats`` is the K-repeat knob, averaged
    inside the kernel. ``rows_per_key`` > 1: each stacked seed covers that
    many consecutive batch rows, run as one request (the noise samples of
    ``core.calibrate.eval_accuracy`` stacked over a batch, each computed as
    that batch alone under one key).

    ``expert_seeds`` maps an expert-batched site -> its (E, 4) seed words:
    the reference's batch-level stream (``collapse_keys`` of the layer's
    request keys, pad rows folded out, then ``site_key`` and
    ``split(.., E)``), one key per expert. Expert e's (G, C, K) buffer is
    that key's rows, counted over the flattened G * C rows, as the
    reference's ``vmap`` over experts runs ``analog_dot`` on it. With
    stacked noise samples the words are (S, E, 4), one stream a sample
    (``sample``).
    """

    cfg: AnalogConfig
    energies: Dict[str, torch.Tensor]
    seeds: Dict[str, torch.Tensor]
    n_repeats: int = 1
    rows_per_key: int = 1
    expert_seeds: Optional[Dict[str, torch.Tensor]] = None

    def __call__(self, site: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        xs = x
        if self.rows_per_key > 1:
            xs = x.reshape(x.shape[0] // self.rows_per_key, -1, x.shape[-1])
        y = analog_dot(
            xs, w, cfg=self.cfg, energy=self.energies[site],
            seed=self.seeds[site], n_repeats=self.n_repeats,
        )
        return y.reshape(*x.shape[:-1], y.shape[-1]).to(x.dtype)

    def sample(self, i: int) -> "AnalogHook":
        """Noise sample ``i`` of a stacked-key hook (``rows_per_key`` > 1)
        as a hook of its own, one key for the sample's rows."""
        return dataclasses.replace(
            self, seeds={s: v[i] for s, v in self.seeds.items()}, rows_per_key=1,
            expert_seeds=None if self.expert_seeds is None else {
                s: v[i] for s, v in self.expert_seeds.items()})

    def batched(self, site: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        n_e = w.shape[0]
        energy = self.energies[site]
        energy = energy.expand(n_e) if energy.dim() == 0 else energy
        seeds = self.expert_seeds[site]
        y = torch.stack([
            analog_dot(x[e], w[e], cfg=self.cfg, energy=energy[e], seed=seeds[e],
                       n_repeats=self.n_repeats)
            for e in range(n_e)
        ])
        return y.to(x.dtype)


@dataclasses.dataclass
class PrefixHook(MatmulHook):
    """Namespaces an inner hook's site names (repeated sublayers per group)."""

    inner: MatmulHook
    prefix: str

    def __call__(self, site: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.inner(f"{self.prefix}{site}", x, w)

    def batched(self, site: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.inner.batched(f"{self.prefix}{site}", x, w)


def hook_for_layer(
    analog_cfg: Optional[AnalogConfig],
    layer_energies: Optional[Dict[str, torch.Tensor]],
    seeds: Optional[Dict[str, torch.Tensor]],
    *,
    n_repeats: int = 1,
    rows_per_key: int = 1,
    expert_seeds: Optional[Dict[str, torch.Tensor]] = None,
) -> MatmulHook:
    """Hook for one layer: ``seeds`` is the layer's row of the forward's
    seed table, the reference's ``fold_key(key, layer_idx)`` → ``site_key``
    chain folded on the host; ``expert_seeds`` the layer's row of its
    expert seed table (``core.analog.expert_seed_table``)."""
    if analog_cfg is None or layer_energies is None:
        return MatmulHook()
    return AnalogHook(cfg=analog_cfg, energies=layer_energies, seeds=seeds, n_repeats=n_repeats,
                      rows_per_key=rows_per_key, expert_seeds=expert_seeds)
