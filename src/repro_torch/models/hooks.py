"""Matmul hooks: where analog execution plugs into the model.

Port of ``repro/models/hooks.py`` (the dense and griffin sites;
expert-batched sites wait for MoE). ``MatmulHook`` runs plain matmuls;
``AnalogHook`` runs each named site through ``analog_dot`` with that
site's energy and noise stream and casts the float32 result back to the
activation dtype; ``PrefixHook`` namespaces the sites of a repeated
sublayer (griffin's ``rec_*`` sites become ``rec{i}_rec_*``).
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
    """

    cfg: AnalogConfig
    energies: Dict[str, torch.Tensor]
    seeds: Dict[str, torch.Tensor]
    n_repeats: int = 1
    rows_per_key: int = 1

    def __call__(self, site: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        xs = x
        if self.rows_per_key > 1:
            xs = x.reshape(x.shape[0] // self.rows_per_key, -1, x.shape[-1])
        y = analog_dot(
            xs, w, cfg=self.cfg, energy=self.energies[site],
            seed=self.seeds[site], n_repeats=self.n_repeats,
        )
        return y.reshape(*x.shape[:-1], y.shape[-1]).to(x.dtype)


@dataclasses.dataclass
class PrefixHook(MatmulHook):
    """Namespaces an inner hook's site names (repeated sublayers per group)."""

    inner: MatmulHook
    prefix: str

    def __call__(self, site: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.inner(f"{self.prefix}{site}", x, w)


def hook_for_layer(
    analog_cfg: Optional[AnalogConfig],
    layer_energies: Optional[Dict[str, torch.Tensor]],
    seeds: Optional[Dict[str, torch.Tensor]],
    *,
    n_repeats: int = 1,
    rows_per_key: int = 1,
) -> MatmulHook:
    """Hook for one layer: ``seeds`` is the layer's row of the forward's
    seed table, the reference's ``fold_key(key, layer_idx)`` → ``site_key``
    chain folded on the host."""
    if analog_cfg is None or layer_energies is None:
        return MatmulHook()
    return AnalogHook(cfg=analog_cfg, energies=layer_energies, seeds=seeds, n_repeats=n_repeats,
                      rows_per_key=rows_per_key)
