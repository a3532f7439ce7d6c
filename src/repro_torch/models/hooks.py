"""Matmul hooks: where analog execution plugs into the model.

Port of ``repro/models/hooks.py``. ``MatmulHook`` runs plain matmuls
(``ServingMatmulHook``: the served digital forward's, batch-invariant);
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
from repro_torch.kernels.analog_matmul import analog_matmul_raw, select_route


class MatmulHook:
    """Digital execution: plain matmuls in the model dtype."""

    def __call__(self, site: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, w.to(x.dtype))

    def batched(self, site: str, x: torch.Tensor, w) -> torch.Tensor:
        """Expert-batched matmul: (E, ..., K) @ (E, K, N); ``w`` may be a
        list of the E (K, N) weights (a train step's gradient views)."""
        return torch.stack([torch.matmul(x[e], w[e].to(x.dtype)) for e in range(len(w))])


@dataclasses.dataclass
class AnalogHook(MatmulHook):
    """Analog execution with per-site energies (paper §IV-V).

    ``energies`` maps site name -> this layer's energy (0-d or per-channel
    tensor); ``seeds`` maps site name -> its seed words, the layer's row of
    the forward's seed table (``lm.seed_tables``; (4,) for one key, (B, 4) with one
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

    ``noise_scale``: the hardware's noise drift, a 0-d float32 tensor
    ``d`` multiplying the noise std at every site. Every noise model's std
    is proportional to ``1/sqrt(E)``, so the drift is served exactly as
    energies ``E / d**2`` (the reference's order: ``d * d``, then the
    division); at ``d = 1`` that division is exact. ``None`` (the
    default) serves the energies as they are. The model's forward divides
    its energy tree once instead (``lm.drifted_energies``, the same bits)
    and builds its hooks without the scale.
    """

    cfg: AnalogConfig
    energies: Dict[str, torch.Tensor]
    seeds: Dict[str, torch.Tensor]
    n_repeats: int = 1
    rows_per_key: int = 1
    expert_seeds: Optional[Dict[str, torch.Tensor]] = None
    noise_scale: Optional[torch.Tensor] = None

    def _site_energy(self, site: str) -> torch.Tensor:
        e = self.energies[site]
        if self.noise_scale is not None:
            e = e / (self.noise_scale * self.noise_scale)  # std ~ 1/sqrt(E)
        return e

    def __call__(self, site: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        xs = x
        if self.rows_per_key > 1:
            xs = x.reshape(x.shape[0] // self.rows_per_key, -1, x.shape[-1])
        y = analog_dot(
            xs, w, cfg=self.cfg, energy=self._site_energy(site),
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
        n_e = len(w)
        energy = self._site_energy(site)
        energy = energy.expand(n_e) if energy.dim() == 0 else energy
        seeds = self.expert_seeds[site]
        y = torch.stack([
            analog_dot(x[e], w[e], cfg=self.cfg, energy=energy[e], seed=seeds[e],
                       n_repeats=self.n_repeats)
            for e in range(n_e)
        ])
        return y.to(x.dtype)


#: (device, B, M, N) -> the noise-free operands of ``ServingMatmulHook``'s
#: decode-route call: row scales 1, column scales 0, no quantizers, seeds 0
_DIGITAL_OPERANDS: dict = {}


def _digital_operands(b: int, m: int, n: int, dev) -> tuple:
    key = (dev, b, m, n)
    ops = _DIGITAL_OPERANDS.get(key)
    if ops is None:
        f32 = torch.float32
        ops = _DIGITAL_OPERANDS[key] = (
            torch.ones((b, m, 1), dtype=f32, device=dev),
            torch.zeros((1, 1, n), dtype=f32, device=dev),
            torch.ones((3, n), dtype=f32, device=dev),
            torch.tensor([[1.0, 0.0, 1.0, 1.0, 0.0, 1.0, 0.0, 0.0]], dtype=f32, device=dev),
            torch.zeros((b, 4), dtype=torch.int32, device=dev),
        )
    return ops


class ServingMatmulHook(MatmulHook):
    """Digital execution of served requests (the serving tiers pass it to
    ``lm.prefill``/``decode_step``): a request's tokens must not depend on
    its batch. On the card a site of at most ``M_DECODE`` rows a request
    (a decode step) takes the analog matmul's decode route with no noise,
    whose order of summation is fixed by (K, N) and which reads the weight
    once for the batch; f32 sums rounded once to the activation dtype, as
    a bf16 GEMM rounds. A longer site, or operands that route does not
    take, runs one matmul a request: cuBLAS picks its kernel, and so the
    order of a sum, by the row count (alone and in its batch a request
    shares its seq bucket, so its own matmul has one shape in both). On
    the CPU plain matmuls."""

    def __call__(self, site: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.to(x.dtype)
        if not x.is_cuda or x.dim() < 3:
            return torch.matmul(x, w)
        b, k, n = x.shape[0], x.shape[-1], w.shape[-1]
        m = x[0].numel() // k
        if (w.dim() == 2 and w.stride(1) == 1 and w.stride(0) >= n
                and select_route(b, m, k, n, x.dtype, "none") == "decode"):
            y = analog_matmul_raw(x.reshape(b, m, k).contiguous(), w,
                                  *_digital_operands(b, m, n, x.device), noise_kind="none")
            return y.to(x.dtype).reshape(*x.shape[:-1], n)
        if b == 1:
            return torch.matmul(x, w)
        return torch.cat([torch.matmul(x[i:i + 1], w) for i in range(b)])


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
    expert seed table (``core.analog.expert_seed_words``)."""
    if analog_cfg is None or layer_energies is None:
        return MatmulHook()
    return AnalogHook(cfg=analog_cfg, energies=layer_energies, seeds=seeds, n_repeats=n_repeats,
                      rows_per_key=rows_per_key, expert_seeds=expert_seeds)
