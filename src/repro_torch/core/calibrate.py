"""Learning optimal precision-energy tradeoffs (paper §V, Eq. 14); port of
``repro/core/calibrate.py``.

Optimizes per-site (or per-channel) energies of a *frozen* model by SGD on

    L(E) = E_{(x,y), xi} [ -log p(y | x, xi; theta, E) ]
           + lambda * max(log E_tot(E) - log E_max, 0)

with the reparameterization trick (noise enters as N(0, 1) draws scaled by
the differentiable std) and straight-through estimators through rounding.
Energies are parameterized in log-space; Adam with lr=0.01 (Appendix A).

``apply_fn(energies, x, key)`` is the noisy forward: ``key`` a raw uint32
(2,) key, as everywhere in the port, and the result the logits. The
gradient runs through plain ops (``backend="torch"``, the reference's
``"jnp"``, or ``"tile"``); the kernel has no backward.

Keys follow the reference: step ``s`` of ``learn_energies`` draws at
``fold_in(key, s)``; sample ``s`` of batch ``b`` of ``eval_accuracy`` at
``fold_in(fold_in(key, b), s)``; sample ``s`` of ``noise_rms`` at
``fold_in(key, s)``. The samples are evaluated together: ``apply_fn`` is
called with a stacked (S, 2) key and ``x`` repeated along a new leading
axis of S, and returns outputs with that axis, each sample computed as it
would be alone (the port's solo == batched rule), so the counts equal a
loop over samples bit for bit. At most ``SAMPLE_CHUNK`` samples go
together, as the reference maps larger counts one at a time. The
reference caches one jitted counter per apply_fn in weak-keyed tables;
PyTorch runs eagerly, so nothing here is cached.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.energy import (
    EnergyTree,
    MacTree,
    apply_repeats,
    avg_energy_per_mac,
    log_energy_penalty,
    to_energy,
    uniform_log_energies,
)
from repro_torch.kernels.prng import fold_in
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update
from repro_torch.tree import map_leaves

F32 = torch.float32
#: noisy forward: (energies, inputs, raw key) -> logits
ApplyFn = Callable[[EnergyTree, torch.Tensor, np.ndarray], torch.Tensor]
#: noise samples evaluated in one call of apply_fn
SAMPLE_CHUNK = 8


@dataclasses.dataclass(frozen=True)
class CalibConfig:
    """Hyperparameters from paper Appendix A."""

    lam: float = 2.0  # 2 for shot noise; 8 for thermal/weight
    lr: float = 0.01
    steps: int = 200
    discrete: bool = False
    quantum: float = 1.0
    #: initial uniform energy/MAC as a multiple of the target (start from a
    #: low-noise regime and let the penalty pull energy down).
    init_mult: float = 8.0


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.to(F32), dim=-1)
    labels = torch.as_tensor(labels, device=logp.device).long()
    return -torch.gather(logp, -1, labels[..., None])[..., 0].mean()


def learn_energies(
    apply_fn: ApplyFn,
    macs: MacTree,
    batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    *,
    key,
    target_e_per_mac: float,
    cfg: CalibConfig = CalibConfig(),
    init_log_e: Optional[EnergyTree] = None,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = softmax_xent,
) -> Tuple[EnergyTree, dict]:
    """Runs the Eq.-14 optimization; returns (energies, diagnostics).

    ``batches`` is cycled for ``cfg.steps`` gradient steps (paper: 4% of the
    training set for one epoch). The log-energies live on the device of
    ``init_log_e``'s leaves, else of ``macs``' leaves. The energies and
    ``diag["log_e"]`` come back detached.
    """
    if init_log_e is None:
        log_e = uniform_log_energies(macs, cfg.init_mult * target_e_per_mac)
    else:
        log_e = map_leaves(lambda _p, t: torch.as_tensor(t, dtype=F32).detach().clone(),
                           init_log_e)
    opt_cfg = AdamConfig(lr=cfg.lr)
    opt_state = adam_init(log_e, opt_cfg)

    losses = []
    for step in range(cfg.steps):
        x, y = batches[step % len(batches)]
        leaves_ = map_leaves(lambda _p, t: t.detach().requires_grad_(True), log_e)
        e = to_energy(leaves_, discrete=cfg.discrete, quantum=cfg.quantum)
        nll = loss_fn(apply_fn(e, x, fold_in(key, step)), y)
        pen = log_energy_penalty(e, macs, target_e_per_mac, cfg.lam)
        (nll + pen).backward()
        grads = map_leaves(
            lambda _p, t: torch.zeros_like(t) if t.grad is None else t.grad, leaves_)
        log_e, opt_state = adam_update(grads, opt_state, log_e, opt_cfg)
        losses.append(float(nll.detach()))

    with torch.no_grad():
        energies = to_energy(log_e, discrete=cfg.discrete, quantum=cfg.quantum)
        avg = float(avg_energy_per_mac(energies, macs))
    diag = {
        "final_nll": losses[-1] if losses else float("nan"),
        "avg_e_per_mac": avg,
        "log_e": log_e,
        "nll_trace": losses,
    }
    return energies, diag


def _stacked(apply_fn: ApplyFn, energies: EnergyTree, x, keys: np.ndarray) -> torch.Tensor:
    """apply_fn on len(keys) samples at once: x repeated on a leading axis."""
    xs = x.unsqueeze(0).expand(len(keys), *x.shape)
    return apply_fn(energies, xs, keys)


def _chunks(keys: np.ndarray):
    return [keys[i:i + SAMPLE_CHUNK] for i in range(0, len(keys), SAMPLE_CHUNK)]


@torch.no_grad()
def eval_accuracy(
    apply_fn: ApplyFn,
    energies: EnergyTree,
    batches: Iterable[Tuple[torch.Tensor, torch.Tensor]],
    *,
    key,
    n_noise_samples: int = 1,
) -> float:
    """Top-1 accuracy of the noisy model, averaged over noise draws; the
    labels ``y`` may have any shape matching the logits' leading axes (a
    language model's greedy agreement at every prefix position)."""
    correct = 0
    total = 0
    for bi, (x, y) in enumerate(batches):
        keys = fold_in(fold_in(key, bi), np.arange(n_noise_samples))
        for chunk in _chunks(keys):
            pred = torch.argmax(_stacked(apply_fn, energies, x, chunk), dim=-1)
            y_dev = torch.as_tensor(y, device=pred.device)
            correct += int((pred == y_dev[None]).sum())
        total += int(np.prod(tuple(y.shape))) * n_noise_samples
    return correct / max(total, 1)


def eval_profile_accuracy(
    apply_fn: ApplyFn,
    energies: EnergyTree,
    repeats,
    batches: Iterable[Tuple[torch.Tensor, torch.Tensor]],
    *,
    key,
    n_noise_samples: int = 1,
) -> float:
    """Accuracy of the noisy model under a per-layer repeat schedule.

    ``repeats`` matches ``energies`` (site -> K). Serving layer ``l`` at
    ``K_l`` repeats averages K_l draws at ``E_l``: in distribution (and bit
    for bit on the ``"torch"`` backend, which folds K into one draw at
    ``K * E``) the same as evaluating at the scaled energies, so a profile's
    accuracy is ``eval_accuracy`` at ``apply_repeats(energies, repeats)``.
    """
    scaled = apply_repeats(energies, repeats)
    return eval_accuracy(apply_fn, scaled, batches, key=key, n_noise_samples=n_noise_samples)


@torch.no_grad()
def noise_rms(
    apply_fn: ApplyFn,
    energies: EnergyTree,
    x,
    reference: torch.Tensor,
    *,
    key,
    n_noise_samples: int = 4,
) -> float:
    """RMS residual of the noisy forward against a clean ``reference``
    output, over ``n_noise_samples`` draws at ``fold_in(key, s)``. Every
    noise model's std is proportional to ``1/sqrt(E)``, so a noise-scale
    drift ``d`` moves it (to first order) linearly in ``d``: the drift
    watchdog's observable."""
    keys = fold_in(key, np.arange(n_noise_samples))
    sq_sum, count = 0.0, 0
    for chunk in _chunks(keys):
        r = (_stacked(apply_fn, energies, x, chunk) - reference[None]).to(F32)
        if len(keys) <= SAMPLE_CHUNK:
            return float(torch.sqrt(torch.mean(torch.square(r))))
        sq_sum += float(torch.sum(torch.square(r)))
        count += r.numel()
    return float(np.sqrt(sq_sum / count))
