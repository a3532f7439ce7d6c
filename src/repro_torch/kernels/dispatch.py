"""Backend dispatch: where one analog matmul executes.

Port of ``repro/kernels/dispatch.py``:

  * ``"cuda"`` — the hand-written kernel (``kernels/analog_matmul.py``);
    takes the place of the reference's ``"pallas"``.
  * ``"tile"`` — the plain counter-based version (``kernels/ref.py``):
    identical math and noise draws, plain PyTorch ops.
  * ``"auto"`` — ``"cuda"`` for CUDA tensors, ``"tile"`` for CPU tensors.
    There is no shape threshold: on the card every analog site goes
    through the kernel.

The reference's ``"jnp"`` backend (``jax.random`` noise, not reproducible
across tilings) has no counterpart yet.
"""
from __future__ import annotations

import torch

AUTO = "auto"
CUDA = "cuda"
TILE = "tile"
BACKENDS = (AUTO, CUDA, TILE)


def resolve_backend(cfg, x: torch.Tensor) -> str:
    """``"cuda"`` or ``"tile"`` (never ``"auto"``) for an analog matmul on x."""
    backend = cfg.backend
    if backend == AUTO:
        return CUDA if x.is_cuda else TILE
    return backend


def fused_dot(x, w, *, cfg, energy, seed, sq=None, n_repeats: int = 1):
    """The kernel path: quant -> matmul -> K-repeat noise -> requant."""
    from repro_torch.kernels import ops

    return ops.analog_matmul(
        x, w, energy=energy, seed=seed, cfg=cfg, sq=sq, n_repeats=n_repeats, device=x.device
    )


def tile_dot(x, w, *, cfg, energy, seed, sq=None, n_repeats: int = 1):
    """The plain path with the kernel's math and noise draws."""
    from repro_torch.kernels import ops

    return ops.analog_matmul_reference(
        x, w, energy=energy, seed=seed, cfg=cfg, sq=sq, n_repeats=n_repeats
    )
