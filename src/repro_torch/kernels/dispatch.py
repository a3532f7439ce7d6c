"""Backend dispatch: where one analog matmul executes.

Port of ``repro/kernels/dispatch.py``:

  * ``"cuda"`` — the hand-written kernel (``kernels/analog_matmul.py``);
    takes the place of the reference's ``"pallas"``.
  * ``"tile"`` — the plain counter-based version (``kernels/ref.py``):
    identical math and noise draws, plain PyTorch ops.
  * ``"torch"`` — the reference's ``"jnp"`` backend: plain PyTorch ops
    with noise drawn from a ``torch.Generator`` per request
    (``core/analog.py``), differentiable (straight-through energy
    snapping and fake-quant), K repeats folded into one draw at K·E. Its
    noise is not reproducible across tilings; the calibration's Eq.-14
    gradient runs on it.
  * ``"auto"`` — ``"cuda"`` for CUDA tensors, ``"tile"`` for CPU tensors.
    There is no shape threshold: on the card every analog site goes
    through the kernel. It never picks ``"torch"``.

The kernel has no backward; ``analog_dot`` refuses a ``"cuda"`` call that
autograd would have to differentiate.

Under an ambient tensor-parallel mesh (``models/sharding.use_mesh``,
``active_mesh`` below) resolution is unchanged: ``"auto"`` keeps the CUDA
routes on the card (they honour a shard's global column offset, as the
reference's Pallas path does) and ``"tile"`` on the CPU, both of them
tiling-invariant, so ``analog_dot`` runs them column-sharded. With no
shape threshold in the port the shard's N decides nothing here; the
route of each shard call is chosen from its own (K, N / tp). ``"torch"``
is not tiling-invariant and is never sharded, as the reference's
``"jnp"``.
"""
from __future__ import annotations

import torch

AUTO = "auto"
CUDA = "cuda"
TILE = "tile"
TORCH = "torch"
BACKENDS = (AUTO, CUDA, TILE, TORCH)
#: backends whose noise is a pure function of global (row, col): shardable
TILING_INVARIANT = (CUDA, TILE)


def active_mesh():
    """The ambient tensor-parallel mesh, or None (``models/sharding.use_mesh``)."""
    from repro_torch.models import sharding

    return sharding.get_mesh()


def active_data_shard():
    """The ambient data shard, or None (``models/sharding.use_data_shard``)."""
    from repro_torch.models import sharding

    return sharding.get_data_shard()


def resolve_backend(cfg, x: torch.Tensor) -> str:
    """``"cuda"``, ``"tile"`` or ``"torch"`` (never ``"auto"``) for an
    analog matmul on x."""
    backend = cfg.backend
    if backend == AUTO:
        return CUDA if x.is_cuda else TILE
    return backend


def fused_dot(x, w, *, cfg, energy, seed, sq=None, n_repeats: int = 1, x_range=None):
    """The kernel path: quant -> matmul -> K-repeat noise -> requant."""
    from repro_torch.kernels import ops

    return ops.analog_matmul(
        x, w, energy=energy, seed=seed, cfg=cfg, sq=sq, n_repeats=n_repeats, device=x.device,
        x_range=x_range,
    )


def tile_dot(x, w, *, cfg, energy, seed, sq=None, n_repeats: int = 1, x_range=None):
    """The plain path with the kernel's math and noise draws."""
    from repro_torch.kernels import ops

    return ops.analog_matmul_reference(
        x, w, energy=energy, seed=seed, cfg=cfg, sq=sq, n_repeats=n_repeats, x_range=x_range
    )
