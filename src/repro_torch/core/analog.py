"""The analog matmul primitive (paper §II-C, §IV); port of ``repro/core/analog.py``.

``analog_dot`` is the choke point every model matmul runs through. In
``digital`` mode it is an (optionally fake-quantized) plain matmul; in
``analog`` mode it simulates the noisy accelerator through the fused
kernel or its plain version (``kernels/dispatch.py``), or through the
``"torch"`` backend, the reference's ``"jnp"`` branch: differentiable
plain ops with ``torch.Generator`` noise, where the Eq.-14 calibration
takes its gradient.

Keys are raw uint32 numpy arrays, as the reference's raw JAX keys: (2,)
for one stream, (B, 2) for stacked per-request streams. They are folded on
the host (``fold_key``, ``site_key``); what reaches the device is a seed
table of int32 words (k0, k1, row0, col0) per request (``key_seed``), made
for a whole forward at once by ``site_seed_table``. The ``"torch"``
backend seeds one generator per request from its words on the host: the
model builds its seed table on the CPU for that backend, so no site waits
for a device-to-host copy.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import noise as noise_lib
from repro_torch.core.noise import NoiseSpec
from repro_torch.kernels import prng
from repro_torch.kernels.dispatch import (
    BACKENDS,
    CUDA,
    TORCH,
    fused_dot,
    resolve_backend,
    tile_dot,
)
from repro_torch.quant.affine import QuantParams, fake_quant, ste_snap_levels

PER_LAYER = "per_layer"
PER_CHANNEL = "per_channel"


@dataclasses.dataclass(frozen=True)
class AnalogConfig:
    """Static configuration of the simulated analog accelerator."""

    mode: str = "digital"
    noise: NoiseSpec = NoiseSpec()
    granularity: str = PER_LAYER
    weight_bits: Optional[float] = 8.0
    act_bits: Optional[float] = 8.0
    out_bits: Optional[float] = 8.0
    #: snap energies to integer multiples of a quantum (photons / K repeats).
    discrete_energy: bool = False
    energy_quantum: float = noise_lib.PHOTON_ENERGY_AJ
    #: "auto" (kernel for CUDA tensors, plain for CPU tensors), "cuda",
    #: "tile", or "torch" (the reference's "jnp": generator noise, autograd)
    backend: str = "auto"

    def __post_init__(self):
        if self.mode not in ("digital", "analog"):
            raise ValueError(f"bad mode {self.mode!r}")
        if self.granularity not in (PER_LAYER, PER_CHANNEL):
            raise ValueError(f"bad granularity {self.granularity!r}")
        if self.backend not in BACKENDS:
            raise ValueError(f"bad backend {self.backend!r}")

    @classmethod
    def shot(cls, **kw) -> "AnalogConfig":
        """Shot-noise configuration: continuous I/O (paper §VI-A)."""
        kw.setdefault("noise", NoiseSpec(kind=noise_lib.SHOT))
        return cls(mode="analog", weight_bits=None, act_bits=None, out_bits=None, **kw)

    @classmethod
    def thermal(cls, sigma_t: float = 0.01, **kw) -> "AnalogConfig":
        kw.setdefault("noise", NoiseSpec(kind=noise_lib.THERMAL, sigma=sigma_t))
        return cls(mode="analog", **kw)

    @classmethod
    def weight(cls, sigma_w: float = 0.1, **kw) -> "AnalogConfig":
        kw.setdefault("noise", NoiseSpec(kind=noise_lib.WEIGHT, sigma=sigma_w))
        return cls(mode="analog", **kw)


@dataclasses.dataclass(frozen=True)
class SiteQuant:
    """Calibrated quantizers for one matmul site (per-channel ``wqp``,
    per-tensor ``xqp`` and ``oqp``)."""

    wqp: Optional[QuantParams] = None
    xqp: Optional[QuantParams] = None
    oqp: Optional[QuantParams] = None


# ---------------------------------------------------------------------------
# keys (host side)
# ---------------------------------------------------------------------------


def raw_key(key) -> np.ndarray:
    """Normalize a key to its raw uint32 words."""
    return np.asarray(key, np.uint32)


def key_batch(key) -> Optional[int]:
    """Leading batch size of a *stacked* (B, 2) key, or None for one (2,) key."""
    if key is None:
        return None
    key = raw_key(key)
    if key.ndim == 1:
        return None
    if key.ndim == 2:
        return key.shape[0]
    raise ValueError(f"bad key shape {key.shape}")


def fold_key(key, data) -> np.ndarray:
    """``fold_in`` that maps over stacked per-request keys."""
    return prng.fold_in(raw_key(key), data)


def collapse_keys(key, valid=None) -> np.ndarray:
    """XOR-fold a stacked (B, 2) key into one batch-level key; rows with
    ``valid`` False fold the XOR identity. Single keys pass through."""
    key = raw_key(key)
    if key_batch(key) is None:
        return key
    if valid is not None:
        key = np.where(np.asarray(valid, bool)[:, None], key, np.uint32(0))
    return np.bitwise_xor.reduce(key, axis=0).astype(np.uint32)


def site_hash(site: str) -> int:
    """Stable 32-bit hash of a site name (blake2s, little-endian)."""
    return int.from_bytes(hashlib.blake2s(site.encode(), digest_size=4).digest(), "little")


def site_key(key, site: str) -> np.ndarray:
    """Per-site stream: ``fold_in(key, blake2s(site))``, row-wise if stacked."""
    return fold_key(key, site_hash(site))


def key_seed(key, device) -> torch.Tensor:
    """Raw key(s) -> the kernel's int32 seed words (k0, k1, row0=0, col0=0):
    (4,) for one key, (B, 4) for stacked keys."""
    key = raw_key(key)
    words = np.concatenate([key, np.zeros(key.shape[:-1] + (2,), np.uint32)], axis=-1)
    # non-blocking: a blocking copy would wait for every queued kernel
    return torch.from_numpy(words.view(np.int32)).to(device, non_blocking=True)


def site_seed_table(key, layers, sites: Sequence[str], device) -> torch.Tensor:
    """Seeds of every analog site of one forward, copied to ``device`` once.

    ``layers``: the layer (or layer-group) indices the key is folded with,
    a sequence of ints, or an int ``n`` for ``range(n)``. Row ``[l, s]`` is
    ``key_seed(site_key(fold_key(key, layers[l]), sites[s]))`` — the
    reference's per-site chain (``hook_for_layer`` then ``AnalogHook``).
    Shape (L, S, 4), or (L, S, B, 4) for stacked keys.
    """
    key = raw_key(key)
    lead = key.shape[:-1]
    idx = np.arange(layers) if isinstance(layers, (int, np.integer)) else np.asarray(layers)
    idx = idx.astype(np.int64).reshape((-1,) + (1,) * len(lead))
    lk = fold_key(key[None], idx)  # (L, [B,] 2)
    hashes = np.asarray([site_hash(s) for s in sites], np.int64)
    sk = fold_key(lk[:, None], hashes.reshape((1, -1) + (1,) * len(lead)))  # (L, S, [B,] 2)
    return key_seed(sk, device)


def expert_seed_table(key, layers, sites: Sequence[str], n_experts: int, valid, device
                      ) -> torch.Tensor:
    """Seeds of the expert-batched sites of one forward, copied to
    ``device`` once: (L, S, E, 4). Row ``[l, s, e]`` is ``key_seed`` of
    expert e's key in the reference's chain: ``fold_key(key, layers[l])``
    per request row, ``collapse_keys`` of the rows (``valid`` False rows,
    the batch padding, fold the XOR identity), ``site_key(.., sites[s])``
    and ``split(.., n_experts)[e]``. One batch-level stream: capacity
    buffers mix the batch's requests."""
    key = raw_key(key)
    idx = np.arange(layers) if isinstance(layers, (int, np.integer)) else np.asarray(layers)
    lk = fold_key(key[None], idx.astype(np.int64).reshape((-1,) + (1,) * (key.ndim - 1)))
    ck = np.stack([collapse_keys(k, valid) for k in lk])  # (L, 2)
    hashes = np.asarray([site_hash(s) for s in sites], np.int64)
    sk = fold_key(ck[:, None], hashes[None, :])  # (L, S, 2)
    ek = prng.fold_in(sk[:, :, None], np.arange(n_experts))  # split: (L, S, E, 2)
    return key_seed(ek, device)


# ---------------------------------------------------------------------------
# the analog matmul
# ---------------------------------------------------------------------------


def _generator(words: np.ndarray, device) -> torch.Generator:
    """A generator on ``device`` seeded from one request's words (k0, k1):
    the 64-bit seed ``k0 * 2^32 + k1``."""
    k0, k1 = (int(v) & 0xFFFFFFFF for v in words[:2])
    return torch.Generator(device=device).manual_seed((k0 << 32) | k1)


def _w_range(sq: Optional[SiteQuant], w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel weight range (1, N), calibrated or from the data."""
    if sq is not None and sq.wqp is not None:
        return (sq.wqp.x_max - sq.wqp.x_min).to(torch.float32).reshape(1, -1)
    return (torch.amax(w, dim=0, keepdim=True) - torch.amin(w, dim=0, keepdim=True)).to(
        torch.float32)


def _x_range(sq: Optional[SiteQuant], x: torch.Tensor) -> torch.Tensor:
    if sq is not None and sq.xqp is not None:
        return (sq.xqp.x_max - sq.xqp.x_min).to(torch.float32)
    return (torch.amax(x) - torch.amin(x)).to(torch.float32)


def _torch_dot(x, w, *, cfg: AnalogConfig, energy, gen: torch.Generator, sq, n_repeats: int):
    """One request on the ``"torch"`` backend (the reference's ``"jnp"``
    branch, ``repro/core/analog.py``): float32 operands, straight-through
    energy snapping and fake-quant, K repeats as one draw at K·E, and
    weight, thermal or shot noise drawn from ``gen``."""
    k_dim = w.shape[0]
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    energy = energy.to(x.device, torch.float32) if torch.is_tensor(energy) else torch.tensor(
        float(energy), dtype=torch.float32, device=x.device)
    if cfg.discrete_energy:
        energy = ste_snap_levels(energy, cfg.energy_quantum)
    if n_repeats > 1:
        # K repeats at E averaged == one draw at K*E (noise in quadrature);
        # core/redundant.py holds the explicit-K oracles
        energy = energy * n_repeats
    w_q = fake_quant(w, sq.wqp) if cfg.weight_bits is not None and sq is not None and \
        sq.wqp is not None else w
    x_q = fake_quant(x, sq.xqp) if cfg.act_bits is not None and sq is not None and \
        sq.xqp is not None else x

    kind = cfg.noise.kind
    if kind == noise_lib.WEIGHT:
        w_noisy = noise_lib.perturb_weights(gen, w_q, _w_range(sq, w_q), cfg.noise.sigma, energy)
        y = torch.matmul(x_q, w_noisy)
    elif kind == noise_lib.THERMAL:
        y = torch.matmul(x_q, w_q)
        std = noise_lib.thermal_noise_std(k_dim, _w_range(sq, w_q), _x_range(sq, x_q),
                                          cfg.noise.sigma, energy)
        y = y + noise_lib.sample_output_noise(gen, y.shape, std)
    elif kind == noise_lib.SHOT:
        y = torch.matmul(x_q, w_q)
        # eps-safe norms: a norm's gradient is NaN at exactly zero
        w_col = torch.sqrt(torch.sum(w_q * w_q, dim=0, keepdim=True) + 1e-20)
        x_row = torch.sqrt(torch.sum(x_q * x_q, dim=-1, keepdim=True) + 1e-20)
        std = noise_lib.shot_noise_std(w_col, x_row, k_dim, energy, cfg.noise.photon_energy_aj)
        y = y + noise_lib.sample_output_noise(gen, y.shape, std)
    else:
        y = torch.matmul(x_q, w_q)

    if cfg.out_bits is not None and sq is not None and sq.oqp is not None:
        y = fake_quant(y, sq.oqp)
    return y


def analog_dot(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    cfg: AnalogConfig,
    energy=None,
    seed: Optional[torch.Tensor] = None,
    sq: Optional[SiteQuant] = None,
    n_repeats: int = 1,
) -> torch.Tensor:
    """Noisy (or digital) matmul ``(..., K) @ (K, N) -> (..., N)``.

    ``energy``: scalar (per-layer) or (N,) per-channel energy per MAC.
    ``seed``: the noise stream's seed words from ``key_seed`` — (4,) for one
    stream, or a stacked (B, 4) table: then ``x[b]`` is request b and runs
    exactly as the reference's ``vmap`` over stacked keys runs it alone
    (its own noise, its own thermal input range, its own row norms).
    ``n_repeats``: K-repeat redundancy averaged in the kernel. Analog
    outputs are float32.

    Backward: ``"tile"`` and ``"torch"`` are plain differentiable ops; the
    kernel (``"cuda"``) has none, so a ``"cuda"`` call whose x or energy
    requires grad while grad mode is on raises rather than return a
    result that would train nothing.
    """
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"contract mismatch {tuple(x.shape)} @ {tuple(w.shape)}")
    if n_repeats < 1:
        raise ValueError(f"n_repeats must be >= 1, got {n_repeats}")
    if cfg.mode == "digital":
        if cfg.weight_bits is not None and sq is not None and sq.wqp is not None:
            w = fake_quant(w, sq.wqp)
        if cfg.act_bits is not None and sq is not None and sq.xqp is not None:
            x = fake_quant(x, sq.xqp)
        y = torch.matmul(x, w.to(x.dtype))
        if cfg.out_bits is not None and sq is not None and sq.oqp is not None:
            y = fake_quant(y, sq.oqp)
        return y
    if energy is None or seed is None:
        raise ValueError("analog mode requires energy and seed")
    if seed.dim() == 2 and (x.dim() < 2 or x.shape[0] != seed.shape[0]):
        raise ValueError(
            f"stacked seed batch {seed.shape[0]} does not match x leading dim {tuple(x.shape)}"
        )
    backend = resolve_backend(cfg, x)
    if backend == CUDA:
        if torch.is_grad_enabled() and (
                x.requires_grad or (torch.is_tensor(energy) and energy.requires_grad)):
            raise RuntimeError(
                'analog_dot on backend="cuda": x or the energy requires grad, and the kernel '
                'has no backward; take the gradient on backend="torch" or "tile", or run '
                "under torch.no_grad()")
        return fused_dot(x, w, cfg=cfg, energy=energy, seed=seed, sq=sq, n_repeats=n_repeats)
    if backend == TORCH:
        # the generators' seeds are host words: a CPU table costs no copy
        words = seed.detach().cpu().numpy()
        if words.ndim == 1:
            return _torch_dot(x, w, cfg=cfg, energy=energy, gen=_generator(words, x.device),
                              sq=sq, n_repeats=n_repeats)
        return torch.stack([
            _torch_dot(x[b], w, cfg=cfg, energy=energy, gen=_generator(words[b], x.device),
                       sq=sq, n_repeats=n_repeats)
            for b in range(words.shape[0])
        ])
    return tile_dot(x, w, cfg=cfg, energy=energy, seed=seed, sq=sq, n_repeats=n_repeats)
