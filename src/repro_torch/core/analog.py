"""The analog matmul primitive (paper §II-C, §IV); port of ``repro/core/analog.py``.

``analog_dot`` is the choke point every model matmul runs through. In
``digital`` mode it is an (optionally fake-quantized) plain matmul; in
``analog`` mode it simulates the noisy accelerator through the fused
kernel or its plain version (``kernels/dispatch.py``).

Keys are raw uint32 numpy arrays, as the reference's raw JAX keys: (2,)
for one stream, (B, 2) for stacked per-request streams. They are folded on
the host (``fold_key``, ``site_key``); what reaches the device is a seed
table of int32 words (k0, k1, row0, col0) per request (``key_seed``), made
for a whole forward at once by ``site_seed_table``.
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
from repro_torch.kernels.dispatch import BACKENDS, fused_dot, resolve_backend, tile_dot
from repro_torch.quant.affine import QuantParams, fake_quant

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
    #: "auto" (kernel for CUDA tensors, plain for CPU tensors), "cuda", "tile".
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


# ---------------------------------------------------------------------------
# the analog matmul
# ---------------------------------------------------------------------------


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
    if resolve_backend(cfg, x) == "cuda":
        return fused_dot(x, w, cfg=cfg, energy=energy, seed=seed, sq=sq, n_repeats=n_repeats)
    return tile_dot(x, w, cfg=cfg, energy=energy, seed=seed, sq=sq, n_repeats=n_repeats)
