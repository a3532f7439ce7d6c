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
table of int32 words (k0, k1, row0, col0) per request (``seed_words``,
``key_seed``), made for a whole forward at once by ``site_seed_words``
(``lm.seed_tables``) and copied to the device once. The ``"torch"``
backend seeds one generator per request from its words on the host: the
model builds its seed table on the CPU for that backend, so no site waits
for a device-to-host copy.

``analog_conv2d`` is the paper's convolution (§II-A): im2col patches in
float32 through ``analog_dot``, so on the card every convolution takes
the kernel's f32 (simt) route.

Under an ambient tensor-parallel mesh (``models/sharding.use_mesh``) the
analog matmul runs column-parallel (``_maybe_sharded_analog_dot``): shard
r draws its noise at the global column offset ``r N / tp``, so the
gathered output is bit-identical to the unsharded call.

Under an ambient data shard (``models/sharding.use_data_shard``: shard r
of ``data``, each holding 1/data of every call's rows, batch-leading) a
call draws the noise of its rows of the whole call, so the noise does not
depend on the cut (the reference draws over the whole logical array,
which ``jax_threefry_partitionable`` keeps under any sharding). ``"tile"``
and ``"cuda"`` add r times the call's flattened rows to the seed's row0
word (the data-axis twin of the tensor shards' col0); ``"torch"`` draws
the whole call's noise and takes its rows (``noise.standard_normal``).
Thermal noise's input range is the whole call's: the distributed form
reduces each shard's max and min at the site (``launch/collectives.py``);
the local form, whose shards run one after another, refuses it
(``ThermalRangeAcrossShards``). Stacked per-request seeds are refused on a
data shard.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import noise as noise_lib
from repro_torch.core.noise import NoiseSpec
from repro_torch.kernels import prng
from repro_torch.kernels.dispatch import (
    BACKENDS,
    CUDA,
    TILING_INVARIANT,
    TORCH,
    active_data_shard,
    active_mesh,
    fused_dot,
    resolve_backend,
    tile_dot,
)
from repro_torch.kernels.ref import seed_words as _seed_word_tensors
from repro_torch.quant.affine import QuantParams, fake_quant, ste_snap_levels

PER_LAYER = "per_layer"
PER_CHANNEL = "per_channel"


class ThermalRangeAcrossShards(NotImplementedError):
    """Thermal noise on the local form of a data mesh: its per-tensor input
    range spans every shard's rows, which a shard run alone cannot see.
    The distributed form reduces the range at each site."""


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


def seed_words(key) -> np.ndarray:
    """Raw key(s) -> the kernel's seed words (k0, k1, row0=0, col0=0) as
    int32 on the host: (4,) for one key, (B, 4) for stacked keys."""
    key = raw_key(key)
    words = np.concatenate([key, np.zeros(key.shape[:-1] + (2,), np.uint32)], axis=-1)
    return words.view(np.int32)


def key_seed(key, device) -> torch.Tensor:
    """``seed_words`` copied to ``device``."""
    # non-blocking: a blocking copy would wait for every queued kernel
    return torch.from_numpy(seed_words(key)).to(device, non_blocking=True)


def site_seed_words(key, layers, sites: Sequence[str]) -> np.ndarray:
    """Seed words of every analog site of one forward, on the host.

    ``layers``: the layer (or layer-group) indices the key is folded with,
    a sequence of ints, or an int ``n`` for ``range(n)``. Row ``[l, s]`` is
    ``seed_words(site_key(fold_key(key, layers[l]), sites[s]))`` — the
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
    return seed_words(sk)


def expert_seed_words(key, layers, sites: Sequence[str], n_experts: int, valid) -> np.ndarray:
    """Seed words of the expert-batched sites of one forward, on the host:
    (L, S, E, 4). Row ``[l, s, e]`` is ``seed_words`` of expert e's key in
    the reference's chain: ``fold_key(key, layers[l])`` per request row,
    ``collapse_keys`` of the rows (``valid`` False rows, the batch padding,
    fold the XOR identity), ``site_key(.., sites[s])`` and ``split(..,
    n_experts)[e]``. One batch-level stream: capacity buffers mix the
    batch's requests."""
    key = raw_key(key)
    idx = np.arange(layers) if isinstance(layers, (int, np.integer)) else np.asarray(layers)
    lk = fold_key(key[None], idx.astype(np.int64).reshape((-1,) + (1,) * (key.ndim - 1)))
    ck = np.stack([collapse_keys(k, valid) for k in lk])  # (L, 2)
    hashes = np.asarray([site_hash(s) for s in sites], np.int64)
    sk = fold_key(ck[:, None], hashes[None, :])  # (L, S, 2)
    ek = prng.fold_in(sk[:, :, None], np.arange(n_experts))  # split: (L, S, E, 2)
    return seed_words(ek)


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


def _col_squares(w: torch.Tensor) -> torch.Tensor:
    """Each column's sum of squares, (N,), summed along the contiguous
    transpose: a column's bits do not depend on how many columns sit
    beside it (a reduction across the strided dim picks its order by the
    width), so a column shard's norms are the whole weight's."""
    wt = w.T.contiguous()
    return torch.sum(wt * wt, dim=-1)


def _torch_energy(cfg: AnalogConfig, energy, n_repeats: int, device) -> torch.Tensor:
    """The ``"torch"`` backend's energy: float32, snapped under
    ``discrete_energy``, K repeats as one draw at K·E."""
    energy = energy.to(device, torch.float32) if torch.is_tensor(energy) else torch.tensor(
        float(energy), dtype=torch.float32, device=device)
    if cfg.discrete_energy:
        energy = ste_snap_levels(energy, cfg.energy_quantum)
    if n_repeats > 1:
        # K repeats at E averaged == one draw at K*E (noise in quadrature);
        # core/redundant.py holds the explicit-K oracles
        energy = energy * n_repeats
    return energy


def _torch_dot(x, w, *, cfg: AnalogConfig, energy, gen: torch.Generator, sq, n_repeats: int,
               x_range=None, rows=None, cols=None):
    """One request on the ``"torch"`` backend (the reference's ``"jnp"``
    branch, ``repro/core/analog.py``): float32 operands, straight-through
    energy snapping and fake-quant, K repeats as one draw at K·E, and
    weight, thermal or shot noise drawn from ``gen``. ``x_range``: thermal
    noise's input range when it spans more rows than ``x`` (a data
    shard's); ``rows`` (r, data): a data shard's rows of the whole call's
    output noise, ``cols`` (t, tp): a tensor shard's window of its columns
    (``noise.standard_normal``)."""
    k_dim = w.shape[0]
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    energy = _torch_energy(cfg, energy, n_repeats, x.device)
    w_q = fake_quant(w, sq.wqp) if cfg.weight_bits is not None and sq is not None and \
        sq.wqp is not None else w
    x_q = fake_quant(x, sq.xqp) if cfg.act_bits is not None and sq is not None and \
        sq.xqp is not None else x

    kind = cfg.noise.kind
    if kind == noise_lib.WEIGHT:
        w_noisy = noise_lib.perturb_weights(gen, w_q, _w_range(sq, w_q), cfg.noise.sigma, energy,
                                            cols=cols)
        y = torch.matmul(x_q, w_noisy)
    elif kind == noise_lib.THERMAL:
        y = torch.matmul(x_q, w_q)
        x_rng = _x_range(sq, x_q) if x_range is None or (sq is not None and sq.xqp is not None) \
            else x_range
        std = noise_lib.thermal_noise_std(k_dim, _w_range(sq, w_q), x_rng, cfg.noise.sigma, energy)
        y = y + noise_lib.sample_output_noise(gen, y.shape, std, rows=rows, cols=cols)
    elif kind == noise_lib.SHOT:
        y = torch.matmul(x_q, w_q)
        # eps-safe norms: a norm's gradient is NaN at exactly zero
        w_col = torch.sqrt(_col_squares(w_q).reshape(1, -1) + 1e-20)
        x_row = torch.sqrt(torch.sum(x_q * x_q, dim=-1, keepdim=True) + 1e-20)
        std = noise_lib.shot_noise_std(w_col, x_row, k_dim, energy, cfg.noise.photon_energy_aj)
        y = y + noise_lib.sample_output_noise(gen, y.shape, std, rows=rows, cols=cols)
    else:
        y = torch.matmul(x_q, w_q)

    if cfg.out_bits is not None and sq is not None and sq.oqp is not None:
        y = fake_quant(y, sq.oqp)
    return y


def _maybe_sharded_analog_dot(x, w, *, backend: str, cfg: AnalogConfig, energy, seed,
                              sq: Optional[SiteQuant], n_repeats: int,
                              x_range=None) -> Optional[torch.Tensor]:
    """Column-parallel analog matmul under the ambient mesh, or None to
    fall back to the unsharded call.

    Shard r holds columns ``[r N / tp, (r + 1) N / tp)`` and draws its
    noise at that global column offset (its seed table's col0 word plus
    ``r N / tp``), so, Threefry being counter-based, it computes exactly
    its tile of the unsharded stream; only N is split (K stays whole: no
    partial sums to add across shards), and the gather is data movement,
    so the result equals the unsharded one bit for bit. Stacked
    per-request seeds stay per request. The local mesh runs the shards one
    after another and concatenates them; the distributed one computes this
    rank's shard and ``all_gather``s them.

    Falls back, as the reference does, without a mesh or at tp <= 1, for
    calibrated quantizers, a weight that is not 2-D, N not divisible by
    tp, a per-channel energy, or a backend that is not tiling-invariant
    (``"torch"``); the fallback is the unsharded computation itself. On the
    card it also falls back where a shard would take another route than
    the whole call (``shard_keeps_route``: grok-1's 8-column router at tp
    = 2 and 4), so the shards' sums run in the whole call's order. The distributed form's
    gather goes through ``launch/collectives.py`` (a dry mesh's records
    it).
    """
    mesh = active_mesh()
    if mesh is None or mesh.tp <= 1:
        return None
    tp = mesh.tp
    if sq is not None or w.dim() != 2 or w.shape[1] % tp != 0:
        return None
    if (energy.dim() if torch.is_tensor(energy) else np.ndim(energy)) != 0:
        return None  # per-channel energy columns would need co-sharding
    if backend not in TILING_INVARIANT:
        return None
    from repro_torch.kernels import ops
    from repro_torch.kernels.analog_matmul import analog_matmul_raw, shard_keeps_route
    from repro_torch.kernels.ref import analog_matmul_ref_raw

    if backend == CUDA and not shard_keeps_route(w.shape[0], w.shape[1], tp, x.dtype):
        return None

    if backend == CUDA:
        raw, kw = analog_matmul_raw, dict(plan_n=w.shape[1])
    else:
        raw, kw = analog_matmul_ref_raw, {}
    outs = ops.analog_matmul_shards(raw, x, w, energy=energy, seed=seed, cfg=cfg,
                                    n_repeats=n_repeats, tp=tp, shards=mesh.shards(),
                                    x_range=x_range, **kw)
    if mesh.distributed:
        from repro_torch.launch import collectives

        outs = collectives.all_gather(outs[0].contiguous(), mesh.tp_group)
    return torch.cat(outs, dim=-1)


#: (device, row offset, column offset) -> the (4,) int64 offsets of a shard's seed
_OFFSETS: dict = {}


def _offset_seed(seed: torch.Tensor, row: int = 0, col: int = 0) -> torch.Tensor:
    """A (4,) seed (or a (B, 4) table) with its row0 and col0 words
    increased by ``row`` and ``col`` as uint32s."""
    key = (seed.device, row, col)
    off = _OFFSETS.get(key)
    if off is None:
        off = torch.zeros(4, dtype=torch.int64)
        off[2], off[3] = row, col
        off = _OFFSETS[key] = off.to(seed.device)
    # summed in int64 from the sign-extended words; the cast keeps the low
    # 32 bits, so the words wrap as the uint32 counters do
    return (seed.to(torch.int64) + off).to(torch.int32)


def _shard_x_range(x: torch.Tensor, group) -> torch.Tensor:
    """The whole call's input range ``max - min`` (float32) from a data
    shard's rows: the shards' maxima and minima reduced over ``group``
    (exact), subtracted in x's dtype as ``_x_range`` does. Every shard's
    rows read it: its gradient, summed over ``group``, reaches the shard
    that holds the global extremum, as the whole call's does (ties across
    shards aside)."""
    import torch.distributed as dist

    from repro_torch.launch import collectives

    hi, lo = torch.amax(x), torch.amin(x)
    ext = torch.stack([hi.detach(), -lo.detach()]).to(torch.float32)
    ext = collectives.all_reduce(ext, dist.ReduceOp.MAX, group)
    g_hi, g_lo = ext[0].to(x.dtype), (-ext[1]).to(x.dtype)
    hi = torch.where(hi == g_hi, hi, g_hi)
    lo = torch.where(lo == g_lo, lo, g_lo)
    return collectives.copy_to_group((hi - lo).to(torch.float32), group)


class QuantizersUnderTensorShards(NotImplementedError):
    """Calibrated site quantizers (``SiteQuant``) on a tensor shard's part
    of an analog call: the quantizers' ranges belong to the whole call,
    which no shard holds. The calibration's and training's sites run
    without them."""


def _data_shard(x: torch.Tensor, seed: torch.Tensor, cfg: AnalogConfig, sq):
    """The ambient data shard of more than one (or None), after the checks
    a call on it must pass: one (4,) seed; thermal noise's input range
    from the data group, which the local form has none of."""
    shard = active_data_shard()
    if shard is None or shard.data == 1:
        return None
    if seed.dim() != 1:
        raise NotImplementedError(
            "a stacked per-request seed table on a data shard: its requests are cut "
            "with the rows; pass one (4,) seed")
    if cfg.noise.kind == noise_lib.THERMAL and (sq is None or sq.xqp is None) \
            and shard.group is None:
        raise ThermalRangeAcrossShards(
            "thermal noise on the local form of a data mesh: the input range spans "
            "every shard's rows; run the shards as ranks (the distributed form)")
    return shard


def analog_dot(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    cfg: AnalogConfig,
    energy=None,
    seed: Optional[torch.Tensor] = None,
    sq: Optional[SiteQuant] = None,
    n_repeats: int = 1,
    cols: Optional[tuple] = None,
) -> torch.Tensor:
    """Noisy (or digital) matmul ``(..., K) @ (K, N) -> (..., N)``.

    ``energy``: scalar (per-layer) or (N,) per-channel energy per MAC.
    ``seed``: the noise stream's seed words from ``key_seed`` — (4,) for one
    stream, or a stacked (B, 4) table: then ``x[b]`` is request b and runs
    exactly as the reference's ``vmap`` over stacked keys runs it alone
    (its own noise, its own thermal input range, its own row norms).
    ``n_repeats``: K-repeat redundancy averaged in the kernel. ``cols``
    (t, tp): ``w`` is tensor shard t's columns of a weight ``tp`` times as
    wide (a column-cut site of a Megatron block), whose noise is that
    window of the whole call's: at col0 + t N on ``"tile"`` and ``"cuda"``,
    the whole draw's columns on ``"torch"``. Analog outputs are float32.

    Backward: ``"tile"`` and ``"torch"`` are plain differentiable ops; the
    kernel (``"cuda"``) has none, so a ``"cuda"`` call whose x or energy
    requires grad while grad mode is on raises rather than return a
    result that would train nothing.
    """
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"contract mismatch {tuple(x.shape)} @ {tuple(w.shape)}")
    if n_repeats < 1:
        raise ValueError(f"n_repeats must be >= 1, got {n_repeats}")
    if cols is not None and sq is not None:
        raise QuantizersUnderTensorShards(
            "site quantizers on a column shard of an analog call")
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
    if backend == CUDA and torch.is_grad_enabled() and (
            x.requires_grad or (torch.is_tensor(energy) and energy.requires_grad)):
        raise RuntimeError(
            'analog_dot on backend="cuda": x or the energy requires grad, and the kernel '
            'has no backward; take the gradient on backend="torch" or "tile", or run '
            "under torch.no_grad()")
    x_range = rows = None
    shard = _data_shard(x, seed, cfg, sq)
    if shard is not None:
        if cfg.noise.kind == noise_lib.THERMAL and (sq is None or sq.xqp is None):
            x_range = _shard_x_range(x, shard.group)
        if backend == TORCH:
            rows = (shard.r, shard.data)
        else:
            seed = _offset_seed(seed, row=shard.r * (x.numel() // x.shape[-1]))
    if cols is not None and backend != TORCH:
        seed = _offset_seed(seed, col=cols[0] * w.shape[1])
    y = None if cols is not None else _maybe_sharded_analog_dot(
        x, w, backend=backend, cfg=cfg, energy=energy, seed=seed, sq=sq, n_repeats=n_repeats,
        x_range=x_range)
    if y is not None:
        return y
    if backend == CUDA:
        return fused_dot(x, w, cfg=cfg, energy=energy, seed=seed, sq=sq, n_repeats=n_repeats,
                         x_range=x_range)
    if backend == TORCH:
        # the generators' seeds are host words: a CPU table costs no copy
        words = seed.detach().cpu().numpy()
        if words.ndim == 1:
            return _torch_dot(x, w, cfg=cfg, energy=energy, gen=_generator(words, x.device),
                              sq=sq, n_repeats=n_repeats, x_range=x_range, rows=rows, cols=cols)
        return torch.stack([
            _torch_dot(x[b], w, cfg=cfg, energy=energy, gen=_generator(words[b], x.device),
                       sq=sq, n_repeats=n_repeats, cols=cols)
            for b in range(words.shape[0])
        ])
    return tile_dot(x, w, cfg=cfg, energy=energy, seed=seed, sq=sq, n_repeats=n_repeats,
                    x_range=x_range)


# ---------------------------------------------------------------------------
# a row-cut site: the shards' partial products summed, the noise after
# ---------------------------------------------------------------------------


def _extreme_over(parts, groups, largest: bool) -> torch.Tensor:
    """The elementwise max (``largest``) or min of equal-shape tensors: the
    local tensor shards' ``parts``, then the other ranks' over each process
    group in ``groups`` (None: no such axis). Its value is exact in any
    order, in the parts' dtype; its gradient reaches every part that holds
    it (ties across shards aside: a one-device ``amax`` shares it)."""
    import torch.distributed as dist

    from repro_torch.launch import collectives

    sign = 1.0 if largest else -1.0
    ext = parts[0].detach().to(torch.float32) * sign
    for p in parts[1:]:
        ext = torch.maximum(ext, p.detach().to(torch.float32) * sign)
    for group in groups:
        if group is not None:
            ext = collectives.all_reduce(ext.contiguous(), dist.ReduceOp.MAX, group)
    top = (ext * sign).to(parts[0].dtype)
    out = top
    for p in parts:  # + 0 with a gradient to each part that holds it
        out = out + torch.where(p == top, p - p.detach(), torch.zeros_like(p))
    return out


def _range_over(parts, groups, dim=None) -> torch.Tensor:
    """``max - min`` (float32) over ``parts`` (``_extreme_over``), each part
    reduced over ``dim`` first (None: every element)."""
    hi = [torch.amax(p) if dim is None else torch.amax(p, dim=dim) for p in parts]
    lo = [torch.amin(p) if dim is None else torch.amin(p, dim=dim) for p in parts]
    return (_extreme_over(hi, groups, True) - _extreme_over(lo, groups, False)).to(torch.float32)


def _reduce_parts(pieces: list, shards) -> list:
    """Each local shard's list of tensors summed over tp as one flat
    tensor (*g*: in shard order, the ranks in rank order), cut back into
    the pieces' shapes."""
    from repro_torch.launch import collectives

    shapes = [p.shape for p in pieces[0]]
    flat = collectives.reduce_from_tp([torch.cat([p.reshape(-1) for p in ps]) for ps in pieces],
                                      shards)
    sizes = [math.prod(sh) for sh in shapes]
    return [t.reshape(sh) for t, sh in zip(torch.split(flat, sizes), shapes)]


def _norm(squares: torch.Tensor) -> torch.Tensor:
    """``sqrt`` of summed squares with a zero gradient where they are 0,
    as ``torch.linalg.vector_norm``'s at a zero row (an MoE capacity
    slot no token took)."""
    some = squares > 0
    return torch.where(some, torch.sqrt(torch.where(some, squares, torch.ones_like(squares))),
                       torch.zeros_like(squares))


def analog_dot_rows(xs, ws, shards, *, cfg: AnalogConfig, energies, seed: torch.Tensor,
                    sq: Optional[SiteQuant] = None, n_repeats: int = 1, scatter: bool = False):
    """A row-cut analog matmul: ``xs[i] @ ws[i]`` is local tensor shard
    ``shards[i]``'s partial product over its 1/tp of K (the row shard of a
    Megatron block), and the result is the whole call's, noise and all.

    The noise-free partials are summed in float32 (*g*: shard order, the
    ranks in rank order), and the noise is drawn once, after the sum, at
    the place the one-device call draws it: its std from the norms (shot:
    each row of x's and each column of w's squares summed over tp) or
    ranges (thermal: x's per tensor, w's per column, reduced over tp and,
    on a data shard, over the data group) of the whole K. Weight noise is
    the whole (K, N) draw, shard i's K rows in its partial ``x_i @ xi_i``,
    summed as the products are and scaled by the columns' std after. So
    the energy enters once, after the sum: its gradient is the same on
    every shard. The sums run in another order than the one-device call's
    product: the result agrees with it within the kernel rule (3e-5
    max|y|), not bit for bit.

    ``scatter``: the sums are reduce-scattered instead (a product over the
    shards' input rows that feeds their channels, griffin's ``rec_a`` and
    ``rec_i``): shard i keeps its 1/tp of the columns and draws their
    window of the noise. ``energies``: the site's energy on each local
    shard; the noise of the sum (not scattered) reads the first.

    ``"torch"`` draws the whole call's noise (``noise.standard_normal``)
    and keeps its window; ``"tile"`` draws the counter-based gaussians at
    the window's offsets. ``"cuda"`` adds its noise inside the product and
    has no backward: it refuses. Returns float32: the whole (..., N), or a
    list of each local shard's (..., N / tp) with ``scatter``.
    """
    if sq is not None:
        raise QuantizersUnderTensorShards("site quantizers on a row shard of an analog call")
    from repro_torch.launch import collectives

    tp = shards[0].tp
    k = ws[0].shape[0] * tp
    n = ws[0].shape[1]
    if cfg.mode == "digital" or cfg.noise.kind == noise_lib.NONE:
        parts = [torch.matmul(x.to(torch.float32), w.to(torch.float32)) for x, w in zip(xs, ws)]
        if scatter:
            return collectives.reduce_scatter_tp(parts, shards)
        return collectives.reduce_from_tp(parts, shards)
    backend = resolve_backend(cfg, xs[0])
    if backend == CUDA:
        raise NotImplementedError(
            'a row-cut analog site on backend="cuda": the kernel adds its noise inside the '
            'product, not after the sum over the shards; run it on "torch" or "tile"')
    if seed.dim() != 1:
        raise NotImplementedError("a row-cut analog site takes one (4,) seed, not a stacked table")
    kind = cfg.noise.kind
    data = _data_shard(xs[0], seed, cfg, sq)
    lead = xs[0].shape[:-1]
    m = math.prod(lead)
    torch_backend = backend == TORCH
    xf = [x.to(torch.float32) for x in xs] if torch_backend else list(xs)
    wf = [w.to(torch.float32) for w in ws]
    words = seed.detach().cpu().numpy() if torch_backend else None
    rows = None
    if data is not None:
        if torch_backend:
            rows = (data.r, data.data)
        else:
            seed = _offset_seed(seed, row=data.r * m)

    # the partial products and the statistics the noise reads, summed over tp
    pieces = [[torch.matmul(x.to(torch.float32), w)] for x, w in zip(xf, wf)]
    if kind == noise_lib.WEIGHT:
        if torch_backend:
            xi_w = noise_lib.standard_normal(_generator(words, xs[0].device), (k, n))
            xis = [xi_w[s.t * (k // tp):(s.t + 1) * (k // tp)] for s in shards]
        else:
            k0, k1, _, col0 = _seed_word_tensors(seed.reshape(1, 4))
            xis = [prng.repeat_averaged_gaussian_tile(
                k0 ^ prng.WEIGHT_STREAM_SALT, k1, s.t * (k // tp), col0, (k // tp, n),
                n_repeats)[0] for s in shards]
        for ps, x, xi in zip(pieces, xf, xis):
            ps.append(torch.matmul(x.to(torch.float32), xi))
    if scatter:
        ys = collectives.reduce_scatter_tp(
            [torch.stack(ps) if len(ps) > 1 else ps[0] for ps in pieces], shards)
        outs = [(y[0], y[1]) if kind == noise_lib.WEIGHT else (y, None) for y in ys]
        cols = [(s.t, tp) for s in shards]
    else:
        outs = [tuple(_reduce_parts(pieces, shards)) + (None,) * (2 - len(pieces[0]))]
        cols = [None]
    stats = []
    if kind == noise_lib.SHOT:
        stats = _reduce_parts([[torch.sum(x.to(torch.float32) ** 2, dim=-1, keepdim=True),
                                _col_squares(w)] for x, w in zip(xf, wf)], shards)
    groups = (shards[0].group, None if data is None else data.group)
    w_rng = x_rng = None
    if kind in (noise_lib.THERMAL, noise_lib.WEIGHT):
        # (N,): each column over the whole K, in the dtype each backend's
        # one-device call subtracts in
        w_rng = _range_over(wf if torch_backend else list(ws), groups[:1], dim=0)
    if kind == noise_lib.THERMAL:
        x_rng = _range_over(xf, groups)
        if groups[1] is not None:  # the data shards' rows read it (``_shard_x_range``)
            x_rng = collectives.copy_to_group(x_rng, groups[1])
    x_sq = stats[0] if stats else None
    x_sqs, x_rngs = [x_sq], [x_rng]
    if scatter:  # every shard's columns read the whole rows' statistics:
        # their gradients summed over tp (*f*), as the one-device call's
        x_sqs = [None] * len(shards) if x_sq is None else collectives.copy_to_tp(x_sq, shards)
        x_rngs = [None] * len(shards) if x_rng is None else collectives.copy_to_tp(x_rng, shards)

    results = []
    for (y, b), c, energy, x_sq, x_rng in zip(outs, cols, energies, x_sqs, x_rngs):
        nl = y.shape[-1]
        lo = 0 if c is None else c[0] * nl
        y2 = y.reshape(m, nl)
        if torch_backend:
            e = _torch_energy(cfg, energy, n_repeats, y.device)
            if kind == noise_lib.SHOT:
                w_col = torch.sqrt(stats[1][lo:lo + nl] + 1e-20).reshape(1, nl)
                x_row = torch.sqrt(x_sq.reshape(m, 1) + 1e-20)
                std = noise_lib.shot_noise_std(w_col, x_row, k, e, cfg.noise.photon_energy_aj)
            elif kind == noise_lib.THERMAL:
                std = noise_lib.thermal_noise_std(k, w_rng[lo:lo + nl].reshape(1, nl), x_rng,
                                                  cfg.noise.sigma, e)
            if kind == noise_lib.WEIGHT:
                std = noise_lib.weight_noise_std(w_rng[lo:lo + nl].reshape(1, nl),
                                                 cfg.noise.sigma, e)
                y2 = y2 + b.reshape(m, nl) * std
            else:
                y2 = y2 + noise_lib.sample_output_noise(_generator(words, y.device), (m, nl), std,
                                                        rows=rows, cols=c)
        else:
            e = torch.as_tensor(energy, dtype=torch.float32, device=y.device)
            if cfg.discrete_energy:
                e = ste_snap_levels(e, cfg.energy_quantum)
            if kind == noise_lib.SHOT:
                photons = e / cfg.noise.photon_energy_aj
                col = _norm(stats[1][lo:lo + nl]).reshape(1, nl) / torch.sqrt(photons * float(k))
                row = _norm(x_sq.reshape(m, 1))
            elif kind == noise_lib.THERMAL:
                col = noise_lib.thermal_noise_std(k, w_rng[lo:lo + nl].reshape(1, nl), x_rng,
                                                  cfg.noise.sigma, e)
                row = 1.0
            if kind == noise_lib.WEIGHT:
                col = noise_lib.weight_noise_std(w_rng[lo:lo + nl].reshape(1, nl),
                                                 cfg.noise.sigma, e)
                y2 = y2 + b.reshape(m, nl) * col
            else:
                k0, k1, row0, col0 = _seed_word_tensors(_offset_seed(seed, col=lo).reshape(1, 4))
                xi = prng.repeat_averaged_gaussian_tile(k0, k1, row0, col0, (m, nl), n_repeats)[0]
                y2 = y2 + row * col * xi
        results.append(y2.reshape(*lead, nl))
    return results if scatter else results[0]


def _same_pads(n: int, k: int, s: int) -> tuple:
    """XLA's ``"SAME"`` padding of one spatial dim: (low, high) with the
    odd element high, so ceil(n / s) outputs (asymmetric at stride 2 on
    even sizes, unlike ``F.unfold``'s symmetric ``padding=``)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_patches(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
                 padding="SAME") -> torch.Tensor:
    """f32 im2col patches of ``x`` (B, H, W, C): (B, Ho, Wo, C * kh * kw),
    features in (c, kh, kw) order, the bits of the reference's
    ``jax.lax.conv_general_dilated_patches``. ``padding``: ``"SAME"``,
    ``"VALID"`` or ((top, bottom), (left, right))."""
    _, h, w, _ = x.shape
    if padding == "SAME":
        (top, bottom), (left, right) = _same_pads(h, kh, stride), _same_pads(w, kw, stride)
    elif padding == "VALID":
        top = bottom = left = right = 0
    else:
        (top, bottom), (left, right) = padding
    nchw = torch.nn.functional.pad(x.to(torch.float32).permute(0, 3, 1, 2),
                                   (left, right, top, bottom))
    ho = (h + top + bottom - kh) // stride + 1
    wo = (w + left + right - kw) // stride + 1
    cols = torch.nn.functional.unfold(nchw, (kh, kw), stride=stride)  # (B, C kh kw, Ho Wo)
    return cols.transpose(1, 2).reshape(x.shape[0], ho, wo, -1).contiguous()


def conv_weight_matrix(kernel: torch.Tensor) -> torch.Tensor:
    """An HWIO kernel (kh, kw, Cin, Cout) as the f32 (Cin kh kw, Cout)
    matrix whose rows follow ``conv_patches``' feature order."""
    kh, kw, cin, cout = kernel.shape
    return kernel.to(torch.float32).permute(2, 0, 1, 3).reshape(kh * kw * cin, cout)


def analog_conv2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    *,
    cfg: AnalogConfig,
    stride: int = 1,
    padding="SAME",
    energy=None,
    seed: Optional[torch.Tensor] = None,
    sq: Optional[SiteQuant] = None,
) -> torch.Tensor:
    """Convolution as an im2col matmul through ``analog_dot`` (paper §II-A,
    [25]). ``x``: (B, H, W, Cin); ``kernel``: (kh, kw, Cin, Cout); returns
    (B, Ho, Wo, Cout). ``seed``, ``energy``, ``sq`` as ``analog_dot``'s: one
    (4,) seed draws over all B * Ho * Wo rows as one request, as the
    reference's one key does."""
    kh, kw, _, _ = kernel.shape
    patches = conv_patches(x, kh, kw, stride, padding)
    return analog_dot(patches, conv_weight_matrix(kernel), cfg=cfg, energy=energy, seed=seed,
                      sq=sq)
