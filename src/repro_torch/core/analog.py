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


def _torch_dot(x, w, *, cfg: AnalogConfig, energy, gen: torch.Generator, sq, n_repeats: int,
               x_range=None, rows=None):
    """One request on the ``"torch"`` backend (the reference's ``"jnp"``
    branch, ``repro/core/analog.py``): float32 operands, straight-through
    energy snapping and fake-quant, K repeats as one draw at K·E, and
    weight, thermal or shot noise drawn from ``gen``. ``x_range``: thermal
    noise's input range when it spans more rows than ``x`` (a data
    shard's); ``rows`` (r, data): a data shard's rows of the whole call's
    output noise (``noise.standard_normal``)."""
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
        x_rng = _x_range(sq, x_q) if x_range is None or (sq is not None and sq.xqp is not None) \
            else x_range
        std = noise_lib.thermal_noise_std(k_dim, _w_range(sq, w_q), x_rng, cfg.noise.sigma, energy)
        y = y + noise_lib.sample_output_noise(gen, y.shape, std, rows=rows)
    elif kind == noise_lib.SHOT:
        y = torch.matmul(x_q, w_q)
        # eps-safe norms: a norm's gradient is NaN at exactly zero
        w_col = torch.sqrt(torch.sum(w_q * w_q, dim=0, keepdim=True) + 1e-20)
        x_row = torch.sqrt(torch.sum(x_q * x_q, dim=-1, keepdim=True) + 1e-20)
        std = noise_lib.shot_noise_std(w_col, x_row, k_dim, energy, cfg.noise.photon_energy_aj)
        y = y + noise_lib.sample_output_noise(gen, y.shape, std, rows=rows)
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


#: (device, row offset) -> the (4,) int64 row0 offset of a data shard's seed
_ROW_OFFSETS: dict = {}


def _row_offset_seed(seed: torch.Tensor, rows: int) -> torch.Tensor:
    """A (4,) seed with its row0 word increased by ``rows`` as a uint32."""
    key = (seed.device, rows)
    off = _ROW_OFFSETS.get(key)
    if off is None:
        off = torch.zeros(4, dtype=torch.int64)
        off[2] = rows
        off = _ROW_OFFSETS[key] = off.to(seed.device)
    # summed in int64 from the sign-extended words; the cast keeps the low
    # 32 bits, so row0 wraps as the uint32 counter does
    return (seed.to(torch.int64) + off).to(torch.int32)


def _shard_x_range(x: torch.Tensor, group) -> torch.Tensor:
    """The whole call's input range ``max - min`` (float32) from a data
    shard's rows: the shards' maxima and minima reduced over ``group``
    (exact), subtracted in x's dtype as ``_x_range`` does. The gradient
    reaches the shard that holds the global extremum, as the whole call's
    does (ties across shards aside)."""
    import torch.distributed as dist

    from repro_torch.launch import collectives

    hi, lo = torch.amax(x), torch.amin(x)
    ext = torch.stack([hi.detach(), -lo.detach()]).to(torch.float32)
    ext = collectives.all_reduce(ext, dist.ReduceOp.MAX, group)
    g_hi, g_lo = ext[0].to(x.dtype), (-ext[1]).to(x.dtype)
    hi = torch.where(hi == g_hi, hi, g_hi)
    lo = torch.where(lo == g_lo, lo, g_lo)
    return (hi - lo).to(torch.float32)


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
    if backend == CUDA and torch.is_grad_enabled() and (
            x.requires_grad or (torch.is_tensor(energy) and energy.requires_grad)):
        raise RuntimeError(
            'analog_dot on backend="cuda": x or the energy requires grad, and the kernel '
            'has no backward; take the gradient on backend="torch" or "tile", or run '
            "under torch.no_grad()")
    x_range = rows = None
    shard = active_data_shard()
    if shard is not None and shard.data > 1:
        if seed.dim() != 1:
            raise NotImplementedError(
                "a stacked per-request seed table on a data shard: its requests are cut "
                "with the rows; pass one (4,) seed")
        if cfg.noise.kind == noise_lib.THERMAL and (sq is None or sq.xqp is None):
            if shard.group is None:
                raise ThermalRangeAcrossShards(
                    "thermal noise on the local form of a data mesh: the input range spans "
                    "every shard's rows; run the shards as ranks (the distributed form)")
            x_range = _shard_x_range(x, shard.group)
        if backend == TORCH:
            rows = (shard.r, shard.data)
        else:
            seed = _row_offset_seed(seed, shard.r * (x.numel() // x.shape[-1]))
    y = _maybe_sharded_analog_dot(x, w, backend=backend, cfg=cfg, energy=energy, seed=seed,
                                  sq=sq, n_repeats=n_repeats, x_range=x_range)
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
                              sq=sq, n_repeats=n_repeats, x_range=x_range, rows=rows)
        return torch.stack([
            _torch_dot(x[b], w, cfg=cfg, energy=energy, gen=_generator(words[b], x.device),
                       sq=sq, n_repeats=n_repeats)
            for b in range(words.shape[0])
        ])
    return tile_dot(x, w, cfg=cfg, energy=energy, seed=seed, sq=sq, n_repeats=n_repeats,
                    x_range=x_range)


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
