"""Operand preparation and the public analog-matmul entry points.

Port of ``repro/kernels/ops.py``. ``prepare_operands`` maps the high-level
(AnalogConfig, SiteQuant, energy, seed) description onto the kernel's raw
operands, so the same preparation feeds the CUDA kernel and the plain
version. It works on a leading request axis: x is (B, M, K) and each
request gets what the reference computes for its own ``vmap`` row — its
own thermal ``x_range`` (over its whole (M, K) slab, pad positions
included, when no calibrated ``xqp`` is given), its own shot row norms and
its own seed words. ``analog_matmul_shards`` runs column shards of one
call (tensor parallelism), each at its global column offset.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core import noise as noise_lib
from repro_torch.device import resolve_device
from repro_torch.kernels.analog_matmul import analog_matmul_raw
from repro_torch.kernels.ref import analog_matmul_ref_raw
from repro_torch.quant.affine import ste_snap_levels
from repro_torch.reduce import row_norm

F32 = torch.float32


def _ranges(sq, w, x3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel weight range (1, 1, N) and per-request input range (B, 1, 1)."""
    if sq is not None and sq.wqp is not None:
        w_rng = (sq.wqp.x_max - sq.wqp.x_min).to(F32).reshape(1, 1, -1)
    else:
        w_rng = (torch.amax(w, dim=0) - torch.amin(w, dim=0)).to(F32).reshape(1, 1, -1)
    if sq is not None and sq.xqp is not None:
        x_rng = (sq.xqp.x_max - sq.xqp.x_min).to(F32).reshape(1, 1, 1)
    else:
        x_rng = (torch.amax(x3, dim=(1, 2)) - torch.amin(x3, dim=(1, 2))).to(F32)
        x_rng = x_rng.reshape(-1, 1, 1)
    return w_rng, x_rng


#: (device, the eight packed floats) -> their (1, 8) float32 tensor on the
#: device: made once per quantizer set, so no site copies from the host (a
#: copy could not be captured into a CUDA graph)
_SCALARS: dict = {}


def _scalars(packed: tuple, dev) -> torch.Tensor:
    key = (dev, packed)
    t = _SCALARS.get(key)
    if t is None:
        t = _SCALARS[key] = torch.tensor(packed, dtype=F32).reshape(1, 8).to(dev)
    return t


def prepare_operands(x3: torch.Tensor, w: torch.Tensor, *, energy, seed, cfg, sq=None,
                     x_range=None) -> dict:
    """Raw kernel operands for ``x3`` (B, M, K) @ ``w`` (K, N).

    ``seed`` is the (B, 4) int32 table of uint32 words (k0, k1, row0, col0),
    one row per request. ``x_range``: thermal noise's input range of the
    one request, taken over rows beyond ``x3`` (a data shard's call: the
    whole call's range, ``core.analog.analog_dot``); None takes it from
    ``x3`` (or the calibrated ``xqp``).
    """
    b, m, k = x3.shape
    n = w.shape[1]
    dev = x3.device
    energy = torch.as_tensor(energy, dtype=F32, device=dev)
    if cfg.discrete_energy:
        energy = ste_snap_levels(energy, cfg.energy_quantum)
    e_col = energy.reshape(1, 1, -1).expand(1, 1, n)

    kind = cfg.noise.kind
    ones_row = torch.ones((b, m, 1), dtype=F32, device=dev)
    if kind == noise_lib.THERMAL:
        w_rng, x_rng = _ranges(sq, w, x3)
        if x_range is not None:
            x_rng = x_range.to(F32).reshape(1, 1, 1)
        col = noise_lib.thermal_noise_std(k, w_rng, x_rng, cfg.noise.sigma, e_col)
        row = ones_row
        noise_kind = "output"
    elif kind == noise_lib.SHOT:
        w_col = torch.linalg.vector_norm(w.to(F32), dim=0).reshape(1, 1, -1)
        photons = e_col / cfg.noise.photon_energy_aj
        col = w_col / torch.sqrt(photons * float(k))  # float32(k) * photons, as the reference
        row = row_norm(x3, keepdim=True)  # the same bits alone as in a batch
        noise_kind = "output"
    elif kind == noise_lib.WEIGHT:
        w_rng, _ = _ranges(sq, w, x3)
        col = noise_lib.weight_noise_std(w_rng, cfg.noise.sigma, e_col)
        row = ones_row
        noise_kind = "weight"
    else:
        col = torch.zeros((1, 1, n), dtype=F32, device=dev)
        row = ones_row
        noise_kind = "none"

    quant_w = cfg.weight_bits is not None and sq is not None and sq.wqp is not None
    quant_x = cfg.act_bits is not None and sq is not None and sq.xqp is not None
    quant_out = cfg.out_bits is not None and sq is not None and sq.oqp is not None

    if quant_w:
        qp = sq.wqp
        wq = torch.stack([
            qp.delta.reshape(-1).expand(n),
            qp.zero_point.reshape(-1).expand(n),
            torch.full((n,), qp.n_bins, dtype=F32, device=dev),
        ]).to(F32)
    else:
        wq = torch.ones((3, n), dtype=F32, device=dev)

    def _sq_scalars(qp):
        if qp is None:
            return [1.0, 0.0, 1.0]
        return [qp.delta, qp.zero_point, qp.n_bins]

    packed = (
        _sq_scalars(sq.xqp if quant_x else None)
        + _sq_scalars(sq.oqp if quant_out else None)
        + [0.0, 0.0]
    )
    if all(isinstance(v, float) for v in packed):
        scalars = _scalars(tuple(packed), dev)
    else:
        scalars = torch.stack([
            torch.full((), v, dtype=F32, device=dev) if isinstance(v, float)
            else torch.as_tensor(v, dtype=F32).to(dev).reshape(())
            for v in packed
        ]).reshape(1, 8)

    return dict(
        x=x3.contiguous(),
        w=w.contiguous(),
        row_scale=row.contiguous(),
        col_scale=col.expand(col.shape[0], 1, n).contiguous(),
        wq=wq.contiguous(),
        scalars=scalars,
        seed=seed.to(dev, torch.int32).reshape(b, 4).contiguous(),
        noise_kind=noise_kind,
        quant_x=quant_x,
        quant_w=quant_w,
        quant_out=quant_out,
    )


def _requests(x, seed):
    """(lead dims, x as (B, M, K), seed as (B, 4)): ``x`` (B, ..., K) with a
    (B, 4) seed table, or (..., K) with one (4,) seed."""
    if seed.dim() == 1:
        return x.shape[:-1], x.reshape(1, -1, x.shape[-1]), seed.reshape(1, 4)
    return x.shape[:-1], x.reshape(x.shape[0], -1, x.shape[-1]), seed


#: (device, tp, n_local) -> the (tp, 1, 4) int64 col0 offsets of the shards
_COL_OFFSETS: dict = {}


def shard_seeds(seed: torch.Tensor, tp: int, n_local: int) -> torch.Tensor:
    """(tp, B, 4) int32 seed tables: shard r's is the requests' (B, 4)
    table with its col0 word increased by ``r * n_local`` as a uint32."""
    key = (seed.device, tp, n_local)
    off = _COL_OFFSETS.get(key)
    if off is None:
        off = torch.zeros((tp, 1, 4), dtype=torch.int64)
        off[:, 0, 3] = torch.arange(tp, dtype=torch.int64) * n_local
        off = _COL_OFFSETS[key] = off.to(seed.device)
    # summed in int64 from the sign-extended words; the cast keeps the low
    # 32 bits, so col0 wraps as the uint32 counter does
    return (seed.to(torch.int64)[None] + off).to(torch.int32)


def analog_matmul_shards(raw, x, w, *, energy, seed, cfg, n_repeats: int, tp: int,
                         shards: Sequence[int], sq=None, x_range=None, **raw_kw):
    """Column shards of one analog matmul ``(..., K) @ (K, N)``: shard r is
    columns ``[r N / tp, (r + 1) N / tp)`` drawn at its global col0, a list
    of (..., N / tp) outputs for ``shards``. Site quantizers (``sq``) only
    at tp = 1, the whole call.

    The operands are prepared once over the whole weight (one pass of the
    column norms or ranges, which each shard slices) and every shard reads
    its columns of the weight in place. ``raw`` is ``analog_matmul_raw``
    (``raw_kw``: its ``plan_n``) or the plain version. ``x_range``: as
    ``prepare_operands``'.
    """
    if tp > 1 and sq is not None:
        raise ValueError("column shards take no site quantizers (the sharded path falls back)")
    lead, x3, seed = _requests(x, seed)
    o = prepare_operands(x3, w, energy=energy, seed=seed, cfg=cfg, sq=sq, x_range=x_range)
    nl = w.shape[1] // tp
    if tp == 1:
        seeds, wq = o["seed"][None], o["wq"]
    else:
        # no weight quantizer: every shard's (3, nl) table is ones
        seeds = shard_seeds(o["seed"], tp, nl)
        wq = torch.ones((3, nl), dtype=F32, device=x3.device)
    outs = []
    for r in shards:
        cols = slice(r * nl, (r + 1) * nl)
        y = raw(o["x"], o["w"][:, cols], o["row_scale"], o["col_scale"][..., cols], wq,
                o["scalars"], seeds[r], noise_kind=o["noise_kind"], quant_x=o["quant_x"],
                quant_w=o["quant_w"], quant_out=o["quant_out"], n_repeats=n_repeats, **raw_kw)
        outs.append(y.reshape(*lead, nl))
    return outs


def _run(raw, x, w, energy, seed, cfg, sq, n_repeats, x_range=None) -> torch.Tensor:
    """The whole call: ``analog_matmul_shards``' one shard at tp = 1."""
    (y,) = analog_matmul_shards(raw, x, w, energy=energy, seed=seed, cfg=cfg, sq=sq,
                                n_repeats=n_repeats, tp=1, shards=(0,), x_range=x_range)
    return y


def analog_matmul(
    x, w, *, energy, seed, cfg, sq=None, n_repeats: int = 1, device="cuda", x_range=None
) -> torch.Tensor:
    """Fused analog matmul ``(..., K) @ (K, N)`` on ``device`` (the CUDA
    kernel there; the plain version on ``device="cpu"``).

    ``seed``: a (4,) int32 seed (one request: every row of x) or a (B, 4)
    table whose row b seeds ``x[b]`` (stacked per-request streams).
    ``x_range``: as ``prepare_operands``'.
    """
    dev = resolve_device(device)
    return _run(analog_matmul_raw, x.to(dev), w.to(dev), energy, seed.to(dev), cfg, sq, n_repeats,
                x_range)


def analog_matmul_reference(x, w, *, energy, seed, cfg, sq=None, n_repeats: int = 1,
                            x_range=None) -> torch.Tensor:
    """The plain version with identical noise draws, on x's device."""
    return _run(analog_matmul_ref_raw, x, w, energy, seed, cfg, sq, n_repeats, x_range)
