"""Wrapper of the hand-written CUDA analog-matmul kernels: one function,
four routes.

The sources in ``csrc/`` replace the Pallas TPU kernel of
``repro/kernels/analog_matmul.py``. Each route is its own source and its
own library, built with ``nvcc`` for ``sm_90a`` into ``_build/`` at first
use (all four compiled side by side) and bound through a plain C
interface with ``ctypes``:

  * ``decode`` (``csrc/analog_decode.cu``) - at most ``M_DECODE`` rows a
    request: bound by the weight bytes; split-K over one wave of blocks,
    16-byte weight loads, f32 SIMT products, the splits added in a second
    pass;
  * ``tc`` (``csrc/analog_tc.cu``) - more rows, bf16 operands, no input
    quantizers: bound by the operand bytes at the served prefills, by the
    products above. bf16 tensor-core products (``wgmma`` fed by TMA), f32
    sums, K cut into 1, 2, 4 or 8 runs of whole 64-deep tiles that are the
    ranks of one thread-block cluster, their partial tiles added in
    distributed shared memory in rank order: one launch (``tc_plan``);
  * ``weight`` (``csrc/analog_weight.cu``) - weight noise, bf16 operands:
    bound by the noise draws; each drawn weight taken once a request, split-K
    over two waves of blocks, the splits added in a second pass; SIMT
    products at up to ``M_DECODE`` rows a request, bf16 tensor-core products
    of the noisy weights split into two bf16 parts above (input quantizers
    there go to simt);
  * ``simt`` (``csrc/analog_matmul.cu``) - everything else: f32 operands
    (every convolution), rows not a multiple of 16 bytes, input quantizers
    above ``M_DECODE`` rows. Bound by the patches' bytes at conv1, by the
    products at the 3x3 sites. Tensor-core products of split bf16 parts:
    each operand value v (after fake-quant and weight noise) is split into
    hi = bf16(v) and lo = bf16(v - hi) in a converting stage fed by a ring
    of TMA or ``cp.async`` copies, and ``wgmma`` sums hi*hi + hi*lo + lo*hi
    in f32 (an unchanged bf16 operand has no lo part); 128 x 64 tiles
    (request under weight noise, row tile, column tile) walked on grid.x by
    persistent clusters, no row limit; K cut into 1,
    2, 4 or 8 runs that are the ranks of one thread-block cluster, their
    partial tiles added in distributed shared memory in rank order
    (``simt_plan``).

``select_route`` picks the route from the call's shapes and flags alone,
never from the batch size. The order of every output's sum is fixed by
(K, ``plan_n``) alone: each plan takes its split of K from them, sums each
split in K order (the decode route over 8 k lanes) and adds the splits in
a fixed order (the tc and simt routes in rank order); rows only pick
which block computes an output. So a request's rows are the same bits alone or in
any batch, and from launch to launch. Every route reads the weight
through its row stride, so a column shard ``w[:, c0:c1]`` of a
tensor-parallel call is a view, never a copy; with ``plan_n`` = the whole
weight's N every route splits K as the whole call does, so a shard at seed
col0 = c0 gives exactly columns c0:c1 of the whole call.
``analog_matmul_raw`` keeps the reference's signature
plus a leading request axis: for a CPU tensor it runs the plain version
(``kernels/ref.py``); for a CUDA tensor it launches its route or raises;
a meta tensor (the dry run's, which allocates nothing) is reckoned by
``reckon_on_meta`` without a launch.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import numpy as np
import torch

from repro_torch import tally
from repro_torch.kernels.ref import analog_matmul_ref_raw

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
HEADER = os.path.join(CSRC, "analog_common.cuh")
BUILD_DIR = os.path.join(_HERE, "_build")
ROUTES = ("decode", "tc", "simt", "weight")
SOURCES = {
    "decode": os.path.join(CSRC, "analog_decode.cu"),
    "tc": os.path.join(CSRC, "analog_tc.cu"),
    "simt": os.path.join(CSRC, "analog_matmul.cu"),
    "weight": os.path.join(CSRC, "analog_weight.cu"),
}
LIBRARIES = {r: os.path.join(BUILD_DIR, f"libanalog_{r}.so") for r in ROUTES}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
NOISE_KINDS = {"none": 0, "output": 1, "weight": 2}

#: largest per-request row count M that takes the decode route. Every decode
#: step has M = 1 and every prefill M >= 32 (the smallest seq bucket). The
#: gate/up sweep of ``chip_smoke.py`` (4 requests) placed the crossover on
#: the H100: decode faster at M = 1 and 2, tc from M = 4 on.
M_DECODE = 2

#: decode route: 256 threads a block, 8 k lanes, 4 loads in flight a
#: thread; K split for at most one wave of 4 blocks a SM, of 256 columns
#: each, on the H100's 132 SMs.
DECODE_BN = 256
DECODE_STEP = 32  # k lanes x loads in flight: the granule of a split
DECODE_KC_MAX = 1024
DECODE_TARGET_BLOCKS = 4 * 132
#: tc route: 128 x 128 output tiles, 64-deep K tiles, each split at least
#: ``TC_MIN_SPLIT`` K tiles (so its 3-stage ring fills); a 96 KB ring. The
#: splits aim at ``TC_BLOCKS`` blocks a row tile: a served prefill (4 x 64
#: rows, two row tiles) then runs about one block a SM, which the H100 ran
#: fastest (PERF.md §6: two blocks a SM share its L2 bandwidth and add
#: partial tiles to add).
TC_BM = 128
TC_BN = 128
TC_BK = 64
TC_MIN_SPLIT = 4
TC_BLOCKS = 64
#: the largest thread-block cluster that is portable: at most 8 splits of K
CLUSTER_MAX = 8
TC_RING = 3 * (TC_BM + TC_BN) * TC_BK * 2
#: weight route: blocks of 128 threads over 64 columns and a slice of K
#: (a multiple of 32 rows, at most 2048); prefill tiles of 64 rows. K is
#: split for two waves of 4 blocks a SM on the H100's 132 SMs.
WEIGHT_BN = 64
WEIGHT_BM = 64
WEIGHT_STEP = 32
WEIGHT_KC_MAX = 2048
WEIGHT_WAVE = 4 * 132
WEIGHT_TARGET_BLOCKS = 2 * WEIGHT_WAVE

#: simt route: output tiles of ``SIMT_BM`` rows (64 a warpgroup, wgmma
#: m64n64) and ``SIMT_BN`` columns; K in 32-deep steps, each split at least
#: ``SIMT_MIN_SPLIT`` steps; the splits aim at ``SIMT_BLOCKS`` blocks a row
#: tile (the 7x7 stage's 3x3, 784 rows: 8 column tiles x 8 splits). A ring
#: of two f32 steps of x and w and the four bf16 parts (two steps deep): two
#: blocks a SM.
SIMT_BM = 128
SIMT_BN = 64
SIMT_BK = 32
SIMT_MIN_SPLIT = 16
SIMT_BLOCKS = 128
SIMT_SMEM = (2 * SIMT_BM * 64 * 2 + 2 * 64 * SIMT_BN * 2 + 2 * (SIMT_BM + SIMT_BN) * SIMT_BK * 4
             + 2 * 8 + 1024)

#: kernel launches so far in this process, by route (one per
#: ``analog_matmul_raw`` call on CUDA tensors): a run shows the main path
#: used the kernels.
LAUNCHES = {r: 0 for r in ROUTES}
#: the same launches by their K-repeat count ``n_repeats`` (every route):
#: a run shows which K each layer of a precision profile ran at.
LAUNCHES_BY_K: dict = {}
#: the same launches by (route, K, N): a run shows which site shapes each
#: route took.
LAUNCHES_BY_SHAPE: dict = {}
#: seconds the last build took (0.0 when the libraries were already built),
#: and what nvcc/ptxas printed for each route (registers, shared memory,
#: spills).
BUILD_SECONDS = 0.0
BUILD_LOG = {r: "" for r in ROUTES}

_libs: dict = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _bf16_rows(k: int, n: int, dtype: torch.dtype) -> bool:
    """Whether the decode, tc and weight routes take such operands at all:
    bf16, whose products are exact in f32, and rows of 16-byte multiples."""
    return dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0


def shard_keeps_route(k: int, n: int, tp: int, dtype: torch.dtype) -> bool:
    """Whether a column shard of ``n // tp`` columns takes the route of the
    whole (K, N) call: a shard whose rows are no longer 16-byte multiples
    would leave the decode, tc or weight route for simt, whose sums run in
    another order, and the gathered shards would not be the whole call's
    bits."""
    return _bf16_rows(k, n, dtype) == _bf16_rows(k, n // tp, dtype)


def select_route(b: int, m: int, k: int, n: int, dtype: torch.dtype, noise_kind: str,
                 quant_x: bool = False, quant_w: bool = False, quant_out: bool = False) -> str:
    """The route that computes a (b, m, k) @ (k, n) call on the card.

    A function of the shapes and flags; ``b`` is taken so the signature
    matches a call, and deliberately never read: a request must take the
    same route alone as in a batch. ``quant_out`` is allowed on every route.
    """
    del b, quant_out
    if not _bf16_rows(k, n, dtype):
        return "simt"
    if m > M_DECODE and (quant_x or quant_w):
        return "simt"
    if noise_kind == "weight":
        return "weight"
    return "decode" if m <= M_DECODE else "tc"


def route_takes(route: str, m: int, k: int, n: int, dtype: torch.dtype, noise_kind: str,
                quant_x: bool, quant_w: bool) -> bool:
    """Whether ``route`` computes such a call at all; the simt route computes
    every call, decode and tc every row count, weight only weight noise and,
    above ``M_DECODE`` rows a request, no input quantizer."""
    if route == "simt":
        return True
    if not _bf16_rows(k, n, dtype) or (route == "weight") != (noise_kind == "weight"):
        return False
    return route == "decode" or (route == "weight" and m <= M_DECODE) or not (quant_x or quant_w)


def _cluster_splits(units: int, min_units: int, tiles: int, blocks: int) -> int:
    """Splits of K for ``tiles`` column tiles (or columns): the least power
    of two up to ``CLUSTER_MAX`` that gives ``blocks`` at one row group,
    unless a split would get fewer than ``min_units`` of the ``units``
    granules of K."""
    splits = 1
    while splits < CLUSTER_MAX and tiles * splits < blocks and units >= 2 * splits * min_units:
        splits *= 2
    return splits


def split_ranges(units: int, splits: int, step: int, k: int) -> list:
    """The (begin, end) rows of K of each split: ``units`` granules of
    ``step`` rows cut into ``splits`` near-equal runs, split q taking
    granules [q * units // splits, (q + 1) * units // splits), as the
    kernels' ``split_begin`` does; the last run ends at K."""
    bounds = [q * units // splits * step for q in range(splits)] + [k]
    return [(bounds[q], min(bounds[q + 1], k)) for q in range(splits)]


def decode_plan(k: int, n: int, rows: int, plan_n=None) -> dict:
    """Launch plan of the decode route for B * M = ``rows`` over ``n``
    columns; the split of K follows ``plan_n`` (default ``n``): a column
    shard passes the whole weight's N and sums in the whole call's order.

    The split of K is a function of (K, N) alone: ``kc`` rows of K a block
    (a multiple of ``DECODE_STEP``), ``splits`` slices cover K exactly (the
    last may be short), at most ``DECODE_TARGET_BLOCKS`` blocks of 256
    columns (one wave) unless the 32-row granule forces more. The rows
    only decide which block computes an output, never the order of its
    sum: ``rt`` rows a block in ``row_groups``, ``cpt`` columns a thread
    (8, one 16-byte load, at 4 rows; 4 at 8 or 16 rows, where 8 would need
    64-128 accumulator registers a thread), ``col_tiles`` of 32 * ``cpt``
    columns.
    """
    want = max(1, DECODE_TARGET_BLOCKS // _cdiv(plan_n or n, DECODE_BN))
    kc = min(DECODE_KC_MAX, max(DECODE_STEP, _cdiv(_cdiv(k, want), DECODE_STEP) * DECODE_STEP))
    rt = 4 if rows <= 4 else 8 if rows <= 8 else 16
    cpt = 8 if rt == 4 else 4
    return dict(kc=kc, splits=_cdiv(k, kc), rt=rt, row_groups=_cdiv(rows, rt), cpt=cpt,
                col_tiles=_cdiv(n, 32 * cpt))


def weight_plan(k: int, n: int, rows: int, plan_n=None) -> dict:
    """Launch plan of the weight route for ``rows`` = M rows a request over
    ``n`` columns; the split of K follows ``plan_n`` (default ``n``), as in
    ``decode_plan``.

    The split of K is a function of (K, N) alone: ``splits`` slices of
    ``kc`` rows (a multiple of ``WEIGHT_STEP``, at most ``WEIGHT_KC_MAX``;
    the last may be short) over ``col_tiles`` of 64 columns give at least
    ``WEIGHT_TARGET_BLOCKS`` blocks a request (two waves) unless the
    granule forbids it. The rows only pick the kernel: ``row_tiles`` 0 takes
    the decode kernel (M <= ``M_DECODE``), else that many tiles of 64 rows
    of each request take the tensor-core one.
    """
    want = _cdiv(WEIGHT_TARGET_BLOCKS, _cdiv(plan_n or n, WEIGHT_BN))
    kc = min(WEIGHT_KC_MAX, max(WEIGHT_STEP, k // want // WEIGHT_STEP * WEIGHT_STEP))
    return dict(kc=kc, splits=_cdiv(k, kc), col_tiles=_cdiv(n, WEIGHT_BN),
                row_tiles=0 if rows <= M_DECODE else _cdiv(rows, WEIGHT_BM))


def tc_plan(rows: int, k: int, n: int, plan_n=None) -> dict:
    """Grid of the tc route: 128 x 128 output tiles (row tiles on grid.x),
    ``k_tiles`` 64-deep K tiles cut into ``splits`` (1, 2, 4 or 8, one
    cluster; grid.z) runs of whole tiles (``split_ranges``). The split is a
    function of (K, ``plan_n``) alone (default ``n``; a column shard passes
    the whole weight's N): enough splits for cdiv(``plan_n``, 128) x
    splits >= ``TC_BLOCKS`` blocks at one row tile, each at least
    ``TC_MIN_SPLIT`` tiles. ``smem``: the block's shared memory."""
    k_tiles = _cdiv(k, TC_BK)
    splits = _cluster_splits(k_tiles, TC_MIN_SPLIT, _cdiv(plan_n or n, TC_BN), TC_BLOCKS)
    return dict(grid_m=_cdiv(rows, TC_BM), grid_n=_cdiv(n, TC_BN), k_tiles=k_tiles,
                splits=splits, smem=TC_RING + 2 * 3 * 8 + 1024)


def simt_plan(rows: int, k: int, n: int, plan_n=None) -> dict:
    """Grid of the simt route for ``rows`` (B * M, or M a request under
    weight noise, whose requests multiply the tiles): ``row_tiles`` of
    ``SIMT_BM``, ``col_tiles`` of ``SIMT_BN``, ``k_steps`` 32-deep K steps
    cut into ``splits`` (1, 2, 4 or 8, one cluster) runs of whole steps
    (``split_ranges``). The split is a function of (K, ``plan_n``) alone
    (``plan_n`` defaults to ``n``; a column shard passes the whole weight's
    N): enough splits for cdiv(``plan_n``, 64) x splits >= ``SIMT_BLOCKS``
    blocks at one row tile, each at least ``SIMT_MIN_SPLIT`` steps. The
    kernel's persistent clusters walk the tiles on grid.x: no row limit.
    ``smem``: the block's shared memory."""
    k_steps = _cdiv(k, SIMT_BK)
    splits = _cluster_splits(k_steps, SIMT_MIN_SPLIT, _cdiv(plan_n or n, SIMT_BN), SIMT_BLOCKS)
    return dict(row_tiles=_cdiv(rows, SIMT_BM), col_tiles=_cdiv(n, SIMT_BN), k_steps=k_steps,
                splits=splits, smem=SIMT_SMEM)


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, ``/usr/local/cuda/bin`` or ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, PATH); "
            "the CUDA kernels are built from csrc/ at first use"
        )
    return found


def _stale(route: str) -> bool:
    lib = LIBRARIES[route]
    if not os.path.exists(lib):
        return True
    built = os.path.getmtime(lib)
    return built < os.path.getmtime(SOURCES[route]) or built < os.path.getmtime(HEADER)


def build(force: bool = False) -> dict:
    """Compile every route's source into ``_build/``, one ``nvcc`` a source,
    all started together, skipping a library newer than its sources unless
    ``force``. Returns the library paths by route."""
    global BUILD_SECONDS
    todo = [r for r in ROUTES if force or _stale(r)]
    if not todo:
        return dict(LIBRARIES)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = {}
    for r in todo:
        tmp = f"{LIBRARIES[r]}.{os.getpid()}.tmp"
        procs[r] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCES[r]],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    failed = []
    for r, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        BUILD_LOG[r] = out + err
        if proc.returncode != 0:
            failed.append(f"{SOURCES[r]} ({proc.returncode}):\n{err}")
        else:
            os.replace(tmp, LIBRARIES[r])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    BUILD_SECONDS = time.perf_counter() - t0
    return dict(LIBRARIES)


def library(route: str) -> ctypes.CDLL:
    """The built library of ``route``, loaded once per process."""
    if route not in _libs:
        lib = ctypes.CDLL(build()[route])
        p, i, f, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
        common = [p, p, p, p, i, p, p, p, p]  # x, w, rs, cs, cs_stride, wq, sc, seed, out
        if route == "simt":
            lib.analog_matmul_launch.argtypes = [
                p, p, i, p, p, i, p, p, p, p, i, i, i, i, i, i, i, i, i, i, f, i, i, i, p,
            ]
            lib.analog_matmul_launch.restype = i
            lib.threefry_words.argtypes = [u32, u32, u32, u32, i, i, p, p]
            lib.threefry_words.restype = i
        elif route == "decode":
            lib.analog_decode_launch.argtypes = common + [p] + [i] * 10 + [f] + [i] * 5 + [p]
            lib.analog_decode_launch.restype = i
        elif route == "weight":
            lib.analog_weight_launch.argtypes = common + [p] + [i] * 9 + [f] + [i] * 4 + [p]
            lib.analog_weight_launch.restype = i
            lib.weight_draw_sum.argtypes = [u32, u32, i, i, i, f, i, p, p]
            lib.weight_draw_sum.restype = i
        else:
            lib.analog_tc_launch.argtypes = common + [i] * 8 + [f, i, i, i, p]
            lib.analog_tc_launch.restype = i
        _libs[route] = lib
    return _libs[route]


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with cudaError {err}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a fresh contiguous copy when its start or its row stride is
    not a multiple of 16 bytes (a view at an odd offset): the decode, tc and
    weight routes read 16 bytes at a time (TMA: 16-byte strides)."""
    ok = t.data_ptr() % 16 == 0 and (t.stride(0) * t.element_size()) % 16 == 0
    return t if ok else torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)


def reckon_on_meta(route: str, x: torch.Tensor, w: torch.Tensor, plan_n=None) -> torch.Tensor:
    """The dry run's stand-in for a call on meta tensors
    (``launch/trace_analysis.py``): no kernel runs and ``LAUNCHES`` is not
    touched. Returns the empty (B, M, N) float32 output, makes and drops
    the route's workspace as the launch would (decode and weight: splits x
    rows x N float32; tc and simt add their partials in shared memory), and
    adds the call's 2·B·M·K·N FLOPs and one site to the open tally."""
    b, m, k = x.shape
    n = w.shape[1]
    out = torch.empty((b, m, n), dtype=torch.float32, device=x.device)
    if route in ("decode", "weight"):
        plan = (decode_plan(k, n, b * m, plan_n) if route == "decode"
                else weight_plan(k, n, m, plan_n))
        torch.empty((plan["splits"], b * m, n), dtype=torch.float32, device=x.device)
    tally.add("analog_flops", 2.0 * b * m * k * n)
    tally.add("analog_sites", 1)
    return out


def analog_matmul_raw(
    x: torch.Tensor,
    w: torch.Tensor,
    row_scale: torch.Tensor,
    col_scale: torch.Tensor,
    wq: torch.Tensor,
    scalars: torch.Tensor,
    seed: torch.Tensor,
    *,
    noise_kind: str = "output",
    quant_x: bool = False,
    quant_w: bool = False,
    quant_out: bool = False,
    n_repeats: int = 1,
    route: str = "auto",
    plan_n=None,
) -> torch.Tensor:
    """(B, M, K) @ (K, N) -> (B, M, N) float32, one request per leading row.

    x (B, M, K) and w (K, N) both bf16 or both f32; row_scale f32 (B, M, 1);
    col_scale f32 (B, 1, N), or (1, 1, N) shared by every request; wq f32
    (3, N) = (delta, zp, bins); scalars f32 (1, 8) = (xd, xz, xbins, od, oz,
    obins, 0, 0); seed int32 (B, 4) holding the uint32 words (k0, k1, row0,
    col0) of each request. ``n_repeats`` K-repeat streams are averaged in
    the epilogue (or the weight load, for weight noise). ``route`` "auto"
    takes ``select_route``'s; naming one forces it (for checks and
    timings) and raises if that route does not compute such a call.

    ``w`` may be a column view of a wider weight (unit column stride, rows
    ``w.stride(0)`` elements apart): a tensor-parallel shard, read in place.
    ``col_scale`` may be such a view too. ``plan_n``: the whole weight's N,
    from which every route takes its split of K (default N), so a shard
    sums in the whole call's order.
    """
    _require(x.dim() == 3 and w.dim() == 2, f"x must be (B, M, K), w (K, N): {x.shape} {w.shape}")
    b, m, k = x.shape
    _require(w.shape[0] == k, f"contract mismatch {tuple(x.shape)} @ {tuple(w.shape)}")
    n = w.shape[1]
    _require(plan_n is None or plan_n >= n, f"plan_n={plan_n} < N={n}")
    _require(n_repeats >= 1, f"n_repeats must be >= 1, got {n_repeats}")
    _require(noise_kind in NOISE_KINDS, f"bad noise_kind {noise_kind!r}")
    _require(route == "auto" or route in ROUTES, f"bad route {route!r}")
    _require(tuple(row_scale.shape) == (b, m, 1), f"row_scale {tuple(row_scale.shape)} != {(b, m, 1)}")
    _require(
        tuple(col_scale.shape) in ((b, 1, n), (1, 1, n)),
        f"col_scale {tuple(col_scale.shape)} must be {(b, 1, n)} or {(1, 1, n)}",
    )
    _require(tuple(wq.shape) == (3, n), f"wq {tuple(wq.shape)} != {(3, n)}")
    _require(tuple(scalars.shape) == (1, 8), f"scalars {tuple(scalars.shape)} != (1, 8)")
    _require(tuple(seed.shape) == (b, 4), f"seed {tuple(seed.shape)} != {(b, 4)}")
    if route == "auto":
        route = select_route(b, m, k, n, x.dtype, noise_kind, quant_x, quant_w, quant_out)
    else:
        _require(route_takes(route, m, k, n, x.dtype, noise_kind, quant_x, quant_w),
                 f"route {route!r} does not compute {noise_kind} noise on {x.dtype} "
                 f"(K={k}, N={n}, quant_x={quant_x}, quant_w={quant_w})")
    if x.device.type == "meta":  # the dry run's reckoning: nothing launches
        return reckon_on_meta(route, x, w, plan_n)
    if x.device.type == "cpu":
        return analog_matmul_ref_raw(
            x, w, row_scale, col_scale, wq, scalars, seed, noise_kind=noise_kind,
            quant_x=quant_x, quant_w=quant_w, quant_out=quant_out, n_repeats=n_repeats,
        )
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    dev = x.device
    for name, t in (("w", w), ("row_scale", row_scale), ("col_scale", col_scale),
                    ("wq", wq), ("scalars", scalars), ("seed", seed)):
        _require(t.device == dev, f"{name} is on {t.device}, x on {dev}")
        _require(name in ("w", "col_scale") or t.is_contiguous(), f"{name} must be contiguous")
    _require(w.stride(1) == 1 and w.stride(0) >= n,
             f"w must have unit column stride and rows >= N apart, got strides {w.stride()}")
    _require(col_scale.stride(2) == 1, "col_scale must have unit column stride")
    _require(x.is_contiguous(), "x must be contiguous")
    _require(
        x.dtype == w.dtype and x.dtype in (torch.float32, torch.bfloat16),
        f"x and w must both be bf16 or both f32, got {x.dtype} and {w.dtype}",
    )
    for name, t in (("row_scale", row_scale), ("col_scale", col_scale),
                    ("wq", wq), ("scalars", scalars)):
        _require(t.dtype == torch.float32, f"{name} must be float32, got {t.dtype}")
    _require(seed.dtype == torch.int32, f"seed must be int32 (uint32 bits), got {seed.dtype}")
    _require(b * m < 2**31 and k * w.stride(0) < 2**31, "problem too large for int32 indexing")

    out = torch.empty((b, m, n), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    cs_stride = col_scale.stride(0) if col_scale.shape[0] == b and b > 1 else 0
    inv_k = float(np.float32(1.0 / n_repeats))
    stream = torch.cuda.current_stream(dev).cuda_stream
    kind = NOISE_KINDS[noise_kind]
    if route == "simt":
        per_req = noise_kind == "weight"
        plan = simt_plan(m if per_req else b * m, k, n, plan_n)
        err = library("simt").analog_matmul_launch(
            x.data_ptr(), w.data_ptr(), int(x.dtype == torch.bfloat16),
            row_scale.data_ptr(), col_scale.data_ptr(), cs_stride,
            wq.data_ptr(), scalars.data_ptr(), seed.data_ptr(), out.data_ptr(),
            b, m, k, n, w.stride(0), kind, int(quant_x), int(quant_w), int(quant_out),
            int(n_repeats), inv_k, plan["row_tiles"], plan["col_tiles"], plan["splits"], stream,
        )
    else:
        x, w = _aligned(x), _aligned(w)
        ldw = w.stride(0)
        ptrs = (x.data_ptr(), w.data_ptr(), row_scale.data_ptr(), col_scale.data_ptr(),
                cs_stride, wq.data_ptr(), scalars.data_ptr(), seed.data_ptr(), out.data_ptr())
        if route == "decode":
            plan = decode_plan(k, n, b * m, plan_n)
            ws = torch.empty((plan["splits"], b * m, n), dtype=torch.float32, device=dev)
            err = library("decode").analog_decode_launch(
                *ptrs, ws.data_ptr(), b, m, k, n, ldw, kind, int(quant_x), int(quant_w),
                int(quant_out), int(n_repeats), inv_k, plan["kc"], plan["splits"], plan["rt"],
                plan["row_groups"], plan["col_tiles"], stream,
            )
        elif route == "weight":
            plan = weight_plan(k, n, m, plan_n)
            ws = torch.empty((plan["splits"], b * m, n), dtype=torch.float32, device=dev)
            err = library("weight").analog_weight_launch(
                *ptrs, ws.data_ptr(), b, m, k, n, ldw, int(quant_x), int(quant_w), int(quant_out),
                int(n_repeats), inv_k, plan["kc"], plan["splits"], plan["col_tiles"],
                plan["row_tiles"], stream,
            )
        else:
            plan = tc_plan(b * m, k, n, plan_n)
            err = library("tc").analog_tc_launch(
                *ptrs, b, m, k, n, ldw, kind, int(quant_out), int(n_repeats), inv_k,
                plan["grid_m"], plan["grid_n"], plan["splits"], stream,
            )
    _check(err, f"analog_matmul ({route})")
    LAUNCHES[route] += 1
    LAUNCHES_BY_K[int(n_repeats)] = LAUNCHES_BY_K.get(int(n_repeats), 0) + 1
    LAUNCHES_BY_SHAPE[(route, k, n)] = LAUNCHES_BY_SHAPE.get((route, k, n), 0) + 1
    return out


def threefry_words(k0: int, k1: int, row0: int, col0: int, shape, device="cuda") -> torch.Tensor:
    """Device Threefry words for the counter grid (row0 + i, col0 + j):
    an int32 (rows, cols, 2) tensor holding the uint32 bits. A check, not
    a path of the model: it does not count as a kernel launch."""
    rows, cols = shape
    out = torch.empty((rows, cols, 2), dtype=torch.int32, device=device)
    _require(out.device.type == "cuda", "threefry_words runs on the card only")
    err = library("simt").threefry_words(
        k0 & 0xFFFFFFFF, k1 & 0xFFFFFFFF, row0 & 0xFFFFFFFF, col0 & 0xFFFFFFFF,
        rows, cols, out.data_ptr(), torch.cuda.current_stream(out.device).cuda_stream,
    )
    _check(err, "threefry_words")
    return out


def weight_draws(k0: int, k1: int, k: int, n: int, n_repeats: int = 1,
                 device="cuda") -> torch.Tensor:
    """The weight route's noise draws alone: xi over the (k, n) counter grid
    of key (k0, k1), ``n_repeats`` streams, summed per thread of
    ``WEIGHT_TARGET_BLOCKS`` blocks of 128 (the route's two waves) into one
    f32 tensor. A measured ceiling of the draw rate, not a path of the
    model: it does not count as a kernel launch."""
    _require(n % 8 == 0 and n_repeats >= 1, f"n={n} must be a multiple of 8, n_repeats >= 1")
    blocks = WEIGHT_TARGET_BLOCKS
    out = torch.empty((blocks * 128,), dtype=torch.float32, device=device)
    _require(out.device.type == "cuda", "weight_draws runs on the card only")
    err = library("weight").weight_draw_sum(
        k0 & 0xFFFFFFFF, k1 & 0xFFFFFFFF, k, n, n_repeats, float(np.float32(1.0 / n_repeats)),
        blocks, out.data_ptr(), torch.cuda.current_stream(out.device).cuda_stream,
    )
    _check(err, "weight_draw_sum")
    return out
