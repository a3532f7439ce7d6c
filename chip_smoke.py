#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --only build,threefry,kernels,routes   # a short check

It builds the four routes of the analog-matmul kernel (``decode``, ``tc``,
``simt``, ``weight``) from ``src/repro_torch/kernels/csrc``, holds the
device Threefry words bit-exactly and each route's gaussians, times the
weight route's draws alone (the measured ceiling of the draw rate), holds
its outputs at the main path's shapes and at a ragged shape (K = 1 and 4,
with output requant, col scales shared and per request) within a stated
tolerance against the plain PyTorch version, checks that each route gives
a request the same bits alone as in a batch and from launch to launch,
times the chosen route beside the simt route at every analog site shape
of granite-3-8b (shot noise; weight noise at K = 1 and 4), sweeps the
per-request row count at gate/up to place ``M_DECODE``, serves eight
requests through ``ServingEngine`` on granite-3-8b at full width and depth
(random bf16 weights from a seed, shot noise) and checks that every
decode-step site launched the decode route and every prefill site the tc
route, times the first batch's prefill and decode steps, and compares
that path with the plain ("tile") backend on the card, beside paths with
a known fault. On the same weights it serves four requests with weight
noise (two at K = 1, two at K = 4) through the weight route, profiles a
forward of each tier and compares the K = 1 prefill logits with the plain
path (``serve_weight``); it then serves a hand-written per-layer precision
profile (``edge4``: K=4 in the first and last four layers, K=1 between),
checks its modelled energy per token against K=1 and K=4, the kernels'
launches by K and its prefill logits against the plain path
(``profile``), and serves 24 requests of mixed budgets over K=1, K=4 and
``edge4`` through continuous batching (per-tier 4-slot decode pools) and
batch-synchronous batches, holding every request's tokens equal bit for
bit across the two, and alone (``continuous``). Then it frees granite's
weights and serves recurrentgemma-2b (griffin: RG-LRU and local
attention, 26 layers, 200 analog sites a forward) at full width and depth
(``serve_griffin``): eight requests through ``ServingEngine`` with every
decode-step site on the decode route and every prefill site on tc, a
request alone against its batch, prefill logits against the plain path;
a 3,000-token prompt whose 2,048-slot rings wrap (``griffin_long``:
prefill against the plain path, and each digital decode step against a
cache-free prefill of the sequence so far); an ``edge`` profile over the
groups and the two tail layers (``griffin_profile``); and the eight
prompts through 4-slot pools against batch-synchronous batches
(``griffin_continuous``). Then the rest of the dense family, one
configuration's weights at a time: granite-20b (GELU with biases, MQA;
``serve_granite20``) and qwen2.5-14b (QKV bias; ``serve_qwen14``) through
the same serve, solo and whole-path checks, launches by route and by site
shape asserted; granite-20b's 12,000-token prompt in a 16,384 bucket
through chunked prefill attention, with its peak memory (``granite20_long``);
qwen2.5-32b at the deepest depth its weights fit beside the reckoned
transients (``qwen32_fit``: a prefill and four decode steps); bert-base's
serve and its energy a token with the GELU sites (``serve_bert``); and
musicgen-large (frames, 4 codebook heads) and internvl2-2b (patch) through
``lm.prefill`` and ``lm.decode_step`` (``frontends``). The kernel checks
hold every route at every site shape of these models too, and each route
gives the same bits twice at its largest shapes (granite-20b's 16,384-row
k/v too). On bert-base's weights it then runs the paper's method
(``calibrate``): the Eq.-14 gradient on the card against the CPU, uniform
and learned ``min_energy_search`` with every accuracy probe through the
kernels, Eq.-14 learning on the "torch" backend, the learned allocation
served; and (``search``) a per-layer repeat profile searched over the 12
layers, saved as JSON, registered as a tier beside K=4 and served, solo
against batched, launches by route, K and site shape. Then the last two
families, one model's weights at a time: xlstm-1.3b at full width and
depth (``serve_xlstm``: the serve, a request alone against its batch, the
whole path kernels against plain block by block (at the logits random
weights make float order alone O(1)), and the eight prompts at K=1 and
K=4 through 4-slot pools against batch-synchronous batches;
``xlstm_long``: a 2,048-token prompt whose chunk scan carries the state
across 4 chunks, its blocks against the plain path and, in float32, each
decode step against a cache-free prefill); grok-1 at 4 of its 64 layers,
full width (``serve_grok``: 12 requests batch-synchronously, the same
batch again, the padding rows' keys and count, and the whole path with
its routing flips counted and the plain path's routing pinned to the
kernels'); and llama4-maverick at 2 of its 48 layers (``llama4_fit``: a
prefill and 4 decode steps over 128 experts). Every phase
that fails raises; each prints its seconds. The last line is ``{"ok":
true, "device": {...}}``; without a CUDA device it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

#: published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM
#: bytes/s, bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12
F32_FLOPS_S = 67e12
#: lanes of an H100 SM a clock (Hopper white paper; spec, not measured) on
#: 132 SMs at the 1.98 GHz boost clock: 64 INT32, 128 FP32 (64 of which also
#: issue IMAD, integer multiply-add) and 16 SFU lanes
SMS, SM_HZ = 132, 1.98e9
INT_LANE_OPS_S = SMS * (64 + 64) * SM_HZ  # integer ops: INT32 lanes + IMAD on FP32 lanes
INT32_LANE_OPS_S = SMS * 64 * SM_HZ
SFU_OPS_S = SMS * 16 * SM_HZ
#: one noise draw (analog_common.cuh counter_gaussian), counted from the
#: source: Threefry-2x32-20 is 72 integer ops (20 rounds of add, rotate and
#: xor; 5 key injections of 2 adds; 2 counter adds); Box-Muller takes 2
#: int -> float conversions, logf, sqrtf and cosf on the SFU lanes (one op
#: each at least) and 5 f32 multiplies or adds. The integer ops bound a draw
#: at 72 / 128 lane-clocks of an SM (2.15 ps on the H100 at 700 W, spec); on
#: the INT32 lanes alone, 72 / 64 (4.3 ps).
DRAW_INT_OPS = 72
DRAW_SFU_OPS = 5
#: kernel vs plain: the reference test's rule (tests/test_kernels.py:47-52)
REL_ATOL = 3e-5
RTOL = 1e-4
#: device vs plain gaussians: the two differ only by float rounding inside
#: Box-Muller (FMA contraction, the last bit of log/cos)
GAUSS_ATOL = 4e-6
#: whole path, kernel vs plain: bf16 activations (8 significant bits) are
#: rounded after every site, so one flipped rounding propagates through 40
#: layers; the bound is on max|dlogit| / max|logit| of the prefill logits.
#: The run also prints what faulty paths give (other seeds, other K, no
#: noise), so a reader sees whether this bound lies below them.
LOGIT_REL_TOL = 5e-2
#: the same bound for recurrentgemma-2b (26 layers, bf16): its plain path
#: disagrees with itself by 3.2-3.8e-2 when only the float order changes
#: (a request alone against the same request in its batch), its digital
#: path by 3.5-4.1e-2, and simt against tc by 4.5e-2 (H100 80GB HBM3, 700 W), so
#: 5e-2 does not part float order from a fault there; 1e-1 does (faulty
#: controls read 0.88-1.14). ``phase_whole_path`` prints that float-order
#: reading beside every check.
GRIFFIN_LOGIT_REL_TOL = 1e-1
SERVE_MAX_GEN = 16
WEIGHT_SERVE_GEN = 4
#: rows a request of the weight-noise serve's prefill (its prompts fit the
#: 32 bucket)
WEIGHT_PREFILL_ROWS = 32
#: the hand-written profile of the profile and continuous phases (not
#: learned: the search is not ported): K=4 at the first and last 4 layers
EDGE4 = (4,) * 4 + (1,) * 32 + (4,) * 4
PROFILE_SERVE_GEN = 8
POOL_SLOTS = 4
#: the griffin serve (recurrentgemma-2b): its edge profile, K=4 at layers
#: 0-2 and 23-25 (both tail layers), K=1 between; the long prompt's length,
#: seq bucket and new tokens
EDGE_GRIFFIN = (4,) * 3 + (1,) * 20 + (4,) * 3
LONG_PROMPT, LONG_BUCKET, LONG_GEN = 3000, 4096, 8
#: granite-20b's long prompt: 12,000 tokens in a 16,384 bucket, 4 new tokens
#: (global attention: one (B, H, T, T) f32 score tensor would be 51.5 GB)
DENSE_LONG_PROMPT, DENSE_LONG_BUCKET, DENSE_LONG_GEN = 12000, 16384, 4
#: qwen2.5-32b's fit: decode steps after the 4 x 64 prefill, and what the
#: reckoning holds back besides the weights: init_params' f32 scratch for the
#: largest leaf drawn whole (the 5120 x 152,064 lm_head, 3.1 GB) and 4 GB for
#: activations, caches and the allocator
FIT_STEPS, FIT_RESERVE_BYTES = 4, 4 * 2**30
#: the frontends phase: rows, and text tokens (frames: frames) after the prefix
FRONTEND_B, FRONTEND_T = 2, 64
#: the calibrate and search phases (bert-base, shot noise): the serve's
#: traffic shape (4 prompts of 64 tokens) and new tokens of their serves;
#: Eq.-14 steps of the learning, of a min_energy_search probe's cold start
#: and of its warm starts (cut from the paper's epoch, so lr 0.05 where
#: Appendix A has 0.01, and the start at the target where the reference
#: takes 8x, which the cut steps would not bring down); bisection steps; noise samples an accuracy probe; the paper's
#: 2 % floor; the noise-free energy whose agreement the floor hangs from,
#: the bisection bracket and the gradient check's energy (aJ/MAC); the
#: gradient check's bound (card vs CPU, on max|g|)
CALIB_B, CALIB_T, CALIB_GEN = 4, 64, 8
CALIB_STEPS, PROBE_STEPS_COLD, PROBE_STEPS_WARM = 24, 12, 6
CALIB_LR, CALIB_INIT_MULT = 0.05, 1.0
SEARCH_ITERS, EVAL_SAMPLES, MAX_DEGRADATION = 4, 2, 0.02
E_CLEAN, SEARCH_LO, SEARCH_HI, GRAD_E = 1e9, 1.0, 1e6, 1e3
GRAD_CHECK_REL = 1e-3
#: xlstm-1.3b's long prompt (one bucket of its length: 4 chunks of 512 carry
#: the recurrent state) and its new tokens
XLSTM_LONG_PROMPT, XLSTM_LONG_GEN = 2048, 4
#: the MoE models' depths: grok-1 at 4 of its 64 layers, llama4-maverick at
#: 2 of its 48 (one dense and one MoE layer); full depth does not fit one card
GROK_LAYERS, LLAMA4_LAYERS = 4, 2
#: grok's serve: 12 prompts of 33..64 tokens at K=1 (3 prefills of 4 x 64)
MOE_REQUESTS = 12
#: decode steps of the MoE pad checks and of the llama4 fit
MOE_STEPS = 4
#: grok's pad-count check: a capacity factor at which no token is dropped
#: and every expert buffer holds more than M_DECODE rows in a 2-row and a
#: 4-row bucket (3 and 6 in decode, 96 and 192 in prefill), so both buckets
#: run every expert site on the tc route. (The no-drop minimum E / top_k =
#: 4 gives the 2-row bucket 2-row decode buffers, which take the decode
#: route: another float order.)
PAD_COUNT_CF = 6.0
PHASES = ("build", "threefry", "kernels", "routes", "site_time", "sweep", "serve",
          "serve_weight", "profile", "continuous", "serve_griffin", "griffin_long",
          "griffin_profile", "griffin_continuous", "serve_granite20", "granite20_long",
          "serve_qwen14", "qwen32_fit", "serve_bert", "calibrate", "search", "frontends",
          "serve_xlstm", "xlstm_long", "serve_grok", "llama4_fit")
#: phases that ``serve`` runs after its own (they share its weights)
SERVE_FOLLOWERS = ("serve_weight", "profile", "continuous")
#: phases that ``serve_griffin`` runs after its own (recurrentgemma's weights)
GRIFFIN_FOLLOWERS = ("griffin_long", "griffin_profile", "griffin_continuous")
#: phases that ``serve_granite20`` runs after its own (granite-20b's weights)
GRANITE20_FOLLOWERS = ("granite20_long",)
#: phases that ``serve_bert`` runs after its own (bert-base's weights); search
#: starts from what calibrate learned
BERT_FOLLOWERS = ("calibrate", "search")
#: phases that ``serve_xlstm`` runs after its own (xlstm-1.3b's weights)
XLSTM_FOLLOWERS = ("xlstm_long",)
SOURCE = {
    "decode": "src/repro_torch/kernels/csrc/analog_decode.cu",
    "tc": "src/repro_torch/kernels/csrc/analog_tc.cu",
    "simt": "src/repro_torch/kernels/csrc/analog_matmul.cu",
    "weight": "src/repro_torch/kernels/csrc/analog_weight.cu",
}
REPLACES = "src/repro/kernels/analog_matmul.py:208"
#: the main paths whose launches each route's entry of the kernels line
#: counts: the serves for decode, tc and weight; simt serves no path since
#: the weight route, so its count is 0 there. ``check_launches`` counts each
#: route's launches in the phases that hold it against the plain version.
DENSE_PATHS = ("serve_granite20", "serve_qwen14", "qwen32_fit", "serve_bert", "frontends")
FAMILY_PATHS = ("serve_xlstm", "xlstm_long", "serve_grok", "llama4_fit")
MAIN_PATHS = {"decode": ("serve", "serve_griffin") + DENSE_PATHS + BERT_FOLLOWERS + FAMILY_PATHS,
              "tc": ("serve", "serve_griffin") + DENSE_PATHS + BERT_FOLLOWERS + FAMILY_PATHS,
              "simt": (), "weight": ("serve_weight",)}
CHECK_PATHS = ("kernels", "routes", "site_time")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int, flush=None) -> float:
    """Median device time of ``fn`` over ``iters`` launches (CUDA events),
    with the L2 cache emptied of the operands before each launch when
    ``flush`` is given: a 256 MB buffer is read (not written, so no dirty
    lines are left for the timed launch to write back)."""
    import torch

    fn()  # warm up
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        if flush is not None:
            flush.sum(dtype=torch.int64)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def _flush_buffer():
    import torch

    return torch.zeros(64 * 2**20, dtype=torch.int32, device="cuda")  # 256 MB > L2


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build() -> None:
    from repro_torch.kernels import analog_matmul as am

    am.build(force=True)
    for r in am.ROUTES:
        am.library(r)
    nvcc = subprocess.run([am.find_nvcc(), "--version"], capture_output=True, text=True)
    keep = ("entry function", "registers", "spill", "stack frame", "Performance")
    ptxas = {r: [l.strip() for l in am.BUILD_LOG[r].splitlines() if any(w in l for w in keep)]
             for r in am.ROUTES}
    log("build", seconds=round(am.BUILD_SECONDS, 3),
        libraries={r: os.path.relpath(p, HERE) for r, p in am.LIBRARIES.items()},
        nvcc=nvcc.stdout.strip().splitlines()[-1], ptxas=ptxas, card=card())


def phase_threefry() -> dict:
    """Device Threefry words bit-exact, and each route's gaussians (zero
    operands, unit scales: the output is the noise itself) against the
    plain ones: a fault in a route's (row, col) mapping moves the noise.
    Then the weight route's draws alone (``weight_draws``) timed at the
    draws of a 2-request decode gate/up call: the measured ceiling of the
    draw rate, ps a draw by K, which the function returns."""
    import numpy as np
    import torch

    from repro_torch.kernels import analog_matmul as am
    from repro_torch.kernels import prng
    from repro_torch.kernels.analog_matmul import analog_matmul_raw

    dev = torch.device("cuda")
    n = 256
    worst = {r: 0.0 for r in am.ROUTES}
    ones = lambda *s: torch.ones(s, device=dev)
    for k0, k1 in ((0, 0), (0x12345678, 0x9ABCDEF0), (0xFFFFFFFF, 7)):
        words = am.threefry_words(k0, k1, 0, 0, (n, n), device=dev)
        rows = torch.arange(n, device=dev, dtype=torch.int64)[:, None]
        cols = torch.arange(n, device=dev, dtype=torch.int64)[None, :]
        w0, w1 = prng.threefry2x32(k0, k1, rows, cols)
        got = words.to(torch.int64) & prng.MASK
        if not (torch.equal(got[..., 0], w0) and torch.equal(got[..., 1], w1)):
            raise AssertionError(f"device Threefry words differ from the plain words for key {(k0, k1)}")
        ref = prng.gaussian_tile(k0, k1, 0, 0, (n, n), device=dev)
        one = np.asarray([[k0, k1, 0, 0]], np.uint32)
        # simt (f32) and tc: one request of n rows
        for route, dtype in (("simt", torch.float32), ("tc", torch.bfloat16)):
            seed = torch.from_numpy(one.view(np.int32)).to(dev)
            xi = analog_matmul_raw(
                torch.zeros((1, n, 16), device=dev, dtype=dtype),
                torch.zeros((16, n), device=dev, dtype=dtype), ones(1, n, 1), ones(1, 1, n),
                ones(3, n), ones(1, 8), seed, noise_kind="output", route=route,
            )[0]
            worst[route] = max(worst[route], float((xi - ref).abs().max()))
        # decode: n requests of one row; request i's seed starts at row i
        table = np.repeat(one, n, axis=0)
        table[:, 2] = np.arange(n, dtype=np.uint32)
        seed = torch.from_numpy(table.view(np.int32)).to(dev)
        xi = analog_matmul_raw(
            torch.zeros((n, 1, 16), device=dev, dtype=torch.bfloat16),
            torch.zeros((16, n), device=dev, dtype=torch.bfloat16), ones(n, 1, 1),
            ones(1, 1, n), ones(3, n), ones(1, 8), seed, noise_kind="output", route="decode",
        )[:, 0]
        worst["decode"] = max(worst["decode"], float((xi - ref).abs().max()))
        # weight (decode kernel): n requests of one row, all on the same
        # seed, request i's row the unit vector e_i over K = n, w = 0, cs = 1:
        # row i of the output is the weight noise of row k = i itself
        seed = torch.from_numpy(np.repeat(one, n, axis=0).view(np.int32)).to(dev)
        eye = torch.eye(n, device=dev, dtype=torch.bfloat16).reshape(n, 1, n)
        xi = analog_matmul_raw(
            eye, torch.zeros((n, n), device=dev, dtype=torch.bfloat16), ones(n, 1, 1),
            ones(1, 1, n), ones(3, n), ones(1, 8), seed, noise_kind="weight", route="weight",
        )[:, 0]
        wref = prng.gaussian_tile(k0 ^ prng.WEIGHT_STREAM_SALT, k1, 0, 0, (n, n), device=dev)
        worst["weight"] = max(worst["weight"], float((xi - wref).abs().max()))
    torch.cuda.synchronize()
    if max(worst.values()) > GAUSS_ATOL:
        raise AssertionError(f"kernel gaussians differ from plain: {worst} > {GAUSS_ATOL}")
    log("threefry", grid=[n, n], keys=3, words="bit-exact", gauss_max_abs_err=worst,
        gauss_atol=GAUSS_ATOL)

    # the draws alone, at the draws of decode gate/up for 2 requests
    k, nn = 2 * 4096, 12800
    ps = {}
    for reps in (1, 4):
        ms = cuda_ms(lambda: am.weight_draws(1, 2, k, nn, reps, device=dev), 10)
        draws = k * nn * reps
        ps[reps] = ms * 1e9 / draws
        log("draw_ceiling", grid=[k, nn], n_repeats=reps, draws=draws, ms=ms, ps_per_draw=ps[reps],
            bound_ps_per_draw=DRAW_INT_OPS / INT_LANE_OPS_S * 1e12,
            int32_only_ps_per_draw=DRAW_INT_OPS / INT32_LANE_OPS_S * 1e12,
            share_of_bound=DRAW_INT_OPS / INT_LANE_OPS_S * 1e12 / ps[reps], card=card())
    return ps


def _site_operands(b, m, k, n, cfg, energy, quant=False, seed=1234, cs_per_request=False):
    """Raw kernel operands for one analog site at (b, m, k) @ (k, n), bf16
    inputs, per-request seeds, optional calibrated quantizers; with
    ``cs_per_request`` request i's col scale is the shared one times 1 +
    i / 4 (a (b, 1, n) col scale, as per-request ranges give)."""
    import torch

    from repro_torch.core.analog import SiteQuant, key_seed
    from repro_torch.kernels import ops, prng
    from repro_torch.quant.affine import QuantParams

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, m, k), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=dev) * k**-0.5).to(torch.bfloat16)
    sq = None
    if quant:
        def minmax(v, dim=None):
            lo = torch.amin(v, dim=dim) if dim is not None else v.min()
            hi = torch.amax(v, dim=dim) if dim is not None else v.max()
            lo = torch.clamp_max(lo.float(), 0.0)
            return QuantParams(lo, torch.maximum(hi.float(), lo + 1e-8))
        y = torch.matmul(x.float(), w.float())
        sq = SiteQuant(wqp=minmax(w, 0), xqp=minmax(x), oqp=minmax(y))
    keys = prng.fold_in(prng.PRNGKey(seed), list(range(b)))
    o = ops.prepare_operands(
        x, w, energy=torch.tensor(energy, device=dev), seed=key_seed(keys, dev), cfg=cfg, sq=sq
    )
    if cs_per_request:
        scale = 1.0 + torch.arange(b, device=dev, dtype=torch.float32).reshape(b, 1, 1) / 4
        o["col_scale"] = (o["col_scale"] * scale).contiguous()
    return o, sq


def _run_raw(raw, o, n_repeats, **kw):
    return raw(
        o["x"], o["w"], o["row_scale"], o["col_scale"], o["wq"], o["scalars"], o["seed"],
        noise_kind=o["noise_kind"], quant_x=o["quant_x"], quant_w=o["quant_w"],
        quant_out=o["quant_out"], n_repeats=n_repeats, **kw,
    )


def _route_of(o):
    from repro_torch.kernels.analog_matmul import select_route

    b, m, k = o["x"].shape
    return select_route(b, m, k, o["w"].shape[1], o["x"].dtype, o["noise_kind"],
                        o["quant_x"], o["quant_w"], o["quant_out"])


def _draws(o, n_repeats):
    """Noise draws of one raw call: each output for output noise, each
    weight of each request for weight noise, times the repeats."""
    b, m, k = o["x"].shape
    n = o["w"].shape[1]
    return {"output": b * m * n, "weight": b * k * n, "none": 0}[o["noise_kind"]] * n_repeats


def _bound(o, n_repeats):
    """Least time of one raw call on the card, ``(ms, by, detail)``.

    The larger of the bytes (each input read once, the f32 output written
    once, over the HBM rate) and the operations, the busiest of: the
    product's FLOPs at the peak for its operands (bf16 x bf16 on the tensor
    cores, twice for noisy weights, which take two bf16 parts; f32 operands
    at the f32 SIMT rate) and the noise draws this call needs on the integer
    lanes and on the SFU lanes. ``detail`` holds each term in ms, the
    draws' on the INT32 lanes alone (``int32_only``) and the bound with the
    product at the f32 SIMT rate (``f32_simt``).
    """
    import torch

    b, m, k = o["x"].shape
    n = o["w"].shape[1]
    n_bytes = sum(o[t].numel() * o[t].element_size()
                  for t in ("x", "w", "row_scale", "col_scale", "wq", "scalars", "seed"))
    n_bytes += b * m * n * 4
    flops = 2.0 * b * m * k * n
    draws = _draws(o, n_repeats)
    if o["x"].dtype == torch.bfloat16:
        product = flops * (2 if o["noise_kind"] == "weight" else 1) / BF16_FLOPS_S
    else:
        product = flops / F32_FLOPS_S
    terms = dict(bytes=n_bytes / HBM_BYTES_S, product=product,
                 draws_int=draws * DRAW_INT_OPS / INT_LANE_OPS_S,
                 draws_sfu=draws * DRAW_SFU_OPS / SFU_OPS_S)
    ops_s = max(v for t, v in terms.items() if t != "bytes")
    detail = {t: v * 1e3 for t, v in terms.items()}
    detail["int32_only"] = draws * DRAW_INT_OPS / INT32_LANE_OPS_S * 1e3
    detail["f32_simt"] = max(terms["bytes"], flops / F32_FLOPS_S, terms["draws_int"]) * 1e3
    by = "bytes" if terms["bytes"] >= ops_s else "operations"
    return max(terms["bytes"], ops_s) * 1e3, by, detail


def _close(yk, yr, o, sq):
    """(max |err|, atol, ok) under the reference's rule."""
    import torch

    scale = float(yr.abs().max()) + 1e-6
    atol = REL_ATOL * scale
    if o["quant_out"]:
        atol = max(atol, float(sq.oqp.delta) * 1.01)
    err = (yk - yr).abs()
    ok = bool((err <= atol + RTOL * yr.abs()).all()) and bool(torch.isfinite(yk).all())
    return float(err.max()), atol, ok


def _cases():
    """(name, (b, m, k, n), cfg, energy, quant, n_repeats, route, cs per
    request) of the kernel-vs-plain phase: every route at main-path shapes
    and at a ragged shape, K = 1 and 4, with output requant. ``route`` None
    takes "auto"."""
    from repro_torch.core.analog import AnalogConfig

    shot, none = AnalogConfig.shot(), AnalogConfig(mode="analog")
    thermal_q = AnalogConfig.thermal(0.01)  # quant_x, quant_w and quant_out
    requant = AnalogConfig.thermal(0.01, weight_bits=None, act_bits=None)  # quant_out only
    weight = AnalogConfig.weight(0.1)  # with quant: quant_x, quant_w and quant_out
    weight_rq = AnalogConfig.weight(0.1, weight_bits=None, act_bits=None)  # quant_out only
    gate, down, kv = (4096, 12800), (12800, 4096), (4096, 1024)
    cases = [
        # decode route: main-path shapes, then the ragged shape
        ("shot K=1 decode gate/up", (4, 1, *gate), shot, 20.0, False, 1, None),
        ("shot K=4 decode gate/up", (4, 1, *gate), shot, 20.0, False, 4, None),
        ("shot K=1 decode down", (4, 1, *down), shot, 20.0, False, 1, None),
        ("requant K=4 decode k/v", (4, 1, *kv), requant, 4.0, True, 4, None),
        ("thermal+quant K=1 decode k/v", (4, 1, *kv), thermal_q, 4.0, True, 1, None),
        ("shot K=1 decode ragged", (3, 1, 4000, 1000), shot, 20.0, False, 1, None),
        ("requant K=4 decode ragged", (3, 1, 4000, 1000), requant, 4.0, True, 4, None),
        # tc route
        ("shot K=1 prefill gate/up", (4, 64, *gate), shot, 20.0, False, 1, None),
        ("shot K=4 prefill gate/up", (4, 64, *gate), shot, 20.0, False, 4, None),
        ("shot K=1 prefill down", (4, 64, *down), shot, 20.0, False, 1, None),
        ("requant K=4 prefill k/v", (4, 64, *kv), requant, 4.0, True, 4, None),
        ("none prefill k/v", (4, 64, *kv), none, 1.0, False, 1, None),
        ("shot K=1 tc ragged", (3, 40, 4000, 1000), shot, 20.0, False, 1, None),
        ("requant K=4 tc ragged", (3, 40, 4000, 1000), requant, 4.0, True, 4, None),
        # simt route: quantized prefill, and the others forced
        ("thermal+quant K=1 prefill k/v", (4, 64, *kv), thermal_q, 4.0, True, 1, None),
        ("weight K=4 simt prefill k/v", (4, 64, *kv), weight, 5.0, False, 4, "simt"),
        ("weight K=1 simt decode gate/up", (2, 1, *gate), weight, 5.0, False, 1, "simt"),
        ("shot K=1 simt prefill gate/up", (4, 64, *gate), shot, 20.0, False, 1, "simt"),
        ("weight K=4 simt ragged", (3, 40, 4000, 1000), weight, 5.0, False, 4, "simt"),
        ("requant K=1 simt ragged", (3, 40, 4000, 1000), requant, 4.0, True, 1, "simt"),
        ("weight+quant K=1 prefill k/v", (2, 32, *kv), weight, 5.0, True, 1, None),
        # weight route: the weight-noise serve's shapes (2 requests, M = 1
        # and 32), gate/up, down and k/v, K = 1 and 4, requant, the ragged
        # shape, two row tiles, col scales per request
        ("weight K=1 decode gate/up", (2, 1, *gate), weight, 5.0, False, 1, None),
        ("weight K=4 decode gate/up", (2, 1, *gate), weight, 5.0, False, 4, None),
        ("weight K=1 decode down", (2, 1, *down), weight, 5.0, False, 1, None),
        ("weight K=4 decode k/v", (2, 1, *kv), weight, 5.0, False, 4, None),
        ("weight+requant K=4 decode k/v", (2, 1, *kv), weight_rq, 5.0, True, 4, None),
        ("weight+quant K=1 decode k/v", (2, 1, *kv), weight, 5.0, True, 1, None),
        ("weight K=1 prefill gate/up", (2, 32, *gate), weight, 5.0, False, 1, None),
        ("weight K=4 prefill down", (2, 32, *down), weight, 5.0, False, 4, None),
        ("weight K=1 prefill k/v", (2, 64, *kv), weight, 5.0, False, 1, None),
        ("weight+requant K=4 prefill k/v", (2, 32, *kv), weight_rq, 5.0, True, 4, None),
        ("weight K=1 decode ragged", (3, 1, 4000, 1000), weight, 5.0, False, 1, None),
        ("weight+requant K=4 prefill ragged", (3, 40, 4000, 1000), weight_rq, 5.0, True, 4, None),
        ("weight K=1 prefill 2 row tiles", (2, 100, 4000, 1000), weight, 5.0, False, 1, None),
    ]
    # recurrentgemma-2b's site shapes: k/v 2560 -> 256 (two column tiles of
    # tc), q/o and the recurrent matrices 2560 -> 2560, gate/up, down; the
    # long prompt's prefill (one request of 4,096 rows)
    for stage, m in (("decode", 1), ("prefill", 64)):
        for site, k, n in GRIFFIN_SITES:
            for reps in (1, 4) if site != "down" else (1,):
                cases.append((f"griffin shot K={reps} {stage} {site}", (4, m, k, n), shot, 20.0,
                              False, reps, None))
        cases.append((f"griffin requant K=4 {stage} k/v", (4, m, 2560, 256), requant, 4.0, True,
                      4, None))
    cases.append(("griffin shot K=1 long prefill k/v", (1, LONG_BUCKET, 2560, 256), shot, 20.0,
                  False, 1, None))
    # the rest of the dense family's site shapes (DENSE_SITES), decode and a
    # 64-row prefill, K = 1 and 4; granite-20b's MQA k/v (N = 128, one tc
    # column tile) under requant too, and at its long prompt's 16,384 rows
    for model, sites in DENSE_SITES.items():
        for stage, m in (("decode", 1), ("prefill", 64)):
            for site, k, n in sites:
                for reps in (1, 4):
                    cases.append((f"{model} shot K={reps} {stage} {site}", (4, m, k, n), shot,
                                  20.0, False, reps, None))
    for stage, m in (("decode", 1), ("prefill", 64)):
        cases.append((f"granite-20b requant K=4 {stage} k/v", (4, m, 6144, 128), requant, 4.0,
                      True, 4, None))
    cases.append(("granite-20b shot K=1 long prefill k/v", (1, DENSE_LONG_BUCKET, 6144, 128),
                  shot, 20.0, False, 1, None))
    # the expert sites: one request of the capacity rows, K = 1 and 4
    for model, (sites, rows) in EXPERT_SITES.items():
        for stage, m in rows.items():
            for site, k, n in sites:
                for reps in (1, 4):
                    cases.append((f"{model} expert shot K={reps} {stage} {site}", (1, m, k, n),
                                  shot, 20.0, False, reps, None))
    per_request = [
        ("weight K=4 decode gate/up, cs per request", (2, 1, *gate), weight, 5.0, False, 4, None),
        ("weight K=1 prefill k/v, cs per request", (2, 32, *kv), weight, 5.0, False, 1, None),
    ]
    return [c + (False,) for c in cases] + [c + (True,) for c in per_request]


#: the case that stands for each route in the kernels line: the main path's
#: shape of that route (simt: the weight-noise serve's decode shape, which
#: it took until the weight route)
HEADLINE = {"decode": "shot K=1 decode gate/up", "tc": "shot K=1 prefill gate/up",
            "simt": "weight K=1 simt decode gate/up", "weight": "weight K=1 decode gate/up"}


def phase_kernels() -> dict:
    """Each route vs plain; returns the headline entries of the kernels line."""
    import torch

    from repro_torch.kernels import analog_matmul as am
    from repro_torch.kernels.analog_matmul import analog_matmul_raw
    from repro_torch.kernels.ref import analog_matmul_ref_raw

    flush = _flush_buffer()
    seen = {r: 0 for r in am.ROUTES}
    entries = {}
    for name, (b, m, k, n), cfg, energy, quant, reps, route, cs_req in _cases():
        o, sq = _site_operands(b, m, k, n, cfg, energy, quant, cs_per_request=cs_req)
        taken = route or _route_of(o)
        before = dict(am.LAUNCHES)
        yk = _run_raw(analog_matmul_raw, o, reps, route=route or "auto")
        launched = [r for r in am.ROUTES if am.LAUNCHES[r] != before[r]]
        yr = _run_raw(analog_matmul_ref_raw, o, reps)
        torch.cuda.synchronize()
        err, atol, ok = _close(yk, yr, o, sq)
        log("kernel_vs_plain", case=name, route=taken, launched=launched, shape=[b, m, k, n],
            n_repeats=reps, quant=[o["quant_x"], o["quant_w"], o["quant_out"]],
            cs_per_request=tuple(o["col_scale"].shape) == (b, 1, n) and b > 1,
            max_abs_err=err, atol=atol, rtol=RTOL, ok=ok)
        if not ok or launched != [taken]:
            raise AssertionError(f"{name}: route {taken} (launched {launched}) disagrees with plain")
        seen[taken] += 1
        if HEADLINE.get(taken) == name:
            bound, by, detail = _bound(o, reps)
            entries[taken] = dict(
                name=f"analog_matmul.{taken}", route="cuda", source=SOURCE[taken],
                replaces=REPLACES, launches=None, max_abs_err=err,
                ms=cuda_ms(lambda: _run_raw(analog_matmul_raw, o, reps, route=taken), 10, flush),
                plain_ms=cuda_ms(lambda: _run_raw(analog_matmul_ref_raw, o, reps), 3, flush),
                bound_ms=bound, bound_by=by, library_ms=None, shape=[b, m, k, n],
                noise=o["noise_kind"], n_repeats=reps, bound_terms_ms=detail,
            )
    if min(seen.values()) == 0 or set(entries) != set(am.ROUTES):
        raise AssertionError(f"a route was not checked: {seen}")
    return entries


def _repeat_cases():
    """(route, (b, m, k, n), cfg, energy, n_repeats) of each route's largest
    site shapes: decode and tc at qwen2.5-32b's gate/up and down, tc at
    granite-20b's long-prompt k/v, weight at granite-3-8b's gate/up and
    down, simt at granite-3-8b's gate/up; grok-1's expert down (prefill,
    tc) and gate/up (decode)."""
    from repro_torch.core.analog import AnalogConfig

    shot, weight = AnalogConfig.shot(), AnalogConfig.weight(0.1)
    return [
        ("decode", (4, 1, 5120, 27648), shot, 20.0, 1),
        ("decode", (4, 1, 27648, 5120), shot, 20.0, 4),
        ("tc", (4, 64, 5120, 27648), shot, 20.0, 1),
        ("tc", (4, 64, 27648, 5120), shot, 20.0, 4),
        ("tc", (1, DENSE_LONG_BUCKET, 6144, 128), shot, 20.0, 1),
        ("weight", (2, 1, 4096, 12800), weight, 5.0, 4),
        ("weight", (2, 32, 12800, 4096), weight, 5.0, 1),
        ("simt", (4, 64, 4096, 12800), weight, 5.0, 1),
        ("tc", (1, 80, 16384, 6144), shot, 20.0, 1),
        ("decode", (1, 2, 6144, 16384), shot, 20.0, 4),
    ]


def phase_routes() -> None:
    """Each route: a request's rows are the same bits alone (B = 1) as in a
    batch, and two launches on the same inputs give the same bits, at each
    route's largest site shapes too (``_repeat_cases``)."""
    import torch

    from repro_torch.core.analog import AnalogConfig
    from repro_torch.kernels.analog_matmul import analog_matmul_raw

    shot = AnalogConfig.shot()
    requant = AnalogConfig.thermal(0.01, weight_bits=None, act_bits=None)
    weight = AnalogConfig.weight(0.1)
    weight_rq = AnalogConfig.weight(0.1, weight_bits=None, act_bits=None)
    cases = [
        ("decode", (4, 1, 4096, 12800), shot, 20.0, False, 1, False),
        ("decode", (3, 1, 4000, 1000), requant, 4.0, True, 4, False),
        ("tc", (4, 64, 4096, 12800), shot, 20.0, False, 1, False),
        ("tc", (3, 40, 4000, 1000), requant, 4.0, True, 4, False),
        ("simt", (4, 64, 4096, 1024), weight, 5.0, False, 4, False),
        ("simt", (3, 40, 4000, 1000), requant, 4.0, True, 1, False),
        ("weight", (2, 1, 4096, 12800), weight, 5.0, False, 1, False),
        ("weight", (3, 1, 4000, 1000), weight_rq, 5.0, True, 4, False),
        ("weight", (3, 1, 4096, 1024), weight, 5.0, False, 1, True),
        ("weight", (2, 32, 4096, 1024), weight, 5.0, False, 4, False),
        ("weight", (3, 40, 4000, 1000), weight_rq, 5.0, True, 1, False),
        ("weight", (3, 32, 12800, 4096), weight, 5.0, False, 1, True),
        ("decode", (4, 1, 2560, 256), shot, 20.0, False, 4, False),
        ("tc", (4, 64, 2560, 256), shot, 20.0, False, 1, False),
        ("decode", (4, 1, 6144, 128), shot, 20.0, False, 4, False),
        ("tc", (4, 64, 6144, 128), shot, 20.0, False, 1, False),
        ("decode", (4, 1, 768, 3072), shot, 20.0, False, 1, False),
        ("tc", (4, 64, 3072, 768), shot, 20.0, False, 4, False),
    ]
    for route, (b, m, k, n), cfg, energy, quant, reps, cs_req in cases:
        o, _ = _site_operands(b, m, k, n, cfg, energy, quant, seed=77, cs_per_request=cs_req)
        batched = _run_raw(analog_matmul_raw, o, reps, route=route)
        again = _run_raw(analog_matmul_raw, o, reps, route=route)
        solo_equal = []
        for i in range(b):
            solo = dict(o)
            for t in ("x", "row_scale", "seed"):
                solo[t] = o[t][i:i + 1].contiguous()
            if o["col_scale"].shape[0] == b:
                solo["col_scale"] = o["col_scale"][i:i + 1].contiguous()
            y = _run_raw(analog_matmul_raw, solo, reps, route=route)
            solo_equal.append(bool(torch.equal(y[0], batched[i])))
        deterministic = bool(torch.equal(batched, again))
        log("routes", route=route, shape=[b, m, k, n], noise=o["noise_kind"], n_repeats=reps,
            quant_out=o["quant_out"], cs_per_request=cs_req, solo_equals_batched=solo_equal,
            deterministic=deterministic)
        if not (all(solo_equal) and deterministic):
            raise AssertionError(f"route {route} at {(b, m, k, n)}: solo {solo_equal}, "
                                 f"deterministic {deterministic}")
    # each route twice on the same operands at its largest site shape, tc at
    # granite-20b's 16,384-row long-prompt k/v too; the plain version there
    # beside it (the long prompt's logits moved between two runs of one tree)
    from repro_torch.kernels.ref import analog_matmul_ref_raw

    for route, (b, m, k, n), cfg, energy, reps in _repeat_cases():
        o, _ = _site_operands(b, m, k, n, cfg, energy, seed=78)
        first = _run_raw(analog_matmul_raw, o, reps, route=route)
        again = _run_raw(analog_matmul_raw, o, reps, route=route)
        equal = bool(torch.equal(first, again))
        plain_equal = None
        if (b, m) == (1, DENSE_LONG_BUCKET):
            plain_equal = bool(torch.equal(_run_raw(analog_matmul_ref_raw, o, reps),
                                           _run_raw(analog_matmul_ref_raw, o, reps)))
        log("routes_repeat", route=route, shape=[b, m, k, n], noise=o["noise_kind"],
            n_repeats=reps, equal_bits=equal, plain_equal_bits=plain_equal)
        if not equal:
            raise AssertionError(f"route {route} at {(b, m, k, n)}: two launches differ")


SITES = [("q/o", 4096, 4096), ("k/v", 4096, 1024), ("gate/up", 4096, 12800), ("down", 12800, 4096)]
#: recurrentgemma-2b's site shapes; "2560x2560" is q/o and the recurrent
#: block's gate, in, a, i and out
GRIFFIN_SITES = [("2560x2560", 2560, 2560), ("k/v", 2560, 256), ("gate/up", 2560, 7680),
                 ("down", 7680, 2560)]
#: the site shapes of the rest of the dense family: granite-20b (GELU in/out,
#: MQA k/v of one 128-wide head), qwen2.5-14b (GQA 40/8), qwen2.5-32b's MLP,
#: bert-base, musicgen-large (q/k/v/o, in, out) and internvl2-2b's k/v (its
#: other shapes are musicgen's)
DENSE_SITES = {
    "granite-20b": [("q/o", 6144, 6144), ("k/v", 6144, 128), ("in", 6144, 24576),
                    ("out", 24576, 6144)],
    "qwen2.5-14b": [("q/o", 5120, 5120), ("k/v", 5120, 1024), ("gate/up", 5120, 13824),
                    ("down", 13824, 5120)],
    "qwen2.5-32b": [("gate/up", 5120, 27648), ("down", 27648, 5120)],
    "bert-base": [("q/k/v/o", 768, 768), ("in", 768, 3072), ("out", 3072, 768)],
    "musicgen-large": [("q/k/v/o", 2048, 2048), ("in", 2048, 8192), ("out", 8192, 2048)],
    "internvl2-2b": [("k/v", 2048, 1024)],
    "xlstm-1.3b": [("2048x2048", 2048, 2048), ("wx", 2048, 8192)],
    "grok-1-314b": [("q/o", 6144, 6144), ("k/v", 6144, 1024), ("router", 6144, 8)],
    "llama4-maverick-400b-a17b": [("q/o", 5120, 5120), ("router", 5120, 128),
                                  ("gate/up", 5120, 8192), ("down", 8192, 5120)],
}
#: the MoE expert sites: each expert's buffer is one key's rows, (1, G*C, K)
#: @ (K, N), G*C the capacity rows of a 4 x 64 prefill and of a 4-row decode
#: step at the config's capacity factor (grok: 16 virtual experts of 16,384;
#: llama4: 128 experts of 8,192)
EXPERT_SITES = {
    "grok-1-314b": ([("gate/up", 6144, 16384), ("down", 16384, 6144)], {"prefill": 80, "decode": 2}),
    "llama4-maverick-400b-a17b": ([("gate/up", 5120, 8192), ("down", 8192, 5120)],
                                  {"prefill": 3, "decode": 1}),
}


def phase_site_time(draw_ps=None) -> list:
    """The chosen route and the simt route, in turns, at every analog site
    shape of granite-3-8b, recurrentgemma-2b, the rest of the dense family,
    xlstm-1.3b and the MoE models' non-expert sites (``DENSE_SITES``): 4
    requests, shot noise, K = 1; and the MoE expert sites at their capacity
    rows (``EXPERT_SITES``, one request); beside the bound,
    the plain version, the bare product and the route without its noise
    (what the output noise costs inside the kernel); then the weight route
    at the weight-noise serve's shapes (2 requests, M = 1 and 32), K = 1
    and 4, beside its bound, the draws' bound on the INT32 lanes alone, the
    measured draw ceiling (``draw_ps``, ps a draw by K, from the threefry
    phase) and the plain version. Raises where a route is slower than
    simt."""
    import torch

    from repro_torch.core.analog import AnalogConfig
    from repro_torch.kernels.analog_matmul import analog_matmul_raw
    from repro_torch.kernels.ref import analog_matmul_ref_raw

    flush = _flush_buffer()
    shot = AnalogConfig.shot()
    rows = []

    def turns(o, reps, route):
        run = lambda r: (lambda: _run_raw(analog_matmul_raw, o, reps, route=r))
        t = [cuda_ms(run(route), 10, flush), cuda_ms(run("simt"), 10, flush),
             cuda_ms(run("simt"), 10, flush), cuda_ms(run(route), 10, flush)]
        return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t

    for model, sites in (("granite-3-8b", SITES), ("recurrentgemma-2b", GRIFFIN_SITES),
                         *DENSE_SITES.items()):
        for stage, m in (("prefill", 64), ("decode", 1)):
            for site, k, n in sites:
                o, _ = _site_operands(4, m, k, n, shot, 20.0)
                route = _route_of(o)
                bound, by, detail = _bound(o, 1)
                ms, simt_ms, t = turns(o, 1, route)
                quiet = dict(o, noise_kind="none")
                row = dict(
                    model=model, site=site, stage=stage, shape=[4, m, k, n], noise="output",
                    n_repeats=1, route=route, ms=ms, simt_ms=simt_ms, turns_ms=t,
                    share_of_bound=bound / ms,
                    no_noise_ms=cuda_ms(lambda: _run_raw(analog_matmul_raw, quiet, 1, route=route),
                                        10, flush),
                    plain_ms=cuda_ms(lambda: _run_raw(analog_matmul_ref_raw, o, 1), 3, flush),
                    matmul_only_ms=cuda_ms(lambda: torch.matmul(o["x"], o["w"]), 10, flush),
                    bound_ms=bound, bound_by=by, f32_simt_bound_ms=detail["f32_simt"],
                )
                rows.append(row)
                log("site_time", **row, card=card())
                # granite's sites hold the route choice; recurrentgemma's are
                # logged (a slower route there is a finding, not hidden)
                if ms > simt_ms and model == "granite-3-8b":
                    raise AssertionError(
                        f"{stage} {site}: route {route} {ms} ms > simt {simt_ms} ms")
    for model, (sites, m_rows) in EXPERT_SITES.items():
        for stage, m in m_rows.items():
            for site, k, n in sites:
                o, _ = _site_operands(1, m, k, n, shot, 20.0)
                route = _route_of(o)
                bound, by, detail = _bound(o, 1)
                ms, simt_ms, t = turns(o, 1, route)
                row = dict(
                    model=model, site=f"expert {site}", stage=stage, shape=[1, m, k, n],
                    noise="output", n_repeats=1, route=route, ms=ms, simt_ms=simt_ms, turns_ms=t,
                    share_of_bound=bound / ms,
                    plain_ms=cuda_ms(lambda: _run_raw(analog_matmul_ref_raw, o, 1), 3, flush),
                    matmul_only_ms=cuda_ms(lambda: torch.matmul(o["x"], o["w"]), 10, flush),
                    bound_ms=bound, bound_by=by, f32_simt_bound_ms=detail["f32_simt"],
                )
                rows.append(row)
                log("site_time", **row, card=card())
    weight = AnalogConfig.weight(0.1)
    for stage, m in (("prefill", WEIGHT_PREFILL_ROWS), ("decode", 1)):
        for site, k, n in SITES:
            for reps in (1, 4):
                o, _ = _site_operands(2, m, k, n, weight, 5.0)
                route = _route_of(o)
                bound, by, detail = _bound(o, reps)
                ms, simt_ms, t = turns(o, reps, route)
                ceiling = None if draw_ps is None else _draws(o, reps) * draw_ps[reps] * 1e-9
                row = dict(
                    site=site, stage=stage, shape=[2, m, k, n], noise="weight", n_repeats=reps,
                    route=route, ms=ms, simt_ms=simt_ms, turns_ms=t, share_of_bound=bound / ms,
                    plain_ms=cuda_ms(lambda: _run_raw(analog_matmul_ref_raw, o, reps), 3, flush),
                    bound_ms=bound, bound_by=by, int32_only_bound_ms=detail["int32_only"],
                    draw_ceiling_ms=ceiling, bound_terms_ms=detail,
                )
                rows.append(row)
                log("site_time", **row, card=card())
                if route != "weight" or ms > simt_ms:
                    raise AssertionError(f"weight noise {stage} {site} K={reps}: route {route} "
                                         f"{ms} ms, simt {simt_ms} ms")
    return rows


def phase_sweep() -> None:
    """decode and tc routes at gate/up (4 requests, shot, K = 1) over the
    per-request row count M: where the decode route stops winning places
    M_DECODE."""
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.kernels import analog_matmul as am
    from repro_torch.kernels.analog_matmul import analog_matmul_raw

    flush = _flush_buffer()
    rows = []
    for m in (1, 2, 4, 16, 32):
        o, _ = _site_operands(4, m, 4096, 12800, AnalogConfig.shot(), 20.0)
        t = {r: cuda_ms(lambda: _run_raw(analog_matmul_raw, o, 1, route=r), 10, flush)
             for r in ("decode", "tc")}
        t["tc_again"] = cuda_ms(lambda: _run_raw(analog_matmul_raw, o, 1, route="tc"), 10, flush)
        t["decode_again"] = cuda_ms(
            lambda: _run_raw(analog_matmul_raw, o, 1, route="decode"), 10, flush)
        dec, tc = (t["decode"] + t["decode_again"]) / 2, (t["tc"] + t["tc_again"]) / 2
        rows.append(dict(m=m, decode_ms=dec, tc_ms=tc, faster="decode" if dec < tc else "tc",
                         chosen=_route_of(o)))
        log("sweep", shape=[4, m, 4096, 12800], decode_ms=dec, tc_ms=tc, turns_ms=t,
            faster=rows[-1]["faster"], chosen=rows[-1]["chosen"], card=card())
    agrees = all(r["faster"] == r["chosen"] for r in rows)
    log("m_decode", m_decode=am.M_DECODE, sweep_agrees=agrees,
        decode_wins_at=[r["m"] for r in rows if r["faster"] == "decode"])


def _traffic(cfg):
    import numpy as np

    rng = np.random.default_rng(0)
    lengths = rng.integers(8, 61, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32) for n in lengths]
    tiers = [1, 1, 1, 1, 4, 4, 4, 4]
    return prompts, tiers


def _zero_launches():
    from repro_torch.kernels import analog_matmul as am

    for r in am.ROUTES:
        am.LAUNCHES[r] = 0
    am.LAUNCHES_BY_K.clear()
    am.LAUNCHES_BY_SHAPE.clear()


def _drain(engine):
    """``engine.flush()`` in one window, launches counted from zero."""
    import torch

    from repro_torch.kernels import analog_matmul as am

    torch.cuda.synchronize()
    _zero_launches()
    t = time.perf_counter()
    results = engine.flush()
    torch.cuda.synchronize()
    return results, time.perf_counter() - t, dict(am.LAUNCHES)


def phase_weights(CONFIG=None):
    """A configuration's random weights (seed 0) and energies on the card
    (granite-3-8b unless ``CONFIG`` says otherwise); returns
    ``make_engine(backend, analog=None, **engine_kw)`` over them."""
    import torch

    from repro_torch.core.analog import AnalogConfig
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServingEngine

    if CONFIG is None:
        from repro_torch.configs.granite_3_8b import CONFIG
    t0 = time.perf_counter()
    params = lm.init_params(CONFIG, seed=0, device="cuda")
    energies = lm.init_energy_tree(CONFIG, 20.0, device="cuda")
    torch.cuda.synchronize()
    log("weights", config=CONFIG.name, params=CONFIG.param_count(),
        gib=round(torch.cuda.memory_allocated() / 2**30, 3),
        seconds=round(time.perf_counter() - t0, 3), card=card())

    def make_engine(backend, analog=None, **kw):
        """An engine over the same weights; ``backend=None`` is digital."""
        if backend is not None and analog is None:
            analog = AnalogConfig.shot(backend=backend)
        opts = dict(max_gen=SERVE_MAX_GEN, batch_buckets=(1, 2, 4), seq_buckets=(32, 64))
        opts.update(kw)
        return ServingEngine(
            params, CONFIG, analog_cfg=analog, energies=None if analog is None else energies,
            device="cuda", **opts,
        )

    make_engine.params, make_engine.energies = params, energies
    return make_engine


def site_launches(cfg) -> dict:
    """Kernel launches of each analog site of a group in one forward: m for
    an mLSTM site (the group's m blocks), E * split for an expert site (one
    a virtual expert), 1 otherwise."""
    from repro_torch.models import lm

    return {s: (suf[0] if suf else 1) for s, suf in lm.group_sites(cfg).items()}


def forward_sites(cfg) -> int:
    """Kernel launches of one forward's analog sites: every group's and
    every tail layer's."""
    from repro_torch.models import lm

    return (sum(site_launches(cfg).values()) * lm.group_structure(cfg)[0]
            + len(lm.TAIL_SITES) * lm.n_tail(cfg))


def layer_sites(cfg) -> list:
    """Kernel launches of the analog sites of each model layer, in layer
    order."""
    from repro_torch.models import lm

    g, per = lm.group_structure(cfg)
    counts = [0] * per
    for site, sub in lm.group_site_subs(cfg).items():
        if sub == "stack":  # one launch for each of the m mLSTM blocks
            for j in range(per - 1):
                counts[j] += 1
        else:
            counts[sub] += site_launches(cfg)[site]
    return counts * g + [len(lm.TAIL_SITES)] * lm.n_tail(cfg)


#: an analog site's suffix -> its weight leaf
_LEAF_OF = {"q": "wq", "k": "wk", "v": "wv", "o": "wo", "gate": "w_gate", "up": "w_up",
            "in": "w_in", "out": "w_down", "rec_gate": "w_gate", "rec_in": "w_x", "rec_a": "w_a",
            "rec_i": "w_i", "rec_out": "w_out"}
#: the xlstm and MoE sites' weight leaves (under ``blocks``)
_FAMILY_LEAF = {"mlstm_z": ("mlstm", "w_z"), "mlstm_q": ("mlstm", "w_q"),
                "mlstm_k": ("mlstm", "w_k"), "mlstm_v": ("mlstm", "w_v"),
                "mlstm_o": ("mlstm", "w_o"), "slstm_wx": ("slstm", "w_x"),
                "slstm_o": ("slstm", "w_o"), "router": ("moe", "router"),
                "moe_gate": ("moe", "w_gate"), "moe_up": ("moe", "w_up"),
                "moe_in": ("moe", "w_in"), "moe_down": ("moe", "w_down"),
                "moe_shared_gate": ("moe", "shared", "w_gate"),
                "moe_shared_up": ("moe", "shared", "w_up"),
                "moe_shared_out": ("moe", "shared", "w_down")}


def forward_shapes(cfg) -> dict:
    """(K, N) of every analog site launch of one forward -> its count, from
    the weight leaves the sites read."""
    from repro_torch.models import lm

    leaves = lm.param_leaves(cfg)
    count = {}

    def add(leaf, times):
        kn = tuple(leaf.shape[-2:])
        count[kn] = count.get(kn, 0) + times

    g = lm.group_structure(cfg)[0]
    for site, n in site_launches(cfg).items():
        if site in _FAMILY_LEAF:
            leaf = leaves["blocks"]
            for part in _FAMILY_LEAF[site]:
                leaf = leaf[part]
        else:
            sub, kind = site.split("_", 1)
            leaf = leaves["blocks"][sub][_LEAF_OF[kind]]
        add(leaf, g * n)
    for site in lm.TAIL_SITES if lm.n_tail(cfg) else ():
        sub, kind = site.split("_", 1)
        add(leaves["tail"]["rec" if sub.startswith("rec") else "mlp"][_LEAF_OF[kind]],
            lm.n_tail(cfg))
    return count


def phase_serve(make_engine, prompts, tiers, CONFIG=None):
    """Eight requests through ``ServingEngine`` (granite-3-8b unless
    ``CONFIG`` says otherwise): every decode-step site launches the decode
    route, every prefill site the tc route, each site shape as often as
    the forwards run it."""
    import torch

    from repro_torch.kernels import analog_matmul as am

    if CONFIG is None:
        from repro_torch.configs.granite_3_8b import CONFIG
    engine = make_engine("auto")
    for p, k in zip(prompts, tiers):
        engine.submit(p, n_repeats=k, max_new_tokens=SERVE_MAX_GEN)

    # one window around the whole drain: the engine's own steps, no added syncs
    results, flush_s, launches = _drain(engine)

    by_shape = {f"{r}:{k}x{n}": c for (r, k, n), c in sorted(am.LAUNCHES_BY_SHAPE.items())}
    st = engine.stats
    forwards = st["batches"] + st["decode_steps"]
    sites = forward_sites(CONFIG)
    for uid in sorted(results):
        toks = results[uid]
        if len(toks) != SERVE_MAX_GEN or toks.min() < 0 or toks.max() >= CONFIG.vocab_size:
            raise AssertionError(f"request {uid}: bad tokens {toks}")
        log("request", uid=uid, tier=tiers[uid], prompt_len=len(prompts[uid]), tokens=toks.tolist())
    if len(results) != len(prompts):
        raise AssertionError(f"served {len(results)} of {len(prompts)} requests")
    expected = {"decode": sites * st["decode_steps"], "tc": sites * st["batches"], "simt": 0,
                "weight": 0}
    if launches != expected:
        raise AssertionError(f"launches by route {launches} != {expected} "
                             f"({sites} sites x decode steps / prefill batches)")
    want_shape = {}
    for (k, n), c in forward_shapes(CONFIG).items():
        want_shape[f"decode:{k}x{n}"] = c * st["decode_steps"]
        want_shape[f"tc:{k}x{n}"] = c * st["batches"]
    if by_shape != {k: v for k, v in sorted(want_shape.items()) if v}:
        raise AssertionError(f"launches by shape {by_shape} != {want_shape}")
    prompt_tokens = sum(len(p) for p in prompts)
    log("serve", config=CONFIG.name, layers=CONFIG.n_layers, requests=len(results),
        batches=st["batches"], decode_steps=st["decode_steps"], launches=launches,
        expected_launches=expected, sites_a_forward=sites, launches_by_shape=by_shape,
        flush_ms=flush_s * 1e3,
        ms_per_forward=flush_s * 1e3 / forwards, prompt_tokens=prompt_tokens,
        generated_tokens=st["tokens_generated"],
        generated_tokens_per_s=st["tokens_generated"] / flush_s,
        peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3), card=card())
    return engine, results, launches


#: analog sites of one granite-3-8b layer by site shape (q and o, k and v,
#: gate and up, down)
SITE_COUNT = {"q/o": 2, "k/v": 2, "gate/up": 2, "down": 1}


def _weight_engine(make_engine, backend="auto"):
    from repro_torch.core.analog import AnalogConfig

    return make_engine(backend, AnalogConfig.weight(0.1, backend=backend),
                       max_gen=WEIGHT_SERVE_GEN, batch_buckets=(1, 2), seq_buckets=(32, 64))


def _weight_traffic(prompts):
    """The weight-noise serve's requests: the first four prompts of at most
    32 tokens, two at K = 1 and two at K = 4."""
    return [p for p in prompts if len(p) <= 32][:4], [1, 1, 4, 4]


def phase_serve_weight(make_engine, prompts, site_rows=None):
    """Four requests served with weight noise, two at K = 1 and two at K = 4
    (4 new tokens each, batch buckets 1 and 2): every site of every forward
    launches the weight route, counted by route and by K, ms a forward over
    one window around the drain. Then one profiled prefill and decode step
    of each tier, for the device's time by kernel, beside what the weight
    and simt routes take for a forward's sites in ``site_rows`` (the
    site_time phase, same shapes)."""
    import torch

    from repro_torch.configs.granite_3_8b import CONFIG
    from repro_torch.kernels import analog_matmul as am
    from repro_torch.models import lm

    engine = _weight_engine(make_engine)
    short, tiers = _weight_traffic(prompts)
    for p, k in zip(short, tiers):
        engine.submit(p, n_repeats=k, max_new_tokens=WEIGHT_SERVE_GEN)
    results, flush_s, launches = _drain(engine)
    by_k = dict(am.LAUNCHES_BY_K)
    st = engine.stats
    forwards = st["batches"] + st["decode_steps"]
    sites = len(lm.group_sites(CONFIG)) * CONFIG.n_layers
    for uid, toks in results.items():
        if len(toks) != WEIGHT_SERVE_GEN or toks.min() < 0 or toks.max() >= CONFIG.vocab_size:
            raise AssertionError(f"weight-noise request {uid}: bad tokens {toks}")
    per_tier = WEIGHT_SERVE_GEN  # a prefill of both requests, then a decode step a token
    expected = {"decode": 0, "tc": 0, "simt": 0, "weight": sites * forwards}
    want_k = {1: sites * per_tier, 4: sites * per_tier}
    if (len(results) != len(short) or forwards != 2 * per_tier or launches != expected
            or by_k != want_k):
        raise AssertionError(f"weight-noise serve: {len(results)} results, {forwards} forwards, "
                             f"launches {launches} != {expected}, by K {by_k} != {want_k}")
    log("serve_weight", requests=len(results), tiers=tiers, prompt_lens=[len(p) for p in short],
        batches=st["batches"], decode_steps=st["decode_steps"], launches=launches,
        expected_launches=expected, launches_by_k=by_k, expected_by_k=want_k,
        flush_ms=flush_s * 1e3, ms_per_forward=flush_s * 1e3 / forwards,
        tokens={int(u): r.tolist() for u, r in results.items()}, card=card())

    for k in (1, 4):
        group = [i for i, t in enumerate(tiers) if t == k]
        fb = _first_batch(engine, [short[i] for i in group], [k] * len(group))
        tier = engine.tiers.get(k)
        cache_len = fb["sb"] + WEIGHT_SERVE_GEN
        prefill = lambda: tier.prefill(fb["tok"], fb["lengths"], fb["table"], cache_len)
        (cache, logits), prefill_ms = _wall_ms(prefill)
        step = lambda: tier.decode(cache, torch.argmax(logits, dim=-1), fb["lengths_np"],
                                   fb["table"])
        _, decode_ms = _wall_ms(step)
        (cache, logits), prefill_prof = _profile(prefill)
        _, decode_prof = _profile(step)
        for name, wall, prof, stage, m in (("prefill", prefill_ms, prefill_prof, "prefill",
                                            WEIGHT_PREFILL_ROWS),
                                           ("decode", decode_ms, decode_prof, "decode", 1)):
            kernel_ms = {}
            for r in site_rows or []:
                if r["noise"] == "weight" and r["stage"] == stage and r["n_repeats"] == k:
                    for route in ("weight", "simt"):
                        kernel_ms[route] = kernel_ms.get(route, 0.0) + (
                            CONFIG.n_layers * SITE_COUNT[r["site"]]
                            * r["ms" if route == "weight" else "simt_ms"])
            log("serve_weight_step", step=name, tier=k, bucket=[fb["bb"], fb["sb"]],
                rows_a_request=m if name == "prefill" else 1, wall_ms=wall,
                idle_share=max(0.0, 1.0 - prof["device_ms"] / wall),
                weight_kernels_ms=sum(t["ms"] for t in prof["top"] if "weight_" in t["name"]),
                site_time_forward_ms=kernel_ms, **prof, card=card())
    return launches


def phase_whole_path_weight(make_engine, prompts):
    """The weight-noise serve's K = 1 batch (2 requests), prefill logits on
    the kernels against the plain ("tile") backend on the card, all 40
    layers, beside what paths with a known fault give against the same
    plain logits: other seeds, no noise."""
    import torch

    from repro_torch.configs.granite_3_8b import CONFIG
    from repro_torch.kernels import analog_matmul as am
    from repro_torch.kernels.prng import PRNGKey, fold_in
    from repro_torch.serving.engine import batch_keys

    short, tiers = _weight_traffic(prompts)
    engine = _weight_engine(make_engine)
    fb = _first_batch(engine, short[:2], tiers[:2])
    n = len(fb["first"])
    cache_len = fb["sb"] + WEIGHT_SERVE_GEN
    prefill = lambda eng, table: eng.tiers.get(1).prefill(
        fb["tok"], fb["lengths"], table, cache_len)[1]
    lk = prefill(engine, fb["table"])
    launches = dict(am.LAUNCHES)
    lt, plain_ms = _wall_ms(lambda: prefill(_weight_engine(make_engine, "tile"), fb["table"]))
    if am.LAUNCHES != launches:
        raise AssertionError("the tile backend launched a CUDA kernel")
    rel = _rel(lk, lt, n)
    other_seeds = batch_keys([fold_in(PRNGKey(1), i) for i in fb["first"]], fb["bb"])
    controls = {"other_seeds": _rel(prefill(engine, other_seeds), lt, n),
                "no_noise": _rel(prefill(make_engine(None), fb["table"]), lt, n)}
    if not (rel <= LOGIT_REL_TOL and bool(torch.isfinite(lk).all())):
        raise AssertionError(f"weight-noise prefill logits kernel vs plain: {rel} > {LOGIT_REL_TOL}")
    log("whole_path_weight", requests=fb["first"], tier=1, bucket=[fb["bb"], fb["sb"]],
        layers=CONFIG.n_layers,
        logit_rel_err=rel, logit_rel_tol=LOGIT_REL_TOL, controls=controls,
        tol_below_controls=LOGIT_REL_TOL < min(controls.values()), plain_prefill_ms=plain_ms,
        card=card())


def _profile(fn):
    """Device time by kernel over one call of ``fn`` (torch.profiler) and
    the host wall time of that profiled call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # device-side events only (kernels, copies): a CPU op's row repeats the
    # device time of the kernels it launched
    dev = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev(e) > 0]
    top = sorted(events, key=dev, reverse=True)[:8]
    return out, dict(
        profiled_wall_ms=wall_ms, device_ms=sum(dev(e) for e in events) / 1e3,
        top=[dict(name=e.key[:60], ms=dev(e) / 1e3, calls=e.count) for e in top],
    )


def _wall_ms(fn):
    """Host wall time of ``fn``, synchronised once before and once after."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _first_batch(engine, prompts, tiers):
    """The scheduler's first batch (request 0's (tier, seq bucket) group),
    padded as the engine pads it, on the card."""
    import torch

    from repro_torch.kernels.prng import PRNGKey, fold_in
    from repro_torch.serving.bucketing import bucket_shape, next_bucket, pad_to_bucket
    from repro_torch.serving.engine import batch_keys

    group = lambda i: (tiers[i], next_bucket(len(prompts[i]), engine.seq_buckets))
    first = [i for i in range(len(prompts)) if group(i) == group(0)][: max(engine.batch_buckets)]
    keys = [fold_in(PRNGKey(0), i) for i in first]
    bb, sb = bucket_shape(len(first), max(len(prompts[i]) for i in first),
                          batch_buckets=engine.batch_buckets, seq_buckets=engine.seq_buckets)
    tok_np, lengths_np = pad_to_bucket([prompts[i] for i in first], (bb, sb))
    return dict(first=first, keys=keys, bb=bb, sb=sb, k=tiers[first[0]], lengths_np=lengths_np,
                tok=torch.from_numpy(tok_np).cuda(), lengths=torch.from_numpy(lengths_np).cuda(),
                table=batch_keys(keys, bb))


def phase_steps(engine, prompts, tiers):
    """Prefill and decode of the first batch through the kernels: wall time
    of an unprofiled prefill and of an unprofiled run of decode steps (one
    sync at each end, as the engine runs them), then one profiled prefill
    and decode step for the device's time by kernel. The idle share is
    1 - profiled device time / unprofiled wall time; the profiler's own
    cost (profiled wall - unprofiled wall) is printed beside it."""
    import torch

    fb = _first_batch(engine, prompts, tiers)
    tier = engine.tiers.get(fb["k"])
    cache_len = fb["sb"] + SERVE_MAX_GEN
    prefill = lambda: tier.prefill(fb["tok"], fb["lengths"], fb["table"], cache_len)
    (cache, logits), prefill_ms = _wall_ms(prefill)
    n_steps = SERVE_MAX_GEN - 1

    def decode_run():
        c, tok = cache, torch.argmax(logits, dim=-1)
        for t in range(n_steps):
            lg, c = tier.decode(c, tok, fb["lengths_np"] + t, fb["table"])
            tok = torch.argmax(lg, dim=-1)
        return tok

    _, decode_ms = _wall_ms(decode_run)
    (cache, logits), prefill_prof = _profile(prefill)
    _, decode_prof = _profile(
        lambda: tier.decode(cache, torch.argmax(logits, dim=-1), fb["lengths_np"], fb["table"]))
    n_real = len(fb["first"])
    prompt_tokens = sum(len(prompts[i]) for i in fb["first"])
    step_ms = decode_ms / n_steps
    for name, wall, prof, rate in (
        ("prefill", prefill_ms, prefill_prof, prompt_tokens / prefill_ms * 1e3),
        ("decode", step_ms, decode_prof, n_real / step_ms * 1e3),
    ):
        log("step", config=engine.model_cfg.name, step=name, requests=fb["first"], tier=fb["k"],
            bucket=[fb["bb"], fb["sb"]],
            wall_ms=wall, tokens_per_s=rate, steps_timed=1 if name == "prefill" else n_steps,
            idle_share=max(0.0, 1.0 - prof["device_ms"] / wall),
            profiler_overhead_ms=prof["profiled_wall_ms"] - wall, **prof, card=card())
    return fb


def _rel(a, b, n):
    return float((a[:n] - b[:n]).abs().max()) / float(b[:n].abs().max())


def _logit_tol(cfg) -> float:
    """The whole-path bound of a model: ``LOGIT_REL_TOL``, or
    ``GRIFFIN_LOGIT_REL_TOL`` for the griffin family."""
    return GRIFFIN_LOGIT_REL_TOL if cfg.family == "griffin" else LOGIT_REL_TOL


def phase_whole_path(make_engine, engine, results, prompts, tiers, fb):
    """The first batch again on the plain ("tile") backend, on the card:
    prefill logits and greedy tokens against the kernels', beside what
    faulty paths give against the same plain logits and what the plain
    path gives against itself when only the float order changes (each
    request alone against its row of the batch)."""
    import torch

    from repro_torch.kernels import analog_matmul as am
    from repro_torch.kernels.prng import PRNGKey, fold_in
    from repro_torch.serving.engine import batch_keys

    first, k, n = fb["first"], fb["k"], len(fb["first"])
    cache_len = fb["sb"] + SERVE_MAX_GEN
    prefill = lambda eng, kk, table: eng.tiers.get(kk).prefill(
        fb["tok"], fb["lengths"], table, cache_len)[1]
    lk = prefill(engine, k, fb["table"])

    tile = make_engine("tile")
    launches = dict(am.LAUNCHES)
    lt = prefill(tile, k, fb["table"])
    t = time.perf_counter()
    for i, key in zip(first, fb["keys"]):
        tile.submit(prompts[i], n_repeats=k, max_new_tokens=SERVE_MAX_GEN, key=key)
    tile_results = tile.flush()
    tile_s = time.perf_counter() - t
    float_order = [_rel(tile.tiers.get(k).prefill(fb["tok"][i:i + 1], fb["lengths"][i:i + 1],
                                                  fb["table"][i:i + 1], cache_len)[1],
                        lt[i:i + 1], 1) for i in range(n)]
    if am.LAUNCHES != launches:
        raise AssertionError("the tile backend launched a CUDA kernel")
    rel = _rel(lk, lt, n)
    tol = _logit_tol(engine.model_cfg)

    # the same check on paths with a known fault: seeds of other requests,
    # the other precision tier, noise dropped
    other_seeds = batch_keys([fold_in(PRNGKey(1), i) for i in first], fb["bb"])
    controls = {
        "other_seeds": _rel(prefill(engine, k, other_seeds), lt, n),
        "other_k": _rel(prefill(engine, 4 if k == 1 else 1, fb["table"]), lt, n),
        "no_noise": _rel(prefill(make_engine(None), 1, fb["table"]), lt, n),
    }
    agree = [int((tile_results[j] == results[i]).sum()) for j, i in enumerate(first)]
    if not (rel <= tol and bool(torch.isfinite(lk).all())):
        raise AssertionError(f"prefill logits kernel vs plain: {rel} > {tol}")
    log("whole_path", config=engine.model_cfg.name, requests=first, tier=k,
        bucket=[fb["bb"], fb["sb"]], logit_rel_err=rel, logit_rel_tol=tol,
        plain_float_order=float_order, controls=controls,
        tol_below_controls=tol < min(controls.values()),
        first_token_equal=[bool(tile_results[j][0] == results[i][0]) for j, i in enumerate(first)],
        tokens_agree=agree, tokens_per_request=SERVE_MAX_GEN, tile_serve_s=tile_s, card=card())


def _edge4():
    from repro_torch.core.profile import PrecisionProfile

    return PrecisionProfile(EDGE4, name="edge4")


def phase_profile(make_engine, prompts, tiers, CONFIG=None, profile=None):
    """A hand-written profile as a tier (granite-3-8b's edge4 unless
    ``CONFIG`` and ``profile`` say otherwise): its modelled energy per
    token between K=1's and K=4's (each equal to ``profile_token_energy``
    of its schedule), a serve whose every site launched at its layer's K,
    and its prefill logits, kernels against the plain path, within the
    whole-path bound, beside the uniform K=1 logits as a control."""
    import torch

    from repro_torch.core.profile import PrecisionProfile
    from repro_torch.kernels import analog_matmul as am
    from repro_torch.models import lm

    if CONFIG is None:
        from repro_torch.configs.granite_3_8b import CONFIG
    profile = profile or _edge4()
    name = profile.name
    engine = make_engine("auto", profiles=[profile])
    energy = {str(t): engine.tier_energy_per_token(t) for t in (1, 4, name)}
    schedules = {"1": PrecisionProfile.uniform(1, CONFIG.n_layers),
                 "4": PrecisionProfile.uniform(4, CONFIG.n_layers), name: profile}
    direct = {t: lm.profile_token_energy(CONFIG, engine.energies, p)
              for t, p in schedules.items()}
    if not (energy["1"] < energy[name] < energy["4"]) or energy != direct:
        raise AssertionError(f"tier energies {energy} (profile_token_energy: {direct})")

    serve = [p for p in prompts if len(p) <= 64][:4]
    for p in serve:
        engine.submit(p, profile=name, max_new_tokens=PROFILE_SERVE_GEN)
    results, flush_s, launches = _drain(engine)
    by_k = dict(am.LAUNCHES_BY_K)
    st = engine.stats
    forwards = st["batches"] + st["decode_steps"]
    per_layer = layer_sites(CONFIG)
    want_k = {k: forwards * sum(n for n, kl in zip(per_layer, profile.repeats) if kl == k)
              for k in sorted(set(profile.repeats))}
    sites = forward_sites(CONFIG)
    want_route = {"decode": sites * st["decode_steps"], "tc": sites * st["batches"], "simt": 0,
                  "weight": 0}
    if by_k != want_k or launches != want_route:
        raise AssertionError(f"{name} launches by K {by_k} != {want_k}, by route {launches} "
                             f"!= {want_route}")
    for uid, toks in results.items():
        if len(toks) != PROFILE_SERVE_GEN or toks.min() < 0 or toks.max() >= CONFIG.vocab_size:
            raise AssertionError(f"{name} request {uid}: bad tokens {toks}")

    fb = _first_batch(engine, prompts, tiers)
    cache_len = fb["sb"] + SERVE_MAX_GEN
    prefill = lambda eng, tier: eng.tiers.get(tier).prefill(
        fb["tok"], fb["lengths"], fb["table"], cache_len)[1]
    n = len(fb["first"])
    lk = prefill(engine, name)
    lt = prefill(make_engine("tile", profiles=[profile]), name)
    rel = _rel(lk, lt, n)
    control = _rel(prefill(engine, 1), lt, n)
    tol = _logit_tol(CONFIG)
    if not (rel <= tol and bool(torch.isfinite(lk).all())):
        raise AssertionError(f"{name} prefill logits kernel vs plain: {rel} > {tol}")
    log("profile", config=CONFIG.name, name=name, profile=list(profile.repeats),
        energy_aj_per_token=energy,
        lm_head_aj=float(lm.energy_macs(CONFIG, 1)["lm_head"] * engine.energies["lm_head"].cpu()),
        requests=len(results), batches=st["batches"], decode_steps=st["decode_steps"],
        launches_by_k=by_k, expected_by_k=want_k, launches=launches,
        flush_ms=flush_s * 1e3, ms_per_forward=flush_s * 1e3 / forwards,
        tokens={int(u): r.tolist() for u, r in results.items()},
        prefill_requests=fb["first"], logit_rel_err=rel, logit_rel_tol=tol,
        control_uniform_k1=control, tol_below_control=tol < control, card=card())
    return launches


def phase_continuous(make_engine, prompts, CONFIG=None, tiers=None):
    """The 8 prompts at each tier of ``tiers`` (granite-3-8b at K=1, K=4
    and edge4 unless told otherwise; budgets from ``default_rng(1)`` in
    [2, 16]) through 4-slot continuous pools and through batch-synchronous
    batches, one seq bucket (64) so both decode over caches of one length:
    every request's tokens equal across the two and alone through its
    pool, bit for bit; fewer decode row-slots for the pools; kernel
    launches per pool step and per admission."""
    import numpy as np

    if CONFIG is None:
        from repro_torch.configs.granite_3_8b import CONFIG
    budgets = [int(b) for b in np.random.default_rng(1).integers(2, 17, size=len(prompts))]
    if tiers is None:
        tiers = ({"n_repeats": 1}, {"n_repeats": 4}, {"profile": "edge4"})
    kw = dict(profiles=[_edge4()] if {"profile": "edge4"} in tiers else [], seq_buckets=(64,),
              max_wait=0.0)
    engines = {"continuous": make_engine("auto", continuous=True, pool_slots=POOL_SLOTS, **kw),
               "sync": make_engine("auto", **kw)}
    sites = forward_sites(CONFIG)
    useful = len(tiers) * sum(b - 1 for b in budgets)  # row-steps the requests need
    out, rows = {}, {}
    for name, engine in engines.items():
        for tier in tiers:
            for p, b in zip(prompts, budgets):
                engine.submit(p, max_new_tokens=b, **tier)
        results, flush_s, launches = _drain(engine)
        st = engine.stats
        want = {"decode": sites * st["decode_steps"], "tc": sites * st["batches"], "simt": 0,
                "weight": 0}
        if launches != want:
            raise AssertionError(f"{name}: launches {launches} != {want}")
        out[name] = results
        forwards = st["batches"] + st["decode_steps"]
        rows[name] = dict(
            requests=len(results), prefills=st["batches"], decode_steps=st["decode_steps"],
            decode_slot_steps=st["decode_slot_steps"], active_slot_steps=st["active_slot_steps"],
            useful_share=useful / st["decode_slot_steps"], launches=launches,
            flush_ms=flush_s * 1e3, ms_per_forward=flush_s * 1e3 / forwards,
            generated_tokens=st["tokens_generated"],
            generated_tokens_per_s=st["tokens_generated"] / flush_s,
            read_ms_per_step=st["pool_read_s"] * 1e3 / max(1, st["decode_steps"]),
        )
        log("continuous_drain", config=CONFIG.name, discipline=name, **rows[name], card=card())
    cont, sync = engines["continuous"], engines["sync"]
    n = len(prompts) * len(tiers)
    if sorted(out["continuous"]) != list(range(n)) or sorted(out["sync"]) != list(range(n)):
        raise AssertionError(f"served {len(out['continuous'])} and {len(out['sync'])} of {n}")
    differ = [u for u in range(n) if not np.array_equal(out["continuous"][u], out["sync"][u])]
    lengths = [len(out["continuous"][u]) for u in range(n)]
    if differ or lengths != budgets * len(tiers):
        raise AssertionError(f"pooled != sync for uids {differ}; lengths {lengths}")
    if cont.stats["active_slot_steps"] != useful:
        raise AssertionError(f"active slot steps {cont.stats['active_slot_steps']} != {useful}")
    if not rows["continuous"]["decode_slot_steps"] < rows["sync"]["decode_slot_steps"]:
        raise AssertionError(f"decode slot steps: continuous {rows['continuous']} >= sync")

    # one request admitted mid-flight in the drain (the last tier, index 5),
    # alone through its pool; pump_step by pump_step: the steps after the
    # admission round are pure pool steps (B = 4, one active row)
    from repro_torch.kernels.prng import PRNGKey, fold_in

    uid = (len(tiers) - 1) * len(prompts) + 5
    cont.submit(prompts[5], max_new_tokens=budgets[5], key=fold_in(PRNGKey(0), uid), **tiers[-1])
    solo, step_ms = {}, []
    while cont.n_in_flight:
        t = time.perf_counter()
        solo.update(cont.pump_step(force=True))  # ends in the host read of the tokens
        step_ms.append((time.perf_counter() - t) * 1e3)
    (solo_tokens,) = solo.values()
    if not np.array_equal(solo_tokens, out["continuous"][uid]):
        raise AssertionError(f"request {uid} alone {solo_tokens} != in the pool {out['continuous'][uid]}")
    pure = sorted(step_ms[1:])
    log("continuous", config=CONFIG.name, pools=[str(t) for t in cont.pools],
        pool_slots=POOL_SLOTS,
        budgets=budgets, pooled_equals_sync=True, solo_uid=uid, solo_equals_pooled=True,
        solo_step_ms=step_ms, ms_per_pool_step=pure[len(pure) // 2],
        slot_steps={k: r["decode_slot_steps"] for k, r in rows.items()},
        tokens_per_s={k: r["generated_tokens_per_s"] for k, r in rows.items()}, card=card())
    return rows["continuous"]["launches"]


def phase_solo(engine, results, prompts, tiers):
    """One request of the first batch of several, served again alone
    through the same engine under its own key: the same tokens, bit for
    bit, on the card."""
    import numpy as np

    from repro_torch.kernels.prng import PRNGKey, fold_in

    fb = _first_batch(engine, prompts, tiers)
    if len(fb["first"]) < 2:
        raise AssertionError(f"the first batch {fb['first']} holds one request")
    uid = fb["first"][-1]
    solo_uid = engine.submit(prompts[uid], n_repeats=tiers[uid], max_new_tokens=SERVE_MAX_GEN,
                             key=fold_in(PRNGKey(0), uid))
    solo = engine.flush()[solo_uid]
    equal = bool(np.array_equal(solo, results[uid]))
    log("solo", config=engine.model_cfg.name, uid=uid, batch=fb["first"],
        bucket=[fb["bb"], fb["sb"]], solo_equals_batched=equal, tokens=solo.tolist(), card=card())
    if not equal:
        raise AssertionError(f"request {uid} alone {solo} != in its batch {results[uid]}")


def phase_griffin_long(make_engine, CONFIG):
    """One request with a 3,000-token prompt in a 4,096 seq bucket, K=1, 8
    new tokens: prefill takes local attention's aligned branch (4096 %
    2048 = 0) and the 2,048-slot rings wrap during decode. Its kernel-path
    prefill logits against the plain path's (with faulty controls); then,
    digitally, each decode step's logits against a cache-free prefill of
    the sequence so far, beside a control that decodes from another
    prompt's cache. Both within ``GRIFFIN_LOGIT_REL_TOL``: the decode step
    and the prefill differ in float order alone (GEMMs of M = 1 against M
    = T, another attention order, the step update against the scan)."""
    import numpy as np
    import torch

    from repro_torch.kernels import analog_matmul as am
    from repro_torch.kernels.prng import PRNGKey, fold_in
    from repro_torch.models import lm
    from repro_torch.serving.engine import batch_keys

    rng = np.random.default_rng(2)
    prompt, other = (rng.integers(0, CONFIG.vocab_size, LONG_PROMPT).astype(np.int32)
                     for _ in range(2))
    kw = dict(max_gen=LONG_GEN, batch_buckets=(1,), seq_buckets=(LONG_BUCKET,))
    engine = make_engine("auto", **kw)
    uid = engine.submit(prompt, n_repeats=1, max_new_tokens=LONG_GEN)
    results, flush_s, launches = _drain(engine)
    st = engine.stats
    sites = forward_sites(CONFIG)
    expected = {"decode": sites * st["decode_steps"], "tc": sites * st["batches"], "simt": 0,
                "weight": 0}
    if launches != expected or len(results[uid]) != LONG_GEN:
        raise AssertionError(f"long prompt: launches {launches} != {expected}, tokens {results}")

    def padded(p):
        tok = np.zeros((1, LONG_BUCKET), np.int64)
        tok[0, :len(p)] = p
        return torch.from_numpy(tok).cuda()

    lengths = torch.tensor([LONG_PROMPT], device="cuda")
    table = batch_keys([fold_in(PRNGKey(0), uid)], 1)
    cache_len = LONG_BUCKET + LONG_GEN
    prefill = lambda eng, tbl, toks=padded(prompt): eng.tiers.get(eng.tiers.base_id).prefill(
        toks, lengths, tbl, cache_len)
    (cache, lk), kernel_ms = _wall_ms(lambda: prefill(engine, table))
    ring = tuple(cache["groups"]["k2"].shape)  # (G, B, slots, KH, hd)
    if ring[2] != CONFIG.local_window:
        raise AssertionError(f"ring {ring} != window {CONFIG.local_window}")
    before = dict(am.LAUNCHES)
    (_, lt), plain_ms = _wall_ms(lambda: prefill(make_engine("tile", **kw), table))
    if am.LAUNCHES != before:
        raise AssertionError("the tile backend launched a CUDA kernel")
    rel = _rel(lk, lt, 1)
    controls = {"other_seeds": _rel(prefill(engine, batch_keys([fold_in(PRNGKey(1), 0)], 1))[1],
                                    lt, 1),
                "no_noise": _rel(prefill(make_engine(None, **kw), table)[1], lt, 1)}
    tol = GRIFFIN_LOGIT_REL_TOL
    if not (rel <= tol and bool(torch.isfinite(lk).all())):
        raise AssertionError(f"long prefill logits kernel vs plain: {rel} > {tol}")

    digital = make_engine(None, **kw)
    cache, logits = prefill(digital, table)
    ocache, _ = prefill(digital, table, padded(other))
    tier = digital.tiers.get(digital.tiers.base_id)
    seq, tok = list(prompt), torch.argmax(logits, dim=-1)
    errs, ctrl, slots = [], [], []
    for step in range(LONG_GEN - 1):
        pos = np.asarray([LONG_PROMPT + step])
        seq.append(int(tok[0]))
        lg, cache = tier.decode(cache, tok, pos, table)
        lo, ocache = tier.decode(ocache, tok, pos, table)
        _, h = lm.prefill(digital.params, torch.tensor([seq], device="cuda"), CONFIG)
        want = lm.logits_last(digital.params, h, CONFIG)[:, 0, 0].float()
        errs.append(_rel(lg, want, 1))
        ctrl.append(_rel(lo, want, 1))
        slots.append(int(pos[0] % CONFIG.local_window))
        tok = torch.argmax(lg, dim=-1)
    ok = max(errs) <= tol and bool(torch.isfinite(lg).all())
    log("griffin_long", config=CONFIG.name, prompt_len=LONG_PROMPT, bucket=LONG_BUCKET,
        new_tokens=LONG_GEN, tokens=results[uid].tolist(), launches=launches,
        expected_launches=expected, flush_ms=flush_s * 1e3, prefill_ms=kernel_ms,
        plain_prefill_ms=plain_ms, attention_branch="aligned" if LONG_BUCKET % CONFIG.local_window
        == 0 else "masked", ring_shape=list(ring), decode_slots=slots, logit_rel_err=rel,
        logit_rel_tol=tol, controls=controls, tol_below_controls=tol < min(controls.values()),
        decode_vs_prefill_rel_err=errs, control_other_cache=ctrl,
        decode_tol_below_control=tol < min(ctrl),
        card=card())
    if not ok:
        raise AssertionError(f"long decode vs cache-free prefill: {errs} > {tol}")


def _free():
    """Drop what the last configuration left on the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def phase_dense_long(make_engine, CONFIG):
    """One request with a 12,000-token prompt in a 16,384 seq bucket, K=1,
    4 new tokens, on global attention: prefill in (1,024 x 1,024) blocks
    with grouped KV. Prints the peak memory (``max_memory_allocated``) and
    the weights' share of it, and the prefill's wall time; holds the
    kernel-path prefill logits against the plain path's (with faulty
    controls) and each digital decode step against a cache-free prefill of
    the sequence so far (padded to the bucket), beside a control that
    decodes from another prompt's cache."""
    import numpy as np
    import torch

    from repro_torch.kernels import analog_matmul as am
    from repro_torch.kernels.prng import PRNGKey, fold_in
    from repro_torch.models import lm
    from repro_torch.serving.engine import batch_keys

    weights = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(2)
    prompt, other = (rng.integers(0, CONFIG.vocab_size, DENSE_LONG_PROMPT).astype(np.int32)
                     for _ in range(2))
    kw = dict(max_gen=DENSE_LONG_GEN, batch_buckets=(1,), seq_buckets=(DENSE_LONG_BUCKET,))
    engine = make_engine("auto", **kw)
    uid = engine.submit(prompt, n_repeats=1, max_new_tokens=DENSE_LONG_GEN)
    results, flush_s, launches = _drain(engine)
    serve_peak = torch.cuda.max_memory_allocated()
    st = engine.stats
    sites = forward_sites(CONFIG)
    expected = {"decode": sites * st["decode_steps"], "tc": sites * st["batches"], "simt": 0,
                "weight": 0}
    if launches != expected or len(results[uid]) != DENSE_LONG_GEN:
        raise AssertionError(f"long prompt: launches {launches} != {expected}, tokens {results}")

    def padded(seq):
        tok = np.zeros((1, DENSE_LONG_BUCKET), np.int64)
        tok[0, :len(seq)] = seq
        return torch.from_numpy(tok).cuda()

    table = batch_keys([fold_in(PRNGKey(0), uid)], 1)
    cache_len = DENSE_LONG_BUCKET + DENSE_LONG_GEN

    def prefill(eng, tbl, seq=prompt):
        lengths = torch.tensor([len(seq)], device="cuda")
        return eng.tiers.get(eng.tiers.base_id).prefill(padded(seq), lengths, tbl, cache_len)

    (_, lk), kernel_ms = _wall_ms(lambda: prefill(engine, table))
    before = dict(am.LAUNCHES)
    (_, lt), plain_ms = _wall_ms(lambda: prefill(make_engine("tile", **kw), table))
    if am.LAUNCHES != before:
        raise AssertionError("the tile backend launched a CUDA kernel")
    rel = _rel(lk, lt, 1)
    controls = {"other_seeds": _rel(prefill(engine, batch_keys([fold_in(PRNGKey(1), 0)], 1))[1],
                                    lt, 1),
                "no_noise": _rel(prefill(make_engine(None, **kw), table)[1], lt, 1)}
    tol = _logit_tol(CONFIG)
    if not (rel <= tol and bool(torch.isfinite(lk).all())):
        raise AssertionError(f"long prefill logits kernel vs plain: {rel} > {tol}")

    digital = make_engine(None, **kw)
    cache, logits = prefill(digital, table)
    ocache, _ = prefill(digital, table, other)
    tier = digital.tiers.get(digital.tiers.base_id)
    seq, tok = list(prompt), torch.argmax(logits, dim=-1)
    errs, ctrl = [], []
    for step in range(DENSE_LONG_GEN - 1):
        pos = np.asarray([DENSE_LONG_PROMPT + step])
        seq.append(int(tok[0]))
        lg, cache = tier.decode(cache, tok, pos, table)
        lo, ocache = tier.decode(ocache, tok, pos, table)
        want = prefill(digital, table, seq)[1]
        errs.append(_rel(lg, want, 1))
        ctrl.append(_rel(lo, want, 1))
        tok = torch.argmax(lg, dim=-1)
    peak = torch.cuda.max_memory_allocated()
    log("granite20_long", config=CONFIG.name, prompt_len=DENSE_LONG_PROMPT,
        bucket=DENSE_LONG_BUCKET, new_tokens=DENSE_LONG_GEN, tokens=results[uid].tolist(),
        attn_chunks=[CONFIG.attn_q_chunk, CONFIG.attn_kv_chunk], launches=launches,
        expected_launches=expected, flush_ms=flush_s * 1e3, prefill_ms=kernel_ms,
        plain_prefill_ms=plain_ms, weights_gib=weights / 2**30,
        serve_peak_gib=serve_peak / 2**30, weights_share_of_serve_peak=weights / serve_peak,
        peak_gib=peak / 2**30, weights_share_of_peak=weights / peak,
        one_score_tensor_gib=CONFIG.n_heads * DENSE_LONG_BUCKET**2 * 4 / 2**30,
        logit_rel_err=rel, logit_rel_tol=tol, controls=controls,
        tol_below_controls=tol < min(controls.values()), decode_vs_prefill_rel_err=errs,
        control_other_cache=ctrl, decode_tol_below_control=tol < min(ctrl), card=card())
    if not (max(errs) <= tol and bool(torch.isfinite(lg).all())):
        raise AssertionError(f"long decode vs cache-free prefill: {errs} > {tol}")


def fit_depth(CONFIG) -> int:
    """The deepest depth of ``CONFIG`` (at most its own) whose bf16 weights
    fit the card's free memory beside ``init_params``' largest f32 scratch
    (one leaf drawn whole, or one layer of a stacked one) and
    ``FIT_RESERVE_BYTES``; reckoned from the parameter count, before any
    weight is made."""
    import math

    import torch

    from repro_torch.configs import reduced_depth
    from repro_torch.models import lm
    from repro_torch.tree import leaves

    free, _ = torch.cuda.mem_get_info()
    one, two = (reduced_depth(CONFIG, n_layers=n, name=CONFIG.name) for n in (1, 2))
    per_layer = (two.param_count() - one.param_count()) * 2
    fixed = one.param_count() * 2 - per_layer
    parts = lm.map_leaves(lambda path, leaf: math.prod(
        leaf.shape[1:] if path[0] in ("blocks", "tail") else leaf.shape), lm.param_leaves(one))
    scratch = max(leaves(parts)) * 4
    return int(max(1, min(CONFIG.n_layers,
                          (free - fixed - scratch - FIT_RESERVE_BYTES) // per_layer)))


def phase_qwen32_fit():
    """qwen2.5-32b (61.0 GiB in bf16) on one card: at full depth if the
    reckoning (``fit_depth``) says it fits, else at the deepest
    ``reduced_depth`` that does, printed. One prefill of a 4 x 64 bucket
    (the first four prompts of the serve's traffic) at K=1 through the
    kernels, then ``FIT_STEPS`` decode steps; launches by route, finite
    logits, tokens in the vocabulary; the peak memory and the weights'
    share of it."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced_depth
    from repro_torch.kernels import analog_matmul as am
    from repro_torch.kernels.prng import PRNGKey, fold_in
    from repro_torch.serving.bucketing import pad_to_bucket
    from repro_torch.serving.engine import batch_keys

    full = get_config("qwen2.5-32b")
    depth = fit_depth(full)
    free_before = torch.cuda.mem_get_info()[0]
    cfg = full if depth >= full.n_layers else reduced_depth(full, n_layers=depth)
    make_engine = phase_weights(cfg)
    weights = torch.cuda.memory_allocated()
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine = make_engine("auto")
    prompts, _ = _traffic(cfg)
    tok_np, lengths_np = pad_to_bucket(prompts[:4], (4, 64))
    table = batch_keys([fold_in(PRNGKey(0), i) for i in range(4)], 4)
    tier = engine.tiers.get(1)
    torch.cuda.synchronize()
    _zero_launches()
    tok, lengths = torch.from_numpy(tok_np).cuda(), torch.from_numpy(lengths_np).cuda()
    (cache, logits), prefill_ms = _wall_ms(
        lambda: tier.prefill(tok, lengths, table, 64 + FIT_STEPS))
    tokens, step_ms = [torch.argmax(logits, dim=-1)], []
    for step in range(FIT_STEPS):
        (logits, cache), ms = _wall_ms(
            lambda: tier.decode(cache, tokens[-1], lengths_np + step, table))
        step_ms.append(ms)
        tokens.append(torch.argmax(logits, dim=-1))
    launches = dict(am.LAUNCHES)
    sites = forward_sites(cfg)
    expected = {"decode": sites * FIT_STEPS, "tc": sites, "simt": 0, "weight": 0}
    toks = torch.stack(tokens, dim=1).cpu().numpy()
    peak = torch.cuda.max_memory_allocated()
    log("qwen32_fit", config=cfg.name, layers=cfg.n_layers, full_layers=full.n_layers,
        fits_at_full_depth=cfg is full, params=cfg.param_count(), weights_gib=weights / 2**30,
        free_gib_before=free_before / 2**30, init_peak_gib=init_peak / 2**30,
        peak_gib=peak / 2**30, weights_share_of_peak=weights / peak, bucket=[4, 64],
        prompt_lens=[len(p) for p in prompts[:4]], prefill_ms=prefill_ms, decode_ms=step_ms,
        launches=launches, expected_launches=expected, tokens=toks.tolist(), card=card())
    if (launches != expected or not bool(torch.isfinite(logits).all())
            or toks.min() < 0 or toks.max() >= cfg.vocab_size):
        raise AssertionError(f"qwen2.5-32b: launches {launches} != {expected} or bad tokens {toks}")
    return launches


def phase_bert_energy(engine):
    """bert-base's modelled energy a token at K=1 and K=4 with its GELU
    sites (``mlp{i}_in``, ``mlp{i}_out``) counted: each tier's
    ``tier_energy_per_token`` equal to ``profile_token_energy`` of its
    schedule, K=4's above K=1's, and the MLP's share of the analog MACs."""
    from repro_torch.core.profile import PrecisionProfile
    from repro_torch.models import lm

    cfg = engine.model_cfg
    sites = list(lm.group_sites(cfg))
    if [s for s in sites if s.startswith("mlp")] != ["mlp0_in", "mlp0_out"]:
        raise AssertionError(f"bert-base sites {sites}")
    energy = {k: engine.tier_energy_per_token(k) for k in (1, 4)}
    direct = {k: lm.profile_token_energy(cfg, engine.energies, PrecisionProfile.uniform(
        k, cfg.n_layers)) for k in (1, 4)}
    macs = lm.energy_macs(cfg, 1)["groups"]
    mlp_share = float(sum(macs[s].sum() for s in sites if s.startswith("mlp"))
                      / sum(macs[s].sum() for s in sites))
    log("bert_energy", config=cfg.name, sites=sites, energy_aj_per_token=energy,
        profile_token_energy=direct, mlp_share_of_analog_macs=mlp_share,
        lm_head_aj=float(lm.energy_macs(cfg, 1)["lm_head"] * engine.energies["lm_head"].cpu()),
        card=card())
    if energy != direct or not energy[1] < energy[4]:
        raise AssertionError(f"bert-base tier energies {energy} (profile_token_energy {direct})")


def _calib_setup(make_engine, cfg):
    """What the calibrate and search phases share: bert-base's weights,
    the traffic (4 prompts of 64 tokens from ``default_rng(0)``), its
    labels (the digital model's greedy token at every position), the MAC
    tree on the card, and ``apply_of(engine)``: the engine's probe apply
    function followed by the float32 lm_head (logits at every position)."""
    import numpy as np
    import torch

    from repro_torch.models import lm
    from repro_torch.tree import map_leaves

    digital = make_engine(None)
    params = digital.params
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"]).float()
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (CALIB_B, CALIB_T))).cuda()
    labels = torch.argmax(digital.probe_reference(toks).float() @ head, dim=-1)

    def apply_of(engine):
        probe = engine.probe_apply()
        return lambda e, x, k: probe(e, x, k).float() @ head

    return dict(params=params, head=head, toks=toks, labels=labels, batches=[(toks, labels)],
                macs=map_leaves(lambda _p, m: m.cuda(), lm.energy_macs(cfg, CALIB_T)),
                apply_of=apply_of)


def _grad_check(st, cfg, dtype):
    """The Eq.-14 objective and its gradient with respect to every
    log-energy leaf on backend "tile", on the card and on the CPU, same
    seeds, activations in ``dtype``; the target above the allocation, so
    the penalty is 0 and the gradient all noise. Returns (ratio, losses)."""
    import dataclasses

    import torch

    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.calibrate import softmax_xent
    from repro_torch.core.energy import log_energy_penalty, to_energy, uniform_log_energies
    from repro_torch.kernels.prng import PRNGKey, fold_in
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.tree import leaves, map_leaves

    mcfg = dataclasses.replace(cfg, dtype=dtype)

    def objective(dev):
        to = lambda _p, a: a.to(dev)  # noqa: E731
        params = map_leaves(to, st["params"])
        macs = map_leaves(to, st["macs"])
        engine = ServingEngine(params, mcfg, analog_cfg=AnalogConfig.shot(backend="tile"),
                               energies=lm.init_energy_tree(mcfg, GRAD_E, device=dev), device=dev)
        log_e = map_leaves(lambda _p, t: t.requires_grad_(True), uniform_log_energies(macs, GRAD_E))
        e = to_energy(log_e)
        logits = engine.probe_apply()(e, st["toks"].to(dev), fold_in(PRNGKey(0), 0)).float() \
            @ st["head"].to(dev)
        loss = softmax_xent(logits, st["labels"].to(dev)) + log_energy_penalty(
            e, macs, 2.0 * GRAD_E, 2.0)
        loss.backward()
        grads = leaves(map_leaves(lambda _p, t: t.grad.cpu(), log_e))
        return float(loss.detach()), torch.cat([g.reshape(-1) for g in grads])

    (loss_card, g_card), (loss_cpu, g_cpu) = objective("cuda"), objective("cpu")
    ratio = float((g_card - g_cpu).abs().max() / g_cpu.abs().max())
    return ratio, {"card": loss_card, "cpu": loss_cpu}, float(g_cpu.abs().max())


def _uniform(macs, e_per_mac):
    from repro_torch.core.energy import avg_energy_per_mac, to_energy, uniform_log_energies

    e = to_energy(uniform_log_energies(macs, e_per_mac))
    return e, float(avg_energy_per_mac(e, macs))


def _learn(st, apply_fn, target, steps, init=None):
    """``learn_energies`` on ``apply_fn`` at ``target`` aJ/MAC; ``init`` (an
    allocation) warm-starts it, its shape moved to the target's average."""
    import math

    import torch

    from repro_torch.core.calibrate import CalibConfig, learn_energies
    from repro_torch.core.energy import avg_energy_per_mac
    from repro_torch.kernels.prng import PRNGKey
    from repro_torch.tree import map_leaves

    init_log_e = None
    if init is not None:
        shift = math.log(target / float(avg_energy_per_mac(init, st["macs"])))
        init_log_e = map_leaves(lambda _p, e: torch.log(e) + shift, init)
    return learn_energies(apply_fn, st["macs"], st["batches"], key=PRNGKey(1),
                          target_e_per_mac=target, init_log_e=init_log_e,
                          cfg=CalibConfig(lr=CALIB_LR, steps=steps, init_mult=CALIB_INIT_MULT))


def _layer_energies(cfg, energies, layers):
    sites = sorted(energies["groups"])
    return {int(l): {s: float(energies["groups"][s][l]) for s in sites} for l in layers}


def phase_calibrate(make_engine, cfg):
    """Eq.-14 calibration of bert-base at full width and depth, shot noise,
    on the serve's traffic shape with the digital model's greedy tokens as
    labels: the objective's gradient on the "tile" backend on the card
    against the CPU (float32 activations asserted, bf16 printed); the
    noise-free agreement of the kernel path (the accuracy the 2 % floor
    hangs from); ``min_energy_search`` over uniform allocations; Eq.-14
    learning on the "torch" backend at half the uniform minimum (ms a
    step, peak memory, NLL, the learned energies of the first, middle and
    last layers); ``min_energy_search`` with warm-started learning as
    ``make_fn``; and the learned allocation served at K=1. Every accuracy
    probe is ``eval_accuracy`` on "auto", the kernels. Returns (launches by
    route over the phase, what the search phase starts from)."""
    import torch

    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.calibrate import eval_accuracy
    from repro_torch.core.search import min_energy_search
    from repro_torch.kernels import analog_matmul as am
    from repro_torch.kernels.prng import PRNGKey, fold_in
    from repro_torch.serving.engine import ServingEngine

    torch.cuda.synchronize()
    _zero_launches()
    st = _calib_setup(make_engine, cfg)
    t0 = time.perf_counter()
    ratio, losses, g_max = _grad_check(st, cfg, "float32")
    ratio_bf16, _, _ = _grad_check(st, cfg, cfg.dtype)
    grad_s = time.perf_counter() - t0
    log("calibrate_grad", config=cfg.name, backend="tile", energy_aj=GRAD_E, loss=losses,
        grad_max=g_max, grad_ratio=ratio, grad_ratio_tol=GRAD_CHECK_REL,
        grad_ratio_activations_bf16=ratio_bf16, seconds=grad_s, card=card())
    if not ratio <= GRAD_CHECK_REL or dict(am.LAUNCHES) != {r: 0 for r in am.ROUTES}:
        raise AssertionError(f"Eq.-14 gradient card vs CPU {ratio} > {GRAD_CHECK_REL}, or the "
                             f"tile backend launched {am.LAUNCHES}")

    auto = st["apply_of"](make_engine("auto"))
    acc = lambda e: eval_accuracy(auto, e, st["batches"], key=PRNGKey(2),  # noqa: E731
                                  n_noise_samples=EVAL_SAMPLES)
    ceiling = acc(_uniform(st["macs"], E_CLEAN)[0])
    floor = ceiling - MAX_DEGRADATION
    t = time.perf_counter()
    uni = min_energy_search(lambda tgt: _uniform(st["macs"], tgt), acc, float_acc=ceiling,
                            max_degradation=MAX_DEGRADATION, lo=SEARCH_LO, hi=SEARCH_HI,
                            max_iters=SEARCH_ITERS)
    uni_s = time.perf_counter() - t
    if uni.min_e_per_mac == float("inf"):
        raise AssertionError(f"no uniform allocation up to {SEARCH_HI} aJ/MAC holds {floor}")

    torch_apply = st["apply_of"](make_engine("torch"))
    target = uni.achieved_e_per_mac / 2
    launches = dict(am.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t = time.perf_counter()
    learned, diag = _learn(st, torch_apply, target, CALIB_STEPS)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / CALIB_STEPS
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if dict(am.LAUNCHES) != launches:
        raise AssertionError("the torch backend launched a CUDA kernel")
    learned_acc = acc(learned)
    n = cfg.n_layers
    log("calibrate_learn", config=cfg.name, backend="torch", steps=CALIB_STEPS, lr=CALIB_LR,
        batch=[CALIB_B, CALIB_T], ms_per_step=step_ms, peak_gib=peak_gib,
        activation_gib=(torch.cuda.max_memory_allocated() - base_mem) / 2**30,
        nll_first=diag["nll_trace"][0], nll_last=diag["nll_trace"][-1],
        nll_trace=diag["nll_trace"], target_e_per_mac=target,
        avg_e_per_mac=diag["avg_e_per_mac"], agreement=learned_acc,
        agreement_uniform_at_target=acc(_uniform(st["macs"], target)[0]),
        energies_by_layer=_layer_energies(cfg, learned, (0, n // 2, n - 1)), card=card())

    calls = {"cold": 0, "warm": 0}

    def make_dynamic(tgt, init=None):
        calls["warm" if init is not None else "cold"] += 1
        e, d = _learn(st, torch_apply, tgt, PROBE_STEPS_WARM if init is not None
                      else PROBE_STEPS_COLD, init)
        return e, d["avg_e_per_mac"]

    t = time.perf_counter()
    dyn = min_energy_search(make_dynamic, acc, float_acc=ceiling, max_degradation=MAX_DEGRADATION,
                            lo=SEARCH_LO, hi=SEARCH_HI, max_iters=SEARCH_ITERS)
    dyn_s = time.perf_counter() - t
    log("calibrate_search", config=cfg.name, eval_samples=EVAL_SAMPLES, float_acc=ceiling,
        float_acc_energy_aj=E_CLEAN, floor=floor, max_iters=SEARCH_ITERS,
        uniform=dict(min_e_per_mac=uni.achieved_e_per_mac, accuracy=uni.accuracy,
                     trace=uni.trace, seconds=uni_s),
        dynamic=dict(min_e_per_mac=dyn.achieved_e_per_mac, accuracy=dyn.accuracy,
                     trace=dyn.trace, probes=calls, seconds=dyn_s,
                     steps_cold_warm=[PROBE_STEPS_COLD, PROBE_STEPS_WARM]),
        dynamic_below_uniform=dyn.achieved_e_per_mac < uni.achieved_e_per_mac, card=card())

    # the learned allocation served at K=1 (the prompts, CALIB_GEN new tokens)
    engine = ServingEngine(st["params"], cfg, analog_cfg=AnalogConfig.shot(), energies=learned,
                           max_gen=CALIB_GEN, batch_buckets=(1, 2, 4), seq_buckets=(32, 64),
                           device="cuda")
    for i, p in enumerate(st["toks"].cpu().numpy()):
        engine.submit(p, max_new_tokens=CALIB_GEN, key=fold_in(PRNGKey(0), i))
    results = engine.flush()
    launches = dict(am.LAUNCHES)
    if any(len(r) != CALIB_GEN for r in results.values()) or not (
            launches["decode"] and launches["tc"]) or launches["simt"] or launches["weight"]:
        raise AssertionError(f"learned allocation served {results}, launches {launches}")
    log("calibrate", config=cfg.name, launches=launches, launches_by_k=dict(am.LAUNCHES_BY_K),
        launches_by_shape={f"{r}:{k}x{n_}": c for (r, k, n_), c in
                           sorted(am.LAUNCHES_BY_SHAPE.items())}, card=card())
    return launches, dict(st=st, auto=auto, acc=acc, ceiling=ceiling, floor=floor,
                          target=target, learned=learned, torch_apply=torch_apply)


def phase_search(cfg, cal):
    """The per-layer repeat profile of bert-base: from the learned
    allocation at a target where uniform K=1 misses the 2 % floor and
    uniform K=4 holds it (the target halved or doubled, the allocation
    learned again from the last, until both hold), ``repeat_profile_search`` over the 12 layers at K in
    (1, 2, 4), weighted by ``w_l = E_l * MACs_l`` (``profile_token_energy``
    deltas), each candidate's accuracy ``eval_profile_accuracy`` through the
    kernels; the profile saved as JSON, loaded back and registered as a
    tier beside uniform K=4 on a bert-base ``ServingEngine`` over the
    learned allocation; the prompts served on it (launches by route, K and
    site shape as the forwards run them) and one of them alone (the same
    tokens, bit for bit). Returns the launches by route of the serve."""
    import numpy as np

    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.calibrate import eval_profile_accuracy
    from repro_torch.core.profile import PrecisionProfile
    from repro_torch.core.search import repeat_profile_search
    from repro_torch.kernels import analog_matmul as am
    from repro_torch.kernels.prng import PRNGKey, fold_in
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServingEngine

    st, n = cal["st"], cfg.n_layers
    floor, target, energies = cal["floor"], cal["target"], cal["learned"]

    def acc(reps):
        tree = lm.profile_repeat_tree(cfg, PrecisionProfile(tuple(reps), name="cand"))
        return eval_profile_accuracy(cal["auto"], energies, tree, st["batches"], key=PRNGKey(3),
                                     n_noise_samples=EVAL_SAMPLES)

    acc_k1, acc_k4 = acc((1,) * n), acc((4,) * n)
    moves = []
    while (acc_k1 >= floor or acc_k4 < floor) and len(moves) < 3:
        moves.append(0.5 if acc_k1 >= floor else 2.0)
        target *= moves[-1]
        energies, _ = _learn(st, cal["torch_apply"], target, PROBE_STEPS_WARM, energies)
        acc_k1, acc_k4 = acc((1,) * n), acc((4,) * n)
    base = lm.profile_token_energy(cfg, energies, PrecisionProfile.uniform(1, n))
    weights = tuple(
        lm.profile_token_energy(cfg, energies, PrecisionProfile(
            tuple(2 if i == l else 1 for i in range(n)), name="w")) - base for l in range(n))
    t = time.perf_counter()
    res = repeat_profile_search(acc, n_layers=n, float_acc=cal["ceiling"],
                                max_degradation=MAX_DEGRADATION, k_levels=(1, 2, 4),
                                weights=weights)
    search_s = time.perf_counter() - t
    if not (res.feasible and res.accuracy >= floor and acc_k1 < floor):
        raise AssertionError(f"profile search: feasible {res.feasible}, accuracy {res.accuracy} "
                             f"(floor {floor}), uniform K=1 {acc_k1}, K=4 {acc_k4}")

    # freeze: JSON out and back, then a tier beside uniform K=4
    profile = PrecisionProfile(res.repeats, name="searched", accuracy=res.accuracy)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bert_base_searched_profile.json")
        profile.save(path)
        loaded = PrecisionProfile.load(path)
    if loaded != profile:
        raise AssertionError(f"profile JSON round trip: {loaded} != {profile}")
    engine = ServingEngine(st["params"], cfg, analog_cfg=AnalogConfig.shot(), energies=energies,
                           profiles=[loaded], max_gen=CALIB_GEN, batch_buckets=(1, 2, 4),
                           seq_buckets=(32, 64), device="cuda")
    energy = {str(k): engine.tier_energy_per_token(k) for k in (1, 4, profile.name)}
    if not energy[profile.name] <= energy["4"]:
        raise AssertionError(f"searched profile's energy a token {energy}")

    prompts = list(st["toks"].cpu().numpy())
    keys = [fold_in(PRNGKey(0), i) for i in range(len(prompts))]
    for p, k in zip(prompts, keys):
        engine.submit(p, profile=profile.name, max_new_tokens=CALIB_GEN, key=k)
    results, flush_s, launches = _drain(engine)
    by_k = dict(am.LAUNCHES_BY_K)
    by_shape = {f"{r}:{k}x{n_}": c for (r, k, n_), c in sorted(am.LAUNCHES_BY_SHAPE.items())}
    stats = engine.stats
    forwards = stats["batches"] + stats["decode_steps"]
    per_layer = layer_sites(cfg)
    want_k = {k: forwards * sum(c for c, kl in zip(per_layer, profile.repeats) if kl == k)
              for k in sorted(set(profile.repeats))}
    sites = forward_sites(cfg)
    want_route = {"decode": sites * stats["decode_steps"], "tc": sites * stats["batches"],
                  "simt": 0, "weight": 0}
    want_shape = {}
    for (k, n_), c in forward_shapes(cfg).items():
        want_shape[f"decode:{k}x{n_}"] = c * stats["decode_steps"]
        want_shape[f"tc:{k}x{n_}"] = c * stats["batches"]
    if by_k != want_k or launches != want_route or by_shape != dict(sorted(want_shape.items())):
        raise AssertionError(f"searched tier launches by K {by_k} != {want_k}, by route "
                             f"{launches} != {want_route}, by shape {by_shape}")
    last = len(prompts) - 1
    solo_uid = engine.submit(prompts[last], profile=profile.name, max_new_tokens=CALIB_GEN,
                             key=keys[last])
    solo = engine.flush()[solo_uid]
    solo_equal = bool(np.array_equal(solo, results[last]))
    if not solo_equal or any(len(r) != CALIB_GEN for r in results.values()):
        raise AssertionError(f"searched tier: request {last} alone {solo} != {results[last]}")
    log("search", config=cfg.name, target_e_per_mac=target, target_moves=moves, floor=floor,
        float_acc=cal["ceiling"], uniform_k1=acc_k1, uniform_k4=acc_k4,
        repeats=list(profile.repeats), accuracy=res.accuracy, evals=res.n_evals,
        search_seconds=search_s, cost=res.cost, uniform_cost=res.uniform_cost,
        saving_pct_vs_k4=100.0 * (1.0 - res.cost / res.uniform_cost),
        energy_aj_per_token=energy,
        tier_saving_pct_vs_k4=100.0 * (1.0 - energy[profile.name] / energy["4"]),
        profile_json=loaded.to_json(), requests=len(results),
        batches=stats["batches"], decode_steps=stats["decode_steps"], launches=launches,
        launches_by_k=by_k, launches_by_shape=by_shape, flush_ms=flush_s * 1e3,
        ms_per_forward=flush_s * 1e3 / forwards, solo_equals_batched=solo_equal,
        tokens={int(u): r.tolist() for u, r in results.items()}, card=card())
    return launches


def _frontend_inputs(cfg, t, seed):
    """Seeded inputs on the card: ``t`` frame embeddings (frames), or the
    patch prefix and ``t`` text tokens (patch); embeddings at the token
    table's scale (0.02)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    emb = lambda n: (torch.randn((FRONTEND_B, n, cfg.d_model), generator=gen, device="cuda")  # noqa: E731
                     * 0.02).to(cfg.compute_dtype)
    if cfg.frontend == "frames":
        return {"embeds": emb(t)}
    toks = torch.randint(0, cfg.vocab_size, (FRONTEND_B, t), generator=gen, device="cuda")
    return {"tokens": toks, "patch_embeds": emb(cfg.n_frontend_tokens)}


def phase_frontends():
    """musicgen-large (frames, 4 codebook heads) and internvl2-2b (patch,
    256 prefix tokens) at full size through ``lm.prefill`` and
    ``lm.decode_step`` (the engine serves token prompts only). For each:
    shot-noise prefill logits of shape (B, 1, n_codebooks, V) on the
    kernels (every site on tc) against the plain path, beside faulty
    controls; one analog decode step on the kernels (every site on
    decode) against the plain path; and, digitally, a decode step against
    the full forward of the inputs plus that step (``tests/test_decode.py``),
    beside a decode from another input's cache."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.analog import AnalogConfig, fold_key
    from repro_torch.kernels import analog_matmul as am
    from repro_torch.kernels.prng import PRNGKey, fold_in
    from repro_torch.models import lm

    total = {r: 0 for r in am.ROUTES}
    for name in ("musicgen-large", "internvl2-2b"):
        _free()
        cfg = get_config(name)
        t0 = time.perf_counter()
        params = lm.init_params(cfg, seed=0, device="cuda")
        energies = lm.init_energy_tree(cfg, 20.0, device="cuda")
        weights = torch.cuda.memory_allocated()
        pre = _frontend_inputs(cfg, FRONTEND_T, seed=1)
        other = _frontend_inputs(cfg, FRONTEND_T, seed=2)
        step_in = ({"embeds": _frontend_inputs(cfg, 1, seed=3)["embeds"]}
                   if cfg.frontend == "frames"
                   else {"tokens": _frontend_inputs(cfg, 1, seed=3)["tokens"]})
        full = {k: torch.cat([pre[k], step_in[k]], dim=1) if k in step_in else v
                for k, v in pre.items()}
        t = FRONTEND_T + (cfg.n_frontend_tokens if cfg.frontend == "patch" else 0)
        keys = np.stack([fold_in(PRNGKey(0), i) for i in range(FRONTEND_B)])
        spec = lambda backend, k=keys: lm.AnalogSpec(  # noqa: E731
            cfg=AnalogConfig.shot(backend=backend), energies=energies, key=k)
        pos = torch.full((FRONTEND_B,), t, device="cuda")
        step_keys = fold_key(keys, np.full(FRONTEND_B, t))

        def analog(backend, inputs=pre, k=keys):
            cache, h = lm.prefill(params, inputs, cfg, analog=spec(backend, k), cache_len=t + 1)
            logits = lm.logits_last(params, h, cfg)
            step = dataclasses.replace(spec(backend, k), key=fold_key(k, np.full(FRONTEND_B, t)))
            dlogits, _ = lm.decode_step(params, cache, step_in, pos, cfg, analog=step)
            return logits, dlogits

        torch.cuda.synchronize()
        _zero_launches()
        (lk, dk), kernel_ms = _wall_ms(lambda: analog("auto"))
        launches = dict(am.LAUNCHES)
        for r in am.ROUTES:
            total[r] += launches[r]
        sites = forward_sites(cfg)
        expected = {"decode": sites, "tc": sites, "simt": 0, "weight": 0}
        lt, dt = analog("tile")
        shape = (FRONTEND_B, 1, cfg.n_codebooks, cfg.vocab_size)
        flat = lambda a: a.reshape(FRONTEND_B, -1).float()  # noqa: E731
        rel, drel = _rel(flat(lk), flat(lt), FRONTEND_B), _rel(flat(dk), flat(dt), FRONTEND_B)
        other_keys = np.stack([fold_in(PRNGKey(1), i) for i in range(FRONTEND_B)])
        controls = {"other_seeds": _rel(flat(analog("auto", k=other_keys)[0]), flat(lt),
                                        FRONTEND_B),
                    "other_inputs": _rel(flat(analog("auto", inputs=other)[0]), flat(lt),
                                         FRONTEND_B)}

        cache, _ = lm.prefill(params, pre, cfg, cache_len=t + 1)
        ocache, _ = lm.prefill(params, other, cfg, cache_len=t + 1)
        dec, _ = lm.decode_step(params, cache, step_in, pos, cfg)
        odec, _ = lm.decode_step(params, ocache, step_in, pos, cfg)
        _, h_full = lm.prefill(params, full, cfg)
        want = lm.logits_last(params, h_full, cfg)
        dec_rel = _rel(flat(dec), flat(want), FRONTEND_B)
        dec_ctrl = _rel(flat(odec), flat(want), FRONTEND_B)
        tol = _logit_tol(cfg)
        log("frontends", config=name, frontend=cfg.frontend, n_codebooks=cfg.n_codebooks,
            layers=cfg.n_layers, weights_gib=weights / 2**30, positions=t,
            logits_shape=list(lk.shape), launches=launches, expected_launches=expected,
            kernel_prefill_and_step_ms=kernel_ms, logit_rel_err=rel, step_logit_rel_err=drel,
            logit_rel_tol=tol, controls=controls, tol_below_controls=tol < min(controls.values()),
            decode_vs_full_rel_err=dec_rel, decode_control_other_cache=dec_ctrl,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            seconds=round(time.perf_counter() - t0, 3), card=card())
        if (tuple(lk.shape) != shape or tuple(dk.shape) != shape or launches != expected
                or not (rel <= tol and drel <= tol and dec_rel <= tol)
                or not bool(torch.isfinite(lk).all() and torch.isfinite(dk).all())):
            raise AssertionError(f"{name}: shape {tuple(lk.shape)} != {shape}, launches "
                                 f"{launches} != {expected}, rel {rel} / {drel} / {dec_rel} > {tol}")
        params = energies = cache = ocache = None
    return total

class _Blocks:
    """Records every xlstm block call of a forward: (the block function,
    x, params, hook, keyword arguments, output y, new state)."""

    def __enter__(self):
        from repro_torch.models import xlstm

        self.calls, self.real = [], (xlstm.mlstm_block, xlstm.slstm_block)

        def wrap(fn):
            def call(x, p, hook, **kw):
                y, st = fn(x, p, hook, **kw)
                self.calls.append((fn, x, p, hook, kw, y, st))
                return y, st
            return call

        xlstm.mlstm_block, xlstm.slstm_block = (wrap(f) for f in self.real)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import xlstm

        xlstm.mlstm_block, xlstm.slstm_block = self.real


def _blocks_vs_plain(forward, lengths):
    """Every xlstm block of ``forward()`` (a kernel-path prefill), run again
    from its own input on the plain path: the whole path, block by block.
    Returns the largest relative errors (max|dy| / max|y| over the real
    tokens) against the plain path, of the plain path against itself (each
    request alone against its row of the batch: float order only), and of
    faulty controls: other noise streams (a key word changed), no noise."""
    import dataclasses

    import torch

    from repro_torch.models.hooks import MatmulHook

    with _Blocks() as rec:
        forward()
    b, t = rec.calls[0][1].shape[:2]
    real = torch.arange(t, device="cuda")[None, :] < lengths.to("cuda")[:, None]
    rows = [i for i in range(b) if int(lengths[i]) > 0]

    def rel(y, want, mask=real):
        return float((y[mask] - want[mask]).abs().max()) / float(want[mask].abs().max())

    out = {"kernel": [], "float_order": [], "other_seeds": [], "no_noise": []}
    for fn, x, p, hook, kw, y, _ in rec.calls:
        tile = dataclasses.replace(hook, cfg=dataclasses.replace(hook.cfg, backend="tile"))
        yt, _ = fn(x, p, tile, **kw)
        out["kernel"].append(rel(y, yt))
        solo = []
        for i in rows:
            one = dataclasses.replace(tile, seeds={s: v[i:i + 1] for s, v in tile.seeds.items()})
            kw1 = dict(kw, pad_mask=None if kw.get("pad_mask") is None else kw["pad_mask"][i:i + 1])
            solo.append(rel(fn(x[i:i + 1], p, one, **kw1)[0], yt[i:i + 1], real[i:i + 1]))
        out["float_order"].append(max(solo))
        flip = torch.tensor([1, 0, 0, 0], dtype=torch.int32, device="cuda")  # another key word
        other = dataclasses.replace(hook, seeds={s: v ^ flip for s, v in hook.seeds.items()})
        out["other_seeds"].append(rel(fn(x, p, other, **kw)[0], yt))
        out["no_noise"].append(rel(fn(x, p, MatmulHook(), **kw)[0], yt))
    return out


def _block_summary(out):
    """The largest error of each kind, and the block that gave it."""
    return {k: dict(max=max(v), block=v.index(max(v)), min=min(v)) for k, v in out.items()}


def phase_whole_path_xlstm(make_engine, engine, prompts, tiers):
    """The first batch, kernels against the plain ("tile") path on the card,
    block by block: each of the 48 blocks of the kernel-path prefill run
    again from its own input on the plain path, within ``LOGIT_REL_TOL`` of
    max|y| and below every faulty control. (On random weights the mLSTM
    block amplifies a relative change of its sites' outputs 60-250 fold,
    so at the logits, 48 blocks deep, float order alone differs by O(1):
    printed beside the controls, not held.)"""
    fb = _first_batch(engine, prompts, tiers)
    k, n = fb["k"], len(fb["first"])
    cache_len = fb["sb"] + SERVE_MAX_GEN
    prefill = lambda eng, table, sl=slice(None): eng.tiers.get(k).prefill(
        fb["tok"][sl], fb["lengths"][sl], table[sl], cache_len)[1]
    blocks = _blocks_vs_plain(lambda: prefill(engine, fb["table"]), fb["lengths"])
    tile = make_engine("tile")
    lk, lt = prefill(engine, fb["table"]), prefill(tile, fb["table"])
    float_order = [_rel(prefill(tile, fb["table"], slice(i, i + 1)), lt[i:i + 1], 1)
                   for i in range(n)]
    summary = _block_summary(blocks)
    tol = LOGIT_REL_TOL
    worst_control = min(min(blocks["other_seeds"]), min(blocks["no_noise"]))
    log("whole_path_xlstm", config=engine.model_cfg.name, requests=fb["first"], tier=k,
        bucket=[fb["bb"], fb["sb"]], blocks=len(blocks["kernel"]), block_rel=summary,
        block_rel_tol=tol, tol_below_controls=tol < worst_control,
        kernel_by_block=blocks["kernel"], logit_rel_err=_rel(lk, lt, n),
        logit_plain_float_order=float_order, card=card())
    if not (summary["kernel"]["max"] <= tol < worst_control):
        raise AssertionError(f"xlstm blocks kernel vs plain: {summary} (tol {tol})")


def phase_xlstm_long(make_engine, CONFIG):
    """One request with a 2,048-token prompt (one bucket of its length: the
    chunk scan carries its state across 4 chunks of 512 in every mLSTM
    block, sLSTM runs 2,048 steps), K=1, ``XLSTM_LONG_GEN`` new tokens
    through the engine. Its kernel-path prefill against the plain path,
    block by block (``_blocks_vs_plain``); then, digitally in float32,
    each decode step's logits against a cache-free prefill of the sequence
    so far (2,049 tokens and on, whose chunk grid ends in a short chunk),
    beside a control that decodes from another prompt's state."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels.prng import PRNGKey, fold_in
    from repro_torch.models import lm
    from repro_torch.serving.engine import batch_keys

    rng = np.random.default_rng(2)
    prompt, other = (rng.integers(0, CONFIG.vocab_size, XLSTM_LONG_PROMPT).astype(np.int32)
                     for _ in range(2))
    kw = dict(max_gen=XLSTM_LONG_GEN, batch_buckets=(1,), seq_buckets=(XLSTM_LONG_PROMPT,))
    engine = make_engine("auto", **kw)
    uid = engine.submit(prompt, n_repeats=1, max_new_tokens=XLSTM_LONG_GEN)
    results, flush_s, launches = _drain(engine)
    st = engine.stats
    sites = forward_sites(CONFIG)
    expected = {"decode": sites * st["decode_steps"], "tc": sites * st["batches"], "simt": 0,
                "weight": 0}
    if launches != expected or len(results[uid]) != XLSTM_LONG_GEN:
        raise AssertionError(f"long prompt: launches {launches} != {expected}, tokens {results}")
    lengths = torch.tensor([XLSTM_LONG_PROMPT], device="cuda")
    table = batch_keys([fold_in(PRNGKey(0), uid)], 1)
    cache_len = XLSTM_LONG_PROMPT + XLSTM_LONG_GEN
    tok = torch.tensor(prompt[None], device="cuda")
    tier = engine.tiers.get(engine.tiers.base_id)
    (_, lk), kernel_ms = _wall_ms(lambda: tier.prefill(tok, lengths, table, cache_len))
    blocks = _block_summary(_blocks_vs_plain(lambda: tier.prefill(tok, lengths, table, cache_len),
                                             lengths))
    tol = LOGIT_REL_TOL
    worst_control = min(blocks["other_seeds"]["min"], blocks["no_noise"]["min"])
    if not (blocks["kernel"]["max"] <= tol < worst_control and bool(torch.isfinite(lk).all())):
        raise AssertionError(f"long prefill blocks kernel vs plain: {blocks} (tol {tol})")

    # float32, digital: decode steps against cache-free prefills
    cfg32 = dataclasses.replace(CONFIG, dtype="float32")
    params = lm.map_leaves(lambda _p, a: a.float(), make_engine.params)
    cache, h = lm.prefill(params, tok, cfg32, cache_len=cache_len)
    ocache, _ = lm.prefill(params, torch.tensor(other[None], device="cuda"), cfg32,
                           cache_len=cache_len)
    seq, nxt = list(prompt), torch.argmax(lm.logits_last(params, h, cfg32)[:, 0, 0], dim=-1)
    errs, ctrl, full_ms = [], [], []
    for step in range(XLSTM_LONG_GEN - 1):
        pos = torch.tensor([XLSTM_LONG_PROMPT + step])
        seq.append(int(nxt[0]))
        lg, cache = lm.decode_step(params, cache, nxt[:, None], pos, cfg32)
        lo, ocache = lm.decode_step(params, ocache, nxt[:, None], pos, cfg32)
        (_, h), ms = _wall_ms(lambda: lm.prefill(params, torch.tensor([seq], device="cuda"), cfg32))
        full_ms.append(ms)
        want = lm.logits_last(params, h, cfg32)[:, 0, 0]
        errs.append(_rel(lg[:, 0, 0], want, 1))
        ctrl.append(_rel(lo[:, 0, 0], want, 1))
        nxt = torch.argmax(lg[:, 0, 0], dim=-1)
    log("xlstm_long", config=CONFIG.name, prompt_len=XLSTM_LONG_PROMPT,
        chunks=-(-XLSTM_LONG_PROMPT // min(CONFIG.attn_kv_chunk, 512)), new_tokens=XLSTM_LONG_GEN,
        tokens=results[uid].tolist(), launches=launches, expected_launches=expected,
        flush_ms=flush_s * 1e3, prefill_ms=kernel_ms, block_rel=blocks, block_rel_tol=tol,
        cache_free_prefill_f32_ms=full_ms, state_gib=sum(
            a.numel() * a.element_size() for a in cache["groups"].values()) / 2**30,
        decode_vs_prefill_f32_rel_err=errs, control_other_state=ctrl,
        decode_tol_below_control=tol < min(ctrl), card=card())
    if not (max(errs) <= tol < min(ctrl) and bool(torch.isfinite(lg).all())):
        raise AssertionError(f"long decode vs cache-free prefill: {errs} > {tol} or control {ctrl}")
    return launches


def _moe_traffic(cfg):
    """``MOE_REQUESTS`` prompts of 33..64 tokens (``default_rng(0)``) at
    K=1: whole 4 x 64 prefill buckets."""
    import numpy as np

    rng = np.random.default_rng(0)
    lengths = rng.integers(33, 65, size=MOE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32) for n in lengths]
    return prompts, [1] * MOE_REQUESTS


class _Routing:
    """Records the expert ids of every ``moe.router_topk`` call (``pin``
    None), or hands each call the ids of a recorded run (``pin``: the
    gate weights are the call's own probabilities at those ids)."""

    def __init__(self, pin=None):
        self.pin, self.ids = pin, []

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self.real = moe.router_topk

        def routed(logits, top_k):
            gates, ids = self.real(logits, top_k)
            if self.pin is not None:
                ids = self.pin[len(self.ids)]
                z = logits.float()
                probs = torch.softmax(z, dim=-1)
                gates = torch.gather(probs, -1, ids)
                if top_k > 1:
                    gates = gates / gates.sum(dim=-1, keepdim=True)
            self.ids.append(ids)
            return gates, ids

        moe.router_topk = routed
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.router_topk = self.real


def _flip_share(a, b, real):
    """Share of the real tokens' (token, slot) expert choices that differ
    between two recorded runs; ``real`` (B * T,) marks real tokens."""
    flips = total = 0
    for x, y in zip(a.ids, b.ids):
        x, y = x.reshape(-1, x.shape[-1])[real], y.reshape(-1, y.shape[-1])[real]
        flips += int((x != y).sum())
        total += x.numel()
    return flips / total


def phase_whole_path_moe(make_engine, engine, prompts, tiers):
    """The first batch's prefill, kernels against the plain ("tile") path
    on the card. Routing is discrete: the share of (token, slot) expert
    choices that differ between the two is held below half of what a path
    with a known fault (other seeds) flips, and the plain path's logits
    with its routing pinned to the kernel path's choices are held to the
    dense rule (``LOGIT_REL_TOL``); the rows whose routing matched in every
    layer are printed with their error."""
    import torch

    from repro_torch.kernels.prng import PRNGKey, fold_in
    from repro_torch.serving.engine import batch_keys

    fb = _first_batch(engine, prompts, tiers)
    k, n = fb["k"], len(fb["first"])
    cache_len = fb["sb"] + SERVE_MAX_GEN
    prefill = lambda eng, kk, table: eng.tiers.get(kk).prefill(
        fb["tok"], fb["lengths"], table, cache_len)[1]
    real = (torch.arange(fb["sb"], device="cuda")[None, :] < fb["lengths"][:, None]).reshape(-1)
    with _Routing() as rk:
        lk = prefill(engine, k, fb["table"])
    tile = make_engine("tile")
    with _Routing() as rt:
        lt = prefill(tile, k, fb["table"])
    with _Routing(pin=rk.ids):
        lt_pinned = prefill(tile, k, fb["table"])
    other = batch_keys([fold_in(PRNGKey(1), i) for i in fb["first"]], fb["bb"])
    with _Routing() as ro:
        lo = prefill(engine, k, other)
    with _Routing() as rd:
        ld = prefill(make_engine(None), 1, fb["table"])
    flips = _flip_share(rk, rt, real)
    controls = {"other_seeds": _flip_share(ro, rt, real), "no_noise": _flip_share(rd, rt, real)}
    bound = 0.5 * controls["other_seeds"]
    rows_real = real.reshape(fb["bb"], fb["sb"])
    matched = [i for i in range(n) if all(bool((
        x.reshape(fb["bb"], fb["sb"], -1)[i][rows_real[i]] == y.reshape(
            fb["bb"], fb["sb"], -1)[i][rows_real[i]]).all()) for x, y in zip(rk.ids, rt.ids))]
    rel_pinned = _rel(lk, lt_pinned, n)
    rel_matched = {i: _rel(lk[i:i + 1], lt[i:i + 1], 1) for i in matched}
    tol = LOGIT_REL_TOL
    log("whole_path_moe", config=engine.model_cfg.name, requests=fb["first"], tier=k,
        bucket=[fb["bb"], fb["sb"]], router_calls=len(rk.ids), flip_share=flips,
        flip_bound=bound, control_flip_share=controls, logit_rel_err_pinned=rel_pinned,
        logit_rel_err_unpinned=_rel(lk, lt, n), logit_rel_tol=tol,
        control_logit_rel={"other_seeds": _rel(lo, lt, n), "no_noise": _rel(ld, lt, n)},
        rows_routing_matched=matched, logit_rel_err_matched_rows=rel_matched, card=card())
    if not (flips <= bound and rel_pinned <= tol and all(r <= tol for r in rel_matched.values())
            and bool(torch.isfinite(lk).all())):
        raise AssertionError(f"moe whole path: flips {flips} > {bound}, or logits {rel_pinned} "
                             f"/ {rel_matched} > {tol}")


def phase_moe_pad(make_engine, CONFIG, prompts):
    """The first two prompts through ``lm.prefill`` and ``MOE_STEPS``
    ``lm.decode_step``s on the kernels, at K=1: (pad keys, the reference's
    ``tests/test_serving.py`` pad-row case) in a 4-row bucket at the
    config's capacity factor, the two padding rows' keys and tokens changed
    -> the real rows' logits equal bit for bit; (pad count) in a 2-row and
    a 4-row bucket at ``PAD_COUNT_CF`` -> equal bit for bit. The capacity
    follows the padded group's size, so the pad count changes it: equal
    capacity behaviour needs no token dropped, and equal bits need each
    expert buffer on one route in both buckets."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.analog import AnalogConfig, fold_key
    from repro_torch.kernels.prng import PRNGKey, fold_in
    from repro_torch.models import lm

    params, energies = make_engine.params, make_engine.energies
    two = prompts[:2]  # of at most 64 tokens
    rng = np.random.default_rng(3)

    def run(cfg, bb, pad_seed, pad_tokens):
        toks = np.zeros((bb, 64), np.int64)
        for i, p in enumerate(two):
            toks[i, :len(p)] = p
        if pad_tokens:
            toks[2:] = rng.integers(0, cfg.vocab_size, (bb - 2, 64))
        lengths = np.asarray([len(p) for p in two] + [0] * (bb - 2))
        keys = np.stack([fold_in(PRNGKey(0), i) for i in range(2)] + [PRNGKey(pad_seed)] * (bb - 2))
        spec = lm.AnalogSpec(cfg=AnalogConfig.shot(), energies=energies, key=keys)
        cache, h = lm.prefill(params, torch.from_numpy(toks).cuda(), cfg, analog=spec,
                              cache_len=64 + MOE_STEPS, lengths=torch.from_numpy(lengths).cuda())
        out = [lm.logits_last(params, h, cfg)[:2, 0, 0].float()]
        for t in range(MOE_STEPS):
            tok = torch.argmax(out[-1], dim=-1)
            pad = torch.from_numpy(rng.integers(0, cfg.vocab_size, bb - 2)).cuda() if pad_tokens \
                else torch.zeros(bb - 2, dtype=tok.dtype, device="cuda")
            pos = lengths + t
            lg, cache = lm.decode_step(params, cache, torch.cat([tok, pad])[:, None],
                                       torch.from_numpy(pos), cfg,
                                       analog=dataclasses.replace(spec, key=fold_key(keys, pos)),
                                       lengths=torch.from_numpy(lengths))
            out.append(lg[:2, 0, 0].float())
        return out

    def equal(a, b):
        return [bool(torch.equal(x, y)) for x, y in zip(a, b)]

    keys_equal = equal(run(CONFIG, 4, 0, False), run(CONFIG, 4, 12345, True))
    wide = dataclasses.replace(CONFIG, capacity_factor=PAD_COUNT_CF)
    count_equal = equal(run(wide, 2, 0, False), run(wide, 4, 0, True))
    cap = lambda cfg, n_tok: max(1, int(-(-min(cfg.moe_group_size, n_tok) * cfg.top_k
                                          * cfg.capacity_factor // cfg.n_experts)))
    log("moe_pad", config=CONFIG.name, prompt_lens=[len(p) for p in two],
        pad_keys_equal=keys_equal, pad_count_equal=count_equal,
        capacity_factor=CONFIG.capacity_factor, pad_count_capacity_factor=PAD_COUNT_CF,
        capacity_rows={"pad_keys": [cap(CONFIG, 4 * 64), cap(CONFIG, 4)],
                       "bucket2": [cap(wide, 2 * 64), cap(wide, 2)],
                       "bucket4": [cap(wide, 4 * 64), cap(wide, 4)]},
        steps=["prefill"] + [f"decode{t}" for t in range(MOE_STEPS)], card=card())
    if not (all(keys_equal) and all(count_equal)):
        raise AssertionError(f"moe pad rows changed real rows: keys {keys_equal}, "
                             f"count {count_equal}")


def phase_serve_grok(make_engine, CONFIG):
    """grok-1 at ``GROK_LAYERS`` layers, full width: ``MOE_REQUESTS``
    requests batch-synchronously through ``ServingEngine`` (3 prefills of 4
    x 64, then decode), every site launch on its route (the 16 virtual
    experts' buffers: 80 rows in prefill on tc, 2 in decode on decode); the
    same traffic again through another engine gives the same tokens.
    Returns (engine, launches, prompts, tiers)."""
    import numpy as np

    prompts, tiers = _moe_traffic(CONFIG)
    engine, results, launches = phase_serve(make_engine, prompts, tiers, CONFIG)
    again = make_engine("auto")
    for p in prompts:
        again.submit(p, n_repeats=1, max_new_tokens=SERVE_MAX_GEN)
    repeat, _, _ = _drain(again)
    same = [bool(np.array_equal(results[u], repeat[u])) for u in sorted(results)]
    log("moe_repeat", config=CONFIG.name, requests=len(results), equal=same, card=card())
    if not all(same):
        raise AssertionError(f"the same batch served twice differs: {same}")
    return engine, launches, prompts, tiers


def phase_llama4_fit():
    """llama4-maverick at ``LLAMA4_LAYERS`` layers (one dense and one MoE
    layer of 128 experts and a shared one), full width: one prefill of a 4
    x 64 bucket at K=1 through the kernels (3 capacity rows an expert, tc),
    then ``MOE_STEPS`` decode steps (1 row an expert, decode); launches by
    route and shape, finite logits, tokens in the vocabulary, wall times,
    the peak memory and the weights' share of it."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced_depth
    from repro_torch.kernels import analog_matmul as am
    from repro_torch.kernels.prng import PRNGKey, fold_in
    from repro_torch.serving.bucketing import pad_to_bucket
    from repro_torch.serving.engine import batch_keys

    cfg = reduced_depth(get_config("llama4-maverick-400b-a17b"), n_layers=LLAMA4_LAYERS)
    make_engine = phase_weights(cfg)
    weights = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine = make_engine("auto")
    prompts, _ = _traffic(cfg)
    tok_np, lengths_np = pad_to_bucket(prompts[:4], (4, 64))
    table = batch_keys([fold_in(PRNGKey(0), i) for i in range(4)], 4)
    tier = engine.tiers.get(1)
    torch.cuda.synchronize()
    _zero_launches()
    tok, lengths = torch.from_numpy(tok_np).cuda(), torch.from_numpy(lengths_np).cuda()
    (cache, logits), prefill_ms = _wall_ms(lambda: tier.prefill(tok, lengths, table, 64 + MOE_STEPS))
    prefill_launches = dict(am.LAUNCHES)
    tokens, step_ms = [torch.argmax(logits, dim=-1)], []
    for step in range(MOE_STEPS):
        (logits, cache), ms = _wall_ms(
            lambda: tier.decode(cache, tokens[-1], lengths_np + step, table, lengths_np))
        step_ms.append(ms)
        tokens.append(torch.argmax(logits, dim=-1))
    launches = dict(am.LAUNCHES)
    by_shape = {f"{r}:{k}x{n}": c for (r, k, n), c in sorted(am.LAUNCHES_BY_SHAPE.items())}
    sites = forward_sites(cfg)
    expected = {"decode": sites * MOE_STEPS, "tc": sites, "simt": 0, "weight": 0}
    toks = torch.stack(tokens, dim=1).cpu().numpy()
    peak = torch.cuda.max_memory_allocated()
    log("llama4_fit", config=cfg.name, layers=cfg.n_layers, params=cfg.param_count(),
        active_params=cfg.active_param_count(), weights_gib=weights / 2**30,
        peak_gib=peak / 2**30, weights_share_of_peak=weights / peak, bucket=[4, 64],
        prompt_lens=[len(p) for p in prompts[:4]], prefill_ms=prefill_ms, decode_ms=step_ms,
        launches=launches, prefill_launches=prefill_launches, expected_launches=expected,
        launches_by_shape=by_shape, tokens=toks.tolist(), card=card())
    if (launches != expected or not bool(torch.isfinite(logits).all())
            or toks.min() < 0 or toks.max() >= cfg.vocab_size):
        raise AssertionError(f"llama4: launches {launches} != {expected} or bad tokens {toks}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help=f"comma-separated phases to run, of {','.join(PHASES)} "
                         "(serve includes the step, whole-path, serve_weight, profile and "
                         "continuous phases; serve_griffin its step, solo, whole-path and the "
                         "griffin_* phases; serve_granite20, serve_qwen14 and serve_bert their "
                         "step, solo and whole-path phases, serve_granite20 granite20_long too, "
                         "serve_bert calibrate and search; serve_xlstm its step, solo, "
                         "whole-path and continuous phases and xlstm_long; serve_grok its "
                         "step, pad and whole-path phases); "
                         "default all")
    args = ap.parse_args()
    only = [p for p in args.only.split(",") if p]
    if set(only) - set(PHASES):
        ap.error(f"unknown phases {sorted(set(only) - set(PHASES))}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    log("start", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, card=card(), phases=only)
    run = set(only) | (set(SERVE_FOLLOWERS) if "serve" in only else set())
    run |= set(GRIFFIN_FOLLOWERS) if "serve_griffin" in only else set()
    run |= set(GRANITE20_FOLLOWERS) if "serve_granite20" in only else set()
    run |= set(BERT_FOLLOWERS) if run & {"serve_bert", *BERT_FOLLOWERS} else set()
    run |= set(XLSTM_FOLLOWERS) if "serve_xlstm" in run else set()

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log("phase_seconds", of=name, seconds=round(time.perf_counter() - t, 3))
        return out

    from repro_torch.kernels import analog_matmul as am

    by_path = {}

    def counted(name, fn, *args):
        """``timed``, with the phase's kernel launches by route in by_path."""
        before = dict(am.LAUNCHES)
        out = timed(name, fn, *args)
        by_path[name] = {r: am.LAUNCHES[r] - before[r] for r in am.ROUTES}
        return out

    timed("build", phase_build)
    draw_ps = timed("threefry", phase_threefry) if "threefry" in run else None
    entries = counted("kernels", phase_kernels) if "kernels" in run else None
    if "routes" in run:
        counted("routes", phase_routes)
    site_rows = counted("site_time", phase_site_time, draw_ps) if "site_time" in run else None
    if "sweep" in run:
        timed("sweep", phase_sweep)
    if run & {"serve", "serve_weight", *SERVE_FOLLOWERS}:
        from repro_torch.configs.granite_3_8b import CONFIG

        make_engine = timed("weights", phase_weights)
        prompts, tiers = _traffic(CONFIG)
    if "serve" in run:
        engine, results, by_path["serve"] = timed("serve", phase_serve, make_engine, prompts, tiers)
        fb = timed("step", phase_steps, engine, prompts, tiers)
        timed("whole_path", phase_whole_path, make_engine, engine, results, prompts, tiers, fb)
    if "serve_weight" in run:
        by_path["serve_weight"] = timed("serve_weight", phase_serve_weight, make_engine, prompts,
                                        site_rows)
        timed("whole_path_weight", phase_whole_path_weight, make_engine, prompts)
    if "profile" in run:
        by_path["profile"] = timed("profile", phase_profile, make_engine, prompts, tiers)
    if "continuous" in run:
        by_path["continuous"] = timed("continuous", phase_continuous, make_engine, prompts)
    if run & {"serve_griffin", *GRIFFIN_FOLLOWERS}:
        import gc

        from repro_torch.configs.recurrentgemma_2b import CONFIG as GRIFFIN
        from repro_torch.core.profile import PrecisionProfile

        make_engine = engine = results = fb = None  # granite's weights go
        gc.collect()
        torch.cuda.empty_cache()
        make_griffin = timed("griffin_weights", phase_weights, GRIFFIN)
        gprompts, gtiers = _traffic(GRIFFIN)
    if "serve_griffin" in run:
        engine, results, by_path["serve_griffin"] = timed(
            "serve_griffin", phase_serve, make_griffin, gprompts, gtiers, GRIFFIN)
        fb = timed("griffin_step", phase_steps, engine, gprompts, gtiers)
        timed("griffin_solo", phase_solo, engine, results, gprompts, gtiers)
        timed("griffin_whole_path", phase_whole_path, make_griffin, engine, results, gprompts,
              gtiers, fb)
    if "griffin_long" in run:
        timed("griffin_long", phase_griffin_long, make_griffin, GRIFFIN)
    if "griffin_profile" in run:
        by_path["griffin_profile"] = timed(
            "griffin_profile", phase_profile, make_griffin, gprompts, gtiers, GRIFFIN,
            PrecisionProfile(EDGE_GRIFFIN, name="edge"))
    if "griffin_continuous" in run:
        by_path["griffin_continuous"] = timed(
            "griffin_continuous", phase_continuous, make_griffin, gprompts, GRIFFIN,
            ({"n_repeats": 1},))
    make_engine = make_griffin = engine = results = fb = None  # the earlier weights go

    def serve_dense(arch, phase, tag):
        """Weights of ``arch`` (after the last model's are freed), then its
        serve, steps, solo and whole-path phases; returns make_engine."""
        from repro_torch.configs import get_config

        _free()
        cfg = get_config(arch)
        make = timed(f"{tag}_weights", phase_weights, cfg)
        if phase in run:
            p, t = _traffic(cfg)
            eng, res, by_path[phase] = timed(phase, phase_serve, make, p, t, cfg)
            fb_ = timed(f"{tag}_step", phase_steps, eng, p, t)
            timed(f"{tag}_solo", phase_solo, eng, res, p, t)
            timed(f"{tag}_whole_path", phase_whole_path, make, eng, res, p, t, fb_)
            if arch == "bert-base":
                timed("bert_energy", phase_bert_energy, eng)
        return make, cfg

    if run & {"serve_granite20", *GRANITE20_FOLLOWERS}:
        make, cfg = serve_dense("granite-20b", "serve_granite20", "granite20")
        if "granite20_long" in run:
            timed("granite20_long", phase_dense_long, make, cfg)
        make = None
    if "serve_qwen14" in run:
        serve_dense("qwen2.5-14b", "serve_qwen14", "qwen14")
    if "qwen32_fit" in run:
        _free()
        by_path["qwen32_fit"] = timed("qwen32_fit", phase_qwen32_fit)
    if run & {"serve_bert", *BERT_FOLLOWERS}:
        make, cfg = serve_dense("bert-base", "serve_bert", "bert")
        by_path["calibrate"], cal = timed("calibrate", phase_calibrate, make, cfg)
        by_path["search"] = timed("search", phase_search, cfg, cal)
        make = cal = None
    if "frontends" in run:
        by_path["frontends"] = timed("frontends", phase_frontends)
    if run & {"serve_xlstm", *XLSTM_FOLLOWERS}:
        from repro_torch.configs import get_config

        _free()
        XLSTM = get_config("xlstm-1.3b")
        make_xlstm = timed("xlstm_weights", phase_weights, XLSTM)
        xprompts, xtiers = _traffic(XLSTM)
    if "serve_xlstm" in run:
        engine, results, by_path["serve_xlstm"] = timed(
            "serve_xlstm", phase_serve, make_xlstm, xprompts, xtiers, XLSTM)
        fb = timed("xlstm_step", phase_steps, engine, xprompts, xtiers)
        timed("xlstm_solo", phase_solo, engine, results, xprompts, xtiers)
        timed("xlstm_whole_path", phase_whole_path_xlstm, make_xlstm, engine, xprompts, xtiers)
        by_path["xlstm_continuous"] = timed(
            "xlstm_continuous", phase_continuous, make_xlstm, xprompts, XLSTM,
            ({"n_repeats": 1}, {"n_repeats": 4}))
        engine = results = fb = None
    if "xlstm_long" in run:
        by_path["xlstm_long"] = timed("xlstm_long", phase_xlstm_long, make_xlstm, XLSTM)
    make_xlstm = None
    if "serve_grok" in run:
        from repro_torch.configs import get_config, reduced_depth

        _free()
        GROK = reduced_depth(get_config("grok-1-314b"), n_layers=GROK_LAYERS)
        make_grok = timed("grok_weights", phase_weights, GROK)
        engine, by_path["serve_grok"], gprompts, gtiers = timed(
            "serve_grok", phase_serve_grok, make_grok, GROK)
        timed("grok_step", phase_steps, engine, gprompts, gtiers)
        timed("grok_pad", phase_moe_pad, make_grok, GROK, gprompts)
        timed("grok_whole_path", phase_whole_path_moe, make_grok, engine, gprompts, gtiers)
        make_grok = engine = None
    if "llama4_fit" in run:
        _free()
        by_path["llama4_fit"] = timed("llama4_fit", phase_llama4_fit)
    log("done", seconds=round(time.perf_counter() - t0, 1), card=card())
    if only != list(PHASES):
        print(json.dumps({"ok": True, "partial": only}))
        return 0
    kernels = []
    for r in ("decode", "tc", "simt", "weight"):
        entry = entries[r]
        entry["paths"] = list(MAIN_PATHS[r])
        entry["launches"] = sum(by_path[p][r] for p in MAIN_PATHS[r])
        entry["check_launches"] = sum(by_path[p][r] for p in CHECK_PATHS)
        entry["launches_by_path"] = {path: l[r] for path, l in by_path.items()}
        idle = [p for p in MAIN_PATHS[r] if by_path[p][r] == 0]
        if idle:
            raise AssertionError(f"route {r} was launched no time on its paths {idle}")
        if entry["check_launches"] == 0:
            raise AssertionError(f"route {r} was launched no time in the checks {CHECK_PATHS}")
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
