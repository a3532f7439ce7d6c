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
bit across the two, and alone (``continuous``). On the same weights it
holds serving resilience (``resilience``): fault plans (empty, drift held
against hand-set energies, transient faults with retries, poisoned rows,
deadlines), the drift watchdog, the precision governor, and a three-replica
cluster over one copy of the weights through a crash, a hang, a degraded
replica and a hedge, every request's tokens against the plain pooled
run's, and an unexpected exception (a plain ``RuntimeError`` at every
call of two tiers) contained as the reference contains it: retried once,
then ``Failed``, its neighbours' tokens the plain run's. On the same
weights it serves tensor-parallel (``tp``): the serve's prompts at K=1,
K=4 and edge4 through engines on a local mesh of 2 and 4 column shards
(run one after another on the card), batch-synchronously and through
4-slot pools, every token equal to the unsharded engine's and tp times
its launches at N / tp, with the decode step's ms, device ms and idle
share at tp = 1, 2, 4; and it serves the int8 digital tier beside the
bf16 one (``int8``: the trees' bytes, int8 logits against bf16, solo
against batched, ms a decode step, energy a token). Before the serves,
``tp_routes`` holds every route's column shards at granite-3-8b's and
recurrentgemma-2b's site shapes to their slices of the unsharded call,
bit for bit. Every engine of a phase that injects no fault must contain
none (``exe_errors``, ``exe_faults``, ``failed``, ``timed_out`` all 0).
Every engine on the "cuda" backend serves through its executable cache,
each step a CUDA graph captured at its first call and replayed after;
each phase prints its engines' cache hits, misses and captures. On the
same weights ``graphs`` holds the captured steps against the eager ones:
the first batch of each tier through ``tier.build_prefill`` /
``build_decode`` against ``tier.prefill`` / ``decode``, logits bit for bit
over a prefill and 15 decode steps with the noise scale switched between
two of them, decode ms a step, device ms and the idle share, prefill ms
and peak memory, graphs against eager (recurrentgemma-2b and granite-20b
at K=1 too, with their weights: ``graphs_griffin``, ``graphs_granite20``);
and the engine's 8 prompts synchronously and through pools, cold then
warm (no miss, 2 hits a batch synchronously, the same tokens), a noise
scale served warm with no miss, a request alone equal to its batch.
Then it frees granite's
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
(``griffin_continuous``), and two of the prompts at K=1 and two at K=4
on a mesh of 2 shards against the unsharded engine (``tp_griffin``, with
``tp``). Then the rest of the dense family, one
configuration's weights at a time: granite-20b (GELU with biases, MQA;
``serve_granite20``) and qwen2.5-14b (QKV bias; ``serve_qwen14``) through
the same serve, solo and whole-path checks, launches by route and by site
shape asserted; granite-20b's 12,000-token prompt in a 16,384 bucket
through chunked prefill attention at 4 of its 52 layers, with its peak
memory (``granite20_long``);
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
``xlstm_long``, at 16 of its 48 layers: a 2,048-token prompt whose chunk
scan carries the state across 4 chunks, its blocks against the plain
path and, in float32, each decode step against a cache-free prefill);
grok-1 at 4 of its 64 layers,
full width (``serve_grok``: 12 requests batch-synchronously, the same
batch again, the padding rows' keys and count, and the whole path with
its routing flips counted and the plain path's routing pinned to the
kernels'); and llama4-maverick at 2 of its 48 layers (``llama4_fit``: a
prefill and 4 decode steps over 128 experts). Under a mesh, the last
two families (``tp_families``): xlstm-1.3b's serve at tp = 2 and grok-1's
at tp = 2 and 4, tokens equal to the unsharded engine's. Then training:
granite-3-8b at full width and the deepest depth whose training state
fits 80 % of the card (``train``: the attention backward against plain at
one layer's shape, six steps of 4 x 2,048 tokens with bf16 weights and
moments and remat, the loss falling, two repeated steps bit-equal, ms a
step, device ms, tokens/s, peak memory and the model-FLOPs share); the
Eq.-14 calibration at LM scale on the same weights and depth on the
"torch" backend (``calibrate_lm``, no kernel launched); the other three
families the same way, each followed by its calibration on its weights
(``train_griffin``: recurrentgemma-2b at full width and depth, 4 x 2,048;
``train_xlstm``: xlstm-1.3b at full width, 24 of its 48 layers, 2 x 64;
``train_moe``: grok-1 at full width and the one layer whose state fits,
2 x 1,024), with the kernels each step runs; and demo-100m
through the fault-tolerant driver with two simulated failures, bit-equal
to a clean run, with its checkpoints' bytes and seconds
(``train_driver``). The paper's CNN path (``conv``): ``analog_conv2d``
(f32 patches, the simt route) at ResNet-50's 23 conv shapes and its fc
at batch 16, shot noise, K = 1 and 4, with and without 8-bit quantizers,
each against the plain version, the paper-table CNN end to end, faulty
controls, each shape's ms against its bound and the largest batch it
takes. Data-parallel training (``train_dp``): granite-3-8b at full width
on 2 data shards with ZeRO-1 moments, 3 steps as one device at 2
microbatches, as the local mesh and as 2 processes on the card over
gloo, bit-equal, with the collectives' ms and bytes; in the same ranks,
after their train steps, the LM calibration on 2 data shards
(``calibrate_dp``: shot noise on the "torch" backend, 2 steps of 4 x 512,
one device, the local mesh and the ranks; local == ranks bit for bit).
Tensor-parallel training (``train_tp``): granite-3-8b at full width on 2
tensor shards (Megatron's column and row shards, the vocab-parallel
loss), 3 steps of 2 x 2,048 as one device, the local form and 2
processes on the card over gloo (train_dp's, after their own steps):
local == ranks bit for bit, both within a stated bound of one device, a
rank's parameter bytes, peak and tp collectives' ms and bytes. The LM
calibration on the same 2 tensor shards (``calibrate_tp``: shot noise on
the "torch" backend, the analog sites' noise at the one-device call's
place, 2 steps of 2 x 512, one device, the local form and the 2 ranks,
which run it after train_tp's steps): local == ranks bit for bit, one
device within a stated bound. Both calibrations also hold a checkpointed
region's recompute, which the autograd device thread runs, to the data
shard's place: data shard 1's energy gradients with every checkpoint on
equal those of a step that checkpoints nothing, bit for bit, and a
control that drops the place in the recompute lies outside.
The dry run's reckoning (``dryrun``): the train programs this run
measured (train_tp's as a rank on a dry mesh), reckoned on the meta
device, each reckoned peak beside the measured one, and a small real step's FLOPs on the card against the
meta reckoning of the same step. Every phase that
fails raises; each prints its seconds. The last line is ``{"ok":
true, "device": {...}}``; without a CUDA device it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

from repro_torch.launch.roofline import H100  # noqa: E402

#: published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM
#: bytes/s and bf16 tensor-core FLOP/s (``launch/roofline.py``'s ``H100``),
#: f32 FLOP/s outside the tensor cores.
HBM_BYTES_S = H100["hbm_bw"]
BF16_FLOPS_S = H100["peak_flops"]
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
#: tokens a request the whole-path checks serve on the plain backend (its
#: eager steps are the run's slowest)
WHOLE_PATH_GEN = 4
WEIGHT_SERVE_GEN = 4
#: rows a request of the weight-noise serve's prefill (its prompts fit the
#: 32 bucket)
WEIGHT_PREFILL_ROWS = 32
#: the hand-written profile of the profile and continuous phases (not
#: learned: the search is not ported): K=4 at the first and last 4 layers
EDGE4 = (4,) * 4 + (1,) * 32 + (4,) * 4
PROFILE_SERVE_GEN = 8
POOL_SLOTS = 4
#: the resilience phase: new tokens a request; the drift factors held
#: against hand-set energies; the watchdog's probe width (2 rows), probe
#: cadence (pump steps), noise samples a probe and the drift's onset
#: (fault clock)
RES_GEN = 8
RES_DRIFT = (1.5, 2.0)
WD_T, WD_INTERVAL, WD_SAMPLES, WD_ONSET = 32, 2, 2, 6
#: the griffin serve (recurrentgemma-2b): its edge profile, K=4 at layers
#: 0-2 and 23-25 (both tail layers), K=1 between; the long prompt's length,
#: seq bucket and new tokens
EDGE_GRIFFIN = (4,) * 3 + (1,) * 20 + (4,) * 3
LONG_PROMPT, LONG_BUCKET, LONG_GEN = 3000, 4096, 8
#: granite-20b's long prompt: 12,000 tokens in a 16,384 bucket, 4 new tokens
#: (global attention: one (B, H, T, T) f32 score tensor would be 51.5 GB)
DENSE_LONG_PROMPT, DENSE_LONG_BUCKET, DENSE_LONG_GEN = 12000, 16384, 4
#: ... at 4 of granite-20b's 52 layers (the first 4 of its own weights'
#: depth; cut to keep the whole run inside its time: each of the phase's
#: nine 12,000-token prefills costs ~0.24 s a layer; 13 layers until the
#: calibrate_dp and dryrun phases came)
DENSE_LONG_LAYERS = 4
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
#: ... at 8 of xlstm-1.3b's 48 layers, one of its groups: 7 mLSTM blocks and
#: the sLSTM (cut to keep the whole run inside its time: 16 layers until the
#: family train phases came)
XLSTM_LONG_LAYERS = 8
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
PHASES = ("build", "threefry", "kernels", "routes", "tp_routes", "site_time", "sweep", "serve",
          "serve_weight", "profile", "continuous", "resilience", "graphs", "tp", "int8",
          "serve_griffin", "griffin_long", "graphs_griffin",
          "griffin_profile", "griffin_continuous", "serve_granite20", "granite20_long",
          "graphs_granite20",
          "serve_qwen14", "qwen32_fit", "serve_bert", "calibrate", "search", "frontends",
          "serve_xlstm", "xlstm_long", "serve_grok", "llama4_fit", "tp_families", "train",
          "calibrate_lm", "train_griffin", "train_xlstm", "train_moe", "train_driver", "conv",
          "train_dp", "train_tp", "calibrate_tp", "dryrun")
#: phases that ``serve`` runs after its own (they share its weights)
SERVE_FOLLOWERS = ("serve_weight", "profile", "continuous", "resilience")
#: phases that ``serve_griffin`` runs after its own (recurrentgemma's weights)
GRIFFIN_FOLLOWERS = ("griffin_long", "griffin_profile", "griffin_continuous")
#: phases that ``serve_granite20`` runs after its own (granite-20b's weights)
GRANITE20_FOLLOWERS = ("granite20_long",)
#: phases that ``graphs`` runs on the other models' weights
GRAPHS_FOLLOWERS = ("graphs_griffin", "graphs_granite20")
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
#: counts: the serves for decode, tc and weight; the convolutions (f32
#: patches) for simt. ``check_launches`` counts each route's launches in the
#: phases that hold it against the plain version.
DENSE_PATHS = ("serve_granite20", "serve_qwen14", "qwen32_fit", "serve_bert", "frontends")
FAMILY_PATHS = ("serve_xlstm", "xlstm_long", "serve_grok", "llama4_fit")
TP_PATHS = ("tp", "tp_griffin", "tp_xlstm", "tp_grok")
MAIN_PATHS = {"decode": ("serve", "resilience", "graphs", "serve_griffin") + DENSE_PATHS
              + BERT_FOLLOWERS + FAMILY_PATHS + TP_PATHS,
              "tc": ("serve", "resilience", "graphs", "serve_griffin") + DENSE_PATHS
              + BERT_FOLLOWERS + FAMILY_PATHS + TP_PATHS,
              "simt": ("conv",), "weight": ("serve_weight",)}
CHECK_PATHS = ("kernels", "routes", "tp_routes", "site_time")


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
    product's FLOPs on the tensor cores at the bf16 peak, once for bf16
    operands that nothing changes and once more for each operand with a lo
    part (an f32 operand, or one after its quantizer or the weight noise,
    is exact as two bf16 parts hi + lo, and x * w as hi*hi + hi*lo +
    lo*hi: three bf16 products for f32 operands, two for noisy bf16
    weights) and the noise draws this call needs on the integer lanes and
    on the SFU lanes. ``detail`` holds each term in ms, the draws' on the
    INT32 lanes alone (``int32_only``) and the bound with the product at the
    f32 SIMT rate (``f32_simt``, the bound this function had until the simt
    route multiplied on the tensor cores).
    """
    import torch

    b, m, k = o["x"].shape
    n = o["w"].shape[1]
    n_bytes = sum(o[t].numel() * o[t].element_size()
                  for t in ("x", "w", "row_scale", "col_scale", "wq", "scalars", "seed"))
    n_bytes += b * m * n * 4
    flops = 2.0 * b * m * k * n
    draws = _draws(o, n_repeats)
    f32 = o["x"].dtype != torch.bfloat16
    lo_parts = int(f32 or o["quant_x"]) + int(f32 or o["quant_w"] or o["noise_kind"] == "weight")
    product = flops * (1 + lo_parts) / BF16_FLOPS_S
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
    """Each route vs plain; returns the headline entries of the kernels line.
    The decode entry also times the route's noise-free use (the served
    digital sites', ``hooks.ServingMatmulHook``) beside ``torch.matmul`` on
    the same inputs, the library call that computes that function."""
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
            if taken == "decode":  # the served digital sites' use: no noise
                quiet = dict(o, noise_kind="none")
                entries[taken]["noise_free"] = dict(
                    ms=cuda_ms(lambda: _run_raw(analog_matmul_raw, quiet, 1, route="decode"), 10,
                               flush),
                    library="torch.matmul",
                    library_ms=cuda_ms(lambda: torch.matmul(o["x"], o["w"]), 10, flush))
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
    from repro_torch.kernels import analog_matmul as am
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
        # the tc route's cluster sizes the site shapes leave out above: 4
        # splits of K (recurrentgemma-2b's gate/up) and 1 (granite-20b's in)
        ("tc", (4, 64, 2560, 7680), shot, 20.0, False, 4, False),
        ("tc", (4, 64, 6144, 24576), shot, 20.0, False, 1, False),
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
        splits = (am.decode_plan(k, n, b * m)["splits"] if route == "decode" else
                  am.tc_plan(b * m, k, n)["splits"] if route == "tc" else None)
        log("routes", route=route, shape=[b, m, k, n], noise=o["noise_kind"], n_repeats=reps,
            quant_out=o["quant_out"], cs_per_request=cs_req, solo_equals_batched=solo_equal,
            deterministic=deterministic, splits=splits)
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
    for line in site_summary(rows):
        log("site_time_summary", **line, card=card())
    return rows


#: the models whose forwards ``site_summary`` adds up
SUMMARY_MODELS = ("granite-3-8b", "recurrentgemma-2b", *DENSE_SITES)


def site_summary(rows) -> list:
    """One line per (model, stage) of ``phase_site_time``'s shot-noise rows
    (4 requests, K = 1): for each route, the launches of one forward
    (``forward_shapes``), Σ (launches x ms) and Σ (launches x bound) over the
    forward's site shapes, and their ratio. A shape is read from any row of
    that (stage, K, N); an MoE model's expert shapes from its expert rows
    (one request at the capacity rows), which the shared expert's shape
    then shares. ``missing``: shapes no row timed."""
    from repro_torch.configs import get_config

    out = []
    for model in SUMMARY_MODELS:
        shapes = forward_shapes(get_config(model))
        for stage in ("prefill", "decode"):
            routes, missing = {}, []
            for (k, n), count in shapes.items():
                cands = [r for r in rows if r["noise"] == "output" and r["stage"] == stage
                         and list(r["shape"][2:]) == [k, n]]
                expert = [r for r in cands if r.get("model") == model
                          and r["site"].startswith("expert")]
                if not cands:
                    missing.append([k, n])
                    continue
                row = (expert or cands)[0]
                t = routes.setdefault(row["route"], dict(launches=0, ms=0.0, bound_ms=0.0))
                t["launches"] += count
                t["ms"] += count * row["ms"]
                t["bound_ms"] += count * row["bound_ms"]
            for t in routes.values():
                t["share_of_bound"] = t["bound_ms"] / t["ms"]
            out.append(dict(model=model, stage=stage, routes=routes, missing=missing))
    return out


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


def forward_sites(cfg, tp: int = 1) -> int:
    """Kernel launches of one forward's analog sites: every group's and
    every tail layer's, ``tp`` launches a site on a mesh of ``tp`` shards
    (one where the site runs whole: ``forward_shapes``)."""
    return sum(forward_shapes(cfg, tp).values())


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


def forward_shapes(cfg, tp: int = 1) -> dict:
    """(K, N) of every analog site launch of one forward -> its count, from
    the weight leaves the sites read; on a mesh of ``tp`` shards each site
    launches ``tp`` times at (K, N / tp), unless its shard would take
    another route than the whole call (``shard_keeps_route``: grok's
    router), which then launches once at (K, N)."""
    from repro_torch.kernels.analog_matmul import shard_keeps_route
    from repro_torch.models import lm

    leaves = lm.param_leaves(cfg)
    count = {}

    def add(leaf, times):
        k, n = leaf.shape[-2], leaf.shape[-1]
        split = n % tp == 0 and shard_keeps_route(k, n, tp, cfg.compute_dtype)
        kn, t = ((k, n // tp), tp) if split else ((k, n), 1)
        count[kn] = count.get(kn, 0) + times * t

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
    """Device time by kernel over one call of ``fn`` (torch.profiler,
    device activity only: the host's op events, thousands a forward, took
    seconds of the run to record and average) and the host wall time of
    that profiled call, with the count of kernels it ran; ``profile_s`` is
    the whole profile's cost."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    dev = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev(e) > 0]
    top = sorted(events, key=dev, reverse=True)[:8]
    return out, dict(
        profiled_wall_ms=wall_ms, device_ms=sum(dev(e) for e in events) / 1e3,
        kernels=sum(e.count for e in events),
        top=[dict(name=e.key[:60], ms=dev(e) / 1e3, calls=e.count) for e in top],
        profile_s=time.perf_counter() - t0,
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
                tok_np=tok_np, tok=torch.from_numpy(tok_np).cuda(),
                lengths=torch.from_numpy(lengths_np).cuda(),
                table=batch_keys(keys, bb))


def phase_steps(engine, prompts, tiers, drift_ab=False, variant=None, n_steps=SERVE_MAX_GEN - 1):
    """Prefill and decode of the first batch through the engine's served
    steps (``tier.build_prefill`` / ``build_decode``: CUDA graphs on the
    card, captured at their first call), with the drift operand as the
    engine passes it: wall time of a prefill and of a run of decode steps
    (one sync at each end, as the engine runs them), then one profiled
    prefill and decode step for the device's time by kernel. The idle share
    is 1 - profiled device time / unprofiled wall time; the profiler's own
    cost (profiled wall - unprofiled wall) is printed beside it.

    ``drift_ab``: also profile one eager decode step without the drift
    operand (the forward of an engine that has none) and one with it: what
    carrying the drift as a runtime operand costs a step in device time.
    ``variant`` names the run in its lines; ``n_steps`` decode steps are
    timed."""
    import torch

    fb = _first_batch(engine, prompts, tiers)
    tier = engine.tiers.get(fb["k"])
    cache_len = fb["sb"] + SERVE_MAX_GEN
    prefill, decode = tier.build_prefill(fb["bb"], fb["sb"], cache_len), \
        tier.build_decode(fb["bb"], cache_len)
    cache = engine._batch_cache(fb["bb"], cache_len)
    lengths = fb["lengths_np"]
    engine._scale_arr()

    def prefill_run():
        tier.fill(prefill, fb["table"], tokens=fb["tok_np"], lengths=lengths)
        _, tok = prefill(cache)
        decode.static["tok"].copy_(tok)

    def decode_run(n=n_steps):
        for t in range(n):
            tier.fill(decode, fb["table"], fold=lengths + t, pos=lengths + t, lengths=lengths)
            _, nxt = decode(cache)
            decode.static["tok"].copy_(nxt)

    prefill_run()  # first calls: the captures
    decode_run(1)
    _, prefill_ms = _wall_ms(prefill_run)
    _, decode_ms = _wall_ms(decode_run)
    if drift_ab:
        scale = engine._scale_arr()
        cache_e, logits = tier.prefill(fb["tok"], fb["lengths"], fb["table"], cache_len,
                                       noise_scale=scale)
        one = lambda d: lambda: tier.decode(cache_e, torch.argmax(logits, dim=-1), lengths,
                                            fb["table"], noise_scale=d)
        prof = {arm: _profile(one(d))[1] for arm, d in (("off", None), ("on", scale))}
        log("drift_operand", config=engine.model_cfg.name, eager=True,
            device_ms_off=prof["off"]["device_ms"], device_ms_on=prof["on"]["device_ms"],
            card=card())
        cache_e = logits = None
    _, prefill_prof = _profile(prefill_run)
    _, decode_prof = _profile(lambda: decode_run(1))
    n_real = len(fb["first"])
    prompt_tokens = sum(len(prompts[i]) for i in fb["first"])
    step_ms = decode_ms / n_steps
    for name, wall, prof, rate in (
        ("prefill", prefill_ms, prefill_prof, prompt_tokens / prefill_ms * 1e3),
        ("decode", step_ms, decode_prof, n_real / step_ms * 1e3),
    ):
        log("step", config=engine.model_cfg.name, step=name, requests=fb["first"], tier=fb["k"],
            tp=1 if engine.mesh is None else engine.mesh.tp, variant=variant,
            graphs=engine.graphs, bucket=[fb["bb"], fb["sb"]],
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
    prefill logits and the first ``WHOLE_PATH_GEN`` greedy tokens against
    the kernels', beside what
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
        tile.submit(prompts[i], n_repeats=k, max_new_tokens=WHOLE_PATH_GEN, key=key)
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
    agree = [int((tile_results[j] == results[i][:WHOLE_PATH_GEN]).sum())
             for j, i in enumerate(first)]
    if not (rel <= tol and bool(torch.isfinite(lk).all())):
        raise AssertionError(f"prefill logits kernel vs plain: {rel} > {tol}")
    log("whole_path", config=engine.model_cfg.name, requests=first, tier=k,
        bucket=[fb["bb"], fb["sb"]], logit_rel_err=rel, logit_rel_tol=tol,
        plain_float_order=float_order, controls=controls,
        tol_below_controls=tol < min(controls.values()),
        first_token_equal=[bool(tile_results[j][0] == results[i][0]) for j, i in enumerate(first)],
        tokens_agree=agree, tokens_per_request=WHOLE_PATH_GEN, tile_serve_s=tile_s, card=card())


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


def _launch_delta(before):
    from repro_torch.kernels import analog_matmul as am

    return {r: am.LAUNCHES[r] - before[r] for r in am.ROUTES}


def _res_serve(engine, subs, *, dt=1e-3, max_rounds=2000):
    """Submit ``(prompt, kwargs)`` pairs at virtual time 0 and poll on a
    virtual clock until every request resolves: (uids, results, wall
    seconds, launches by route in the window)."""
    import torch

    from repro_torch.kernels import analog_matmul as am

    torch.cuda.synchronize()
    before = dict(am.LAUNCHES)
    t0 = time.perf_counter()
    uids = [engine.submit(p, now=0.0, **kw) for p, kw in subs]
    results, now = {}, 0.0
    for _ in range(max_rounds):
        if not engine.n_in_flight:
            break
        now += dt
        results.update(engine.poll(now=now))
    torch.cuda.synchronize()
    if engine.n_in_flight:
        raise AssertionError(f"engine did not drain in {max_rounds} rounds")
    return uids, results, time.perf_counter() - t0, _launch_delta(before)


def _tokens_ok(toks, n, vocab):
    import numpy as np

    return isinstance(toks, np.ndarray) and len(toks) == n and toks.min() >= 0 and toks.max() < vocab


def phase_resilience(make_engine, prompts, tiers, CONFIG=None):
    """Serving resilience on granite-3-8b at full width and depth (shot
    noise at 20 aJ/MAC), the serve's eight prompts and tiers through 4-slot
    continuous pools (one seq bucket, ``RES_GEN`` new tokens), every check
    a failure of the run: (a) an empty ``FaultPlan`` gives the plain
    engine's tokens and launches; (b) under a ``DriftRamp`` at each of
    ``RES_DRIFT`` the tokens equal an engine's without a plan whose
    energies are E/d**2 set by hand, launches by route unchanged, and a
    noise scale of 1.0 gives the prefill logits of no scale bit for bit;
    (c) a transient decode fault retries its pool's rows at the promoted
    tier, the other pool's tokens equal to the plain run's, and a fault
    past the retry budget resolves to ``Failed``; (d) a poisoned row
    retires that row alone; (e) a queued deadline gives an empty
    ``TimedOut``, a pooled one keeps a prefix of the plain run's tokens;
    (f) the drift watchdog stays in band at nominal and catches a 2x step
    within two probe intervals (ms a probe); (g) the precision governor
    demotes K=4 -> K=1 under a load ramp and promotes back, sheds only with
    no demotion headroom left, and a power budget holds promotion off; (h)
    three replicas over one copy of the weights (``ClusterRouter``): a
    healthy cluster, a crash (failover, journaled prefixes re-served equal),
    a hang (suspect, recovered, no failover), a degraded replica (its queued
    work quarantined) and a hedge give the plain run's tokens; the
    failover's seconds, peak memory and the cluster's tokens/s beside one
    engine's. Returns the phase's launches by route."""
    import numpy as np
    import torch

    from repro_torch.core.analog import AnalogConfig
    from repro_torch.kernels import analog_matmul as am
    from repro_torch.kernels.prng import PRNGKey, fold_in
    from repro_torch.serving import (
        ClusterRouter,
        DriftRamp,
        Failed,
        FaultPlan,
        NoiseDriftWatchdog,
        PolicyConfig,
        QueueFull,
        ReplicaCrash,
        ReplicaDegraded,
        ReplicaHang,
        ServingEngine,
        TierSpec,
        TimedOut,
        WatchdogConfig,
    )
    from repro_torch.serving.bucketing import pad_to_bucket
    from repro_torch.serving.engine import batch_keys
    from repro_torch.tree import leaves, map_leaves

    if CONFIG is None:
        from repro_torch.configs.granite_3_8b import CONFIG
    vocab, sites = CONFIG.vocab_size, forward_sites(CONFIG)
    opts = dict(continuous=True, pool_slots=POOL_SLOTS, seq_buckets=(64,), max_wait=0.0,
                max_gen=RES_GEN, k_ladder=(1, 2, 4))

    def eng(**kw):
        return make_engine("auto", **dict(opts, **kw))

    def eng_over(energies, **kw):
        return ServingEngine(make_engine.params, CONFIG, analog_cfg=AnalogConfig.shot(),
                             energies=energies, device="cuda", batch_buckets=(1, 2, 4),
                             **dict(opts, **kw))

    keys = [fold_in(PRNGKey(0), i) for i in range(len(prompts))]
    subs = [(p, dict(n_repeats=k, max_new_tokens=RES_GEN, key=key))
            for p, k, key in zip(prompts, tiers, keys)]
    torch.cuda.synchronize()
    _zero_launches()
    n_eng = len(_ENGINE_STATS)

    # (a) the plain pooled run, and an armed but empty plan
    base_eng = eng()
    _, base, base_s, base_l = _res_serve(base_eng, subs)
    st = base_eng.stats
    want = {"decode": sites * st["decode_steps"], "tc": sites * st["batches"], "simt": 0,
            "weight": 0}
    if base_l != want or not all(_tokens_ok(base[u], RES_GEN, vocab) for u in range(len(subs))):
        raise AssertionError(f"plain run: launches {base_l} != {want} or bad tokens {base}")
    _, empty, _, empty_l = _res_serve(eng(fault_plan=FaultPlan()), subs)
    same = [bool(np.array_equal(empty[u], base[u])) for u in range(len(subs))]
    log("resilience_empty_plan", equal=same, launches=empty_l, plain_launches=base_l,
        plain_s=base_s, plain_tokens_per_s=RES_GEN * len(subs) / base_s, card=card())
    if not all(same) or empty_l != base_l:
        raise AssertionError(f"empty plan changed the serve: equal {same}, launches {empty_l}")

    # (b) drift served as E / d**2, a tensor operand; scale 1.0 is no scale
    for d in RES_DRIFT:
        _, drifted, _, drift_l = _res_serve(
            eng(fault_plan=FaultPlan(drift=DriftRamp(start=0, rate=None, max_scale=d))), subs)
        dt = torch.tensor(d, dtype=torch.float32, device="cuda")
        hand_energies = map_leaves(lambda _p, e: e / (dt * dt), make_engine.energies)
        _, hand, _, hand_l = _res_serve(eng_over(hand_energies), subs)
        equal = [bool(np.array_equal(drifted[u], hand[u])) for u in range(len(subs))]
        moved = sum(int((drifted[u] != base[u]).sum()) for u in range(len(subs)))
        log("resilience_drift", scale=d, equal_to_hand_set=equal, tokens_moved_from_plain=moved,
            launches=drift_l, hand_launches=hand_l, card=card())
        if not all(equal) or not drift_l == hand_l == base_l:
            raise AssertionError(f"drift {d}: equal {equal}, launches {drift_l} {hand_l} {base_l}")
        if d == max(RES_DRIFT) and moved == 0:
            raise AssertionError(f"a {d}x drift moved no token: the scale did not reach the kernels")
    tier = base_eng.tiers.get(1)
    tok, lengths = pad_to_bucket([p for p in prompts[:4]], (4, 64))
    tok, lengths = torch.from_numpy(tok).cuda(), torch.from_numpy(lengths).cuda()
    table = batch_keys(keys[:4], 4)
    _, no_scale = tier.prefill(tok, lengths, table, 64 + RES_GEN)
    _, unit = tier.prefill(tok, lengths, table, 64 + RES_GEN,
                           noise_scale=torch.ones((), dtype=torch.float32, device="cuda"))
    log("resilience_unit_scale", logits_equal=bool(torch.equal(no_scale, unit)), card=card())
    if not torch.equal(no_scale, unit):
        raise AssertionError("noise scale 1.0 changed the prefill logits")

    # (c) a transient decode fault: the faulted pool's rows retry one rung up
    fault_eng = eng(fault_plan=FaultPlan(exe_faults=[("decode", 2)]))
    uids, res, _, _ = _res_serve(fault_eng, subs)
    entry = next(e for e in fault_eng.fault_log if e["kind"] == "exe_fault")
    hit = set(entry["uids"])
    kept = [bool(np.array_equal(res[u], base[u])) for u in uids if u not in hit]
    promoted = {u: (tiers[u], t) for u, t in entry["promoted"].items()}
    ok = (fault_eng.stats["exe_faults"] == 1 and hit and set(entry["retried"]) == hit
          and all(t > k or k == 4 for k, t in promoted.values()) and all(kept)
          and all(_tokens_ok(res[u], RES_GEN, vocab) for u in uids))
    fail_eng = eng(fault_plan=FaultPlan(exe_fault_rate=1.0), max_retries=1)
    (fu,), fres, _, fail_l = _res_serve(fail_eng, subs[:1])
    failed = fres[fu]
    log("resilience_transient", faulted=sorted(hit), promoted=promoted, neighbours_equal=kept,
        failed=type(failed).__name__, failed_retries=getattr(failed, "retries", None),
        failed_launches=fail_l, card=card())
    if not ok or not (isinstance(failed, Failed) and failed.retries == 1
                      and failed.tokens.size == 0 and not any(fail_l.values())):
        raise AssertionError(f"transient fault: {fault_eng.fault_log}, {failed}")

    # (c2) an unexpected exception (not the plan's transient fault) at every
    # call of the K=1 and K=2 tiers: contained, retried once one rung up,
    # then Failed; the K=4 pool serves the plain tokens
    err_eng = eng(fault_plan=_broken_tier_plan((1, 2)), max_retries=1)
    uids, res, _, err_l = _res_serve(err_eng, subs)
    hit = [u for u in uids if tiers[u] in (1, 2)]
    kept = [bool(np.array_equal(res[u], base[u])) for u in uids if u not in hit]
    failed = [res[u] for u in hit]
    est = err_eng.stats
    log("resilience_exe_error", broken_tiers=[1, 2], failed=[type(f).__name__ for f in failed],
        failed_retries=[getattr(f, "retries", None) for f in failed],
        detail=getattr(failed[0], "detail", None), neighbours_equal=kept,
        exe_errors=est["exe_errors"], retried=est["retried"], launches=err_l, card=card())
    if not (failed and all(isinstance(f, Failed) and f.retries == 1 and f.tokens.size == 0
                           and f.detail.startswith("RuntimeError(") for f in failed)
            and kept and all(kept) and est["exe_errors"] >= 2 and est["exe_faults"] == 0
            and sorted(res) == sorted(uids)
            and all(p.n_active == 0 and p.n_free == p.slots for p in err_eng.pools.values())):
        raise AssertionError(f"generic exception: {err_eng.fault_log}, {failed}, kept {kept}")
    err_stats = est

    # (d) a poisoned readout row retires that row alone
    poison_eng = eng(fault_plan=FaultPlan(poison={(2, 0): -9}))
    uids, res, _, _ = _res_serve(poison_eng, subs)
    hit = {u for e in poison_eng.fault_log for u in e.get("uids", ())}
    kept = [bool(np.array_equal(res[u], base[u])) for u in uids if u not in hit]
    log("resilience_poison", poisoned=sorted(hit), others_equal=kept,
        poisoned_rows=poison_eng.stats["poisoned_rows"], card=card())
    if (poison_eng.stats["poisoned_rows"] != 1 or len(hit) != 1 or not all(kept)
            or not all(_tokens_ok(res[u], RES_GEN, vocab) for u in uids)):
        raise AssertionError(f"poisoned row: {poison_eng.fault_log}")

    # (e) deadlines: queued -> empty TimedOut; pooled -> a prefix of the plain tokens
    q_eng = eng(max_wait=10.0)
    qu = q_eng.submit(prompts[0], now=0.0, deadline=0.5, **subs[0][1])
    first = q_eng.poll(now=0.1)
    queued = q_eng.poll(now=0.6)[qu]
    p_eng = eng(fault_plan=FaultPlan(stall_steps=range(3, 1000)))
    pu = p_eng.submit(prompts[0], now=0.0, deadline=0.006, **subs[0][1])
    pooled, now = {}, 0.0
    while pu not in pooled and now < 0.1:
        now += 1e-3
        pooled.update(p_eng.pump_step(now=now))
    pooled = pooled.get(pu)
    log("resilience_deadline", queued=type(queued).__name__, queued_tokens=len(queued.tokens),
        pooled=type(pooled).__name__, pooled_tokens=None if pooled is None else
        np.asarray(pooled.tokens).tolist(), plain=base[0].tolist(), card=card())
    if not (first == {} and isinstance(queued, TimedOut) and queued.tokens.size == 0
            and isinstance(pooled, TimedOut) and 1 <= pooled.tokens.size < RES_GEN
            and np.array_equal(pooled.tokens, base[0][: pooled.tokens.size])):
        raise AssertionError(f"deadlines: queued {queued}, pooled {pooled}")

    # (f) the drift watchdog: probes at nominal, then a 2x step at WD_ONSET
    wd_eng = eng(fault_plan=FaultPlan(drift=DriftRamp(start=WD_ONSET, rate=None, max_scale=2.0)))
    probe = np.stack([np.resize(p, WD_T) for p in prompts[:2]]).astype(np.int32)
    cfg = WatchdogConfig(interval=WD_INTERVAL, n_samples=WD_SAMPLES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wd = NoiseDriftWatchdog(wd_eng, probe, config=cfg, key=PRNGKey(3))
    baseline_ms, probe_ms = (time.perf_counter() - t0) * 1e3, []
    event, now = None, 0.0
    for step in range(4 * WD_ONSET):
        now += 1e-3
        if wd_eng.n_in_flight == 0:  # keep a pool decoding
            wd_eng.submit(prompts[0], now=now, **subs[0][1])
        wd_eng.pump_step(now=now)
        n = len(wd.estimates)
        t0 = time.perf_counter()
        event = wd.maybe_probe(step)
        if len(wd.estimates) > n:
            probe_ms.append((time.perf_counter() - t0) * 1e3)
        if event is not None:
            break
    nominal = [e for s, e in wd.estimates if s < WD_ONSET]
    wd_eng.promote_tiers(event)
    wd_eng.submit(prompts[0], now=now + 1e-3, n_repeats=1, max_new_tokens=2, key=keys[0])
    promoted_to = sorted(wd_eng.scheduler.pending_tiers())
    wd_eng.flush()
    wd_eng.fault_plan = None
    wd_eng.recalibrate()
    wd.clear()
    after = wd.probe(step=1000)
    log("resilience_watchdog", baseline_rms=wd.baseline_rms, estimates=wd.estimates,
        event=None if event is None else dict(step=event.step, clock=event.clock,
                                              estimate=event.estimate),
        onset=WD_ONSET, interval=WD_INTERVAL, n_samples=WD_SAMPLES, probe_rows=list(probe.shape),
        promoted_tiers=promoted_to, recalibrated_estimate=wd.estimates[-1][1],
        ms_per_probe=sorted(probe_ms)[len(probe_ms) // 2], baseline_ms=baseline_ms, card=card())
    if (not nominal or not all(cfg.band[0] < e < cfg.band[1] for e in nominal)
            or event is None or event.step < WD_ONSET or event.step > WD_ONSET + 2 * WD_INTERVAL
            or event.estimate <= cfg.band[1] or promoted_to != [2] or after is not None):
        raise AssertionError(f"watchdog: estimates {wd.estimates}, event {event}, "
                             f"promoted {promoted_to}, after {after}")

    # (g) the precision governor
    ladder = (TierSpec(1, 0.80), TierSpec(2, 0.90), TierSpec(4, 0.97))
    gov_eng = eng(policy=PolicyConfig(tiers=ladder, demote_at=1.0, promote_at=0.25, shed_at=3.0,
                                      min_dwell=2))
    now, ramp = 0.0, []
    for tick in range(3):  # four K=4 arrivals a tick: a pool's worth
        for i in range(4):
            j = 4 * tick + i
            ramp.append(gov_eng.submit(prompts[j % len(prompts)], n_repeats=4, max_new_tokens=4,
                                       now=now, key=fold_in(PRNGKey(1), j)))
        now += 1e-2
        gov_eng.pump_step(now=now)
    while gov_eng.n_in_flight:
        now += 1e-2
        gov_eng.pump_step(now=now)
    for _ in range(6):
        now += 1e-2
        gov_eng.pump_step(now=now)
    kinds = [e.kind for e in gov_eng.governor.events]
    demoted_served = sorted({gov_eng.served_tiers[u] for u in ramp})
    shed_eng = eng(policy=PolicyConfig(tiers=ladder, demote_at=1.0, promote_at=0.25, shed_at=2.0,
                                       min_dwell=1))
    for i in range(12):
        shed_eng.submit(prompts[i % len(prompts)], n_repeats=4, max_new_tokens=2, now=0.0,
                        accuracy_floor=0.97, key=fold_in(PRNGKey(2), i))
    shed_eng.pump_step(now=0.01)
    shed_eng.pump_step(now=0.02)
    shed_kinds = [e.kind for e in shed_eng.governor.events]
    try:
        shed_eng.submit(prompts[0], n_repeats=4, now=0.03)
        refused = False
    except QueueFull:
        refused = True
    now = 0.03
    while shed_eng.n_in_flight:
        now += 1e-2
        shed_eng.pump_step(now=now)
    for _ in range(6):
        now += 1e-2
        shed_eng.pump_step(now=now)
    e1, e4 = base_eng.tier_energy_per_token(1), base_eng.tier_energy_per_token(4)
    budget_eng = eng(policy=PolicyConfig(tiers=ladder, demote_at=50.0, promote_at=0.25,
                                         shed_at=50.0, min_dwell=1, power_budget_aj=(e1 + e4) / 2))
    bu = budget_eng.submit(prompts[0], n_repeats=4, max_new_tokens=4, now=0.0, key=keys[0])
    now, held = 0.0, []
    while budget_eng.n_in_flight:
        now += 1e-2
        budget_eng.pump_step(now=now)
        held.append(budget_eng.governor.mode)
    for _ in range(4):
        now += 1e-2
        budget_eng.pump_step(now=now)
    budget_kinds = [(e.kind, e.detail) for e in budget_eng.governor.events]
    log("resilience_governor", ramp_events=kinds, ramp_served_tiers=demoted_served,
        ramp_mode=gov_eng.governor.mode, shed_events=shed_kinds, shed_refused=refused,
        shed_mode=shed_eng.governor.mode, budget_events=budget_kinds, budget_modes=held,
        budget_served=budget_eng.served_tiers[bu], budget_aj=(e1 + e4) / 2,
        tier_aj={1: e1, 4: e4}, card=card())
    if not (kinds[:1] == ["demote"] and "promote" in kinds and 1 in demoted_served
            and gov_eng.governor.mode == "nominal"
            and shed_kinds[:2] == ["demote", "shed_on"] and refused
            and shed_eng.governor.mode == "nominal"
            and budget_kinds[0] == ("demote", "power budget") and set(held) == {"demoted"}
            and budget_kinds[-1][0] == "promote" and budget_eng.served_tiers[bu] == 1
            and budget_eng.governor.mode == "nominal"):
        raise AssertionError(f"governor: ramp {kinds}, shed {shed_kinds} {refused}, "
                             f"budget {budget_kinds} {held}")

    # (h) three replicas over one copy of the weights
    base_eng = fault_eng = fail_eng = err_eng = poison_eng = q_eng = p_eng = wd_eng = None
    gov_eng = shed_eng = budget_eng = None
    torch.cuda.synchronize()
    weights_gib = sum(a.numel() * a.element_size()
                      for a in leaves(make_engine.params)) / 2**30
    before_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()

    def cluster_run(n, faults=(), slots=POOL_SLOTS, **kw):
        """The serve's traffic through ``n`` replicas on a virtual clock:
        (cluster, results, wall seconds at the end of each round, the round
        each request was delivered)."""
        cluster = ClusterRouter([eng(pool_slots=slots) for _ in range(n)], seed=0,
                                backoff_jitter=0, faults=faults, **kw)
        for p, k in zip(prompts, tiers):
            cluster.submit(p, tier=k, max_new_tokens=RES_GEN, now=0.0)
        torch.cuda.synchronize()
        t0, now, results, walls, at = time.perf_counter(), 0.0, {}, [], {}
        for rnd in range(2000):
            if not cluster.n_in_flight:
                break
            now += 1e-2
            got = cluster.pump_step(now=now)
            results.update(got)
            at.update({c: rnd for c in got})
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        if cluster.n_in_flight:
            raise AssertionError("cluster did not drain")
        return cluster, results, walls, at

    def equal_base(results, cuids=None):
        return [bool(np.array_equal(results[c], base[c]))
                for c in (sorted(results) if cuids is None else cuids)]

    healthy, h_res, h_walls, _ = cluster_run(3)
    h_equal = equal_base(h_res)
    crash, c_res, c_walls, c_at = cluster_run(3, faults=(ReplicaCrash(replica=0, at=2),),
                                              suspect_after=2, dead_after=4)
    fo = next(e for e in crash.events if e["kind"] == "failover")
    failover_s = c_walls[max(c_at[c] for c in fo["uids"])] - c_walls[fo["round"]]
    c_equal = equal_base(c_res)
    hang, g_res, _, _ = cluster_run(3, faults=(ReplicaHang(replica=1, at=1, steps=3),),
                                    suspect_after=2, dead_after=8, recover_after=2)
    hang_moves = [(e["frm"], e["to"]) for e in hang.events if e["kind"] == "health"]
    degr, d_res, _, _ = cluster_run(2, faults=(ReplicaDegraded(replica=0, at=0, scale=2.5),),
                                    slots=1, drift_patience=2, recover_after=2)
    nominal_served = [c for c in sorted(d_res) if degr.journal[c].replica != 0]
    d_equal = equal_base(d_res, nominal_served)
    hedge = ClusterRouter([eng() for _ in range(2)], seed=0)
    cu = hedge.submit(prompts[0], tier=tiers[0], max_new_tokens=RES_GEN, now=0.0, hedge=True)
    e_res, _ = hedge.run_until_drained(0.0)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    cs, ks, ds, es = crash.stats, hang.stats, degr.stats, hedge.stats
    log("resilience_cluster", replicas=3, weights_gib=weights_gib,
        allocated_before_gib=before_gib, peak_gib=peak_gib,
        healthy_equal=h_equal, healthy_s=h_walls[-1],
        cluster_tokens_per_s=RES_GEN * len(h_res) / h_walls[-1],
        engine_tokens_per_s=RES_GEN * len(base) / base_s,
        crash_equal=c_equal, crash_health=crash.health, failover_round=fo["round"],
        failed_over=fo["uids"], failover_s=failover_s, crash_s=c_walls[-1],
        dedup_tokens=cs["dedup_tokens"], redispatched=cs["redispatched"],
        prefix_mismatches=cs["prefix_mismatches"], hang_health_moves=hang_moves,
        hang_failed_over=ks["failed_over"], degraded_quarantined=ds["quarantined"],
        degraded_health=degr.health, degraded_nominal_served=nominal_served,
        degraded_nominal_equal=d_equal,
        hedge_stats={k: es[k] for k in ("hedges", "hedge_wins_primary", "hedge_wins_backup",
                                         "hedge_cancelled", "duplicates_discarded", "delivered")},
        card=card())
    if not (all(h_equal) and len(h_res) == len(prompts)
            and all(c_equal) and len(c_res) == len(prompts) and crash.health[0] == "dead"
            and cs["failed_over"] > 0 and cs["dedup_tokens"] > 0 and cs["prefix_mismatches"] == 0
            and hang_moves == [("healthy", "suspect"), ("suspect", "healthy")]
            and ks["failed_over"] == 0 and all(equal_base(g_res)) and len(g_res) == len(prompts)
            and ds["quarantined"] > 0 and ds["replicas_degraded"] == 1
            and len(d_res) == len(prompts) and nominal_served and all(d_equal)
            and list(e_res) == [cu] and np.array_equal(e_res[cu], base[0])
            and es["delivered"] == 1 and es["hedge_wins_primary"] + es["hedge_wins_backup"] == 1
            and es["hedge_cancelled"] + es["duplicates_discarded"] >= 1
            and es["prefix_mismatches"] == 0):
        raise AssertionError("cluster checks failed (see the resilience_cluster line)")
    # no engine of the phase contained an exception but the broken-tier one
    others = [st["exe_errors"] for _, st in _ENGINE_STATS[n_eng:] if st is not err_stats]
    if any(others):
        raise AssertionError(f"an engine contained an unexpected exception: {others}")
    log("resilience", config=CONFIG.name, layers=CONFIG.n_layers, launches=dict(am.LAUNCHES),
        launches_by_shape={f"{r}:{k}x{n}": v for (r, k, n), v in sorted(am.LAUNCHES_BY_SHAPE.items())},
        card=card())
    return dict(am.LAUNCHES)


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


#: decode steps each side of the graphs phase runs and times
GRAPH_STEPS = 15
#: the noise scale the graphs phase switches to between two decode steps
GRAPH_SCALE = 1.5


def _eager_steps(engine, tier, fb, cache_len, switch=None):
    """The first batch's prefill and ``GRAPH_STEPS`` decode steps through the
    tier's own eager steps (from host keys): the logits of each; the noise
    scale goes to ``GRAPH_SCALE`` before step ``switch``."""
    import torch

    engine.set_noise_scale(1.0)
    cache, logits = tier.prefill(fb["tok"], fb["lengths"], fb["table"], cache_len,
                                 noise_scale=engine._scale_arr())
    out = [logits]
    for t in range(GRAPH_STEPS):
        if t == switch:
            engine.set_noise_scale(GRAPH_SCALE)
        logits, cache = tier.decode(cache, torch.argmax(logits, dim=-1), fb["lengths_np"] + t,
                                    fb["table"], fb["lengths_np"],
                                    noise_scale=engine._scale_arr())
        out.append(logits)
    engine.set_noise_scale(1.0)
    return out


def _graph_steps(engine, tier, fb, cache_len, steps, switch=None):
    """The same through the tier's captured steps ``steps`` = (prefill,
    decode) (``build_prefill``/``build_decode``), refilled as the engine
    refills them; the logits of each, copied out of the graphs' pool."""
    prefill, decode = steps
    engine.set_noise_scale(1.0)
    engine._scale_arr()
    lengths = fb["lengths_np"]
    tier.fill(prefill, fb["table"], tokens=fb["tok_np"], lengths=lengths)
    cache = engine._batch_cache(fb["bb"], cache_len)
    logits, tok = prefill(cache)
    out = [logits.clone()]
    decode.static["tok"].copy_(tok)
    for t in range(GRAPH_STEPS):
        if t == switch:
            engine.set_noise_scale(GRAPH_SCALE)
        engine._scale_arr()
        tier.fill(decode, fb["table"], fold=lengths + t, pos=lengths + t, lengths=lengths)
        logits, nxt = decode(cache)
        out.append(logits.clone())
        decode.static["tok"].copy_(nxt)
    engine.set_noise_scale(1.0)
    return out


def _serve_keys(engine, prompts, tiers, idx=None):
    """``prompts[i]`` at ``tiers[i]`` for i in ``idx`` (all by default) under
    the key ``fold_in(PRNGKey(0), i)``, drained in one window: (tokens by i,
    seconds, launches, cache stats)."""
    from repro_torch.kernels.prng import PRNGKey, fold_in

    idx = range(len(prompts)) if idx is None else idx
    uids = {i: engine.submit(prompts[i], n_repeats=tiers[i], max_new_tokens=SERVE_MAX_GEN,
                             key=fold_in(PRNGKey(0), i)) for i in idx}
    results, seconds, launches = _drain(engine)
    return {i: results[u] for i, u in uids.items()}, seconds, launches, engine.cache_stats()


def phase_graphs(make_engine, prompts, tiers, CONFIG, full=True):
    """The executable cache on the card: every served step a CUDA graph.

    Direct: the first batch of each tier (K = 1 and 4; K = 1 alone without
    ``full``) through the tiers'
    captured prefill and decode steps against their eager steps, logits bit
    for bit at the prefill and ``GRAPH_STEPS`` decode steps, with the noise
    scale set to ``GRAPH_SCALE`` between two steps (the output moves as the
    eager step's does, and nothing is captured again); decode ms a step
    (wall, unprofiled, the mean of ``GRAPH_STEPS``; turns eager, graphs,
    graphs, eager), device ms of one profiled step and the idle share, the
    prefill's ms, each graphs against eager, and the memory allocated above
    the start at the peak of each run (the graphs' first run, whose first
    calls run eagerly and capture, and a warm one).
    Through the engine (``full``): the 8 prompts synchronously and through
    4-slot pools, each cold then warm (the warm replay misses nothing, hits
    2 x batches synchronously, and gives the cold tokens), a noise scale
    served warm with no miss, a request alone equal to its batch, and each
    entry's first-use seconds (warm-up plus capture). Returns the launches
    by route of the warm synchronous serve."""
    import numpy as np
    import torch

    rows = []

    def peak_of(fn):
        """(what fn returns, its ms, GiB allocated above the start at its peak)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, ms = _wall_ms(fn)
        return out, ms, (torch.cuda.max_memory_allocated() - base) / 2**30

    for k in sorted(set(tiers)) if full else [tiers[0]]:
        engine = make_engine("auto")
        if not engine.graphs:
            raise AssertionError(f"{CONFIG.name}: the engine on the card does not capture")
        fb = _first_batch(engine, prompts, [k] * len(prompts))
        tier = engine.tiers.get(k)
        cache_len = fb["sb"] + SERVE_MAX_GEN
        steps = (tier.build_prefill(fb["bb"], fb["sb"], cache_len),
                 tier.build_decode(fb["bb"], cache_len))
        switch = GRAPH_STEPS // 2
        eager, _, eager_peak = peak_of(lambda: _eager_steps(engine, tier, fb, cache_len, switch))
        graph, first_ms, first_peak = peak_of(
            lambda: _graph_steps(engine, tier, fb, cache_len, steps, switch))
        equal = [bool(torch.equal(a, b)) for a, b in zip(graph, eager)]
        captures = [len(s.capture_s) for s in steps]
        if not all(equal) or captures != [1, 1]:
            raise AssertionError(f"{CONFIG.name} K={k}: graph == eager by step {equal}, "
                                 f"captures {captures}")
        # timing, in turns: eager, graphs, graphs, eager (at scale 1: the first
        # eager turn is the plain run the scale switch moved away from)
        ms, peak, plain = {"eager": [], "graphs": []}, {}, None
        for arm in ("eager", "graphs", "graphs", "eager"):
            run = (lambda: _eager_steps(engine, tier, fb, cache_len)) if arm == "eager" else \
                (lambda: _graph_steps(engine, tier, fb, cache_len, steps))
            out, t, p = peak_of(run)
            ms[arm].append(t)
            peak.setdefault(arm, p)
            plain = out if plain is None else plain
        moved = [not torch.equal(a, b) for a, b in zip(eager, plain)]
        if any(moved[:switch + 1]) or not moved[switch + 1]:
            raise AssertionError(f"{CONFIG.name} K={k}: the scale moved steps {moved}")
        cache = engine._batch_cache(fb["bb"], cache_len)
        tier.fill(steps[0], fb["table"], tokens=fb["tok_np"], lengths=fb["lengths_np"])
        prefill_ms = {"graphs": _wall_ms(lambda: steps[0](cache))[1]}
        (cache_e, logits_e), prefill_ms["eager"] = _wall_ms(lambda: tier.prefill(
            fb["tok"], fb["lengths"], fb["table"], cache_len, noise_scale=engine._scale_arr()))
        tok_e = torch.argmax(logits_e, dim=-1)
        decode = steps[1]
        tier.fill(decode, fb["table"], fold=fb["lengths_np"], pos=fb["lengths_np"],
                  lengths=fb["lengths_np"])
        decode.static["tok"].copy_(tok_e)
        prof = {"eager": _profile(lambda: tier.decode(cache_e, tok_e, fb["lengths_np"],
                                                      fb["table"], fb["lengths_np"],
                                                      noise_scale=engine._scale_arr()))[1],
                "graphs": _profile(lambda: decode(cache))[1]}
        # prefill once, then GRAPH_STEPS decode steps: the decode share of a run
        step_ms = {a: (sum(v) / len(v) - prefill_ms[a]) / GRAPH_STEPS for a, v in ms.items()}
        row = dict(config=CONFIG.name, k=k, bucket=[fb["bb"], fb["sb"]], cache_len=cache_len,
                   steps=GRAPH_STEPS, logits_equal=True, scale_moved_from_step=switch + 1,
                   first_run_ms=first_ms, capture_s=[s.capture_s[0] for s in steps],
                   run_ms=ms, prefill_ms=prefill_ms, decode_ms=step_ms,
                   device_ms={a: p["device_ms"] for a, p in prof.items()},
                   idle_share={a: max(0.0, 1.0 - prof[a]["device_ms"] / step_ms[a])
                               for a in prof},
                   top_graphs=prof["graphs"]["top"][:4],
                   peak_above_gib=dict(eager=eager_peak, graphs_first_run=first_peak,
                                       graphs_warm=peak["graphs"]),
                   reserved_gib=torch.cuda.memory_reserved() / 2**30, card=card())
        log("graphs_steps", **row)
        rows.append(row)
        steps = cache = cache_e = decode = None
        engine = None
    if not full:
        return None

    # through the engine's cache
    out = {}
    for mode in ("sync", "pooled"):
        kw = dict(continuous=True, pool_slots=POOL_SLOTS) if mode == "pooled" else {}
        engine = make_engine("auto", **kw)
        cold, cold_s, _, cold_st = _serve_keys(engine, prompts, tiers)
        entries = [dict(phase=key[0], shape=list(key[1:-3] if key[0] != "insert" else key[1:]),
                        tier=key[-3] if key[0] != "insert" else None,
                        first_use_s=sum(step.capture_s), captures=len(step.capture_s))
                   for key, step in engine.exe_cache.entries()]
        engine.exe_cache.reset_stats()
        batches = engine.stats["batches"]
        warm, warm_s, launches, warm_st = _serve_keys(engine, prompts, tiers)
        batches = engine.stats["batches"] - batches
        same = all(np.array_equal(cold[i], warm[i]) for i in cold)
        if warm_st["misses"] or not same:
            raise AssertionError(f"{mode}: warm replay {warm_st}, tokens equal {same}")
        if mode == "sync" and warm_st["hits"] != 2 * batches:
            raise AssertionError(f"sync: {warm_st['hits']} hits for {batches} batches")
        engine.set_noise_scale(GRAPH_SCALE)
        scaled, _, _, scaled_st = _serve_keys(engine, prompts, tiers)
        engine.set_noise_scale(1.0)
        moved = sum(int((scaled[i] != warm[i]).sum()) for i in warm)
        if scaled_st["misses"] or moved == 0:
            raise AssertionError(f"{mode}: scale {GRAPH_SCALE}: {scaled_st}, tokens moved {moved}")
        log("graphs_engine", config=CONFIG.name, mode=mode, requests=len(prompts),
            cold_s=cold_s, warm_s=warm_s, cold_stats=cold_st, warm_stats=warm_st,
            warm_batches=batches, warm_equals_cold=same, scaled_stats=scaled_st,
            scaled_tokens_moved=moved, entries=entries, launches=launches,
            generated_tokens_per_s_warm=len(prompts) * SERVE_MAX_GEN / warm_s, card=card())
        out[mode] = dict(engine=engine, tokens=warm, launches=launches)
    # a request alone equals its batch, under replay
    engine = out["sync"]["engine"]
    fb = _first_batch(engine, prompts, tiers)
    uid = fb["first"][-1]
    solo, _, _, solo_st = _serve_keys(engine, prompts, tiers, [uid])
    equal = bool(np.array_equal(solo[uid], out["sync"]["tokens"][uid]))
    log("graphs_solo", config=CONFIG.name, uid=uid, batch=fb["first"], solo_equals_batched=equal,
        stats=solo_st, card=card())
    if not equal:
        raise AssertionError(f"request {uid} alone {solo[uid]} != batched")
    return out["sync"]["launches"]


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
    log("granite20_long", config=CONFIG.name, layers=CONFIG.n_layers,
        prompt_len=DENSE_LONG_PROMPT,
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
    log("xlstm_long", config=CONFIG.name, layers=CONFIG.n_layers,
        prompt_len=XLSTM_LONG_PROMPT,
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

# ---------------------------------------------------------------------------
# the paper's CNN path: analog convolution through the simt route
# ---------------------------------------------------------------------------

#: the conv phase: ResNet-50's convolutions at this batch from 224 x 224,
#: shot noise at this energy (aJ/MAC), K = 1 and 4, with and without the
#: paper's 8-bit input, weight and output quantizers (App. A)
CONV_B, CONV_E, CONV_REPEATS = 16, 20.0, (1, 4)
#: the paper-table CNN (``benchmarks/common.py`` ``build_cnn``): its
#: channels, classes, images and their side
CNN_CHANNELS, CNN_CLASSES, CNN_IMAGES, CNN_SIZE = ((3, 16), (16, 32), (32, 32)), 10, 256, 16
#: the shape whose faulty controls the conv phase shows
CONV_CONTROL = "s2 3x3/2 128->128"
#: conv1's batch run in one call against plain: above 334 images, the most
#: that 65,535 row tiles of 64 rows would hold
CONV_BIG = 400


def resnet50_convs() -> list:
    """ResNet-50's 23 distinct convolution shapes (He et al. 2016, Table 1,
    50-layer; the stride on the 3x3, as torchvision's ``resnet50``) and its
    fc: (name, input side, kernel side, stride, Cin, Cout, occurrences in
    one forward). Stages of 3, 4, 6 and 3 bottleneck blocks give 53
    convolutions; stage 1's projection has its expand's shape."""
    convs = [("conv1 7x7/2 3->64", 224, 7, 2, 3, 64, 1),
             ("s1 1x1 64->64", 56, 1, 1, 64, 64, 1),
             ("s1 3x3 64->64", 56, 3, 1, 64, 64, 3),
             ("s1 1x1 64->256 (expand, projection)", 56, 1, 1, 64, 256, 4),
             ("s1 1x1 256->64", 56, 1, 1, 256, 64, 2)]
    for s, (side, blocks, cin, mid) in enumerate(((56, 4, 256, 128), (28, 6, 512, 256),
                                                   (14, 3, 1024, 512)), 2):
        out, big = side // 2, 4 * mid
        convs += [(f"s{s} 1x1 {cin}->{mid}", side, 1, 1, cin, mid, 1),
                  (f"s{s} 3x3/2 {mid}->{mid}", side, 3, 2, mid, mid, 1),
                  (f"s{s} 3x3 {mid}->{mid}", out, 3, 1, mid, mid, blocks - 1),
                  (f"s{s} 1x1 {mid}->{big}", out, 1, 1, mid, big, blocks),
                  (f"s{s} 1x1/2 {cin}->{big} (projection)", side, 1, 2, cin, big, 1),
                  (f"s{s} 1x1 {big}->{mid}", out, 1, 1, big, mid, blocks - 1)]
    assert len(convs) == 23 and sum(c[-1] for c in convs) == 53
    return convs


def _conv_cfgs():
    """(shot, shot with the 8-bit quantizers) on the card's backend."""
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.noise import SHOT, NoiseSpec

    return AnalogConfig.shot(), AnalogConfig(mode="analog", noise=NoiseSpec(kind=SHOT))


def _conv_quant(patches, w_mat):
    """Min/max quantizers of a conv site: per-channel weight, per-tensor
    input and output."""
    from repro_torch.core.analog import SiteQuant
    from repro_torch.quant.affine import calibrate_minmax

    return SiteQuant(wqp=calibrate_minmax(w_mat, channel_axis=1), xqp=calibrate_minmax(patches),
                     oqp=calibrate_minmax(patches @ w_mat))


def _conv_close(yk, yr, sq):
    """(max |err|, atol, ok) under the kernel rule: ``3e-5 max|y|`` plus
    ``1e-4 |y|``, one output-quantizer bin under requant."""
    import torch

    atol = REL_ATOL * (float(yr.abs().max()) + 1e-6)
    if sq is not None:
        atol = max(atol, float(sq.oqp.delta) * 1.01)
    err = (yk - yr).abs()
    ok = bool((err <= atol + RTOL * yr.abs()).all()) and bool(torch.isfinite(yk).all())
    return float(err.max()), atol, ok


def _conv_site(name, side, kh, stride, cin, cout, seed, b=CONV_B):
    """One site's f32 input (b, side, side, Cin), HWIO kernel (1/sqrt(fan-in)
    scale) and seed words, from ``seed``; the fc (kh 0) is a (b, Cin) input
    and a (Cin, Cout) weight."""
    import torch

    from repro_torch.core.analog import key_seed
    from repro_torch.kernels import prng

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (b, cin) if kh == 0 else (b, side, side, cin)
    x = torch.randn(shape, generator=gen, device="cuda")
    wshape = (cin, cout) if kh == 0 else (kh, kh, cin, cout)
    k = torch.randn(wshape, generator=gen, device="cuda") / math.sqrt(max(kh, 1) ** 2 * cin)
    return x, k, key_seed(prng.PRNGKey(seed), "cuda")


def _conv_call(x, k, stride, cfg, seed, sq, reps, backend=None):
    """The site on ``backend`` (None: the card's): ``analog_conv2d`` at K = 1,
    ``analog_dot`` on its patches at K = 4 (the conv itself takes no K, as
    the reference's); the fc through ``analog_dot``."""
    import torch

    from repro_torch.core.analog import analog_conv2d, analog_dot, conv_patches, conv_weight_matrix

    if backend is not None:
        cfg = dataclasses.replace(cfg, backend=backend)
    e = torch.tensor(CONV_E, device=x.device)
    if x.dim() == 2:
        return analog_dot(x, k, cfg=cfg, energy=e, seed=seed, sq=sq, n_repeats=reps)
    if reps == 1:
        return analog_conv2d(x, k, cfg=cfg, stride=stride, energy=e, seed=seed, sq=sq)
    return analog_dot(conv_patches(x, k.shape[0], k.shape[1], stride), conv_weight_matrix(k),
                      cfg=cfg, energy=e, seed=seed, sq=sq, n_repeats=reps)


def _cnn_weights():
    import numpy as np

    rng = np.random.default_rng(0)
    ws = [(rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
          for cin, cout in CNN_CHANNELS]
    head_in = CNN_CHANNELS[-1][1]
    ws.append((rng.standard_normal((head_in, CNN_CLASSES)) / np.sqrt(head_in)).astype(np.float32))
    return ws


def _cnn_forward(images, ws, cfg, key):
    """``build_cnn``'s analog apply: three 3x3 convs (stride 1, then 2),
    ReLU, a spatial mean, an ``analog_dot`` head; conv i's seed is
    ``site_key(fold_in(key, i), "c<i>")``, the head's ``site_key(key,
    "head")``."""
    import torch

    from repro_torch.core.analog import analog_conv2d, analog_dot, fold_key, key_seed, site_key

    e = torch.tensor(CONV_E, device=images.device)
    h = images
    for i, kern in enumerate(ws[:-1]):
        h = analog_conv2d(h, kern, cfg=cfg, stride=2 if i else 1, energy=e,
                          seed=key_seed(site_key(fold_key(key, i), f"c{i}"), images.device))
        h = torch.relu(h)
    return analog_dot(h.mean(dim=(1, 2)), ws[-1], cfg=cfg, energy=e,
                      seed=key_seed(site_key(key, "head"), images.device))


def _conv2d_library(x, k, side, kh, stride):
    """``F.conv2d`` (f32; TF32 off, as ``main`` sets) of the site's NHWC
    input, padded as "SAME" pads it, and HWIO kernel, laid out NCHW / OIHW
    outside the timed call: the noise-free conv's library call."""
    import torch

    from repro_torch.core.analog import _same_pads

    (top, bottom), (left, right) = _same_pads(side, kh, stride), _same_pads(side, kh, stride)
    pad = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    w_oihw = k.permute(3, 2, 0, 1).contiguous()
    return lambda: torch.nn.functional.conv2d(pad, w_oihw, stride=stride)


def phase_conv():
    """The paper's CNN path on the card (``analog_conv2d``, f32 patches: the
    simt route), under ``torch.no_grad()``.

    Driven with the launch counts from zero: every ResNet-50 conv shape and
    the fc (``resnet50_convs``) at batch ``CONV_B``, shot noise at
    ``CONV_E`` aJ/MAC, K = 1 and 4, without and with the 8-bit quantizers,
    each against the plain version ("tile") under the kernel rule; then the
    paper-table CNN on ``CNN_IMAGES`` images of the port's
    ``make_image_dataset`` against plain end to end. Every launch must be
    simt's. Then, uncounted: faulty controls (another seed, K = 4 against
    K = 1, no noise) at ``CONV_CONTROL`` and the CNN's another key, which
    must fail the rule; each shape's kernel ms (L2 flushed), whole-call ms
    and bound (with the f32-SIMT bound beside it), its noise-free kernel ms
    beside ``torch.matmul``'s on the same patches and ``F.conv2d``'s, the
    forward's sums weighted by the shapes' occurrences, the heaviest shape's
    plain ms; each shape's peak bytes an image and the largest batch the
    card's free memory holds (no grid limit); conv1 at ``CONV_BIG`` images
    in one call against plain. Returns (launches by route, the kernels
    line's simt entry)."""
    import numpy as np
    import torch

    from repro_torch.core.analog import conv_patches, conv_weight_matrix
    from repro_torch.core.noise import NoiseSpec
    from repro_torch.data import make_image_dataset
    from repro_torch.kernels import analog_matmul as am
    from repro_torch.kernels import ops, prng
    from repro_torch.kernels.analog_matmul import analog_matmul_raw
    from repro_torch.kernels.ref import analog_matmul_ref_raw

    shot, quant = _conv_cfgs()
    sites = resnet50_convs() + [("fc 2048->1000", 1, 0, 1, 2048, 1000, 1)]
    rows = []
    torch.cuda.synchronize()
    _zero_launches()
    with torch.no_grad():
        for i, (name, side, kh, stride, cin, cout, occ) in enumerate(sites):
            x, k, seed = _conv_site(name, side, kh, stride, cin, cout, 100 + i)
            row = dict(site=name, input=list(x.shape), kernel=list(k.shape), stride=stride,
                       occurrences=occ, checks=[])
            for q in (False, True):
                sq = None
                if q:
                    p2 = x if kh == 0 else conv_patches(x, kh, kh, stride).reshape(-1, kh * kh * cin)
                    sq = _conv_quant(p2, k if kh == 0 else conv_weight_matrix(k))
                    p2 = None
                for reps in CONV_REPEATS:
                    cfg = quant if q else shot
                    yk = _conv_call(x, k, stride, cfg, seed, sq, reps)
                    yr = _conv_call(x, k, stride, cfg, seed, sq, reps, backend="tile")
                    err, atol, ok = _conv_close(yk, yr, sq)
                    row["checks"].append(dict(quant=q, n_repeats=reps, max_abs_err=err,
                                              atol=atol, ok=ok))
                    if not ok:
                        raise AssertionError(f"conv {name} quant={q} K={reps}: kernel vs plain "
                                             f"{err} > {atol}")
            row["rows"] = int(yk.numel() // cout)
            rows.append(row)
        images, labels = make_image_dataset(CNN_IMAGES, n_classes=CNN_CLASSES, size=CNN_SIZE,
                                            seed=5)
        images = torch.from_numpy(images).cuda()
        ws = [torch.from_numpy(w).cuda() for w in _cnn_weights()]
        key = prng.PRNGKey(0)
        logits = _cnn_forward(images, ws, shot, key)
        plain = _cnn_forward(images, ws, dataclasses.replace(shot, backend="tile"), key)
        torch.cuda.synchronize()
    launches = dict(am.LAUNCHES)
    cnn_err, cnn_atol, cnn_ok = _conv_close(logits, plain, None)
    if not cnn_ok or tuple(logits.shape) != (CNN_IMAGES, CNN_CLASSES):
        raise AssertionError(f"paper CNN: kernels vs plain {cnn_err} > {cnn_atol}")
    if set(r for r, n in launches.items() if n) != {"simt"}:
        raise AssertionError(f"the conv path launched {launches}, not simt alone")

    with torch.no_grad():
        controls = {}
        name, side, kh, stride, cin, cout, _ = next(s for s in sites if s[0] == CONV_CONTROL)
        x, k, seed = _conv_site(name, side, kh, stride, cin, cout, 7)
        want = _conv_call(x, k, stride, shot, seed, None, 1, backend="tile")
        other = seed.clone()
        other[1] += 1
        quiet = dataclasses.replace(shot, noise=NoiseSpec())
        for label, y in (("another seed", _conv_call(x, k, stride, shot, other, None, 1)),
                         ("K=4 against K=1", _conv_call(x, k, stride, shot, seed, None, 4)),
                         ("no noise", _conv_call(x, k, stride, quiet, seed, None, 1))):
            err, atol, ok = _conv_close(y, want, None)
            controls[label] = dict(max_abs_err=err, atol=atol, fails=not ok)
        y = _cnn_forward(images, ws, shot, prng.PRNGKey(1))
        err, atol, ok = _conv_close(y, plain, None)
        controls["paper CNN, another key"] = dict(max_abs_err=err, atol=atol, fails=not ok)
        if not all(c["fails"] for c in controls.values()):
            raise AssertionError(f"a faulty conv control passed the rule: {controls}")
        accuracy = float((logits.argmax(-1).cpu().numpy() == labels).mean())

        flush = _flush_buffer()
        free, total = torch.cuda.mem_get_info()
        for i, (row, (name, side, kh, stride, cin, cout, occ)) in enumerate(zip(rows, sites)):
            x, k, seed = _conv_site(name, side, kh, stride, cin, cout, 100 + i)
            e = torch.tensor(CONV_E, device="cuda")
            patches = x if kh == 0 else conv_patches(x, kh, kh, stride)
            w_mat = k if kh == 0 else conv_weight_matrix(k)
            o = ops.prepare_operands(patches.reshape(1, -1, w_mat.shape[0]), w_mat, energy=e,
                                     seed=seed.reshape(1, 4), cfg=shot)
            bound, by, detail = _bound(o, 1)
            p2, quiet = o["x"][0], dict(o, noise_kind="none")
            row.update(kernel_ms=cuda_ms(lambda: _run_raw(analog_matmul_raw, o, 1), 10, flush),
                       call_ms=cuda_ms(lambda: _conv_call(x, k, stride, shot, seed, None, 1), 5,
                                       flush),
                       bound_ms=bound, bound_by=by, f32_simt_bound_ms=detail["f32_simt"],
                       noise_free_ms=cuda_ms(lambda: _run_raw(analog_matmul_raw, quiet, 1), 10,
                                             flush),
                       matmul_ms=cuda_ms(lambda: torch.matmul(p2, w_mat), 10, flush),
                       conv2d_ms=None if kh == 0 else cuda_ms(
                           _conv2d_library(x, k, side, kh, stride), 10, flush))
            row["share_of_bound"] = bound / row["kernel_ms"]
            row["f32_simt_share"] = detail["f32_simt"] / row["kernel_ms"]
            p2 = quiet = None
            _free()
            base = torch.cuda.memory_allocated()
            _conv_call(x, k, stride, shot, seed, None, 1)
            torch.cuda.synchronize()
            per_image = (torch.cuda.max_memory_allocated() - base) / CONV_B
            # memory is the only limit: the grid enumerates row tiles on grid.x
            row.update(peak_bytes_an_image=per_image,
                       largest_batch=int(0.9 * free // per_image))
            x = k = patches = o = None
            log("conv_site", **{kk: v for kk, v in row.items() if kk != "checks"},
                checks=row["checks"], card=card())
        # the heaviest conv shape (by its bound) stands for simt in the kernels line
        i, row = max(enumerate(rows[:-1]), key=lambda ir: ir[1]["bound_ms"])
        name, side, kh, stride, cin, cout, _ = sites[i]
        x, k, seed = _conv_site(name, side, kh, stride, cin, cout, 100 + i)
        w_mat = conv_weight_matrix(k)
        o = ops.prepare_operands(conv_patches(x, kh, kh, stride).reshape(1, -1, w_mat.shape[0]),
                                 w_mat, energy=torch.tensor(CONV_E, device="cuda"),
                                 seed=seed.reshape(1, 4), cfg=shot)
        err, _, _ = _conv_close(_run_raw(analog_matmul_raw, o, 1),
                                _run_raw(analog_matmul_ref_raw, o, 1), None)
        _, _, detail = _bound(o, 1)
        head = dict(
            name="analog_matmul.simt", route="cuda", source=SOURCE["simt"], replaces=REPLACES,
            launches=launches["simt"], max_abs_err=err, ms=row["kernel_ms"],
            plain_ms=cuda_ms(lambda: _run_raw(analog_matmul_ref_raw, o, 1), 3, flush),
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None, site=name,
            shape=list(o["x"].shape) + [w_mat.shape[1]], noise="output", n_repeats=1,
            bound_terms_ms=detail, f32_simt_share=row["f32_simt_share"],
            noise_free=dict(
                ms=row["noise_free_ms"],
                library="torch.nn.functional.conv2d (f32, on the padded NCHW input)",
                library_ms=row["conv2d_ms"],
                matmul="torch.matmul (f32, TF32 off, on the same patches)",
                matmul_ms=row["matmul_ms"]))
        x = k = o = None
        # conv1 above the old grid's 334 images, in one call, against plain
        name, side, kh, stride, cin, cout, _ = sites[0]
        _free()
        x, k, seed = _conv_site(name, side, kh, stride, cin, cout, 3, b=CONV_BIG)
        y = _conv_call(x, k, stride, shot, seed, None, 1)
        want = _conv_call(x, k, stride, shot, seed, None, 1, backend="tile")
        torch.cuda.synchronize()
        big_err, big_atol, big_ok = _conv_close(y, want, None)
        big_rows = int(y.numel() // cout)
        x = y = want = None
        _free()
    if not big_ok:
        raise AssertionError(f"conv1 at batch {CONV_BIG}: kernel vs plain {big_err} > {big_atol}")
    total = {t: sum(r[t] * r["occurrences"] for r in rows)
             for t in ("kernel_ms", "call_ms", "bound_ms", "f32_simt_bound_ms", "noise_free_ms",
                       "matmul_ms")}
    log("conv", batch=CONV_B, energy_aj=CONV_E, sites=len(rows),
        convolutions_a_forward=sum(r["occurrences"] for r in rows[:-1]),
        forward_kernel_ms=total["kernel_ms"], forward_call_ms=total["call_ms"],
        forward_bound_ms=total["bound_ms"],
        forward_share_of_bound=total["bound_ms"] / total["kernel_ms"],
        forward_f32_simt_bound_ms=total["f32_simt_bound_ms"],
        forward_f32_simt_share=total["f32_simt_bound_ms"] / total["kernel_ms"],
        forward_noise_free_ms=total["noise_free_ms"], forward_matmul_ms=total["matmul_ms"],
        launches=launches, cnn=dict(images=CNN_IMAGES, size=CNN_SIZE, max_abs_err=cnn_err,
                                    atol=cnn_atol, accuracy_random_weights=accuracy),
        controls=controls, largest_batch_by_memory={r["site"]: r["largest_batch"] for r in rows},
        conv1_big=dict(images=CONV_BIG, rows=big_rows, max_abs_err=big_err, atol=big_atol,
                       ok=big_ok),
        card=card())
    return launches, head


# ---------------------------------------------------------------------------
# data-parallel training with ZeRO-1 moments
# ---------------------------------------------------------------------------

#: the train_dp phase (granite-3-8b at full width, bf16 weights and moments,
#: ``TrainConfig()``): data shards, rows and positions a step (each shard its
#: half), steps, and what the depth reckoning holds back a rank beside its
#: state (one layer's recompute at its rows, a loss chunk's logits, Adam's
#: f32 slices, its CUDA context and the allocator's slack)
TRAIN_DP, TRAIN_DP_B, TRAIN_DP_T, TRAIN_DP_STEPS = 2, 4, 2048, 3
TRAIN_DP_RESERVE_BYTES = 7 * 2**30
#: ... run at this many layers, cut from the reckoned depth (19 of 40 on an
#: H100 80GB, whose three forms were bit-equal there too) for the whole
#: run's time: on one card the ranks' collectives go through gloo on the
#: host at 0.4-0.65 GB/s, and a step at 19 layers moved 12.6 GB a rank
#: (35 s), at 8 layers 6.0 GB (13 s), at 4 3.6 GB (10 s)
TRAIN_DP_LAYERS = 4
#: the LM calibration on the data mesh (``calibrate_dp``, run by the
#: train_dp ranks after their train steps, at their depth): rows,
#: positions, steps; shot noise on the "torch" backend from
#: ``CAL_LM_INIT_MULT`` x ``CAL_LM_TARGET``. The one-device form holds the
#: same noise (each shard draws the whole call and takes its rows) and sums
#: in another order: its loss and NLL within ``CAL_DP_REL`` relative and
#: its log energies within ``CAL_DP_LOG_E`` (4e-3 ``CAL_LM_LR``), both set
#: from the card's readings (PERF.md); ``scripts/calibrate_dp_control.py``
#: plants a shard that takes the wrong rows of the noise and shows where it
#: lands against them
CAL_DP_B, CAL_DP_T, CAL_DP_STEPS = 4, 512, 2
CAL_DP_REL, CAL_DP_LOG_E = 1e-4, 2e-4
#: the train_tp phase: granite-3-8b at full width and train_dp's depth,
#: positions and steps, ``TRAIN_TP_B`` rows (half train_dp's, for the
#: run's time), on ``TRAIN_TP`` tensor shards, three ways (the one-device
#: step, the local form in this process, ``TRAIN_TP`` gloo processes on the
#: card: train_dp's own processes when the run has both phases). The local
#: form and the ranks run the same shards and add in the same order: equal
#: bit for bit. Both hold the one-device step's loss and gradient norm
#: within ``TRAIN_TP_REL`` (relative; bf16 partials summed over the
#: shards), set from the card's readings (PERF.md); a rank holds at most
#: ``TRAIN_TP_PARAM_SHARE`` of one device's parameter bytes
TRAIN_TP, TRAIN_TP_B, TRAIN_TP_REL, TRAIN_TP_PARAM_SHARE = 2, 2, 2e-3, 0.6
#: the calibrate_tp phase: the LM calibration at train_tp's model, depth and
#: shards, ``CAL_TP_B`` x ``CAL_DP_T``, ``CAL_DP_STEPS`` steps, shot noise on
#: the "torch" backend, three ways (one device, the local form, train_tp's
#: ranks after their train steps). Local == ranks bit for bit; the local
#: form holds the one-device step's loss and NLL within ``CAL_TP_REL``
#: (relative) and its log energies within ``CAL_TP_LOG_E`` (absolute): the
#: row-cut sites' partials are summed over the shards before their noise,
#: in another order than one device's product. calibrate_dp's bounds (the
#: log energies' is 4e-3 ``CAL_LM_LR``: Adam's normalised second step can
#: amplify a small gradient's difference); the card's reading sits 5x and
#: 70x inside them (PERF.md)
CAL_TP_B = 2
CAL_TP_REL, CAL_TP_LOG_E = CAL_DP_REL, CAL_DP_LOG_E
#: a checkpointed region's recompute (``models/sharding.py`` ``remat``):
#: data shard 1's energy gradients in one calibrate step with every
#: checkpoint on equal a step's that checkpoints nothing bit for bit; the
#: control, whose recompute drops the places (the autograd device thread's
#: empty thread-local state), lies at least 5x this distance from them
#: (largest |difference| over the largest |gradient|)
CAL_REMAT_REL = 1e-4
#: train_tp's ranks' results when train_dp's processes ran them after
#: their own steps (no second pair of processes to start and warm)
_TP_RANKS: list = []
#: calibrate_tp's ranks' results (run by train_tp's ranks after their steps)
_CAL_TP_RANKS: list = []
#: the train phases' programs (phase -> (config, rows, positions, the
#: measured peak bytes[, tensor shards])), for the dry run's reckoning
TRAIN_PEAKS: dict = {}
#: the reckoned peak against the measured one, relative; the small real
#: step of the FLOP check (layers, rows, positions)
DRYRUN_PEAK_REL = 0.15
DRYRUN_STEP = (2, 2, 512)


def train_dp_depth(CONFIG) -> int:
    """The most layers of ``CONFIG`` whose ``TRAIN_DP`` ranks' training
    state fits ``TRAIN_PEAK_SHARE`` of the card, as ``train_depth``
    reckons it for a rank: 6 bytes a parameter (bf16 weights and gradients,
    half of the two bf16 moments), its layers' saved inputs (its rows x
    positions x d bf16) and ``TRAIN_DP_RESERVE_BYTES``."""
    import torch

    _, total = torch.cuda.mem_get_info()
    c = CONFIG
    heads = 1 if c.tie_embeddings else 1 + c.n_codebooks
    fixed = heads * c.vocab_size * c.d_model
    per_layer = (c.param_count() - fixed) / c.n_layers
    fixed += heads * (c.padded_vocab - c.vocab_size) * c.d_model
    saved = TRAIN_DP_B // TRAIN_DP * TRAIN_DP_T * c.d_model * 2
    depth = int((TRAIN_PEAK_SHARE * total - TRAIN_DP * (TRAIN_DP_RESERVE_BYTES + 6 * fixed))
                // (TRAIN_DP * (6 * per_layer + saved)))
    if depth < 1:
        raise AssertionError(f"{TRAIN_DP} ranks of {c.name} fit no layer")
    return min(c.n_layers, depth)


def _fingerprint(tree) -> list:
    """Bit fingerprint of a tree of tensors on the card: for each leaf and
    each of its ``leading_slices``, the sum of its 16-bit words and their
    sum weighted by (position mod 65,521) + 1, both exact in int64. Equal
    trees give equal lists; a changed bit changes the first sum, a moved
    word the second."""
    import torch

    from repro_torch.optim.adam import leading_slices
    from repro_torch.tree import leaves

    out = []
    for t in leaves(tree):
        words = t.contiguous().reshape(-1).view(torch.int16)
        for sl in leading_slices(words):
            v = words[sl].to(torch.int64) & 0xFFFF
            w = torch.arange(v.numel(), device=v.device, dtype=torch.int64) % 65521 + 1
            out.append([int(v.sum()), int((v * w).sum())])
    return out


def _dp_cfg(n_layers):
    from repro_torch.configs import reduced_depth
    from repro_torch.configs.granite_3_8b import CONFIG

    return reduced_depth(CONFIG, n_layers=n_layers, name=CONFIG.name)


def _dp_run(cfg, mesh, microbatches, profile=False, keep=False, counting=None,
            prints=_fingerprint, rows=TRAIN_DP_B) -> dict:
    """``TRAIN_DP_STEPS`` train steps from seed 0 on ``markov_batch``es of
    ``rows`` x ``TRAIN_DP_T`` (a mesh or one device; a rank of a
    tensor mesh on its shard of the weights): each step's loss, gradient
    norm, parameters' ``prints`` and ms; the steps' peak (the state held),
    the parameters' and moments' bytes here and the analog launches (none
    expected). With ``profile``, the last step profiled (device ms,
    kernels); ``keep``: the parameters returned too; ``counting``: a dict
    whose ``"on"`` is True while a step runs."""
    import torch

    from repro_torch.data.pipeline import TokenTaskConfig, markov_batch
    from repro_torch.kernels import analog_matmul as am
    from repro_torch.launch.steps import TrainConfig, make_opt_init, make_train_step, shard_params
    from repro_torch.models import lm
    from repro_torch.tree import leaves

    tcfg = TrainConfig(microbatches=microbatches)
    data = TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_DP_T, global_batch=rows,
                           seed=7)
    before = sum(am.LAUNCHES.values())
    _free()
    state = [shard_params(lm.init_params(cfg, seed=0, device="cuda"), cfg, mesh)]
    _free()
    state.append(make_opt_init(cfg, mesh, tcfg)(state[0]))
    step = make_train_step(cfg, mesh, tcfg)
    out = dict(losses=[], grad_norms=[], prints=[], step_ms=[], peak_gib=0.0)
    counting = {} if counting is None else counting
    for i in range(TRAIN_DP_STEPS):
        def one(i=i):
            counting["on"] = True
            state[0], state[1], m = step(state[0], state[1], markov_batch(data, i))
            counting["on"] = False
            return m
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if profile and i == TRAIN_DP_STEPS - 1:
            m, prof = _profile(one)
            ms = prof["profiled_wall_ms"]
            out.update(device_ms=prof["device_ms"], kernels_a_step=prof["kernels"],
                       top=prof["top"])
        else:
            m, ms = _wall_ms(one)
        out["peak_gib"] = max(out["peak_gib"], torch.cuda.max_memory_allocated() / 2**30)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["prints"].append(prints(state[0]))
        out["step_ms"].append(ms)
    out["moment_bytes"] = sum(t.numel() * t.element_size()
                              for t in leaves(state[1].mu) + leaves(state[1].nu))
    out["param_bytes"] = sum(t.numel() * t.element_size() for t in leaves(state[0]))
    out["analog_launches"] = sum(am.LAUNCHES.values()) - before
    if keep:
        out["params"] = leaves(state[0])
    state = None
    _free()
    return out


def _cal_setup(cfg, mesh, rows, seed=0):
    """A ``make_calibrate_step`` on ``mesh`` with its inputs: bf16 weights
    from seed 0 (a tensor rank's shard of them, ``shard_params``), uniform
    log energies at ``CAL_LM_INIT_MULT`` x ``CAL_LM_TARGET`` and their Adam
    state, shot noise on the "torch" backend, ``markov_batch``es of
    ``rows`` x ``CAL_DP_T`` from ``seed``: (step, params, log_e, opt,
    data)."""
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.energy import uniform_log_energies
    from repro_torch.data.pipeline import TokenTaskConfig
    from repro_torch.launch.steps import make_calibrate_step, shard_params
    from repro_torch.models import lm
    from repro_torch.optim.adam import AdamConfig, adam_init
    from repro_torch.tree import map_leaves

    params = shard_params(lm.init_params(cfg, seed=0, device="cuda"), cfg, mesh)
    step = make_calibrate_step(cfg, mesh, analog_cfg=AnalogConfig.shot(backend="torch"),
                               seq_len=CAL_DP_T, target_e_per_mac=CAL_LM_TARGET, lam=CAL_LM_LAM,
                               lr=CAL_LM_LR)
    log_e = map_leaves(lambda _p, t: t.cuda(),
                       uniform_log_energies(step.macs, CAL_LM_INIT_MULT * CAL_LM_TARGET))
    data = TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=CAL_DP_T, global_batch=rows,
                           seed=7 + seed)
    return step, params, log_e, adam_init(log_e, AdamConfig(lr=CAL_LM_LR)), data


def _cal_dp_run(cfg, mesh, seed=0, rows=CAL_DP_B, counting=None) -> dict:
    """``CAL_DP_STEPS`` LM calibration steps (``make_calibrate_step`` on
    ``mesh``: a data x tp mesh, a rank of one, or one device; ``_cal_setup``)
    of ``rows`` x ``CAL_DP_T``, batches and noise keys from ``seed``: each
    step's loss, NLL and ms, the steps' peak GiB, the log energies (their
    values and fingerprint) and E a MAC after the steps. ``counting``: a
    dict whose ``"on"`` is True while a step runs."""
    import torch

    from repro_torch.core.energy import avg_energy_per_mac, to_energy
    from repro_torch.data.pipeline import markov_batch
    from repro_torch.kernels import prng
    from repro_torch.tree import leaves

    _free()
    step, params, log_e, opt, data = _cal_setup(cfg, mesh, rows, seed)
    counting = {} if counting is None else counting
    out = dict(losses=[], nlls=[], step_ms=[], peak_gib=0.0)
    for i in range(CAL_DP_STEPS):
        def one(i=i):
            counting["on"] = True
            res = step(log_e, opt, params, markov_batch(data, i),
                       prng.fold_in(prng.PRNGKey(seed), i))
            counting["on"] = False
            return res
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (log_e, opt, m), ms = _wall_ms(one)
        out["peak_gib"] = max(out["peak_gib"], torch.cuda.max_memory_allocated() / 2**30)
        out["losses"].append(float(m["loss"]))
        out["nlls"].append(float(m["nll"]))
        out["step_ms"].append(ms)
    with torch.no_grad():
        out["e_per_mac"] = float(avg_energy_per_mac(to_energy(log_e), step.macs))
    out["log_e"] = [t.float().cpu().reshape(-1).tolist() for t in leaves(log_e)]
    out["prints"] = _fingerprint(log_e)
    params = None
    _free()
    return out


def _remat_check(cfg, tp) -> dict:
    """A checkpointed region's recompute under its data shard's place: one
    calibrate step (``_cal_setup``, ``CAL_DP_B`` rows) in the local form
    of ``TRAIN_DP`` data x ``tp`` tensor shards, three ways, and data shard
    1's energy gradients on each tensor shard (``steps._grads_of``' calls
    for that shard, before their sum over tp): ``cfg.remat`` on with every
    checkpoint of the port (``sharding.remat``: the layer groups and each
    lm_head chunk of the loss; on the card their recompute runs on the
    autograd device thread), ``eager`` (remat off and ``sharding.remat`` a
    plain call: nothing checkpointed), and the control (every checkpoint,
    its recompute under no places at all, as the autograd device thread saw
    them before ``remat`` re-entered them). The remat gradients and
    the control's against the eager ones: bit-equal, and the largest
    |difference| over the largest |gradient|; ms of each step."""
    import torch
    import torch.utils.checkpoint

    from repro_torch.data.pipeline import markov_batch
    from repro_torch.kernels import prng
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh_for_devices
    from repro_torch.models import sharding
    from repro_torch.tree import leaves

    mesh = make_mesh_for_devices(tp, data=TRAIN_DP)
    per = max(1, tp)  # _grads_of calls a data shard: one a tensor shard
    ways = {"remat": sharding.remat, "eager": lambda fn, *args: fn(*args),
            "control": lambda fn, *args: torch.utils.checkpoint.checkpoint(
                fn, *args, use_reentrant=False,
                context_fn=lambda: (contextlib.nullcontext(), sharding._within({})))}
    plain_remat, plain_grads = sharding.remat, steps._grads_of
    grads, ms = {}, {}
    try:
        for how, remat in ways.items():
            got = []

            def grads_of(tree, got=got):
                g = plain_grads(tree)
                got.append([t.detach().clone() for t in leaves(g)])
                return g

            _free()
            step, params, log_e, opt, data = _cal_setup(
                dataclasses.replace(cfg, remat=how != "eager"), mesh, CAL_DP_B)
            sharding.remat, steps._grads_of = remat, grads_of
            _, ms[how] = _wall_ms(lambda: step(log_e, opt, params, markov_batch(data, 0),
                                               prng.fold_in(prng.PRNGKey(0), 0)))
            sharding.remat, steps._grads_of = plain_remat, plain_grads
            grads[how] = [g for shard in got[per:2 * per] for g in shard]
            step = params = log_e = opt = None
    finally:
        sharding.remat, steps._grads_of = plain_remat, plain_grads
    _free()

    def rel(a, b):
        return (max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))
                / max(float(y.float().abs().max()) for y in b))

    want = grads["eager"]
    return dict(remat_bit_equal=all(torch.equal(x, y) for x, y in zip(grads["remat"], want)),
                remat_rel=rel(grads["remat"], want), control_rel=rel(grads["control"], want),
                grad_tensors=len(want), step_ms=ms, data_shards=TRAIN_DP, tensor_shards=tp)


def _check_remat(phase, r) -> None:
    """``_remat_check``'s verdict: the remat gradients bit-equal to the
    eager ones, the control at least 5x ``CAL_REMAT_REL`` from them."""
    if not (r["remat_bit_equal"] and r["control_rel"] >= 5 * CAL_REMAT_REL):
        raise AssertionError(f"{phase}: a recompute's data-shard place: {r} "
                             f"(the control's bound {5 * CAL_REMAT_REL})")


def _train_dp_worker(rank, port, out_dir, n_layers, with_tp=False, with_cal=False):
    """One rank of the distributed form: a gloo group of ``TRAIN_DP`` ranks
    on the one card (NCCL refuses two ranks on one device), CUDA tensors
    staged through pinned host memory by ``launch/collectives.py``; the
    collectives' seconds and bytes a step counted; ``with_tp``: then
    train_tp's distributed form on the same group (``_tp_rank_run``), and
    with ``with_cal`` calibrate_tp's; its results written to
    ``out_dir/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import make_mesh_for_devices
    from repro_torch.launch.steps import zero1_regions
    from repro_torch.tree import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=TRAIN_DP, rank=rank)
    try:
        mesh = make_mesh_for_devices(1, group=dist.group.WORLD, data=TRAIN_DP)
        cfg = _dp_cfg(n_layers)
        # gloo's own rate: an all_gather of 256 MB pinned host buffers
        pin = torch.cuda.is_available()
        probe = torch.zeros(2**28, dtype=torch.uint8, pin_memory=pin)
        outs = [torch.empty(2**28, dtype=torch.uint8, pin_memory=pin) for _ in range(TRAIN_DP)]
        dist.all_gather(outs, probe)
        t0 = time.perf_counter()
        dist.all_gather(outs, probe)
        gloo_gb_s = probe.numel() * (TRAIN_DP - 1) / (time.perf_counter() - t0) / 1e9
        probe = outs = None
        spent = {"reduce_s": 0.0, "gather_s": 0.0, "reduce_bytes": 0, "gather_bytes": 0}

        def timed(fn, what):
            def wrap(t, *args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(t, *args)
                torch.cuda.synchronize()
                spent[f"{what}_s"] += time.perf_counter() - t0
                reg = args[0][rank] if what == "gather" else None
                spent[f"{what}_bytes"] += (t if reg is None else t[reg]).numel() * t.element_size()
                return out
            return wrap

        plain = collectives.sum_in_rank_order_, collectives.gather_regions_
        collectives.sum_in_rank_order_ = timed(collectives.sum_in_rank_order_, "reduce")
        collectives.gather_regions_ = timed(collectives.gather_regions_, "gather")
        res = _dp_run(cfg, mesh, 1, profile=True)
        res.update({k: v / TRAIN_DP_STEPS for k, v in spent.items()}, gloo_gb_s=gloo_gb_s,
                   rank=rank, cut=sum(r is not None for r in leaves(zero1_regions(cfg, mesh, rank))))
        spent.update({k: 0 for k in spent})
        res["calibrate"] = _cal_dp_run(cfg, mesh)
        res["calibrate"].update({k: v / CAL_DP_STEPS for k, v in spent.items()})
        collectives.sum_in_rank_order_, collectives.gather_regions_ = plain
        if with_tp:
            res["train_tp"] = _tp_rank_run(rank, n_layers, with_cal)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def phase_train_dp(with_tp=False, with_cal=False):
    """granite-3-8b at full width, trained on a data mesh of ``TRAIN_DP``
    shards with ZeRO-1 moments at ``TRAIN_DP_LAYERS`` layers (at most the
    depth ``train_dp_depth`` reckons, which the log names too):
    ``TRAIN_DP_STEPS`` steps of ``TRAIN_DP_B`` x ``TRAIN_DP_T`` three ways
    (the one-device step at ``microbatches = TRAIN_DP``, the local form in
    this process, the distributed form as ``TRAIN_DP`` processes on the
    card over gloo), each step's loss, gradient norm and parameters
    (``_fingerprint``) equal across the three and the ranks; ms a step,
    rank 0's device ms a step, the collectives' seconds and bytes a step,
    peak GiB a rank and moment bytes a rank against one device's. Training
    launches no analog kernel. ``with_tp`` (the run has train_tp too): the
    ranks then run train_tp's distributed form (``_TP_RANKS``), and with
    ``with_cal`` calibrate_tp's. calibrate_dp holds a checkpointed
    region's recompute to its data shard's place (``_remat_check``)."""
    import shutil
    import socket

    import torch
    import torch.multiprocessing as mp

    from repro_torch.configs.granite_3_8b import CONFIG
    from repro_torch.launch.mesh import make_mesh_for_devices

    fit = train_dp_depth(CONFIG)
    depth = min(fit, TRAIN_DP_LAYERS)
    cfg = _dp_cfg(depth)
    one = _dp_run(cfg, None, TRAIN_DP)
    local = _dp_run(cfg, make_mesh_for_devices(1, data=TRAIN_DP), 1)
    cal_one = _cal_dp_run(cfg, None)
    cal_local = _cal_dp_run(cfg, make_mesh_for_devices(1, data=TRAIN_DP))
    cal_remat = _remat_check(cfg, 1)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        with_tp = with_tp and TRAIN_TP == TRAIN_DP
        mp.start_processes(_train_dp_worker, args=(port, out_dir, depth, with_tp, with_cal),
                           nprocs=TRAIN_DP, start_method="spawn", join=True)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(TRAIN_DP):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    _TP_RANKS[:] = [r.pop("train_tp") for r in ranks] if with_tp else []
    _, total = torch.cuda.mem_get_info()
    keys = ("losses", "grad_norms", "prints")
    forms = {"one_device_microbatches": one, "local": local,
             **{f"rank{r['rank']}": r for r in ranks}}
    equal = {name: all(f[k] == one[k] for k in keys) for name, f in forms.items()}
    r0 = ranks[0]
    log("train_dp", config=cfg.name, layers=depth, fit_layers=fit, of_layers=CONFIG.n_layers,
        params=cfg.param_count(), data_shards=TRAIN_DP, batch=[TRAIN_DP_B, TRAIN_DP_T],
        rows_a_rank=TRAIN_DP_B // TRAIN_DP, losses=one["losses"], grad_norms=one["grad_norms"],
        equal_to_one_device=equal,
        step_ms={name: f["step_ms"] for name, f in forms.items()},
        ms_a_step=statistics.median(r0["step_ms"][1:-1]), device_ms=r0["device_ms"],
        idle_share=max(0.0, 1.0 - r0["device_ms"] / statistics.median(r0["step_ms"][1:-1])),
        kernels_a_step=r0["kernels_a_step"], top=r0["top"],
        reduce_ms=r0["reduce_s"] * 1e3, reduce_bytes=r0["reduce_bytes"],
        gather_ms=r0["gather_s"] * 1e3, gather_bytes=r0["gather_bytes"],
        gloo_gb_s_received_a_rank=r0["gloo_gb_s"],
        peak_gib={name: f["peak_gib"] for name, f in forms.items()},
        peak_share_two_ranks=sum(r["peak_gib"] for r in ranks) * 2**30 / total,
        moment_bytes={name: f["moment_bytes"] for name, f in forms.items()},
        moment_share_a_rank=r0["moment_bytes"] / one["moment_bytes"],
        leaves_cut=r0["cut"], spawn_s=spawn_s,
        analog_launches={name: f["analog_launches"] for name, f in forms.items()}, card=card())
    if not all(equal.values()):
        raise AssertionError(f"train_dp: the forms differ from one device: {equal}")
    if any(f["analog_launches"] for f in forms.values()):
        raise AssertionError("train_dp launched an analog kernel")
    if not all(map(math.isfinite, one["losses"])) or r0["moment_bytes"] > 0.6 * one["moment_bytes"]:
        raise AssertionError(f"train_dp: losses {one['losses']}, moments a rank "
                             f"{r0['moment_bytes']} of {one['moment_bytes']}")
    if sum(r["peak_gib"] for r in ranks) * 2**30 > TRAIN_PEAK_SHARE * total:
        raise AssertionError(f"train_dp: the ranks' peaks {[r['peak_gib'] for r in ranks]} GiB "
                             f"over {TRAIN_PEAK_SHARE} of the card")
    _check_calibrate_dp(cfg, cal_one, cal_local, [r["calibrate"] for r in ranks], cal_remat)


def _tp_counted(run) -> tuple:
    """``run(counting)`` with each tp exchange (every one passes
    ``collectives._gather``) made while ``counting["on"]`` is True timed
    and counted: (its result, the exchanges' seconds, calls and received
    bytes in all)."""
    import torch

    from repro_torch.launch import collectives

    counting = {"on": False}
    spent = {"s": 0.0, "calls": 0, "bytes": 0}
    gather = collectives._gather

    def timed(t, group):
        if not counting["on"]:
            return gather(t, group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gather(t, group)
        torch.cuda.synchronize()
        spent["s"] += time.perf_counter() - t0
        spent["calls"] += 1
        spent["bytes"] += t.numel() * t.element_size() * (len(out) - 1)
        return out

    collectives._gather = timed
    try:
        return run(counting), spent
    finally:
        collectives._gather = gather


def _tp_rank_run(rank, n_layers, with_cal=False) -> dict:
    """train_tp's distributed form in one rank of a gloo group of
    ``TRAIN_TP`` ranks on the one card, each holding its tensor shard of
    the weights: ``_dp_run``'s results (its parameters' fingerprint its
    shard's), with the tp collectives' seconds, calls and received bytes a
    step (``_tp_counted``); ``with_cal``: then calibrate_tp's rank, its
    ``_cal_dp_run`` on the same shards with its tp exchanges, under
    ``"calibrate_tp"``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_for_devices

    mesh = make_mesh_for_devices(TRAIN_TP, group=dist.group.WORLD)
    cfg = _dp_cfg(n_layers)
    res, spent = _tp_counted(lambda counting: _dp_run(cfg, mesh, 1, profile=True,
                                                      counting=counting, rows=TRAIN_TP_B))
    res.update({f"tp_{k}": v / TRAIN_DP_STEPS for k, v in spent.items()}, rank=rank)
    if with_cal:
        cal, spent = _tp_counted(lambda counting: _cal_dp_run(cfg, mesh, rows=CAL_TP_B,
                                                              counting=counting))
        cal.update({f"tp_{k}": v / CAL_DP_STEPS for k, v in spent.items()}, rank=rank)
        res["calibrate_tp"] = cal
    return res


def _train_tp_worker(rank, port, out_dir, n_layers, with_cal=False):
    """One rank of train_tp's distributed form in a process of its own
    (the run has no train_dp): ``_tp_rank_run``, written to
    ``out_dir/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=TRAIN_TP, rank=rank)
    try:
        res = _tp_rank_run(rank, n_layers, with_cal)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def phase_train_tp(with_cal=False):
    """granite-3-8b at full width trained on ``TRAIN_TP`` tensor shards
    (Megatron's column and row shards, the vocab-parallel loss) at
    train_dp's depth, positions and steps and ``TRAIN_TP_B`` rows, three
    ways: the one-device step, the local form in this process (the shards
    in turn inside each block), ``TRAIN_TP`` gloo processes on the card
    (train_dp's, ``_TP_RANKS``, when it ran; they share the card and talk
    through the host: correctness and a rank's memory, not speed). The
    local form equals the ranks bit for bit (losses, gradient norms, each
    tensor shard's ``_fingerprint``: rank t's shard against the local
    form's weights cut as rank t holds them); both hold the one-device
    step's losses and gradient norms within ``TRAIN_TP_REL``; a rank holds
    at most ``TRAIN_TP_PARAM_SHARE`` of one device's parameter bytes; no
    analog kernel runs. Logged: ms a step of each form, a rank's parameter
    and moment bytes against one device's, peak GiB a rank, the tp
    collectives' ms, calls and received bytes a step, the parameters'
    distance from one device's after the steps. ``with_cal``: the ranks
    run calibrate_tp's too (``_CAL_TP_RANKS``)."""
    import shutil
    import socket

    import torch
    import torch.multiprocessing as mp

    from repro_torch.configs.granite_3_8b import CONFIG
    from repro_torch.launch.mesh import make_mesh_for_devices
    from repro_torch.models.sharding import take_tensor_shard, tensor_plan

    depth = min(train_dp_depth(CONFIG), TRAIN_DP_LAYERS)
    cfg = _dp_cfg(depth)
    plan = tensor_plan(cfg, TRAIN_TP)
    one = _dp_run(cfg, None, 1, keep=True, rows=TRAIN_TP_B)
    local = _dp_run(cfg, make_mesh_for_devices(TRAIN_TP), 1, keep=True, rows=TRAIN_TP_B,
                    prints=lambda p: [_fingerprint(take_tensor_shard(p, plan, TRAIN_TP, t))
                                      for t in range(TRAIN_TP)])
    with torch.no_grad():
        diff = [(a.float() - b.float()).abs() for a, b in zip(local["params"], one["params"])]
        param_max = max(float(d.max()) for d in diff)
        param_equal = sum(int((d == 0).sum()) for d in diff) / sum(d.numel() for d in diff)
    diff = one["params"] = local["params"] = None
    _free()
    ranks, spawn_s = list(_TP_RANKS), None
    if not ranks:  # no train_dp processes ran them: processes of their own
        out_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_")
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            t0 = time.perf_counter()
            mp.start_processes(_train_tp_worker, args=(port, out_dir, depth, with_cal),
                               nprocs=TRAIN_TP,
                               start_method="spawn", join=True)
            spawn_s = time.perf_counter() - t0
            for r in range(TRAIN_TP):
                with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
    _CAL_TP_RANKS[:] = [r.pop("calibrate_tp") for r in ranks if "calibrate_tp" in r]
    forms = {"one_device": one, "local": local, **{f"rank{r['rank']}": r for r in ranks}}
    equal = {name: all(f[k] == local[k] for k in ("losses", "grad_norms"))
             for name, f in forms.items()}
    for r in ranks:  # rank r holds tensor shard r
        equal[f"rank{r['rank']}"] &= r["prints"] == [p[r["rank"]] for p in local["prints"]]
    rel = {name: max(abs(x - y) / abs(y) for k in ("losses", "grad_norms")
                     for x, y in zip(f[k], one[k])) for name, f in forms.items()}
    r0 = ranks[0]
    med = lambda f: statistics.median(f["step_ms"][1:])  # noqa: E731
    TRAIN_PEAKS["train_tp"] = (cfg, TRAIN_TP_B, TRAIN_DP_T,
                               max(r["peak_gib"] for r in ranks) * 2**30, TRAIN_TP)
    log("train_tp", config=cfg.name, layers=depth, of_layers=CONFIG.n_layers,
        params=cfg.param_count(), tensor_shards=TRAIN_TP, batch=[TRAIN_TP_B, TRAIN_DP_T],
        ranks_in="train_dp's processes" if spawn_s is None else "processes of their own",
        losses={n: f["losses"] for n, f in forms.items()},
        grad_norms={n: f["grad_norms"] for n, f in forms.items()},
        equal_to_local=equal, rel_to_one_device=rel, bound=TRAIN_TP_REL,
        param_max_abs_local_vs_one=param_max, param_share_bit_equal=param_equal,
        ms_a_step={n: med(f) for n, f in forms.items()},
        step_ms={n: f["step_ms"] for n, f in forms.items()},
        device_ms_rank0=r0["device_ms"], kernels_a_step_rank0=r0["kernels_a_step"],
        top_rank0=r0["top"],
        tp_collective_ms_a_step=r0["tp_s"] * 1e3, tp_collective_calls_a_step=r0["tp_calls"],
        tp_collective_bytes_received_a_step=r0["tp_bytes"],
        peak_gib={n: f["peak_gib"] for n, f in forms.items()},
        param_bytes={n: f["param_bytes"] for n, f in forms.items()},
        moment_bytes={n: f["moment_bytes"] for n, f in forms.items()},
        param_share_a_rank=r0["param_bytes"] / one["param_bytes"],
        moment_share_a_rank=r0["moment_bytes"] / one["moment_bytes"], spawn_s=spawn_s,
        analog_launches={n: f["analog_launches"] for n, f in forms.items()}, card=card())
    if not all(v for n, v in equal.items() if n != "one_device"):
        raise AssertionError(f"train_tp: the ranks differ from the local form: {equal}")
    if any(f["analog_launches"] for f in forms.values()):
        raise AssertionError("train_tp launched an analog kernel")
    if not (all(map(math.isfinite, local["losses"])) and rel["local"] <= TRAIN_TP_REL):
        raise AssertionError(f"train_tp: {rel['local']} from one device (bound {TRAIN_TP_REL}), "
                             f"losses {local['losses']}")
    if max(r["param_bytes"] for r in ranks) > TRAIN_TP_PARAM_SHARE * one["param_bytes"]:
        raise AssertionError(f"train_tp: a rank holds {[r['param_bytes'] for r in ranks]} of "
                             f"{one['param_bytes']} parameter bytes")


def cal_dp_diffs(a, b) -> tuple:
    """Two ``_cal_dp_run``s' largest relative difference of loss and NLL
    (over ``b``'s) and largest absolute difference of a log energy."""
    rel = max(abs(x - y) / abs(y) for k in ("losses", "nlls") for x, y in zip(a[k], b[k]))
    log_e = max(abs(x - y) for u, v in zip(a["log_e"], b["log_e"]) for x, y in zip(u, v))
    return rel, log_e


def _check_calibrate_dp(cfg, one, local, ranks, remat):
    """``calibrate_dp``'s line and checks: the local form and every rank
    equal bit for bit (losses, NLLs, log energies); the one-device form
    within ``CAL_DP_REL`` (loss, NLL) and ``CAL_DP_LOG_E`` (log
    energies); the recompute's place (``remat``, ``_check_remat``)."""
    keys = ("losses", "nlls", "prints")
    forms = {"one_device": one, "local": local, **{f"rank{r}": c for r, c in enumerate(ranks)}}
    equal = {name: all(f[k] == local[k] for k in keys) for name, f in forms.items()}
    rel, log_e_diff = cal_dp_diffs(local, one)
    log("calibrate_dp", config=cfg.name, layers=cfg.n_layers, data_shards=TRAIN_DP,
        batch=[CAL_DP_B, CAL_DP_T], steps=CAL_DP_STEPS, noise="shot", backend="torch",
        losses={n: f["losses"] for n, f in forms.items()},
        nlls={n: f["nlls"] for n, f in forms.items()},
        ms_a_step={n: statistics.median(f["step_ms"]) for n, f in forms.items()},
        step_ms={n: f["step_ms"] for n, f in forms.items()},
        collective_bytes_a_step={n: f.get("reduce_bytes", 0) for n, f in forms.items()},
        collective_ms_a_step={n: f.get("reduce_s", 0.0) * 1e3 for n, f in forms.items()},
        e_per_mac_after={n: f["e_per_mac"] for n, f in forms.items()},
        equal_to_local=equal, one_device_rel=rel, one_device_log_e_abs=log_e_diff,
        bounds=dict(rel=CAL_DP_REL, log_e_abs=CAL_DP_LOG_E),
        peak_gib={n: f["peak_gib"] for n, f in forms.items()},
        recompute=remat, recompute_control_bound=5 * CAL_REMAT_REL, card=card())
    if not all(v for n, v in equal.items() if n != "one_device"):
        raise AssertionError(f"calibrate_dp: the ranks differ from the local form: {equal}")
    if not (all(map(math.isfinite, local["losses"] + local["nlls"])) and rel <= CAL_DP_REL
            and log_e_diff <= CAL_DP_LOG_E):
        raise AssertionError(f"calibrate_dp: one device {rel} relative, log energies "
                             f"{log_e_diff}, losses {local['losses']}")
    _check_remat("calibrate_dp", remat)


def phase_calibrate_tp():
    """granite-3-8b's LM calibration on ``TRAIN_TP`` tensor shards (the
    analog sites' noise at the one-device call's place: a column shard's
    window, a row-cut site's noise once after the sum) at train_tp's
    depth: ``CAL_DP_STEPS`` steps of ``CAL_TP_B`` x ``CAL_DP_T``, shot
    noise on "torch", three ways: one device, the local form in this
    process, and train_tp's ranks (``_CAL_TP_RANKS``, run after their train
    steps). The local form equals the ranks bit for bit (losses, NLLs, log
    energies) and holds one device's within ``CAL_TP_REL`` and
    ``CAL_TP_LOG_E``; the recompute's place on ``TRAIN_DP`` data x
    ``TRAIN_TP`` tensor shards (``_remat_check``). Logged: each form's
    losses, NLLs and ms a step, the tp collectives' ms, calls and received
    bytes a step of a rank, peak GiB, the distance from one device."""
    from repro_torch.configs.granite_3_8b import CONFIG
    from repro_torch.launch.mesh import make_mesh_for_devices

    ranks = list(_CAL_TP_RANKS)
    if len(ranks) != TRAIN_TP:
        raise AssertionError(f"calibrate_tp: {len(ranks)} ranks ran it (train_tp's run them)")
    depth = min(train_dp_depth(CONFIG), TRAIN_DP_LAYERS)
    cfg = _dp_cfg(depth)
    one = _cal_dp_run(cfg, None, rows=CAL_TP_B)
    local = _cal_dp_run(cfg, make_mesh_for_devices(TRAIN_TP), rows=CAL_TP_B)
    remat = _remat_check(cfg, TRAIN_TP)
    forms = {"one_device": one, "local": local, **{f"rank{r['rank']}": r for r in ranks}}
    equal = {n: all(f[k] == local[k] for k in ("losses", "nlls", "prints"))
             for n, f in forms.items()}
    rel, log_e_diff = cal_dp_diffs(local, one)
    r0 = ranks[0]
    log("calibrate_tp", config=cfg.name, layers=depth, of_layers=CONFIG.n_layers,
        tensor_shards=TRAIN_TP, batch=[CAL_TP_B, CAL_DP_T], steps=CAL_DP_STEPS, noise="shot",
        backend="torch", losses={n: f["losses"] for n, f in forms.items()},
        nlls={n: f["nlls"] for n, f in forms.items()},
        ms_a_step={n: statistics.median(f["step_ms"]) for n, f in forms.items()},
        step_ms={n: f["step_ms"] for n, f in forms.items()},
        tp_collective_ms_a_step=r0["tp_s"] * 1e3, tp_collective_calls_a_step=r0["tp_calls"],
        tp_collective_bytes_received_a_step=r0["tp_bytes"],
        peak_gib={n: f["peak_gib"] for n, f in forms.items()},
        e_per_mac_after={n: f["e_per_mac"] for n, f in forms.items()},
        equal_to_local=equal, one_device_rel=rel, one_device_log_e_abs=log_e_diff,
        bounds=dict(rel=CAL_TP_REL, log_e_abs=CAL_TP_LOG_E), recompute=remat,
        recompute_control_bound=5 * CAL_REMAT_REL, card=card())
    if not all(v for n, v in equal.items() if n != "one_device"):
        raise AssertionError(f"calibrate_tp: the ranks differ from the local form: {equal}")
    if not (all(map(math.isfinite, local["losses"] + local["nlls"])) and rel <= CAL_TP_REL
            and log_e_diff <= CAL_TP_LOG_E):
        raise AssertionError(f"calibrate_tp: one device {rel} relative, log energies "
                             f"{log_e_diff}, losses {local['losses']}")
    _check_remat("calibrate_tp", remat)


# ---------------------------------------------------------------------------
# training and the LM calibration
# ---------------------------------------------------------------------------

#: the train phase (granite-3-8b at full width, bf16 weights, ``TrainConfig()``
#: defaults: bf16 moments, clip 1.0; remat): rows and positions a step, the
#: steps (the first untimed), the share of the card's memory
#: the reckoned depth may fill, and what the reckoning holds back beside the
#: weights, gradients, moments and the layers' saved inputs: one layer's
#: recompute, a loss chunk's logits and the allocator's slack
TRAIN_B, TRAIN_T, TRAIN_STEPS = 4, 2048, 6
TRAIN_PEAK_SHARE, TRAIN_RESERVE_BYTES = 0.8, 10 * 2**30
#: the least depth ``train_depth`` may reckon for each trained config:
#: recurrentgemma-2b and xlstm-1.3b train at full depth; grok-1's one layer
#: holds 4.9 B parameters (8 experts of 3 x 6,144 x 32,768), so one
TRAIN_MIN_LAYERS = {"granite-3-8b": 8, "recurrentgemma-2b": 26, "xlstm-1.3b": 48,
                    "grok-1-314b": 1}
#: the attention backward's check at one layer's shape (B, T, H, KH, D), f32
#: with TF32 off, against autograd through a plain masked softmax
ATTN_CHECK, ATTN_GRAD_REL = (1, 2048, 32, 8, 128), 1e-4
#: the driver phase (demo-100m of the training entry point, its optimizer):
#: steps, checkpoint interval, the steps that fail, positions and rows
DRIVER_STEPS, DRIVER_CKPT_EVERY, DRIVER_FAILS = 24, 8, (5, 17)
DRIVER_T, DRIVER_B = 256, 8
#: the LM calibration (the train phase's weights and depth, shot noise on the
#: "torch" backend): rows, positions, steps, the budget in aJ/MAC, and the
#: calibration example's penalty weight, learning rate and start (4x budget)
CAL_LM_B, CAL_LM_T, CAL_LM_STEPS, CAL_LM_TARGET = 4, 512, 4, 2.0
CAL_LM_LAM, CAL_LM_LR, CAL_LM_INIT_MULT = 20.0, 0.05, 4.0
#: the family train phases, each followed by the LM calibration on its
#: weights: phase -> (config, rows, positions, the calibration's positions
#: at ``CAL_LM_B`` rows). xlstm's sLSTM is a loop over time and its mLSTM
#: chunk scan a loop over requests (small launches, in the forward, the
#: recompute and the backward), and the host launches every kernel (on an
#: H100 80GB HBM3 at 700.00 W: 489,034 kernels and 17.5 s a step at 4 x 512,
#: 112,513 and 6.1 s at 4 x 64), so its rows and positions are cut to keep the
#: phase's seconds; grok's tokens are cut so that its expert buffers fit
#: beside 52 GB of state
FAMILY_TRAIN = {"train_griffin": ("recurrentgemma-2b", 4, 2048, CAL_LM_T),
                "train_xlstm": ("xlstm-1.3b", 2, 64, 64),
                "train_moe": ("grok-1-314b", 2, 1024, CAL_LM_T)}
#: a family phase's train steps (the first untimed), all on one batch so
#: that a falling loss is the optimizer's and not the batches' spread (at
#: 2 x 1,024 tokens grok's loss moved 0.03 from batch to batch on the same
#: card), and its calibration steps
FAMILY_TRAIN_STEPS, FAMILY_CAL_STEPS = 3, 2


def train_depth(CONFIG, rows=TRAIN_B, positions=TRAIN_T) -> int:
    """The most layers of ``CONFIG`` whose training state fits
    ``TRAIN_PEAK_SHARE`` of the card: 8 bytes a parameter (bf16 weights,
    gradients and two moments) of the embedding, the lm_head (vocabulary
    padding included) and the mean layer, each layer's saved input (rows x
    positions x d bf16, remat) and ``TRAIN_RESERVE_BYTES``; reckoned before
    any weight is made. Raises below the config's ``TRAIN_MIN_LAYERS``."""
    import torch

    _, total = torch.cuda.mem_get_info()
    c = CONFIG
    heads = 1 if c.tie_embeddings else 1 + c.n_codebooks  # the embedding, the lm_head(s)
    fixed = heads * c.vocab_size * c.d_model
    per_layer = (c.param_count() - fixed) / c.n_layers
    fixed += heads * (c.padded_vocab - c.vocab_size) * c.d_model
    saved = rows * positions * c.d_model * 2
    depth = int((TRAIN_PEAK_SHARE * total - TRAIN_RESERVE_BYTES - 8 * fixed)
                // (8 * per_layer + saved))
    floor = TRAIN_MIN_LAYERS[c.name]
    if depth < floor:
        raise AssertionError(f"training {c.name} fits {depth} layers, under {floor}")
    return min(c.n_layers, depth)


def _attention_backward_check(cfg):
    """``layers.chunked_attention``'s backward (the flash Function) at one
    layer's shape against autograd through a plain masked-softmax
    attention on the same f32 inputs: dq, dk, dv within ``ATTN_GRAD_REL``
    max|g|; the peak bytes each takes above its inputs, and the ms of a
    forward and backward (median of 3)."""
    import torch

    from repro_torch.models import layers

    b, t, h, kh, d = ATTN_CHECK
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(sh, generator=gen, device="cuda")
                   for sh in ((b, t, h, d), (b, t, kh, d), (b, t, kh, d), (b, t, h, d)))
    mask = torch.ones((t, t), dtype=torch.bool, device="cuda").tril()

    def flash():
        qq, kk, vv = (a.detach().requires_grad_() for a in (q, k, v))
        out = layers.chunked_attention(qq, kk, vv, q_chunk=cfg.attn_q_chunk,
                                       kv_chunk=cfg.attn_kv_chunk)
        return torch.autograd.grad(out, (qq, kk, vv), do)

    def plain():
        qq, kk, vv = (a.detach().requires_grad_() for a in (q, k, v))
        sc = torch.einsum("bqhgd,bkhd->bhgqk", qq.reshape(b, t, kh, h // kh, d), kk) / d**0.5
        p = torch.softmax(sc.masked_fill(~mask, -1e30), dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", p, vv).reshape(b, t, h, d)
        return torch.autograd.grad(out, (qq, kk, vv), do)

    peaks = {}
    for name, fn in (("flash", flash), ("plain", plain)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = fn()
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated() - base, grads)
    errs = [float((g - w).abs().max()) / float(w.abs().max())
            for g, w in zip(peaks["flash"][1], peaks["plain"][1])]
    row = dict(shape=list(ATTN_CHECK), chunks=[cfg.attn_q_chunk, cfg.attn_kv_chunk],
               rel_err_dq_dk_dv=errs, bound=ATTN_GRAD_REL,
               flash_peak_bytes=peaks["flash"][0], plain_peak_bytes=peaks["plain"][0],
               flash_ms=cuda_ms(flash, 3), plain_ms=cuda_ms(plain, 3))
    log("attention_backward", **row, card=card())
    if max(errs) > ATTN_GRAD_REL:
        raise AssertionError(f"attention backward vs plain: {errs} > {ATTN_GRAD_REL}")
    return row


def _train_flops(cfg, rows, positions) -> float:
    """Model FLOPs of a train step: 6 N a token over the matmul parameters
    (N: the active ones in MoE, top-k experts a token; the embedding is a
    gather unless it is also the tied lm_head), plus the attention's and
    the mLSTM chunk's score and value matmuls, 6 B H hd T S with S the keys
    a query sees (T, or the window in local attention; the chunk in an
    mLSTM block), causal halving included as in ``phase_train``."""
    from repro_torch.models import lm

    n = cfg.active_param_count() - (0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model)
    if cfg.family == "xlstm":
        g, per = lm.group_structure(cfg)
        seen = min(positions, cfg.attn_kv_chunk, 512)  # lm._xlstm_group's chunk
        mix = 6 * rows * cfg.d_model * positions * seen * g * (per - 1)
    else:
        layers = cfg.n_layers
        seen = positions
        if cfg.family == "griffin":  # the tail layers are recurrent
            layers = cfg.griffin_pattern.count("attn") * lm.group_structure(cfg)[0]
            seen = min(positions, cfg.local_window)
        mix = 6 * rows * cfg.n_heads * cfg.head_dim * positions * seen * layers
    return 6 * n * rows * positions + mix


def _train_run(phase, CONFIG, cfg, batches, **extra):
    """A train step on each of ``batches`` but the last on ``cfg`` (bf16
    weights from seed 0, ``TrainConfig()``, remat): the loss finite at
    every step and lower at the last; ms a step (median of steps 2 on,
    unprofiled), a step on the last batch profiled (device ms, idle share,
    kernels launched), tokens/s, the peak against the card's memory and
    the model-FLOPs share (``_train_flops`` over the step's seconds at the
    bf16 spec peak). Then two steps again from the same weights and a
    fresh optimizer: the parameters equal those after the first run's
    second step bit for bit. Logs the row under ``phase`` and returns the
    repeat's parameters (two steps from seed 0)."""
    import statistics

    import torch

    from repro_torch.launch.steps import TrainConfig, make_opt_init, make_train_step
    from repro_torch.models import lm
    from repro_torch.tree import leaves

    tcfg = TrainConfig()
    n_steps = len(batches) - 1
    rows, positions = batches[0]["tokens"].shape
    step = make_train_step(cfg, None, tcfg)

    def fresh():
        params = lm.init_params(cfg, seed=0, device="cuda")
        return params, make_opt_init(cfg, None, tcfg)(params)

    _free()
    t0 = time.perf_counter()
    state = list(fresh())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses, norms, ms, after_two = [], [], [], None
    for i in range(n_steps):
        def one(i=i):
            state[0], state[1], m = step(state[0], state[1], batches[i])
            return m
        m, wall = _wall_ms(one)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        ms.append(wall)
        if i == 1:  # the state the repeat below must reproduce
            after_two = [p.to("cpu", copy=True) for p in leaves(state[0])]
    peak = torch.cuda.max_memory_allocated()
    TRAIN_PEAKS[phase] = (cfg, rows, positions, peak)
    _, prof = _profile(lambda: step(state[0], state[1], batches[n_steps]))
    step_ms = statistics.median(ms[1:])
    tokens = rows * positions
    flops = _train_flops(cfg, rows, positions)
    _, total = torch.cuda.mem_get_info()
    state = None
    _free()
    params, opt = fresh()
    for i in range(2):
        params, opt, _ = step(params, opt, batches[i])
    equal = [bool(torch.equal(p, a.to("cuda"))) for p, a in zip(leaves(params), after_two)]
    opt = after_two = None
    _free()
    row = dict(config=cfg.name, family=cfg.family, layers=cfg.n_layers,
               of_layers=CONFIG.n_layers, params=cfg.param_count(),
               active_params=cfg.active_param_count(), batch=[rows, positions], losses=losses,
               grad_norms=norms, step_ms=ms, ms_a_step=step_ms, init_s=init_s,
               device_ms=prof["device_ms"], idle_share=max(0.0, 1.0 - prof["device_ms"] / step_ms),
               profiled_wall_ms=prof["profiled_wall_ms"], profile_s=prof["profile_s"],
               kernels_a_step=prof["kernels"],
               top=prof["top"], tokens_per_s=tokens / step_ms * 1e3, peak_gib=peak / 2**30,
               card_gib=total / 2**30, peak_share=peak / total, model_flops=flops,
               mfu_of_bf16_spec_peak=flops / (step_ms / 1e3 * BF16_FLOPS_S),
               repeat_equal=equal, **extra, card=card())
    log(phase, **row)
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{phase}: losses {losses}")
    if not all(equal):
        raise AssertionError(f"{phase}: two runs of 2 steps differ at leaves {equal}")
    if peak > TRAIN_PEAK_SHARE * total:
        raise AssertionError(f"{phase}: peak {peak} bytes over {TRAIN_PEAK_SHARE} of {total}")
    return params


def phase_train(CONFIG=None):
    """granite-3-8b trained at full width: the depth ``train_depth``
    reckons, the attention backward checked first
    (``_attention_backward_check``), then ``_train_run`` of
    ``TRAIN_STEPS`` steps at ``TRAIN_B`` x ``TRAIN_T``, each on its own
    batch. Returns the depth-cut config."""
    from repro_torch.configs import reduced_depth
    from repro_torch.data.pipeline import TokenTaskConfig, markov_batch

    if CONFIG is None:
        from repro_torch.configs.granite_3_8b import CONFIG
    attn = _attention_backward_check(CONFIG)
    cfg = reduced_depth(CONFIG, n_layers=train_depth(CONFIG), name=CONFIG.name)
    data = TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_T, global_batch=TRAIN_B,
                           seed=7)
    _train_run("train", CONFIG, cfg, [markov_batch(data, i) for i in range(TRAIN_STEPS + 1)],
               attention=attn)
    return cfg


def phase_train_family(phase):
    """A family of ``FAMILY_TRAIN`` trained at full width and the depth
    ``train_depth`` reckons at the phase's rows and positions
    (recurrentgemma-2b and xlstm-1.3b whole, grok-1 at one layer):
    ``_train_run`` of ``FAMILY_TRAIN_STEPS`` steps on one batch, then the
    LM calibration on the repeat's weights (``phase_calibrate_lm``, logged
    as ``calibrate_<family>``). The analog kernels take no part, as in the
    reference's training."""
    from repro_torch.configs import get_config, reduced_depth
    from repro_torch.data.pipeline import TokenTaskConfig, markov_batch

    arch, rows, positions, cal_positions = FAMILY_TRAIN[phase]
    full = get_config(arch)
    cfg = reduced_depth(full, n_layers=train_depth(full, rows, positions), name=full.name)
    data = TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=positions, global_batch=rows,
                           seed=7)
    one = markov_batch(data, 0)
    params = _train_run(phase, full, cfg, [one] * (FAMILY_TRAIN_STEPS + 1), one_batch=True)
    phase_calibrate_lm(cfg, params, name=phase.replace("train", "calibrate"),
                       steps=FAMILY_CAL_STEPS, positions=cal_positions)


def phase_train_driver():
    """demo-100m of the training entry point (its optimizer, f32 moments)
    through ``TrainDriver`` at ``DRIVER_B`` x ``DRIVER_T``:
    ``DRIVER_STEPS`` steps with async checkpoints every
    ``DRIVER_CKPT_EVERY``, once clean and once with ``SimulatedFailure`` at
    ``DRIVER_FAILS``: 2 restarts, the final parameters and moments equal
    the clean run's bit for bit, the loss falls (its mean over the last 4
    steps below the first 4's). Then one blocking save of
    the final state and its restore, timed: the checkpoint's bytes and
    seconds. Checkpoints go under a temporary directory, removed after."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint.store import restore_checkpoint, save_checkpoint
    from repro_torch.data.pipeline import TokenTaskConfig
    from repro_torch.runtime.driver import DriverConfig, SimulatedFailure, TrainDriver
    from repro_torch.runtime.train_lm import MODELS, TRAIN_CFG
    from repro_torch.tree import leaves

    cfg = MODELS["100m"]
    data = TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=DRIVER_T, global_batch=DRIVER_B,
                           seed=7)
    dcfg = DriverConfig(max_steps=DRIVER_STEPS, ckpt_every=DRIVER_CKPT_EVERY, ckpt_async=True,
                        log_every=1)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        runs = {}
        for name in ("clean", "faulty"):
            fails = set(DRIVER_FAILS) if name == "faulty" else set()

            def hook(step, fails=fails):
                if step in fails:
                    fails.discard(step)
                    raise SimulatedFailure(f"crash at step {step}")

            drv = TrainDriver(cfg, data, ckpt_dir=os.path.join(root, name), train_cfg=TRAIN_CFG,
                              driver_cfg=dcfg, failure_hook=hook)
            t0 = time.perf_counter()
            out = drv.run()
            torch.cuda.synchronize()
            runs[name] = (drv, out, time.perf_counter() - t0)
            shutil.rmtree(os.path.join(root, name))
        (clean, c_out, c_s), (faulty, f_out, f_s) = runs["clean"], runs["faulty"]
        state = f_out["state"]
        equal = all(torch.equal(a, b) for a, b in zip(
            leaves(c_out["state"]["params"]) + leaves(c_out["state"]["opt"].mu),
            leaves(state["params"]) + leaves(state["opt"].mu)))
        t0 = time.perf_counter()
        path = save_checkpoint(os.path.join(root, "timed"), DRIVER_STEPS, state)
        save_s = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(path, n)) for n in os.listdir(path))
        t0 = time.perf_counter()
        _, back = restore_checkpoint(os.path.join(root, "timed"), template=state)
        restore_s = time.perf_counter() - t0
        raw = sum(t.numel() * t.element_size() for t in leaves(back["params"])
                  + leaves(back["opt"].mu) + leaves(back["opt"].nu))
        same = all(torch.equal(a.cpu(), b) for a, b in zip(leaves(state["params"]),
                                                           leaves(back["params"])))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    losses = [m["loss"] for m in c_out["metrics"]]
    log("train_driver", config=cfg.name, params=cfg.param_count(), batch=[DRIVER_B, DRIVER_T],
        steps=DRIVER_STEPS, fails_at=list(DRIVER_FAILS), restarts=faulty.restarts,
        final_equal_clean=equal, losses=losses, faulty_losses=[m["loss"] for m in f_out["metrics"]],
        step_ms=[m["dt"] * 1e3 for m in c_out["metrics"]], clean_s=c_s, faulty_s=f_s,
        ckpt_bytes=ckpt_bytes, raw_bytes=raw, save_s=save_s,
        restore_s=restore_s, restored_equal=same, straggler_flags=len(faulty.monitor.flags),
        card=card())
    falls = sum(losses[-4:]) < sum(losses[:4])  # the last 4 steps' mean below the first 4's
    if not (equal and same and faulty.restarts == len(DRIVER_FAILS) and falls):
        raise AssertionError(f"train_driver: equal {equal}, restored {same}, restarts "
                             f"{faulty.restarts}, losses {losses}")


def phase_calibrate_lm(cfg, params=None, name="calibrate_lm", steps=CAL_LM_STEPS,
                       positions=CAL_LM_T):
    """Eq. 14 at LM scale on a train phase's config (its depth; ``params``,
    or bf16 weights from seed 0): ``make_calibrate_step`` with shot noise
    on the "torch" backend (the kernel has no backward), ``steps`` steps
    of ``markov_batch`` at ``CAL_LM_B`` x ``positions`` from a uniform start
    at ``CAL_LM_INIT_MULT`` x the budget: NLL and loss finite, the penalty
    falling, no kernel route launched; ms a step, peak GiB, the mean
    energy a MAC after each step. Logged under ``name``."""
    import torch

    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.energy import avg_energy_per_mac, to_energy, uniform_log_energies
    from repro_torch.data.pipeline import TokenTaskConfig, markov_batch
    from repro_torch.kernels import analog_matmul as am
    from repro_torch.kernels import prng
    from repro_torch.launch.steps import make_calibrate_step
    from repro_torch.models import lm
    from repro_torch.optim.adam import AdamConfig, adam_init
    from repro_torch.tree import map_leaves

    _free()
    if params is None:
        params = lm.init_params(cfg, seed=0, device="cuda")
    step = make_calibrate_step(cfg, analog_cfg=AnalogConfig.shot(backend="torch"),
                               seq_len=positions, target_e_per_mac=CAL_LM_TARGET, lam=CAL_LM_LAM,
                               lr=CAL_LM_LR)
    log_e = map_leaves(lambda _p, t: t.cuda(),
                       uniform_log_energies(step.macs, CAL_LM_INIT_MULT * CAL_LM_TARGET))
    opt = adam_init(log_e, AdamConfig(lr=CAL_LM_LR))
    data = TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=positions, global_batch=CAL_LM_B,
                           seed=7)
    batches = [markov_batch(data, i) for i in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dict(am.LAUNCHES)
    nll, loss, e_mac, ms = [], [], [], []
    for i in range(steps):
        (log_e, opt, m), wall = _wall_ms(
            lambda i=i: step(log_e, opt, params, batches[i], prng.fold_in(prng.PRNGKey(0), i)))
        nll.append(float(m["nll"]))
        loss.append(float(m["loss"]))
        ms.append(wall)
        with torch.no_grad():
            e_mac.append(float(avg_energy_per_mac(to_energy(log_e), step.macs)))
    launched = _launch_delta(before)
    penalty = [a - b for a, b in zip(loss, nll)]
    log(name, config=cfg.name, layers=cfg.n_layers, batch=[CAL_LM_B, positions],
        target_e_per_mac=CAL_LM_TARGET, nll=nll, loss=loss, penalty=penalty,
        e_per_mac_after_step=e_mac, step_ms=ms, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        kernel_launches=launched, card=card())
    params = None
    _free()
    if not (all(map(math.isfinite, nll + loss)) and penalty[-1] < penalty[0]):
        raise AssertionError(f"{name}: nll {nll}, loss {loss}")
    if any(launched.values()):
        raise AssertionError(f"{name} launched kernel routes {launched}")


# ---------------------------------------------------------------------------
# the dry run's reckoning against the card
# ---------------------------------------------------------------------------


def _meta_train(cfg, rows, positions, tp=1):
    """(fn, hold) of one train step of ``cfg`` (``TrainConfig()``: bf16
    moments, remat) at ``rows`` x ``positions`` on the meta device: the
    weights, the moments and the batch held, as the train phases hold
    them; at ``tp`` > 1 tensor shard 0's step on a dry mesh of ``tp``
    shards (its weights, its collectives recorded)."""
    import torch

    from repro_torch.launch.collectives import DryGroup, Recorder
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import TrainConfig, make_opt_init, make_train_step, shard_params
    from repro_torch.launch.trace_analysis import meta_params

    tcfg = TrainConfig()
    mesh = None if tp == 1 else Mesh(tp=tp, group=DryGroup(tp, Recorder()))
    params = shard_params(meta_params(cfg), cfg, mesh)
    opt = make_opt_init(cfg, mesh, tcfg)(params)
    batch = {k: torch.empty((rows, positions), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, mesh, tcfg)
    return (lambda: step(params, opt, batch)), (params, opt, batch)


def phase_dryrun():
    """The dry run's reckoning (``launch/trace_analysis.py``) against the
    card: each train program this run measured (``TRAIN_PEAKS``: train,
    train_griffin, train_moe, and a rank of train_tp: tensor shard 0 on a
    dry mesh of its shards) reckoned on the meta device at its depth,
    rows and positions, with the state the phase holds (bf16 weights,
    gradient buffers, bf16 moments), its reckoned peak within
    ``DRYRUN_PEAK_REL`` of the measured ``max_memory_allocated``; then
    one small real step (granite-3-8b at ``DRYRUN_STEP``) on the card
    under the same counters (``FlopCounterMode`` among them), its FLOPs
    equal to the meta reckoning of the same step. These programs launch
    no analog kernel and draw no generator noise: no stand-in enters
    them."""
    import torch

    from repro_torch.configs import reduced_depth
    from repro_torch.configs.granite_3_8b import CONFIG
    from repro_torch.data.pipeline import TokenTaskConfig, markov_batch
    from repro_torch.launch.steps import TrainConfig, batch_tensors, make_opt_init, make_train_step
    from repro_torch.launch.trace_analysis import reckon
    from repro_torch.models import lm

    programs = ("train", "train_griffin", "train_moe", "train_tp")
    missing = [p for p in programs if p not in TRAIN_PEAKS]
    if missing:
        raise AssertionError(f"dryrun: no measured peak of {missing}: run those phases "
                             "before it (--only train,train_griffin,train_moe,train_tp,dryrun)")
    rows_out, bad = [], []
    for phase in programs:
        cfg, rows, positions, measured, *tp = TRAIN_PEAKS[phase]
        fn, hold = _meta_train(cfg, rows, positions, *tp)
        t0 = time.perf_counter()
        _, st = reckon(fn, hold=hold)
        row = dict(program=phase, config=cfg.name, layers=cfg.n_layers, batch=[rows, positions],
                   tensor_shards=(tp or [1])[0],
                   reckoned_peak_gib=st.peak_bytes / 2**30, measured_peak_gib=measured / 2**30,
                   rel=(st.peak_bytes - measured) / measured, state_gib=st.base_bytes / 2**30,
                   dot_flops=st.dot_flops, reckon_s=time.perf_counter() - t0)
        rows_out.append(row)
        if abs(row["rel"]) > DRYRUN_PEAK_REL:
            bad.append(phase)
    layers, rows, positions = DRYRUN_STEP
    cfg = reduced_depth(CONFIG, n_layers=layers, name=CONFIG.name)
    fn, hold = _meta_train(cfg, rows, positions)
    _, meta = reckon(fn, hold=hold)
    _free()
    tcfg = TrainConfig()
    params = lm.init_params(cfg, seed=0, device="cuda")
    opt = make_opt_init(cfg, None, tcfg)(params)
    step = make_train_step(cfg, None, tcfg)
    batch = batch_tensors(markov_batch(TokenTaskConfig(vocab_size=cfg.vocab_size,
                                                       seq_len=positions, global_batch=rows,
                                                       seed=7), 0), "cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, real = reckon(lambda: step(params, opt, batch), device="cuda", hold=(params, opt, batch))
    torch.cuda.synchronize()
    real_peak = torch.cuda.max_memory_allocated()
    params = opt = batch = None
    _free()
    log("dryrun", programs=rows_out, bound=DRYRUN_PEAK_REL,
        small_step=dict(config=cfg.name, layers=layers, batch=[rows, positions],
                        meta_matmul_flops=meta.matmul_flops, card_matmul_flops=real.matmul_flops,
                        meta_dot_flops=meta.dot_flops, card_dot_flops=real.dot_flops,
                        meta_peak_gib=meta.peak_bytes / 2**30,
                        card_tracked_peak_gib=real.peak_bytes / 2**30,
                        card_allocated_before_gib=base / 2**30,
                        card_max_allocated_gib=real_peak / 2**30),
        card=card())
    if bad:
        raise AssertionError(f"dryrun: reckoned peaks off by more than {DRYRUN_PEAK_REL}: {bad}")
    if meta.matmul_flops != real.matmul_flops or meta.dot_flops != real.dot_flops:
        raise AssertionError(f"dryrun: FLOPs on meta {meta.dot_flops} != on the card "
                             f"{real.dot_flops}")


# ---------------------------------------------------------------------------
# contained faults, tensor parallelism, the int8 tier
# ---------------------------------------------------------------------------

#: (phase, stats) of every ServingEngine the run builds (``_watch_engines``)
_ENGINE_STATS: list = []
#: phase -> its engines' step-cache hits, misses, captures and capture seconds
_CACHE_TALLY: dict = {}
#: the phase running now (set by ``main``'s ``timed``)
_PHASE = ["start"]
#: phases that inject faults on purpose: each holds its own engines
FAULT_PHASES = ("resilience",)
#: an engine's counters of contained faults and structured failures
CONTAINED = ("exe_errors", "exe_faults", "failed", "timed_out")


def _watch_engines() -> None:
    """Keep the stats of every ``ServingEngine`` built from here on, with
    the phase that built it, for ``_no_contained_faults``: the engine
    contains an unexpected exception as a structured ``Failed`` (the
    reference's ``exe_error`` path), and that must not hide a kernel
    failure. Wraps the constructor; the engine behaves as it does."""
    from repro_torch.serving.engine import ServingEngine

    init = ServingEngine.__init__

    def watched(self, *args, **kw):
        init(self, *args, **kw)
        _ENGINE_STATS.append((_PHASE[0], self.stats))

    ServingEngine.__init__ = watched

    # each phase's cache traffic: hits and misses of every engine's step
    # cache, and the graphs captured with their seconds
    from repro_torch.serving.cache import ExecutableCache

    get, captured = ExecutableCache.get, ServingEngine._captured

    def tallied_get(self, key, build):
        hits, misses = self.hits, self.misses
        exe = get(self, key, build)
        tally = _CACHE_TALLY.setdefault(_PHASE[0], dict(hits=0, misses=0, captures=0,
                                                         capture_s=0.0))
        tally["hits"] += self.hits - hits
        tally["misses"] += self.misses - misses
        return exe

    def tallied_capture(self, seconds):
        captured(self, seconds)
        tally = _CACHE_TALLY.setdefault(_PHASE[0], dict(hits=0, misses=0, captures=0,
                                                         capture_s=0.0))
        tally["captures"] += 1
        tally["capture_s"] += seconds

    ExecutableCache.get = tallied_get
    ServingEngine._captured = tallied_capture


def _no_contained_faults() -> None:
    """Every engine built outside ``FAULT_PHASES`` contained no exception
    and resolved no request to a ``RequestFailure``."""
    bad = [(phase, {k: st[k] for k in CONTAINED}) for phase, st in _ENGINE_STATS
           if phase not in FAULT_PHASES and any(st[k] for k in CONTAINED)]
    if bad:
        raise AssertionError(f"an engine contained a fault where none was injected: {bad}")


def _broken_tier_plan(broken):
    """A ``FaultPlan`` under which every prefill and decode call of the
    uniform-K tiers ``broken`` raises a plain ``RuntimeError``: an
    unexpected exception, not the plan's ``TransientExecutableFault``. A
    call's key ends in its tier's ``cache_key()``, (K, backend, "shot")
    for a uniform K of shot noise."""
    from repro_torch.serving import FaultPlan

    class BrokenTierPlan(FaultPlan):
        def check_executable(self, key) -> None:
            super().check_executable(key)
            if key[0] != "insert" and key[-1] == "shot" and key[-3] in broken:
                raise RuntimeError(f"unplanned executable crash: {key}")

    return BrokenTierPlan()


#: tensor parallelism: shard counts, new tokens a request, and the tiers of
#: the serve's 8 prompts (K=1, K=4 and edge4)
TP_SIZES = (2, 4)
TP_GEN = 8
#: decode steps a step timing at each tp (a mean; the serve's phases time 15)
TP_STEPS = 5
TP_TIERS = ({"n_repeats": 1},) * 3 + ({"n_repeats": 4},) * 3 + ({"profile": "edge4"},) * 2
TP_GRIFFIN_TIERS = ({"n_repeats": 1},) * 2 + ({"n_repeats": 4},) * 2
#: tp_families: grok-1's serve (``MOE_REQUESTS`` requests at K=1) at tp = 2
#: and 4, and xlstm-1.3b's serve (4 at K=1, 4 at K=4) at tp = 2,
#: batch-synchronous (MoE has no pools)
TP_GROK_TIERS = ({"n_repeats": 1},) * MOE_REQUESTS
TP_XLSTM_TIERS = ({"n_repeats": 1},) * 4 + ({"n_repeats": 4},) * 4
#: the sites of tp_routes: granite-3-8b's and recurrentgemma-2b's
TP_ROUTE_SITES = [("granite-3-8b " + s, k, n) for s, k, n in SITES] + [
    ("recurrentgemma-2b " + s, k, n) for s, k, n in GRIFFIN_SITES]


def _tp_route_cases():
    """(route, (b, m), cfg, energy) of tp_routes: each route at its main
    path's rows (weight noise at decode and prefill rows; simt forced)."""
    from repro_torch.core.analog import AnalogConfig

    shot, weight = AnalogConfig.shot(), AnalogConfig.weight(0.1)
    return [("decode", (4, 1), shot, 20.0), ("tc", (4, 64), shot, 20.0),
            ("weight", (2, 1), weight, 5.0), ("weight", (2, 32), weight, 5.0),
            ("simt", (4, 1), shot, 20.0)]


def phase_tp_routes() -> None:
    """Every route at granite-3-8b's and recurrentgemma-2b's site shapes, K
    = 1 and 4, tp = 2 and 4 (N / tp % 8 == 0 at each): shard r of
    ``ops.analog_matmul_shards`` (a column view of the weight, its seed's
    col0 at r N / tp, ``plan_n`` N) equals columns [r N / tp, (r + 1) N /
    tp) of the unsharded call bit for bit, launching the route once a
    shard; the gathered shards are within the route's rule of the plain
    version; each shard's launch plan splits K as the whole call's. At K = 1
    the decode and tc routes are timed (median of 10, L2 emptied): one
    shard's launch beside its bound, and the unsharded call."""
    import functools

    import torch

    from repro_torch.kernels import analog_matmul as am
    from repro_torch.kernels import ops
    from repro_torch.kernels.analog_matmul import analog_matmul_raw
    from repro_torch.kernels.ref import analog_matmul_ref_raw

    flush = _flush_buffer()
    rows = []
    for site, k, n in TP_ROUTE_SITES:
        for route, (b, m), cfg, energy in _tp_route_cases():
            for reps in (1, 4):
                o, _ = _site_operands(b, m, k, n, cfg, energy, seed=91)
                whole = _run_raw(analog_matmul_raw, o, reps, route=route)
                plain = _run_raw(analog_matmul_ref_raw, o, reps)
                raw = functools.partial(analog_matmul_raw, route=route)
                for tp in TP_SIZES:
                    nl = n // tp
                    if nl % 8:
                        continue
                    before = dict(am.LAUNCHES)
                    shards = ops.analog_matmul_shards(
                        raw, o["x"], o["w"], energy=torch.tensor(energy, device="cuda"),
                        seed=o["seed"], cfg=cfg, n_repeats=reps, tp=tp, shards=range(tp),
                        plan_n=n)
                    launched = _launch_delta(before)
                    equal = [bool(torch.equal(y, whole[..., r * nl:(r + 1) * nl]))
                             for r, y in enumerate(shards)]
                    err, atol, ok = _close(torch.cat(shards, dim=-1), plain, o, None)
                    if route == "decode":
                        plans = (am.decode_plan(k, nl, b * m, plan_n=n),
                                 am.decode_plan(k, n, b * m))
                        fields = ("kc", "splits")
                    elif route == "weight":
                        plans = (am.weight_plan(k, nl, m, plan_n=n), am.weight_plan(k, n, m))
                        fields = ("kc", "splits")
                    else:
                        plans = (am.tc_plan(b * m, k, nl, plan_n=n), am.tc_plan(b * m, k, n))
                        fields = ("k_tiles", "splits")
                    same_plan = all(plans[0][f] == plans[1][f] for f in fields)
                    row = dict(site=site, route=route, shape=[b, m, k, n], n_repeats=reps, tp=tp,
                               shard_equals_slice=equal, max_abs_err=err, atol=atol, ok=ok,
                               plan={f: plans[0][f] for f in fields},
                               same_plan=same_plan, launched=launched)
                    if reps == 1 and route in ("decode", "tc"):
                        seeds = ops.shard_seeds(o["seed"], tp, nl)
                        shard = dict(o, w=o["w"][:, :nl], col_scale=o["col_scale"][..., :nl],
                                     wq=torch.ones((3, nl), device="cuda"), seed=seeds[0])
                        row["shard_ms"] = cuda_ms(
                            lambda: _run_raw(analog_matmul_raw, shard, 1, route=route, plan_n=n),
                            10, flush)
                        row["shard_bound_ms"], row["shard_bound_by"], _ = _bound(shard, 1)
                        row["unsharded_ms"] = cuda_ms(
                            lambda: _run_raw(analog_matmul_raw, o, 1, route=route), 10, flush)
                    rows.append(row)
                    log("tp_route", **row)
                    if not (all(equal) and ok and same_plan
                            and launched == {r: tp * (r == route) for r in am.ROUTES}):
                        raise AssertionError(f"tp route {route} {site} tp={tp} K={reps}: {row}")
    log("tp_routes", cases=len(rows), routes=sorted({r["route"] for r in rows}),
        all_shards_equal=True, card=card())


def _expected_launches(cfg, stats, tp):
    """Launches by route and by (route, K, N / tp) of an engine's decode
    steps and prefill batches, on a mesh of ``tp`` shards."""
    sites = forward_sites(cfg, tp)
    by_route = {"decode": sites * stats["decode_steps"], "tc": sites * stats["batches"],
                "simt": 0, "weight": 0}
    by_shape = {}
    for (k, n), c in forward_shapes(cfg, tp).items():
        for route, forwards in (("decode", stats["decode_steps"]), ("tc", stats["batches"])):
            if c * forwards:
                by_shape[(route, k, n)] = c * forwards
    return by_route, by_shape


def _tp_serve(make_engine, prompts, tiers, mesh, continuous, profiles):
    """The tp traffic (``prompts`` at ``tiers``, ``TP_GEN`` tokens) through an
    engine over the weights: (engine, tokens by uid, launches by route, by
    (route, K, N), seconds)."""
    from repro_torch.kernels import analog_matmul as am

    kw = dict(continuous=True, pool_slots=POOL_SLOTS) if continuous else {}
    engine = make_engine("auto", profiles=profiles, seq_buckets=(64,), max_wait=0.0,
                         max_gen=TP_GEN, mesh=mesh, **kw)
    for p, t in zip(prompts, tiers):
        engine.submit(p, max_new_tokens=TP_GEN, **t)
    results, s, launches = _drain(engine)
    if sorted(results) != list(range(len(prompts))):
        raise AssertionError(f"served {sorted(results)} of {len(prompts)}")
    return engine, results, launches, dict(am.LAUNCHES_BY_SHAPE), s


def phase_tp(make_engine, prompts, CONFIG=None, sizes=TP_SIZES, tiers=TP_TIERS,
             disciplines=(False, True), time_steps=True):
    """Tensor-parallel serving on one card (a local mesh: the shards run
    one after another): the traffic at each tp of ``sizes``, batch-
    synchronous and through 4-slot pools (``disciplines``), equals the
    unsharded batch-synchronous engine's tokens bit for bit (at one seq
    bucket pooled == sync, as ``continuous`` holds), with tp times its
    launches by route, at N / tp (a site whose shard would change route
    runs whole: ``forward_shapes``); an ``attach_mesh`` with a request in
    flight raises; then, with ``time_steps``, the ms a decode step
    (``TP_STEPS`` timed), device ms and idle share of the first batch at
    tp = 1 and each of ``sizes``.
    Returns the launches by route of the sharded serves."""
    import numpy as np

    from repro_torch.kernels import analog_matmul as am
    from repro_torch.launch.mesh import make_mesh_for_devices

    if CONFIG is None:
        from repro_torch.configs.granite_3_8b import CONFIG
    prompts = list(prompts[:len(tiers)])
    profiles = [_edge4()] if {"profile": "edge4"} in tiers else []
    total = {r: 0 for r in am.ROUTES}
    eng1, want, l1, _, s1 = _tp_serve(make_engine, prompts, tiers, None, False, profiles)
    if l1 != _expected_launches(CONFIG, eng1.stats, 1)[0]:
        raise AssertionError(f"unsharded: launches {l1}")
    step_engines = {1: eng1}
    for continuous in disciplines:
        name = "pooled" if continuous else "sync"
        for tp in sizes:
            mesh = make_mesh_for_devices(tp)
            eng, got, launches, by_shape, s = _tp_serve(make_engine, prompts, tiers, mesh,
                                                        continuous, profiles)
            equal = [bool(np.array_equal(got[u], want[u])) for u in range(len(prompts))]
            want_launch, want_shape = _expected_launches(CONFIG, eng.stats, tp)
            ok_launch = launches == want_launch and by_shape == want_shape
            if not continuous:  # the same forwards as the unsharded serve
                ok_launch = ok_launch and want_launch == _expected_launches(
                    CONFIG, eng1.stats, tp)[0]
            st = eng.stats
            log("tp_serve", config=CONFIG.name, layers=CONFIG.n_layers, tp=tp, discipline=name,
                requests=len(got), tokens_equal_unsharded=equal, launches=launches,
                unsharded_launches=l1,
                launches_by_shape={f"{r}:{k}x{n}": c for (r, k, n), c in sorted(by_shape.items())},
                forwards=st["batches"] + st["decode_steps"], flush_ms=s * 1e3,
                unsharded_flush_ms=s1 * 1e3,
                ms_per_forward=s * 1e3 / (st["batches"] + st["decode_steps"]),
                generated_tokens_per_s=st["tokens_generated"] / s,
                unsharded_tokens_per_s=eng1.stats["tokens_generated"] / s1, card=card())
            if not (all(equal) and ok_launch):
                raise AssertionError(f"tp={tp} {name}: equal {equal}, launches {launches} vs "
                                     f"{want_launch} ({l1} unsharded), by shape {by_shape} vs "
                                     f"{want_shape}")
            for r in am.ROUTES:
                total[r] += launches[r]
            if not continuous:
                step_engines[tp] = eng
    # attach_mesh with a request in flight is refused; drained, it attaches
    eng = step_engines[max(sizes)]
    eng.submit(prompts[0], max_new_tokens=TP_GEN, **tiers[0])
    try:
        eng.attach_mesh(make_mesh_for_devices(1))
        refused = False
    except ValueError:
        refused = True
    eng.flush()
    log("tp_attach", refused_in_flight=refused, card=card())
    if not refused:
        raise AssertionError("attach_mesh with a request in flight did not raise")
    step_tiers = [t.get("n_repeats", 1) for t in tiers]
    for tp, eng in sorted(step_engines.items()) if time_steps else ():
        phase_steps(eng, prompts, step_tiers, n_steps=TP_STEPS)
    return total


def phase_int8(make_engine, prompts, CONFIG=None):
    """The int8 digital tier and the bf16 digital tier on one analog engine
    (granite-3-8b at full size): the bytes of both trees (int8 < 0.62x),
    the int8 prefill logits of the first batch against bf16 (within 0.25
    max|logit|, top-1 agreement >= 0.5: the reference test's bound), a
    serve of the 8 prompts on each tier with its peak memory, tokens/s, a
    request alone equal to its batch and its decode steps' sites on the
    decode route (no noise), the decode step of each (ms, device ms, idle
    share) and the int8 energy a token (30,000 aJ a MAC). Then the bf16
    tier's serve and decode step with its digital sites as one batched
    matmul a site (the hook swapped for those runs only), and one gate/up
    site on the route, as one matmul and as one matmul a request: what the
    decode route buys."""
    import numpy as np
    import torch

    from repro_torch.core.energy import DIGITAL_INT8_AJ_PER_MAC, total_macs
    from repro_torch.kernels.prng import PRNGKey, fold_in
    from repro_torch.models import lm
    from repro_torch.models.hooks import MatmulHook, ServingMatmulHook
    from repro_torch.quant.weights import param_bytes
    from repro_torch.serving import DigitalTier, Int8DigitalTier

    if CONFIG is None:
        from repro_torch.configs.granite_3_8b import CONFIG
    engine = make_engine("auto", seq_buckets=(64,), max_wait=0.0, max_gen=TP_GEN)
    tiers = {"bf16": DigitalTier(engine), "int8": Int8DigitalTier(engine)}
    for t in tiers.values():
        engine.register_tier(t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = tiers["int8"].params
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    gib = {"bf16": param_bytes(engine.params) / 2**30, "int8": param_bytes(qparams) / 2**30}

    fb = _first_batch(engine, prompts, ["int8"] * len(prompts))
    cache_len = fb["sb"] + TP_GEN
    logits = {name: t.prefill(fb["tok"], fb["lengths"], fb["table"], cache_len)[1]
              for name, t in tiers.items()}
    n = len(fb["first"])
    l8, l16 = logits["int8"][:n], logits["bf16"][:n]
    rel = float((l8 - l16).abs().max()) / float(l16.abs().max())
    agree = float((l8.argmax(-1) == l16.argmax(-1)).float().mean())

    def serve_tier(name, engine=engine):
        """The 8 prompts on tier ``name``: (tokens by prompt, one summary)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps = engine.stats["decode_steps"]
        for i, p in enumerate(prompts):
            engine.submit(p, tier=name, max_new_tokens=TP_GEN, key=fold_in(PRNGKey(0), i))
        results, s, launches = _drain(engine)
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = {r: 0 for r in launches}
        want["decode"] = forward_sites(CONFIG) * (engine.stats["decode_steps"] - steps)
        tokens = [results[min(results) + i] for i in range(len(prompts))]
        solo_uid = engine.submit(prompts[fb["first"][-1]], tier=name, max_new_tokens=TP_GEN)
        solo = engine.flush()[solo_uid]
        return tokens, dict(tokens_per_s=TP_GEN * len(results) / s, flush_ms=s * 1e3,
                            peak_gib=peak, launches=launches, decode_route_launches=want,
                            solo_equals_batched=bool(np.array_equal(solo,
                                                                    tokens[fb["first"][-1]])),
                            tokens_ok=all(_tokens_ok(r, TP_GEN, CONFIG.vocab_size)
                                          for r in results.values()))

    serve = {}
    for name in tiers:
        tokens, serve[name] = serve_tier(name)
        if name == "bf16":
            bf16_tokens = tokens
    # the bf16 tier again with the digital sites as one batched matmul a
    # site, as before the decode route (a request alone may differ from its
    # batch); the hook swapped for this serve and its step only
    served = ServingMatmulHook.__call__
    ServingMatmulHook.__call__ = MatmulHook.__call__
    try:  # a new engine: the first one's graphs hold the decode route
        gemm_engine = make_engine("auto", seq_buckets=(64,), max_wait=0.0, max_gen=TP_GEN)
        gemm_engine.register_tier(DigitalTier(gemm_engine))
        tokens, gemm = serve_tier("bf16", gemm_engine)
        gemm["tokens_equal_decode_route"] = [bool(np.array_equal(a, b))
                                             for a, b in zip(tokens, bf16_tokens)]
        phase_steps(gemm_engine, prompts, ["bf16"] * len(prompts),
                    variant="one batched matmul a site")
    finally:
        ServingMatmulHook.__call__ = served
        gemm_engine = None
    macs = float(total_macs(lm.energy_macs(CONFIG, 1)))
    aj = engine.tier_energy_per_token("int8")
    # one gate/up decode site with 4 rows: cuBLAS's rows against a row alone,
    # and the site's ms on the decode route, as one GEMM and a GEMM a request
    x = torch.randn((4, 1, 4096), device="cuda", dtype=torch.bfloat16)
    w = torch.randn((4096, 12800), device="cuda", dtype=torch.bfloat16) * 4096**-0.5
    gemm_rows_equal = bool(torch.equal(torch.matmul(x, w)[:1], torch.matmul(x[:1], w)))
    hook = ServingMatmulHook()
    site_ms = {"decode route": cuda_ms(lambda: hook("mlp0_up", x, w), 10),
               "one matmul": cuda_ms(lambda: torch.matmul(x, w), 10),
               "one matmul a request": cuda_ms(
                   lambda: torch.cat([torch.matmul(x[i:i + 1], w) for i in range(4)]), 10)}
    # the route against its plain version (an f32 product): the bf16 rounding of the output
    plain = torch.matmul(x.float(), w.float())
    route_err = float((hook("mlp0_up", x, w).float() - plain).abs().max())
    route_tol = 2.0**-8 * float(plain.abs().max())
    log("int8", config=CONFIG.name, layers=CONFIG.n_layers, param_gib=gib,
        ratio=gib["int8"] / gib["bf16"], quantize_s=quantize_s, prefill_requests=fb["first"],
        logit_rel_err=rel, top1_agreement=agree, serve=serve,
        aj_per_token=aj, macs_per_token=macs, aj_per_mac=DIGITAL_INT8_AJ_PER_MAC,
        gate_up_batched_rows_equal_solo=gemm_rows_equal, bf16_one_batched_matmul_a_site=gemm,
        gate_up_site_ms=site_ms, gate_up_route_max_abs_err_vs_f32=route_err,
        gate_up_route_tol=route_tol, card=card())
    if not (gib["int8"] < 0.62 * gib["bf16"] and rel < 0.25 and agree >= 0.5
            and all(v["solo_equals_batched"] and v["tokens_ok"]
                    and v["launches"] == v["decode_route_launches"] for v in serve.values())
            and aj == DIGITAL_INT8_AJ_PER_MAC * macs and route_err <= route_tol):
        raise AssertionError(f"int8: bytes {gib}, logits {rel} / {agree}, serve {serve}, {aj}, "
                             f"route {route_err} > {route_tol}")
    for name in tiers:
        phase_steps(engine, prompts, [name] * len(prompts))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help=f"comma-separated phases to run, of {','.join(PHASES)} "
                         "(serve includes the step, whole-path, serve_weight, profile, "
                         "continuous and resilience phases; serve_griffin its step, solo, whole-path and the "
                         "griffin_* phases; serve_granite20, serve_qwen14 and serve_bert their "
                         "step, solo and whole-path phases, serve_granite20 granite20_long too, "
                         "serve_bert calibrate and search; serve_xlstm its step, solo, "
                         "whole-path and continuous phases and xlstm_long; serve_grok its "
                         "step, pad and whole-path phases; graphs runs graphs_griffin and "
                         "graphs_granite20 on those models' weights; tp and int8 run on granite-3-8b's "
                         "weights, tp then on recurrentgemma-2b's; tp_families on xlstm-1.3b's "
                         "and grok-1's; calibrate_lm on train's config; train_griffin, "
                         "train_xlstm and train_moe each calibrate on their weights; train_dp "
                         "runs calibrate_dp in its ranks; calibrate_tp runs in train_tp's ranks "
                         "and needs it; dryrun reckons the train phases run "
                         "before it, train_tp's a rank; conv stands alone); default all")
    args = ap.parse_args()
    only = [p for p in args.only.split(",") if p]
    if set(only) - set(PHASES):
        ap.error(f"unknown phases {sorted(set(only) - set(PHASES))}")
    if "calibrate_tp" in only and "train_tp" not in only:
        ap.error("calibrate_tp runs in train_tp's ranks: add train_tp")

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
    run |= set(GRAPHS_FOLLOWERS) if "graphs" in only else set()
    run |= set(BERT_FOLLOWERS) if run & {"serve_bert", *BERT_FOLLOWERS} else set()
    run |= set(XLSTM_FOLLOWERS) if "serve_xlstm" in run else set()

    _watch_engines()

    def timed(name, fn, *args):
        t = time.perf_counter()
        _PHASE[0] = name
        out = fn(*args)
        _no_contained_faults()  # engines of every phase so far, fault phases aside
        log("phase_seconds", of=name, seconds=round(time.perf_counter() - t, 3),
            cache=_CACHE_TALLY.get(name))
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
    if "tp_routes" in run:
        counted("tp_routes", phase_tp_routes)
    site_rows = counted("site_time", phase_site_time, draw_ps) if "site_time" in run else None
    if "sweep" in run:
        timed("sweep", phase_sweep)
    if "conv" in run:
        by_path["conv"], conv_head = timed("conv", phase_conv)
    if run & {"serve", *SERVE_FOLLOWERS, "graphs", "tp", "int8"}:
        from repro_torch.configs.granite_3_8b import CONFIG

        make_engine = timed("weights", phase_weights)
        prompts, tiers = _traffic(CONFIG)
    if "serve" in run:
        engine, results, by_path["serve"] = timed("serve", phase_serve, make_engine, prompts, tiers)
        fb = timed("step", phase_steps, engine, prompts, tiers, True)
        timed("whole_path", phase_whole_path, make_engine, engine, results, prompts, tiers, fb)
    if "serve_weight" in run:
        by_path["serve_weight"] = timed("serve_weight", phase_serve_weight, make_engine, prompts,
                                        site_rows)
        timed("whole_path_weight", phase_whole_path_weight, make_engine, prompts)
    if "profile" in run:
        by_path["profile"] = timed("profile", phase_profile, make_engine, prompts, tiers)
    if "continuous" in run:
        by_path["continuous"] = timed("continuous", phase_continuous, make_engine, prompts)
    if "resilience" in run:
        by_path["resilience"] = timed("resilience", phase_resilience, make_engine, prompts, tiers)
    if "graphs" in run:
        by_path["graphs"] = timed("graphs", phase_graphs, make_engine, prompts, tiers, CONFIG)
    if "tp" in run:
        by_path["tp"] = timed("tp", phase_tp, make_engine, prompts)
    if "int8" in run:
        timed("int8", phase_int8, make_engine, prompts)
    if run & {"serve_griffin", *GRIFFIN_FOLLOWERS, "graphs_griffin", "tp"}:
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
    if "graphs_griffin" in run:
        timed("graphs_griffin", phase_graphs, make_griffin, gprompts, gtiers, GRIFFIN, False)
    if "griffin_profile" in run:
        by_path["griffin_profile"] = timed(
            "griffin_profile", phase_profile, make_griffin, gprompts, gtiers, GRIFFIN,
            PrecisionProfile(EDGE_GRIFFIN, name="edge"))
    if "griffin_continuous" in run:
        by_path["griffin_continuous"] = timed(
            "griffin_continuous", phase_continuous, make_griffin, gprompts, GRIFFIN,
            ({"n_repeats": 1},))
    if "tp" in run:
        by_path["tp_griffin"] = timed("tp_griffin", phase_tp, make_griffin, gprompts, GRIFFIN,
                                      (2,), TP_GRIFFIN_TIERS, (False,))
    make_engine = make_griffin = engine = results = fb = None  # the earlier weights go

    def serve_dense(arch, phase, tag):
        """Weights of ``arch`` (after the last model's are freed), then its
        serve, steps, solo and whole-path phases; returns make_engine."""
        from repro_torch.configs import get_config

        _free()
        cfg = get_config(arch)
        make = timed(f"{tag}_weights", phase_weights, cfg)
        p, t = _traffic(cfg)
        if phase in run:
            eng, res, by_path[phase] = timed(phase, phase_serve, make, p, t, cfg)
            fb_ = timed(f"{tag}_step", phase_steps, eng, p, t)
            timed(f"{tag}_solo", phase_solo, eng, res, p, t)
            timed(f"{tag}_whole_path", phase_whole_path, make, eng, res, p, t, fb_)
            if arch == "bert-base":
                timed("bert_energy", phase_bert_energy, eng)
            eng = res = fb_ = None
        if f"graphs_{tag}" in run:
            timed(f"graphs_{tag}", phase_graphs, make, p, t, cfg, False)
        return make, cfg

    if run & {"serve_granite20", *GRANITE20_FOLLOWERS, "graphs_granite20"}:
        from repro_torch.configs import reduced_depth

        make, cfg = serve_dense("granite-20b", "serve_granite20", "granite20")
        if "granite20_long" in run:
            make = None
            _free()
            long_cfg = reduced_depth(cfg, n_layers=DENSE_LONG_LAYERS, name=cfg.name)
            make = timed("granite20_long_weights", phase_weights, long_cfg)
            timed("granite20_long", phase_dense_long, make, long_cfg)
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
    if run & {"serve_xlstm", *XLSTM_FOLLOWERS, "tp_families"}:
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
    if "tp_families" in run:
        by_path["tp_xlstm"] = timed("tp_xlstm", phase_tp, make_xlstm, xprompts, XLSTM, (2,),
                                    TP_XLSTM_TIERS, (False,), False)
    if "xlstm_long" in run:
        from repro_torch.configs import reduced_depth

        make_xlstm = None
        _free()
        long_cfg = reduced_depth(XLSTM, n_layers=XLSTM_LONG_LAYERS, name=XLSTM.name)
        make_xlstm = timed("xlstm_long_weights", phase_weights, long_cfg)
        by_path["xlstm_long"] = timed("xlstm_long", phase_xlstm_long, make_xlstm, long_cfg)
    make_xlstm = None
    if run & {"serve_grok", "tp_families"}:
        from repro_torch.configs import get_config, reduced_depth

        _free()
        GROK = reduced_depth(get_config("grok-1-314b"), n_layers=GROK_LAYERS)
        make_grok = timed("grok_weights", phase_weights, GROK)
        gprompts, gtiers = _moe_traffic(GROK)
    if "serve_grok" in run:
        engine, by_path["serve_grok"], gprompts, gtiers = timed(
            "serve_grok", phase_serve_grok, make_grok, GROK)
        timed("grok_step", phase_steps, engine, gprompts, gtiers)
        timed("grok_pad", phase_moe_pad, make_grok, GROK, gprompts)
        timed("grok_whole_path", phase_whole_path_moe, make_grok, engine, gprompts, gtiers)
        engine = None
    if "tp_families" in run:
        by_path["tp_grok"] = timed("tp_grok", phase_tp, make_grok, gprompts, GROK, TP_SIZES,
                                   TP_GROK_TIERS, (False,))
    make_grok = None
    if "llama4_fit" in run:
        _free()
        by_path["llama4_fit"] = timed("llama4_fit", phase_llama4_fit)
    if run & {"train", "calibrate_lm"}:
        from repro_torch.configs import reduced_depth
        from repro_torch.configs.granite_3_8b import CONFIG as GRANITE

        _free()
        trained = (timed("train", phase_train) if "train" in run else
                   reduced_depth(GRANITE, n_layers=train_depth(GRANITE), name=GRANITE.name))
    if "calibrate_lm" in run:
        timed("calibrate_lm", phase_calibrate_lm, trained)
    trained = None
    for phase in FAMILY_TRAIN:  # each with its calibration on its weights
        if phase in run:
            _free()
            timed(phase, phase_train_family, phase)
    if "train_driver" in run:
        _free()
        timed("train_driver", phase_train_driver)
    if "train_dp" in run:
        _free()
        timed("train_dp", phase_train_dp, "train_tp" in run, "calibrate_tp" in run)
    if "train_tp" in run:
        _free()
        timed("train_tp", phase_train_tp, "calibrate_tp" in run)
    if "calibrate_tp" in run:
        _free()
        timed("calibrate_tp", phase_calibrate_tp)
    if "dryrun" in run:
        _free()
        timed("dryrun", phase_dryrun)
    log("done", seconds=round(time.perf_counter() - t0, 1), card=card())
    if only != list(PHASES):
        print(json.dumps({"ok": True, "partial": only}))
        return 0
    kernels = []
    # simt's main path is the convolutions: its entry is the heaviest conv
    # shape's, the kernel check's headline beside it
    entries["simt"] = dict(conv_head, kernel_check=entries["simt"])
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
