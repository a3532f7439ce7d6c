"""Wrapper of the hand-written CUDA analog-matmul kernel.

``csrc/analog_matmul.cu`` replaces the Pallas TPU kernel of
``repro/kernels/analog_matmul.py``. It is built with ``nvcc`` for
``sm_90a`` into ``_build/`` at first use (from the sources in this
checkout) and bound through its plain C interface with ``ctypes``.

``analog_matmul_raw`` keeps the reference's signature plus a leading
request axis: for a CPU tensor it runs the plain version
(``kernels/ref.py``); for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import numpy as np
import torch

from repro_torch.kernels.ref import analog_matmul_ref_raw

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "analog_matmul.cu")
BUILD_DIR = os.path.join(_HERE, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libanalog_matmul.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
NOISE_KINDS = {"none": 0, "output": 1, "weight": 2}

#: kernel launches so far in this process (one per ``analog_matmul_raw``
#: call on CUDA tensors); a run shows the main path used the kernel.
LAUNCHES = 0
#: seconds the last build took (0.0 when the library was already built),
#: and what nvcc/ptxas printed (registers, shared memory, spills).
BUILD_SECONDS = 0.0
BUILD_LOG = ""

_lib = None


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
            "the CUDA kernel is built from csrc/ at first use"
        )
    return found


def build(force: bool = False) -> str:
    """Compile ``csrc/analog_matmul.cu`` into ``_build/`` unless the library
    is newer than its source. Returns the library path."""
    global BUILD_SECONDS, BUILD_LOG
    if (
        not force
        and os.path.exists(LIBRARY)
        and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)
    ):
        return LIBRARY
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [find_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = proc.stdout + proc.stderr
    return LIBRARY


def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.analog_matmul_launch.argtypes = [
            p, p, i, p, p, i, p, p, p, p, i, i, i, i, i, i, i, i, i,
            ctypes.c_float, p,
        ]
        lib.analog_matmul_launch.restype = i
        u32 = ctypes.c_uint32
        lib.threefry_words.argtypes = [u32, u32, u32, u32, i, i, p, p]
        lib.threefry_words.restype = i
        _lib = lib
    return _lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with cudaError {err}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


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
) -> torch.Tensor:
    """(B, M, K) @ (K, N) -> (B, M, N) float32, one request per leading row.

    x (B, M, K) and w (K, N) both bf16 or both f32; row_scale f32 (B, M, 1);
    col_scale f32 (B, 1, N), or (1, 1, N) shared by every request; wq f32
    (3, N) = (delta, zp, bins); scalars f32 (1, 8) = (xd, xz, xbins, od, oz,
    obins, 0, 0); seed int32 (B, 4) holding the uint32 words (k0, k1, row0,
    col0) of each request. ``n_repeats`` K-repeat streams are averaged in
    the epilogue (or the weight load, for weight noise).
    """
    _require(x.dim() == 3 and w.dim() == 2, f"x must be (B, M, K), w (K, N): {x.shape} {w.shape}")
    b, m, k = x.shape
    _require(w.shape[0] == k, f"contract mismatch {tuple(x.shape)} @ {tuple(w.shape)}")
    n = w.shape[1]
    _require(n_repeats >= 1, f"n_repeats must be >= 1, got {n_repeats}")
    _require(noise_kind in NOISE_KINDS, f"bad noise_kind {noise_kind!r}")
    _require(tuple(row_scale.shape) == (b, m, 1), f"row_scale {tuple(row_scale.shape)} != {(b, m, 1)}")
    _require(
        tuple(col_scale.shape) in ((b, 1, n), (1, 1, n)),
        f"col_scale {tuple(col_scale.shape)} must be {(b, 1, n)} or {(1, 1, n)}",
    )
    _require(tuple(wq.shape) == (3, n), f"wq {tuple(wq.shape)} != {(3, n)}")
    _require(tuple(scalars.shape) == (1, 8), f"scalars {tuple(scalars.shape)} != (1, 8)")
    _require(tuple(seed.shape) == (b, 4), f"seed {tuple(seed.shape)} != {(b, 4)}")
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
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(x.is_contiguous(), "x must be contiguous")
    _require(
        x.dtype == w.dtype and x.dtype in (torch.float32, torch.bfloat16),
        f"x and w must both be bf16 or both f32, got {x.dtype} and {w.dtype}",
    )
    for name, t in (("row_scale", row_scale), ("col_scale", col_scale),
                    ("wq", wq), ("scalars", scalars)):
        _require(t.dtype == torch.float32, f"{name} must be float32, got {t.dtype}")
    _require(seed.dtype == torch.int32, f"seed must be int32 (uint32 bits), got {seed.dtype}")
    _require(b * m < 2**31 and k * n < 2**31, "problem too large for int32 indexing")

    out = torch.empty((b, m, n), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    global LAUNCHES
    err = library().analog_matmul_launch(
        x.data_ptr(), w.data_ptr(), int(x.dtype == torch.bfloat16),
        row_scale.data_ptr(), col_scale.data_ptr(),
        n if col_scale.shape[0] == b and b > 1 else 0,
        wq.data_ptr(), scalars.data_ptr(), seed.data_ptr(), out.data_ptr(),
        b, m, k, n, NOISE_KINDS[noise_kind],
        int(quant_x), int(quant_w), int(quant_out), int(n_repeats),
        float(np.float32(1.0 / n_repeats)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _check(err, "analog_matmul")
    LAUNCHES += 1
    return out


def threefry_words(k0: int, k1: int, row0: int, col0: int, shape, device="cuda") -> torch.Tensor:
    """Device Threefry words for the counter grid (row0 + i, col0 + j):
    an int32 (rows, cols, 2) tensor holding the uint32 bits. A check, not
    a path of the model: it does not count as a kernel launch."""
    rows, cols = shape
    out = torch.empty((rows, cols, 2), dtype=torch.int32, device=device)
    _require(out.device.type == "cuda", "threefry_words runs on the card only")
    err = library().threefry_words(
        k0 & 0xFFFFFFFF, k1 & 0xFFFFFFFF, row0 & 0xFFFFFFFF, col0 & 0xFFFFFFFF,
        rows, cols, out.data_ptr(), torch.cuda.current_stream(out.device).cuda_stream,
    )
    _check(err, "threefry_words")
    return out
