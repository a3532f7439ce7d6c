"""Plain PyTorch version of the analog-matmul kernel.

Port of ``repro/kernels/ref.py`` with a leading request axis: request ``b``
computes exactly what the reference computes for one ``vmap`` row — its own
seed words, its own row/col scales and, for weight noise, its own noisy
weights. The gaussians are keyed on global element indices, so this and the
CUDA kernel agree for any tiling. The CPU path of ``analog_matmul_raw`` and
the "tile" backend run this; on the card it is the kernel's comparison.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import prng


def _fake_quant(v, delta, zp, bins):
    code = torch.clamp_min(torch.round(v / delta) + zp, 0.0)
    code = torch.minimum(code, torch.as_tensor(bins, dtype=code.dtype, device=code.device))
    return (code - zp) * delta


def seed_words(seed: torch.Tensor):
    """(B, 4) int32 seed table (uint32 bits) -> four (B, 1, 1) int64 words
    ``k0, k1, row0, col0``."""
    words = seed.to(torch.int64) & prng.MASK
    return [words[:, i].reshape(-1, 1, 1) for i in range(4)]


def analog_matmul_ref_raw(
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

    row_scale (B, M, 1); col_scale (B, 1, N) or (1, 1, N); wq (3, N) rows =
    (delta, zp, bins); scalars (1, 8) = (xd, xz, xbins, od, oz, obins, 0, 0);
    seed (B, 4) int32 holding the uint32 words (k0, k1, row0, col0).
    """
    _, m, k = x.shape
    n = w.shape[1]
    sc = scalars.to(torch.float32).reshape(-1)
    k0, k1, row0, col0 = seed_words(seed)
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    cs = col_scale.to(torch.float32)

    if quant_x:
        x = _fake_quant(x, sc[0], sc[1], sc[2])
    if quant_w:
        w = _fake_quant(w, wq[0:1, :], wq[1:2, :], wq[2:3, :])
    if noise_kind == "weight":
        xi = prng.repeat_averaged_gaussian_tile(
            k0 ^ prng.WEIGHT_STREAM_SALT, k1, 0, col0, (k, n), n_repeats
        )
        w = w + cs * xi  # (B, K, N): every request reads its own noisy array

    y = torch.matmul(x, w)

    if noise_kind == "output":
        xi = prng.repeat_averaged_gaussian_tile(k0, k1, row0, col0, (m, n), n_repeats)
        y = y + row_scale.to(torch.float32) * cs * xi
    if quant_out:
        y = _fake_quant(y, sc[3], sc[4], sc[5])
    return y
