"""Counter-based PRNG (Threefry-2x32, 20 rounds) + Box-Muller gaussians.

Port of ``repro/kernels/prng.py``. The device functions of the CUDA kernel
(``csrc/analog_matmul.cu``) compute the same words; this module is their
plain version.

Words are held as non-negative int64 values below 2**32 and every add and
shift is masked with ``0xFFFFFFFF``: torch on the CPU has no uint32 add or
shift. The same arithmetic runs on numpy int64 arrays, which is how the
host builds per-forward key tables (``fold_in`` over numpy keys).

Key functions mirror ``jax.random``'s raw uint32 keys: a key is a numpy
``uint32`` array of shape (2,) (single) or (B, 2) (stacked, one per
request). ``PRNGKey(s) = [0, s]`` and ``fold_in(k, d) = threefry(k, (0, d))``.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA
#: salt xored into the key for the weight-noise stream.
WEIGHT_STREAM_SALT = 0x9E3779B9
#: multiplier folded into the key word per repeat index (K-repeat averaging).
REPEAT_STREAM_MULT = 0x85EBCA6B
#: float32(2.0 * 3.14159265358979), the Box-Muller angle scale.
TWO_PI_F32 = float(np.float32(2.0 * 3.14159265358979))
_UNIT = 2.0**-24


def _rotl(x, d: int):
    return ((x << d) & MASK) | (x >> (32 - d))


def _rounds(x0, x1, rots):
    for d in rots:
        x0 = (x0 + x1) & MASK
        x1 = _rotl(x1, d)
        x1 = x1 ^ x0
    return x0, x1


#: the key words injected after each group of four rounds: (into x0, into
#: x1, the count added to x1), as indices into (k0, k1, ks2)
_INJECT = ((1, 2, 1), (2, 0, 2), (0, 1, 3), (1, 2, 4), (2, 0, 5))


def _threefry_torch(k0, k1, c0, c1):
    """``threefry2x32`` on torch tensors: every step in place on the two
    words and one scratch buffer, a third of the passes over memory that a
    new tensor an op takes; the same bits."""
    ts = [v for v in (k0, k1, c0, c1) if torch.is_tensor(v)]
    shape = torch.broadcast_shapes(*(v.shape for v in ts))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = torch.zeros(shape, dtype=torch.int64, device=ts[0].device)
    x1, tmp = torch.zeros_like(x0), torch.empty_like(x0)
    x0.add_(c0).add_(k0).bitwise_and_(MASK)
    x1.add_(c1).add_(k1).bitwise_and_(MASK)
    for rots, (a, b, n) in zip((_ROT_A, _ROT_B, _ROT_A, _ROT_B, _ROT_A), _INJECT):
        for d in rots:
            x0.add_(x1).bitwise_and_(MASK)
            torch.bitwise_right_shift(x1, 32 - d, out=tmp)
            x1.bitwise_left_shift_(d).bitwise_and_(MASK).bitwise_or_(tmp).bitwise_xor_(x0)
        x0.add_(ks[a]).bitwise_and_(MASK)
        x1.add_(ks[b]).add_(n).bitwise_and_(MASK)
    return x0, x1


def threefry2x32(k0, k1, c0, c1):
    """Full 20-round Threefry-2x32 on int64 words (torch or numpy),
    broadcastable. Returns two int64 word arrays in [0, 2**32)."""
    if any(torch.is_tensor(v) for v in (k0, k1, c0, c1)):
        return _threefry_torch(k0, k1, c0, c1)
    ks2 = k0 ^ k1 ^ _PARITY
    x0 = (c0 + k0) & MASK
    x1 = (c1 + k1) & MASK
    x0, x1 = _rounds(x0, x1, _ROT_A)
    x0 = (x0 + k1) & MASK
    x1 = (x1 + ks2 + 1) & MASK
    x0, x1 = _rounds(x0, x1, _ROT_B)
    x0 = (x0 + ks2) & MASK
    x1 = (x1 + k0 + 2) & MASK
    x0, x1 = _rounds(x0, x1, _ROT_A)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1 + 3) & MASK
    x0, x1 = _rounds(x0, x1, _ROT_B)
    x0 = (x0 + k1) & MASK
    x1 = (x1 + ks2 + 4) & MASK
    x0, x1 = _rounds(x0, x1, _ROT_A)
    x0 = (x0 + ks2) & MASK
    x1 = (x1 + k0 + 5) & MASK
    return x0, x1


def bits_to_unit_open(bits: torch.Tensor) -> torch.Tensor:
    """int64 words -> float32 in (0, 1]: 1 - (bits >> 8) * 2^-24."""
    return 1.0 - (bits >> 8).to(torch.float32) * _UNIT


def bits_to_unit_halfopen(bits: torch.Tensor) -> torch.Tensor:
    """int64 words -> float32 in [0, 1)."""
    return (bits >> 8).to(torch.float32) * _UNIT


def counter_gaussian(k0, k1, c0, c1) -> torch.Tensor:
    """One standard gaussian per (c0, c1) counter pair via Box-Muller."""
    b0, b1 = threefry2x32(k0, k1, c0, c1)
    u1 = bits_to_unit_open(b0)
    u2 = bits_to_unit_halfopen(b1)
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = TWO_PI_F32 * u2
    return r * torch.cos(theta)


def gaussian_tile(k0, k1, row0, col0, shape, device=None) -> torch.Tensor:
    """Gaussians for global element indices [row0:row0+m, col0:col0+n).

    ``k0``/``k1``/``row0``/``col0`` are ints or int64 tensors; tensors of
    shape (B, 1, 1) give one (m, n) tile per request, (B, m, n) in all.
    """
    m, n = shape
    if device is None:
        device = next(
            (v.device for v in (k0, k1, row0, col0) if torch.is_tensor(v)), "cpu"
        )
    rows = torch.arange(m, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    return counter_gaussian(k0, k1, (rows + row0) & MASK, (cols + col0) & MASK)


def repeat_key(k1, r: int):
    """Second key word for repeat stream ``r``; ``r = 0`` leaves ``k1``."""
    return k1 ^ ((r * REPEAT_STREAM_MULT) & MASK)


#: counters a plain tile draws at once: a larger tile is drawn in blocks of
#: rows, which bounds the int64 temporaries (16 M words of 8 bytes each);
#: every value depends on its own counter alone, so the blocks change none
TILE_ELEMS = 1 << 24


def repeat_averaged_gaussian_tile(
    k0, k1, row0, col0, shape, n_repeats: int, device=None
) -> torch.Tensor:
    """Mean of ``n_repeats`` gaussian tiles, one per repeat stream.

    The order (r = 0..K-1) and the final ``float32(1/K)`` scale are part of
    the contract shared with the CUDA kernel and the reference.
    """
    m, n = shape
    lead = max([v.numel() for v in (k0, k1, row0, col0) if torch.is_tensor(v)] + [1])
    rows = max(1, TILE_ELEMS // max(1, n * lead))
    if m > rows:
        return torch.cat([
            repeat_averaged_gaussian_tile(k0, k1, row0 + lo, col0, (min(rows, m - lo), n),
                                          n_repeats, device)
            for lo in range(0, m, rows)
        ], dim=-2)
    xi = gaussian_tile(k0, k1, row0, col0, shape, device)
    for r in range(1, n_repeats):
        xi = xi + gaussian_tile(k0, repeat_key(k1, r), row0, col0, shape, device)
    if n_repeats > 1:
        xi = xi * float(np.float32(1.0 / n_repeats))
    return xi


# ---------------------------------------------------------------------------
# raw uint32 keys (the host side of the key chain)
# ---------------------------------------------------------------------------


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey`` for a 32-bit seed: the raw key ``[0, seed]``."""
    return np.asarray([0, int(seed) & MASK], np.uint32)


def fold_in(key, data) -> np.ndarray:
    """``jax.random.fold_in`` on raw keys: ``threefry(key, (0, data))``.

    ``key`` (..., 2) uint32; ``data`` an int or an integer array that
    broadcasts against ``key[..., 0]`` (a (B,) array folds row-wise, as
    ``vmap(fold_in)`` does).
    """
    key = np.asarray(key, np.uint32).astype(np.int64)
    data = np.asarray(data).astype(np.int64) & MASK
    x0, x1 = threefry2x32(key[..., 0], key[..., 1], np.zeros_like(data), data)
    return np.stack(np.broadcast_arrays(x0, x1), axis=-1).astype(np.uint32)


def split(key, num: int) -> np.ndarray:
    """``jax.random.split`` on a raw (2,) key, as JAX computes it with
    ``jax_threefry_partitionable`` on: key ``i`` of the ``num`` is
    ``threefry(key, (0, i))``, which is ``fold_in(key, i)``. Returns
    (num, 2) uint32."""
    return fold_in(np.asarray(key, np.uint32)[None, :], np.arange(int(num)))


def key_to_words(key):
    """Raw key -> its two uint32 key words (a one-word key is ``(0, w)``)."""
    data = np.asarray(key, np.uint32).reshape(-1)
    if data.size == 1:
        return np.uint32(0), data[0]
    return data[0], data[1]
