"""Port vs reference: chunked, grouped prefill attention.

The port's ``chunked_attention`` runs the forward of the reference's
``chunked_attention`` (``repro/models/layers.py``): (q-chunk x kv-chunk)
blocks, an online softmax in f32, KV grouped as (B, S, KH, D). Held here at
chunk 32 with T not a multiple of the chunk (the largest divisor is taken),
for MHA, GQA and MQA, windowed and not; the unaligned branch of
``local_attention`` goes through it too. Tolerance: 1e-5 of max|out|, f32
sums in another order. The port skips blocks the masks empty; that the
numbers do not move is held against a one-block run, and that no (B, H, T,
T) tensor is built is held by recording every tensor an op returns.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs as several processes on the cores (pytest-xdist): torch's
# intra-op threads in each would oversubscribe them (20x slower when six run)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.models import layers  # noqa: E402

REL = 1e-5
H, D = 4, 8


def _qkv(t, kh, seed=0, b=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((b, t, kh, D)).astype(np.float32) for _ in range(2))
    return q, k, v


def _close(got, want, rel=REL):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


@pytest.mark.parametrize("t", [45, 64, 100], ids=["t45", "t64", "t100"])
@pytest.mark.parametrize("kh", [4, 2, 1], ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("window", [None, 24], ids=["global", "window24"])
def test_chunked_attention_matches_reference(t, kh, window):
    q, k, v = _qkv(t, kh)
    want = jlayers.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_chunk=32,
                                     kv_chunk=32, causal=True, window=window)
    got = layers.chunked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                   q_chunk=32, kv_chunk=32, window=window)
    _close(got, want)


@pytest.mark.parametrize("t,window", [(13, 4), (40, 16), (6, 8)], ids=["t13w4", "t40w16", "short"])
@pytest.mark.parametrize("kh", [2, 1], ids=["gqa", "mqa"])
def test_local_attention_grouped_matches_reference(t, window, kh):
    """The unaligned / short branch (``t % window`` or ``t <= window``) runs
    the chunked path with ``q_chunk = min(t, window)``; the aligned branch
    is held in ``test_torch_griffin.py``. Grouped KV here."""
    q, k, v = _qkv(t, kh, seed=1)
    want = jlayers.local_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window)
    got = layers.local_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 window=window)
    _close(got, want)


def test_local_attention_aligned_grouped_matches_reference():
    q, k, v = _qkv(32, 1, seed=2)
    want = jlayers.local_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=8)
    got = layers.local_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 window=8)
    _close(got, want)


@pytest.mark.parametrize("window", [None, 20])
def test_skipped_blocks_leave_the_numbers(window):
    """Blocks of 8 (most of them skipped by the causal or window mask)
    against one 96 x 96 block: the same output to f32 rounding."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(96, 2, seed=3))
    small = layers.chunked_attention(q, k, v, q_chunk=8, kv_chunk=8, window=window)
    one = layers.chunked_attention(q, k, v, q_chunk=96, kv_chunk=96, window=window)
    _close(small, one)


@pytest.mark.parametrize("t,chunk,want", [(45, 32, 15), (64, 32, 32), (100, 32, 25), (7, 32, 7),
                                          (97, 32, 1)])
def test_chunk_is_the_largest_divisor(t, chunk, want):
    assert layers._divisor_chunk(t, chunk) == want


class _Sizes(TorchDispatchMode):
    """The largest tensor any op returns."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(o, torch.Tensor):
                self.largest = max(self.largest, o.numel())
        return out


@pytest.mark.parametrize("kh", [4, 1], ids=["mha", "mqa"])
def test_no_full_score_matrix_is_built(kh):
    """T = 256 in chunks of 32: no op returns a tensor as large as one
    (B, H, T, T) score matrix; the largest is a block of scores (B, KH, G,
    32, 32) or a (B, T, H, D) activation."""
    b, t = 2, 256
    q, k, v = (torch.from_numpy(a) for a in _qkv(t, kh, b=b))
    with _Sizes() as sizes:
        layers.chunked_attention(q, k, v, q_chunk=32, kv_chunk=32)
    assert sizes.largest <= max(b * H * 32 * 32, b * t * H * D) < b * H * t * t


@pytest.mark.parametrize("t,window", [(97, None), (101, 24)], ids=["prime", "prime-window24"])
def test_lengths_without_a_useful_divisor(t, window):
    """A prime T: the reference's rule would give 1-row blocks; the port
    takes blocks of the chunk with a short last one (``_chunk``), the same
    result to f32 rounding."""
    assert layers._chunk(t, 32) == 32
    q, k, v = _qkv(t, 2, seed=4)
    want = jlayers.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_chunk=32,
                                     kv_chunk=32, causal=True, window=window)
    got = layers.chunked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                   q_chunk=32, kv_chunk=32, window=window)
    _close(got, want)
