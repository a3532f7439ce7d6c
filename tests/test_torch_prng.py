"""Port vs reference: Threefry words, key chains and gaussian tiles.

Words and keys must agree bit-for-bit; gaussians to a few float32 ulp
(Box-Muller's log/cos differ between XLA and PyTorch in the last bit).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs as several processes on the cores (pytest-xdist): torch's
# intra-op threads in each would oversubscribe them (20x slower when six run)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import analog as janalog  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.kernels import prng as jprng  # noqa: E402
from repro.models import hooks as jhooks  # noqa: E402
from repro_torch.core import analog  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.kernels import prng  # noqa: E402
from repro_torch.models import hooks  # noqa: E402

#: |gaussian| < 6, so 2e-6 is about 4 float32 ulp at the tails
GAUSS_ATOL = 2e-6


def _jwords(a):
    return np.asarray(a, np.uint32).astype(np.int64)


def test_threefry_known_answer():
    x0, x1 = prng.threefry2x32(0, 0, 0, 0)
    assert (x0, x1) == (0x6B200159, 0x99BA4EFE)


def test_threefry_words_match_reference_on_random_counters():
    rng = np.random.default_rng(0)
    k0, k1, c0, c1 = (rng.integers(0, 2**32, 512, dtype=np.uint64).astype(np.int64) for _ in range(4))
    j0, j1 = jprng.threefry2x32(*(jnp.asarray(v.astype(np.uint32)) for v in (k0, k1, c0, c1)))
    t0, t1 = prng.threefry2x32(*(torch.from_numpy(v) for v in (k0, k1, c0, c1)))
    np.testing.assert_array_equal(t0.numpy(), _jwords(j0))
    np.testing.assert_array_equal(t1.numpy(), _jwords(j1))
    n0, n1 = prng.threefry2x32(k0, k1, c0, c1)  # the numpy (host) path
    np.testing.assert_array_equal(n0, _jwords(j0))
    np.testing.assert_array_equal(n1, _jwords(j1))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_prngkey_and_fold_in(seed):
    jk = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.PRNGKey(seed), np.asarray(jk))
    for d in (0, 1, 123456, 0xF0000001):
        np.testing.assert_array_equal(
            prng.fold_in(prng.PRNGKey(seed), d), np.asarray(jax.random.fold_in(jk, d))
        )


def _stacked():
    return [jax.random.fold_in(jax.random.PRNGKey(3), u) for u in range(4)]


def test_fold_key_and_site_key_single_and_stacked():
    jkeys = jnp.stack(_stacked())
    keys = np.asarray(jkeys)
    for jk, k in ((jkeys[1], keys[1]), (jkeys, keys)):
        np.testing.assert_array_equal(analog.fold_key(k, 17), np.asarray(janalog.fold_key(jk, 17)))
        for site in ("attn0_q", "mlp0_out", "x"):
            np.testing.assert_array_equal(
                analog.site_key(analog.fold_key(k, 5), site),
                np.asarray(janalog.site_key(janalog.fold_key(jk, 5), site)),
            )
    # per-row decode positions fold row-wise, as vmap(fold_in)
    pos = np.asarray([3, 9, 0, 40])
    np.testing.assert_array_equal(
        analog.fold_key(keys, pos), np.asarray(jax.vmap(jax.random.fold_in)(jkeys, jnp.asarray(pos)))
    )
    valid = np.asarray([True, False, True, True])
    np.testing.assert_array_equal(
        analog.collapse_keys(keys, valid), np.asarray(janalog.collapse_keys(jkeys, jnp.asarray(valid)))
    )


@pytest.mark.parametrize("stacked", [False, True])
def test_hook_for_layer_site_chain_and_seed_table(stacked):
    jkey = jnp.stack(_stacked()) if stacked else jax.random.PRNGKey(11)
    key = np.asarray(jkey)
    sites = ["attn0_q", "attn0_k", "mlp0_gate", "mlp0_out"]
    table = torch.from_numpy(analog.site_seed_words(key, 3, sites))
    words = table.numpy().view(np.uint32)
    for layer in range(3):
        jh = jhooks.hook_for_layer(JAnalogConfig.shot(), {}, jkey, layer)
        h = hooks.hook_for_layer(
            AnalogConfig.shot(), {}, {s: table[layer, i] for i, s in enumerate(sites)}
        )
        for s, site in enumerate(sites):
            want = np.asarray(janalog.site_key(jh.key, site))
            np.testing.assert_array_equal(analog.site_key(analog.fold_key(key, layer), site), want)
            np.testing.assert_array_equal(words[layer, s][..., :2], want)
            np.testing.assert_array_equal(words[layer, s][..., 2:], 0)
            assert torch.equal(h.seeds[site], table[layer, s])
            k0, k1 = jprng.key_to_words(want if not stacked else want[0])
            assert (int(k0), int(k1)) == tuple(int(v) for v in prng.key_to_words(
                want if not stacked else want[0]))


@pytest.mark.parametrize("n_repeats", [1, 3])
def test_gaussian_tiles_match_reference(n_repeats):
    for k0, k1, r0, c0 in ((5, 9, 0, 0), (0xFFFFFFFF, 1, 7, 13), (123, 0x85EBCA6B, 2**20, 5)):
        want = jprng.repeat_averaged_gaussian_tile(
            jnp.uint32(k0), jnp.uint32(k1), r0, c0, (24, 40), n_repeats
        )
        got = prng.repeat_averaged_gaussian_tile(k0, k1, r0, c0, (24, 40), n_repeats)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GAUSS_ATOL, rtol=0)


def test_gaussian_tile_offset_consistency_and_moments():
    full = prng.gaussian_tile(1, 2, 0, 0, (32, 32))
    sub = prng.gaussian_tile(1, 2, 8, 16, (8, 8))
    torch.testing.assert_close(full[8:16, 16:24], sub, rtol=0, atol=0)
    g = prng.gaussian_tile(5, 9, 0, 0, (64, 64)).reshape(-1)
    assert abs(float(g.mean())) < 0.05
    assert float(g.std()) == pytest.approx(1.0, rel=0.05)


def test_per_request_tiles_equal_solo_tiles():
    """A (B, 1, 1) key table draws, per request, exactly its solo tile."""
    k0 = torch.tensor([3, 4, 5], dtype=torch.int64).reshape(3, 1, 1)
    k1 = torch.tensor([7, 7, 0xFFFFFFFF], dtype=torch.int64).reshape(3, 1, 1)
    both = prng.repeat_averaged_gaussian_tile(k0, k1, 2, 5, (6, 10), 4)
    for b in range(3):
        solo = prng.repeat_averaged_gaussian_tile(int(k0[b]), int(k1[b]), 2, 5, (6, 10), 4)
        torch.testing.assert_close(both[b], solo, rtol=0, atol=0)
