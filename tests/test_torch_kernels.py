"""Port vs reference: the plain analog matmul and ``analog_dot``.

The port's plain version (what the CUDA kernel is held against on the
card) must agree with the reference's ``analog_matmul_reference`` ("tile")
for every noise kind, K-repeat count and quantizer setting, with stacked
per-request seeds equal to the reference's ``vmap`` over stacked keys.
Tolerance: the reference's own kernel-vs-oracle rule
(``tests/test_kernels.py``): ``atol = 3e-5 * max|y|``, widened to one
output-quantizer bin under output quant, ``rtol = 1e-4``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs as several processes on the cores (pytest-xdist): torch's
# intra-op threads in each would oversubscribe them (20x slower when six run)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.core import SiteQuant as JSiteQuant  # noqa: E402
from repro.core.analog import analog_dot as janalog_dot  # noqa: E402
from repro.kernels import analog_matmul as jkernel  # noqa: E402
from repro.kernels import analog_matmul_reference as jreference  # noqa: E402
from repro.quant import calibrate_minmax  # noqa: E402
from repro_torch.core.analog import AnalogConfig, SiteQuant, analog_dot, key_seed  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.analog_matmul import analog_matmul_raw  # noqa: E402
from repro_torch.quant.affine import QuantParams  # noqa: E402

SHAPES = [(32, 64, 16), (96, 200, 72), (128, 128, 128), (17, 33, 9)]
KEY = jax.random.PRNGKey(11)
KINDS = {
    "shot": (lambda m, **kw: m.shot(**kw), 10.0),
    "thermal": (lambda m, **kw: m.thermal(0.01, **kw), 4.0),
    "weight": (lambda m, **kw: m.weight(0.1, **kw), 5.0),
    "none": (lambda m, **kw: m(mode="analog", **kw), 1.0),
}


def _cfgs(kind, **kw):
    make, e = KINDS[kind]
    return make(JAnalogConfig, **kw), make(AnalogConfig, **kw), e


def _data(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.2).astype(np.float32)
    return x, w


def _quant(x, w):
    """Calibrated quantizers for both packages from the same numbers."""
    jsq = JSiteQuant(
        wqp=calibrate_minmax(jnp.asarray(w), channel_axis=1),
        xqp=calibrate_minmax(jnp.asarray(x)),
        oqp=calibrate_minmax(jnp.asarray(x) @ jnp.asarray(w)),
    )

    def port(qp):
        return QuantParams(torch.from_numpy(np.array(qp.x_min)),
                           torch.from_numpy(np.array(qp.x_max)), qp.bits)

    return jsq, SiteQuant(wqp=port(jsq.wqp), xqp=port(jsq.xqp), oqp=port(jsq.oqp))


def _assert_close(got, want, cfg, jsq):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else got
    atol = 3e-5 * (float(np.abs(want).max()) + 1e-6)
    if jsq is not None and cfg.out_bits is not None and jsq.oqp is not None:
        atol = max(atol, float(jsq.oqp.delta) * 1.01)  # one requant bin
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-4)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "quant"])
@pytest.mark.parametrize("n_repeats", [1, 4, 16])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_reference(shape, kind, n_repeats, quant):
    m, k, n = shape
    x, w = _data(m, k, n)
    jcfg, cfg, e = _cfgs(kind)
    jsq, sq = _quant(x, w) if quant else (None, None)
    want = jreference(jnp.asarray(x), jnp.asarray(w), energy=jnp.asarray(e), key=KEY, cfg=jcfg,
                      sq=jsq, n_repeats=n_repeats)
    got = ops.analog_matmul(
        torch.from_numpy(x), torch.from_numpy(w), energy=torch.tensor(e),
        seed=key_seed(np.asarray(KEY), "cpu"), cfg=cfg, sq=sq, n_repeats=n_repeats,
        device="cpu",
    )
    _assert_close(got, want, jcfg, jsq)


@pytest.mark.parametrize("n_repeats", [1, 4])
def test_per_channel_energy(n_repeats):
    x, w = _data(48, 64, 24)
    jcfg, cfg, _ = _cfgs("shot", granularity="per_channel")
    e = np.linspace(1.0, 40.0, 24).astype(np.float32)
    want = jreference(jnp.asarray(x), jnp.asarray(w), energy=jnp.asarray(e), key=KEY, cfg=jcfg,
                      n_repeats=n_repeats)
    got = ops.analog_matmul_reference(
        torch.from_numpy(x), torch.from_numpy(w), energy=torch.from_numpy(e),
        seed=key_seed(np.asarray(KEY), "cpu"), cfg=cfg, n_repeats=n_repeats,
    )
    _assert_close(got, want, jcfg, None)


@pytest.mark.parametrize("n_repeats", [1, 4])
@pytest.mark.parametrize("kind", list(KINDS))
def test_stacked_seeds_match_vmapped_reference(kind, n_repeats):
    """One call over a (B, 4) seed table == the reference's vmap over stacked
    keys: per-request noise, per-request thermal x_range (pad rows included),
    per-request shot row norms, per-request weight-noise draws."""
    b, t, k, n = 3, 6, 40, 24
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, t, k)).astype(np.float32)
    x[2, 4:] = 0.0  # a right-padded request: its zero rows still count in its range
    x[1] *= 3.0  # a request with a wider input range than its batch-mates
    w = (rng.standard_normal((k, n)) * 0.2).astype(np.float32)
    jcfg, cfg, e = _cfgs(kind)
    jkeys = jnp.stack([jax.random.fold_in(KEY, u) for u in range(b)])
    want = jax.vmap(lambda xr, kr: jreference(
        xr, jnp.asarray(w), energy=jnp.asarray(e), key=kr, cfg=jcfg, n_repeats=n_repeats
    ))(jnp.asarray(x), jkeys)
    seeds = key_seed(np.asarray(jkeys), "cpu")
    got = ops.analog_matmul_reference(torch.from_numpy(x), torch.from_numpy(w),
                                      energy=torch.tensor(e), seed=seeds, cfg=cfg,
                                      n_repeats=n_repeats)
    _assert_close(got, want, jcfg, None)
    # and inside the port, batched == solo bit for bit
    for r in range(b):
        solo = ops.analog_matmul_reference(torch.from_numpy(x[r]), torch.from_numpy(w),
                                           energy=torch.tensor(e), seed=seeds[r], cfg=cfg,
                                           n_repeats=n_repeats)
        torch.testing.assert_close(got[r], solo, rtol=0, atol=0)


@pytest.mark.parametrize("n_repeats", [1, 4])
@pytest.mark.parametrize("kind", ["shot", "thermal"])
def test_analog_dot_stacked_keys_matches_reference(kind, n_repeats):
    """``analog_dot`` on stacked keys, against the reference on backend "tile"."""
    b, t, k, n = 2, 5, 32, 16
    rng = np.random.default_rng(2)
    x = rng.standard_normal((b, t, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.2).astype(np.float32)
    make, e = KINDS[kind]
    jcfg, cfg = make(JAnalogConfig, backend="tile"), make(AnalogConfig)
    jkeys = jnp.stack([jax.random.fold_in(KEY, u + 7) for u in range(b)])
    want = janalog_dot(jnp.asarray(x), jnp.asarray(w), cfg=jcfg, energy=jnp.asarray(e),
                       key=jkeys, n_repeats=n_repeats)
    got = analog_dot(torch.from_numpy(x), torch.from_numpy(w), cfg=cfg, energy=torch.tensor(e),
                     seed=key_seed(np.asarray(jkeys), "cpu"), n_repeats=n_repeats)
    _assert_close(got, want, jcfg, None)


def test_digital_analog_dot_is_plain_matmul():
    x, w = _data(8, 16, 4)
    got = analog_dot(torch.from_numpy(x), torch.from_numpy(w), cfg=AnalogConfig())
    torch.testing.assert_close(got, torch.from_numpy(x) @ torch.from_numpy(w))


@pytest.mark.parametrize("kind", ["shot", "weight"])
def test_plain_matches_pallas_kernel_interpret(kind):
    """One tiny case against the Pallas kernel itself (interpret mode)."""
    x, w = _data(24, 40, 20, seed=3)
    jcfg, cfg, e = _cfgs(kind)
    want = jkernel(jnp.asarray(x), jnp.asarray(w), energy=jnp.asarray(e), key=KEY, cfg=jcfg,
                   n_repeats=4, block=(16, 16, 16), interpret=True)
    got = ops.analog_matmul(torch.from_numpy(x), torch.from_numpy(w), energy=torch.tensor(e),
                            seed=key_seed(np.asarray(KEY), "cpu"), cfg=cfg, n_repeats=4,
                            device="cpu")
    _assert_close(got, want, jcfg, None)


def _raw_args(b=2, m=3, k=4, n=5):
    f = torch.float32
    return [torch.zeros(b, m, k), torch.zeros(k, n), torch.ones(b, m, 1, dtype=f),
            torch.ones(1, 1, n, dtype=f), torch.ones(3, n, dtype=f), torch.ones(1, 8, dtype=f),
            torch.zeros(b, 4, dtype=torch.int32)]


@pytest.mark.parametrize("bad", ["x", "row_scale", "col_scale", "seed", "kind"])
def test_raw_wrapper_validates(bad):
    args = _raw_args()
    kw = {}
    if bad == "x":
        args[0] = torch.zeros(2, 3, 7)
    elif bad == "row_scale":
        args[2] = torch.ones(2, 3)
    elif bad == "col_scale":
        args[3] = torch.ones(2, 2, 5)
    elif bad == "seed":
        args[6] = torch.zeros(3, 4, dtype=torch.int32)
    else:
        kw["noise_kind"] = "thermal"
    with pytest.raises(ValueError):
        analog_matmul_raw(*args, **kw)


def test_raw_wrapper_cpu_runs_plain_version():
    y = analog_matmul_raw(*_raw_args(), noise_kind="none")
    assert y.shape == (2, 3, 5) and y.dtype == torch.float32
    assert float(y.abs().max()) == 0.0
