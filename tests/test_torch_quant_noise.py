"""Port vs reference: the quantizers, the noise functions, the ``"torch"``
backend (the reference's ``"jnp"``) and Adam.

Inputs are made with numpy from a seed and handed to both packages.

* Quantizer codes, ``calibrate_minmax`` (per tensor, per channel) and
  ``merge_running``: bit-exact. ``calibrate_percentile``: within one
  float32 ulp (both interpolate in float32; the sums may round apart once),
  on an input above 2^24 elements too. The straight-through gradients of
  ``ste_round``, ``fake_quant`` (half the gradient on a clip bound, as
  ``jnp.clip``) and ``ste_snap_levels`` equal ``jax.grad`` of the
  reference's to float32 rounding (rtol 1e-6).
* The ``"torch"`` backend draws from ``torch.Generator`` and the
  reference's ``"jnp"`` from ``jax.random``: their noise std agrees within
  10 % (the rule of ``tests/test_kernels.py``) for each noise kind. Inside
  the port: ``d noise / dE = -noise / (2E)`` (std ∝ E^-1/2) to 1e-5, K
  repeats equal one draw at K·E bit for bit, solo == batched bit for bit.
* ``analog_dot`` on ``backend="cuda"`` refuses an energy or input that
  requires grad before it touches a device.
* Adam: the same gradients give the same parameters to 1e-6 relative over
  10 steps.
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
from repro.core import noise as jnoise  # noqa: E402
from repro.core.analog import analog_dot as janalog_dot  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.quant import affine as jaffine  # noqa: E402
from repro_torch.core import noise  # noqa: E402
from repro_torch.core.analog import AnalogConfig, analog_dot, key_seed  # noqa: E402
from repro_torch.kernels.prng import PRNGKey, fold_in  # noqa: E402
from repro_torch.optim import AdamConfig, adam_init, adam_update  # noqa: E402
from repro_torch.quant import affine  # noqa: E402

STD_REL = 0.10
GRAD_RTOL = 1e-6


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _qp_pair(x, **kw):
    return jaffine.calibrate_minmax(jnp.asarray(x), **kw), affine.calibrate_minmax(
        torch.from_numpy(x), **kw)


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channel_axis", [None, 0, 1, -1])
def test_calibrate_minmax_bit_exact(channel_axis):
    x = _x((37, 19), seed=1) + 0.5
    jqp, qp = _qp_pair(x, bits=6.0, channel_axis=channel_axis)
    assert np.array_equal(np.asarray(jqp.x_min), qp.x_min.numpy())
    assert np.array_equal(np.asarray(jqp.x_max), qp.x_max.numpy())
    assert qp.bits == jqp.bits


@pytest.mark.parametrize("bits", [8.0, 4.644, 2.0])
@pytest.mark.parametrize("channel_axis", [None, 1])
def test_quantize_codes_bit_exact(bits, channel_axis):
    x = _x((64, 24), seed=2)
    jqp, qp = _qp_pair(x, bits=bits, channel_axis=channel_axis)
    y = _x((64, 24), seed=3, scale=1.3)  # some values outside the range: clipped
    jcode = np.asarray(jaffine.quantize(jnp.asarray(y), jqp))
    code = affine.quantize(torch.from_numpy(y), qp).numpy()
    assert np.array_equal(jcode, code)
    assert np.array_equal(np.asarray(jaffine.fake_quant(jnp.asarray(y), jqp)),
                          affine.fake_quant(torch.from_numpy(y), qp).numpy())
    assert np.array_equal(np.asarray(jaffine.dequantize(jnp.asarray(jcode), jqp)),
                          affine.dequantize(torch.from_numpy(code), qp).numpy())


def test_merge_running_bit_exact():
    a, b = _x((50,), seed=4), _x((50,), seed=5) * 2
    ja, ta = _qp_pair(a)
    jb, tb = _qp_pair(b)
    for m in (0.99, 0.5):
        jm, tm = jaffine.merge_running(ja, jb, m), affine.merge_running(ta, tb, m)
        assert np.array_equal(np.asarray(jm.x_min), tm.x_min.numpy())
        assert np.array_equal(np.asarray(jm.x_max), tm.x_max.numpy())


@pytest.mark.parametrize("n,percentile", [(1000, 99.99), (4097, 99.0), (2**24 + 1001, 99.99)])
def test_calibrate_percentile_within_one_ulp(n, percentile):
    x = _x((n,), seed=6)
    jqp = jaffine.calibrate_percentile(jnp.asarray(x), percentile=percentile)
    qp = affine.calibrate_percentile(torch.from_numpy(x), percentile=percentile)
    for j, t in ((jqp.x_min, qp.x_min), (jqp.x_max, qp.x_max)):
        j, t = np.float32(np.asarray(j)), np.float32(t.numpy())
        assert abs(float(j) - float(t)) <= float(np.spacing(abs(j))), (j, t)


def _jgrad(fn, x, c):
    return np.asarray(jax.grad(lambda v: jnp.sum(fn(v) * c))(jnp.asarray(x)))


def _tgrad(fn, x, c):
    v = torch.from_numpy(x.copy()).requires_grad_(True)
    torch.sum(fn(v) * torch.from_numpy(c)).backward()
    return v.grad.numpy()


def test_ste_gradients_equal_jax():
    x = _x((48, 16), seed=7)
    jqp, qp = _qp_pair(x, bits=4.0, channel_axis=1)
    y = _x((48, 16), seed=8, scale=1.5)
    # values exactly on the clip bounds: half the gradient there
    y[0] = np.asarray(jqp.x_min).reshape(-1)
    y[1] = np.asarray(jqp.x_max).reshape(-1)
    c = _x((48, 16), seed=9)
    cases = [
        (lambda v: jaffine.fake_quant(v, jqp), lambda v: affine.fake_quant(v, qp)),
        (lambda v: jaffine.quantize(v, jqp), lambda v: affine.quantize(v, qp)),
        (jaffine.ste_round, affine.ste_round),
        (lambda v: jaffine.ste_snap_levels(jnp.abs(v), 0.3),
         lambda v: affine.ste_snap_levels(torch.abs(v), 0.3)),
    ]
    for jf, tf in cases:
        np.testing.assert_allclose(_tgrad(tf, y, c), _jgrad(jf, y, c), rtol=GRAD_RTOL, atol=0)
        assert np.array_equal(np.asarray(jf(jnp.asarray(y))), tf(torch.from_numpy(y)).detach().numpy())
    # ste_snap_levels passes gradient 1 everywhere, below one quantum too
    g = _tgrad(lambda v: affine.ste_snap_levels(v, 1.0), np.full((4,), 0.2, np.float32),
               np.ones(4, np.float32))
    assert np.array_equal(g, np.ones(4, np.float32))


# ---------------------------------------------------------------------------
# noise functions
# ---------------------------------------------------------------------------


def test_noise_variance_for_layer_matches_reference():
    wr, xr, wc = _x((1, 8), 10) ** 2 + 0.1, np.float32(2.5), _x((1, 8), 11) ** 2 + 0.1
    kw = dict(n_macs=96.0, energy=7.0, w_range=wr, x_range=xr, w_col_norms=wc,
              x_row_norm_sq_mean=np.float32(3.0))
    for kind in noise.KINDS:
        spec, jspec = noise.NoiseSpec(kind=kind, sigma=0.05), jnoise.NoiseSpec(kind=kind, sigma=0.05)
        got = noise.noise_variance_for_layer(
            spec, **{k: torch.as_tensor(v) for k, v in kw.items()})
        want = jnoise.noise_variance_for_layer(jspec, **{k: jnp.asarray(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_generator_draws_reproducible_with_std():
    std = torch.linspace(0.5, 2.0, 64)
    a = noise.sample_output_noise(torch.Generator().manual_seed(3), (4000, 64), std)
    b = noise.sample_output_noise(torch.Generator().manual_seed(3), (4000, 64), std)
    assert torch.equal(a, b)
    np.testing.assert_allclose((a / std).std(dim=0).numpy(), 1.0, rtol=0.1)
    w = torch.from_numpy(_x((300, 64), 12))
    pw = noise.perturb_weights(torch.Generator().manual_seed(4), w, torch.full((1, 64), 2.0), 0.1,
                                torch.tensor(4.0))
    np.testing.assert_allclose(float((pw - w).std()), 2.0 * 0.1 / 2.0, rtol=0.05)


# ---------------------------------------------------------------------------
# the "torch" backend
# ---------------------------------------------------------------------------

KINDS = {
    "shot": (lambda m, **kw: m.shot(**kw), 10.0),
    "thermal": (lambda m, **kw: m.thermal(0.01, weight_bits=None, act_bits=None, out_bits=None,
                                          **kw), 4.0),
    "weight": (lambda m, **kw: m.weight(0.1, weight_bits=None, act_bits=None, out_bits=None,
                                        **kw), 5.0),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_torch_backend_std_within_10pct_of_jnp(kind):
    make, e = KINDS[kind]
    x, w = _x((32, 64), 13), _x((64, 16), 14, 0.2)
    clean = x @ w
    keys = jax.random.split(jax.random.PRNGKey(5), 128)
    jcfg = make(JAnalogConfig, backend="jnp")
    ys = jax.vmap(lambda k: janalog_dot(jnp.asarray(x), jnp.asarray(w), cfg=jcfg,
                                        energy=jnp.asarray(e), key=k))(keys)
    s_ref = float(jnp.std(ys - clean[None]))
    cfg = make(AnalogConfig, backend="torch")
    seeds = key_seed(fold_in(PRNGKey(5), np.arange(128)), "cpu")
    xs = torch.from_numpy(x).expand(128, *x.shape)
    y = analog_dot(xs, torch.from_numpy(w), cfg=cfg, energy=torch.tensor(e), seed=seeds)
    s_port = float((y - torch.from_numpy(clean)).std())
    assert abs(s_port / s_ref - 1.0) < STD_REL, (s_port, s_ref)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_torch_backend_energy_gradient_is_analytic(kind):
    """noise = std(E)·ξ with std ∝ E^-1/2: d noise / dE = -noise / (2E)."""
    make, e = KINDS[kind]
    cfg, clean_cfg = make(AnalogConfig, backend="torch"), AnalogConfig(mode="analog",
                                                                         backend="torch")
    x, w = torch.from_numpy(_x((8, 32), 15)), torch.from_numpy(_x((32, 12), 16, 0.3))
    c = torch.from_numpy(_x((8, 12), 17))
    seed = key_seed(PRNGKey(9), "cpu")
    energy = torch.tensor(e, requires_grad=True)
    y = analog_dot(x, w, cfg=cfg, energy=energy, seed=seed)
    clean = analog_dot(x, w, cfg=clean_cfg, energy=1.0, seed=seed)
    torch.sum(y * c).backward()
    want = float(torch.sum((y.detach() - clean) * c)) * (-0.5 / e)
    np.testing.assert_allclose(float(energy.grad), want, rtol=1e-5)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_torch_backend_repeats_equal_one_draw_at_k_energy(kind):
    make, e = KINDS[kind]
    cfg = make(AnalogConfig, backend="torch")
    x, w = torch.from_numpy(_x((2, 6, 40), 18)), torch.from_numpy(_x((40, 24), 19, 0.3))
    seed = key_seed(fold_in(PRNGKey(2), np.arange(2)), "cpu")
    for k in (2, 4):
        yk = analog_dot(x, w, cfg=cfg, energy=torch.tensor(e), seed=seed, n_repeats=k)
        y1 = analog_dot(x, w, cfg=cfg, energy=torch.tensor(e) * k, seed=seed)
        assert torch.equal(yk, y1)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_torch_backend_solo_equals_batched(kind):
    make, e = KINDS[kind]
    cfg = make(AnalogConfig, backend="torch")
    x, w = torch.from_numpy(_x((3, 5, 40), 20)), torch.from_numpy(_x((40, 24), 21, 0.3))
    seeds = key_seed(fold_in(PRNGKey(3), np.arange(3)), "cpu")
    batched = analog_dot(x, w, cfg=cfg, energy=e, seed=seeds)
    for b in range(3):
        assert torch.equal(analog_dot(x[b], w, cfg=cfg, energy=e, seed=seeds[b]), batched[b])
    # the same seed draws the same noise; another seed other noise
    assert torch.equal(analog_dot(x[0], w, cfg=cfg, energy=e, seed=seeds[0]), batched[0])
    assert not torch.equal(analog_dot(x[0], w, cfg=cfg, energy=e, seed=seeds[1]), batched[0])


@pytest.mark.parametrize("grad_of", ["energy", "x"])
def test_cuda_backend_refuses_grad(grad_of):
    cfg = AnalogConfig.shot(backend="cuda")
    x = torch.ones((2, 8), requires_grad=grad_of == "x")
    energy = torch.tensor(5.0, requires_grad=grad_of == "energy")
    with pytest.raises(RuntimeError, match='backend="torch" or "tile"'):
        analog_dot(x, torch.ones((8, 4)), cfg=cfg, energy=energy, seed=key_seed(PRNGKey(0), "cpu"))


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_matches_reference_over_10_steps(weight_decay):
    rng = np.random.default_rng(22)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    jcfg = jadam.AdamConfig(lr=0.01, weight_decay=weight_decay)
    cfg = AdamConfig(lr=0.01, weight_decay=weight_decay)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = {"a": torch.from_numpy(p0["a"]), "b": {"c": torch.from_numpy(p0["b"]["c"])}}
    js, ts = jadam.adam_init(jp, jcfg), adam_init(tp, cfg)
    for _ in range(10):
        g = {"a": rng.standard_normal((3, 4)).astype(np.float32),
             "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
        jp, js = jadam.adam_update(jax.tree.map(jnp.asarray, g), js, jp, jcfg)
        tp, ts = adam_update({"a": torch.from_numpy(g["a"]), "b": {"c": torch.from_numpy(g["b"]["c"])}},
                             ts, tp, cfg)
    np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]), rtol=1e-6)
    np.testing.assert_allclose(tp["b"]["c"].numpy(), np.asarray(jp["b"]["c"]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 10


# ---------------------------------------------------------------------------
# redundant coding (core/redundant.py) on "tile": the kernel's rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["time_averaged_dot", "spatial_averaged_dot",
                                "time_averaged_dot_explicit", "spatial_averaged_dot_explicit"])
@pytest.mark.parametrize("kind", ["shot", "weight"])
def test_redundant_dots_match_reference(fn, kind):
    from repro.core import redundant as jredundant
    from repro_torch.core import redundant

    make, e = KINDS[kind]
    x, w = _x((12, 48), 23), _x((48, 20), 24, 0.3)
    kw = dict(base_energy=e, k_repeats=3)
    want = getattr(jredundant, fn)(jnp.asarray(x), jnp.asarray(w), cfg=make(JAnalogConfig, backend="tile"),
                                   key=jax.random.PRNGKey(6), **kw)
    got = getattr(redundant, fn)(torch.from_numpy(x), torch.from_numpy(w),
                                 cfg=make(AnalogConfig, backend="tile"), key=PRNGKey(6), **kw)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5 * float(np.abs(want).max()), rtol=1e-4)


def test_discrete_levels_is_the_ste_snap():
    from repro_torch.core.redundant import discrete_levels

    e = torch.tensor([0.1, 1.4, 2.6], requires_grad=True)
    y = discrete_levels(e, 1.0)
    y.sum().backward()
    assert y.tolist() == [1.0, 1.0, 3.0] and e.grad.tolist() == [1.0, 1.0, 1.0]


def test_log_energy_penalty_gradient_matches_jax_at_the_tie():
    """max(log E_tot - log E_max, 0): half the gradient where the budget is
    met exactly, as jnp.maximum gives (torch.clamp_min would pass all)."""
    from repro.core import energy as jenergy
    from repro_torch.core import energy

    macs = {"a": np.float32(3.0), "b": np.float32(5.0)}
    for e in ({"a": 2.0, "b": 2.0}, {"a": 4.0, "b": 1.0}, {"a": 1.0, "b": 1.0}):
        je = {k: jnp.asarray(np.float32(v)) for k, v in e.items()}
        jg = jax.grad(lambda t: jenergy.log_energy_penalty(
            t, {k: jnp.asarray(v) for k, v in macs.items()}, 2.0, 3.0))(je)
        te = {k: torch.tensor(v, requires_grad=True) for k, v in e.items()}
        energy.log_energy_penalty(te, {k: torch.tensor(v) for k, v in macs.items()}, 2.0,
                                  3.0).backward()
        for k in e:
            np.testing.assert_allclose(float(te[k].grad), float(jg[k]), rtol=1e-6)
