"""Port vs reference: ``analog_conv2d`` (the paper's CNN path).

Inputs are numpy from a seed, handed to both packages; the reference runs
on its ``"tile"`` backend, the port on the CPU's plain path (``"auto"``).

* ``conv_patches`` equals ``jax.lax.conv_general_dilated_patches`` bit for
  bit: 3x3 at strides 1 and 2, 7x7 at stride 2 on a 10x7 input (XLA's
  asymmetric ``"SAME"``), 1x1 and 2x2 at stride 2, ``"VALID"`` at strides 1
  and 2, and explicit ((top, bottom), (left, right)) pairs.
* ``analog_conv2d`` against the reference's at B = 2, H, W <= 10, Cin 8,
  Cout 16, for noise none, shot, thermal and weight, quantizers on and
  off, strides 1 and 2; K = 4 (at stride 2) through ``analog_dot`` on the
  same patches (the reference's conv takes no K); the digital mode;
  per-channel energy. Tolerance: the kernel rule of ``tests/test_kernels.py``,
  ``3e-5 max|y|`` plus ``1e-4 |y|``, widened to one output-quantizer bin
  under requant.
* The energy gradient on ``"tile"`` within ``1e-4 max|g|`` of ``jax.grad``
  of the reference's, scalar and per-channel.
* The paper-table CNN (``benchmarks/common.py`` ``build_cnn``: three 3x3
  convs, stride 1 then 2, ReLU, a spatial mean and an ``analog_dot``
  head) end to end on ``make_image_dataset`` images against the same
  composition of the reference's functions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.core import SiteQuant as JSiteQuant  # noqa: E402
from repro.core.analog import analog_conv2d as janalog_conv2d  # noqa: E402
from repro.core.analog import analog_dot as janalog_dot  # noqa: E402
from repro.core.analog import site_key as jsite_key  # noqa: E402
from repro.data.synthetic import make_image_dataset as jmake_image_dataset  # noqa: E402
from repro.quant import calibrate_minmax  # noqa: E402
from repro_torch.core import analog_conv2d  # noqa: E402
from repro_torch.core.analog import (  # noqa: E402
    AnalogConfig,
    SiteQuant,
    analog_dot,
    conv_patches,
    conv_weight_matrix,
    fold_key,
    key_seed,
    site_key,
)
from repro_torch.data import make_image_dataset  # noqa: E402
from repro_torch.quant.affine import QuantParams  # noqa: E402

KEY = jax.random.PRNGKey(7)
REL_ATOL, RTOL, GRAD_REL = 3e-5, 1e-4, 1e-4
KINDS = {
    "none": (lambda m, **kw: m(mode="analog", **kw), 1.0),
    "shot": (lambda m, **kw: m.shot(**kw), 10.0),
    "thermal": (lambda m, **kw: m.thermal(0.01, **kw), 4.0),
    "weight": (lambda m, **kw: m.weight(0.1, **kw), 5.0),
}
PATCH_CASES = [  # (B, H, W, C, kh, kw, stride, padding)
    (2, 8, 8, 3, 3, 3, 1, "SAME"),
    (2, 8, 8, 3, 3, 3, 2, "SAME"),
    (2, 10, 7, 3, 7, 7, 2, "SAME"),
    (2, 8, 8, 4, 1, 1, 2, "SAME"),
    (2, 8, 8, 4, 2, 2, 2, "SAME"),
    (2, 9, 9, 3, 3, 3, 1, "VALID"),
    (2, 10, 9, 2, 3, 3, 2, "VALID"),
    (2, 9, 8, 3, 3, 3, 2, ((1, 2), (0, 1))),
    (1, 7, 7, 2, 2, 3, 1, ((0, 0), (2, 1))),
]


def _data(h=10, w=10, cin=8, cout=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    return x, k


def _jpatches(x, kh, kw, stride, padding="SAME"):
    return jax.lax.conv_general_dilated_patches(
        jnp.asarray(x), (kh, kw), (stride, stride), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def _quant(x, k, stride):
    """Calibrated quantizers from the reference's patches and im2col weight,
    for both packages."""
    p = _jpatches(x, 3, 3, stride)
    w = jnp.transpose(jnp.asarray(k), (2, 0, 1, 3)).reshape(-1, k.shape[-1])
    jsq = JSiteQuant(wqp=calibrate_minmax(w, channel_axis=1), xqp=calibrate_minmax(p),
                     oqp=calibrate_minmax(p @ w))

    def port(qp):
        return QuantParams(torch.from_numpy(np.array(qp.x_min)),
                           torch.from_numpy(np.array(qp.x_max)), qp.bits)

    return jsq, SiteQuant(wqp=port(jsq.wqp), xqp=port(jsq.xqp), oqp=port(jsq.oqp))


def _assert_close(got, want, jcfg, jsq):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    atol = REL_ATOL * (float(np.abs(want).max()) + 1e-6)
    if jsq is not None and jcfg.out_bits is not None:
        atol = max(atol, float(jsq.oqp.delta) * 1.01)  # one requant bin
    np.testing.assert_allclose(got, want, atol=atol, rtol=RTOL)


def _seed(key=KEY):
    return key_seed(np.asarray(key), "cpu")


@pytest.mark.parametrize("case", PATCH_CASES, ids=lambda c: "-".join(map(str, c[4:7])) + str(c[7])[:5])
def test_patches_bit_equal(case):
    b, h, w, c, kh, kw, stride, padding = case
    x = np.random.default_rng(1).standard_normal((b, h, w, c)).astype(np.float32)
    want = np.asarray(_jpatches(x, kh, kw, stride, padding))
    got = conv_patches(torch.from_numpy(x), kh, kw, stride, padding).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "quant"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_conv_matches_reference(kind, quant, stride):
    make, e = KINDS[kind]
    jcfg, cfg = make(JAnalogConfig, backend="tile"), make(AnalogConfig)
    x, k = _data()
    jsq, sq = _quant(x, k, stride) if quant else (None, None)
    want = janalog_conv2d(jnp.asarray(x), jnp.asarray(k), cfg=jcfg, stride=stride,
                          energy=jnp.asarray(e), key=KEY, sq=jsq)
    got = analog_conv2d(torch.from_numpy(x), torch.from_numpy(k), cfg=cfg, stride=stride,
                        energy=torch.tensor(e), seed=_seed(), sq=sq)
    _assert_close(got, want, jcfg, jsq)


@pytest.mark.parametrize("kind", list(KINDS))
def test_conv_at_four_repeats_matches_reference(kind, stride=2):
    """K = 4: ``analog_dot`` on the conv's patches and im2col weight, the
    reference's composition on both sides."""
    make, e = KINDS[kind]
    jcfg, cfg = make(JAnalogConfig, backend="tile"), make(AnalogConfig)
    x, k = _data(seed=2)
    jw = jnp.transpose(jnp.asarray(k), (2, 0, 1, 3)).reshape(-1, k.shape[-1])
    want = janalog_dot(_jpatches(x, 3, 3, stride), jw, cfg=jcfg, energy=jnp.asarray(e),
                       key=KEY, n_repeats=4)
    got = analog_dot(conv_patches(torch.from_numpy(x), 3, 3, stride),
                     conv_weight_matrix(torch.from_numpy(k)), cfg=cfg, energy=torch.tensor(e),
                     seed=_seed(), n_repeats=4)
    _assert_close(got, want, jcfg, None)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "quant"])
def test_digital_conv_matches_reference(quant):
    x, k = _data(h=9, w=7)
    jsq, sq = _quant(x, k, 2) if quant else (None, None)
    jcfg = JAnalogConfig()
    want = janalog_conv2d(jnp.asarray(x), jnp.asarray(k), cfg=jcfg, stride=2, sq=jsq)
    got = analog_conv2d(torch.from_numpy(x), torch.from_numpy(k), cfg=AnalogConfig(),
                        stride=2, sq=sq)
    _assert_close(got, want, jcfg, jsq)


def _energies(per_channel):
    return np.linspace(2.0, 30.0, 16).astype(np.float32) if per_channel else np.float32(6.0)


@pytest.mark.parametrize("per_channel", [False, True], ids=["scalar", "per_channel"])
def test_energy_forms_match_reference(per_channel):
    kw = dict(granularity="per_channel") if per_channel else {}
    jcfg, cfg = JAnalogConfig.shot(backend="tile", **kw), AnalogConfig.shot(**kw)
    x, k = _data(seed=3)
    e = _energies(per_channel)
    want = janalog_conv2d(jnp.asarray(x), jnp.asarray(k), cfg=jcfg, stride=2,
                          energy=jnp.asarray(e), key=KEY)
    got = analog_conv2d(torch.from_numpy(x), torch.from_numpy(k), cfg=cfg, stride=2,
                        energy=torch.from_numpy(np.array(e)), seed=_seed())
    _assert_close(got, want, jcfg, None)


@pytest.mark.parametrize("per_channel", [False, True], ids=["scalar", "per_channel"])
def test_energy_gradient_matches_reference(per_channel):
    kw = dict(granularity="per_channel") if per_channel else {}
    jcfg = JAnalogConfig.shot(backend="tile", **kw)
    cfg = AnalogConfig.shot(backend="tile", **kw)
    x, k = _data(seed=4)
    r = np.random.default_rng(5).standard_normal((2, 5, 5, 16)).astype(np.float32)
    e = _energies(per_channel)

    def jloss(en):
        y = janalog_conv2d(jnp.asarray(x), jnp.asarray(k), cfg=jcfg, stride=2, energy=en,
                           key=KEY)
        return jnp.sum(y * r)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(e)))
    en = torch.from_numpy(np.array(e)).requires_grad_()
    y = analog_conv2d(torch.from_numpy(x), torch.from_numpy(k), cfg=cfg, stride=2, energy=en,
                      seed=_seed())
    (y * torch.from_numpy(r)).sum().backward()
    got = en.grad.numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, atol=GRAD_REL * np.abs(want).max(), rtol=0)


CNN_CHANNELS = [(3, 16), (16, 32), (32, 32)]  # benchmarks/common.py:265
CNN_CLASSES = 10


def _cnn_weights(seed=0):
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
          for cin, cout in CNN_CHANNELS]
    head_in = CNN_CHANNELS[-1][1]
    ws.append((rng.standard_normal((head_in, CNN_CLASSES)) / np.sqrt(head_in)).astype(np.float32))
    return ws


def test_paper_cnn_matches_reference():
    """``build_cnn``'s analog apply on 16 images of 16x16: shot noise at
    20 aJ/MAC, each conv's key ``site_key(fold_in(key, i), "c<i>")``, the
    head's ``site_key(key, "head")``."""
    ws = _cnn_weights()
    jx, _ = jmake_image_dataset(16, n_classes=CNN_CLASSES, size=16, seed=5)
    x, _ = make_image_dataset(16, n_classes=CNN_CLASSES, size=16, seed=5)
    jcfg, cfg = JAnalogConfig.shot(backend="tile"), AnalogConfig.shot()
    e = 20.0

    @jax.jit
    def jcnn(h, params):
        for i, kern in enumerate(params[:-1]):
            h = janalog_conv2d(h, kern, cfg=jcfg, stride=2 if i else 1, energy=jnp.asarray(e),
                               key=jsite_key(jax.random.fold_in(KEY, i), f"c{i}"))
            h = jax.nn.relu(h)
        return janalog_dot(jnp.mean(h, axis=(1, 2)), params[-1], cfg=jcfg,
                           energy=jnp.asarray(e), key=jsite_key(KEY, "head"))

    want = jcnn(jnp.asarray(jx), [jnp.asarray(w) for w in ws])

    key = np.asarray(KEY)
    t = torch.from_numpy(x)
    for i, kern in enumerate(ws[:-1]):
        t = analog_conv2d(t, torch.from_numpy(kern), cfg=cfg, stride=2 if i else 1,
                          energy=torch.tensor(e),
                          seed=key_seed(site_key(fold_key(key, i), f"c{i}"), "cpu"))
        t = torch.relu(t)
    got = analog_dot(t.mean(dim=(1, 2)), torch.from_numpy(ws[-1]), cfg=cfg,
                     energy=torch.tensor(e), seed=key_seed(site_key(key, "head"), "cpu"))
    assert got.shape == (16, CNN_CLASSES)
    _assert_close(got, want, jcfg, None)
