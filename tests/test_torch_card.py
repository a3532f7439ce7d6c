"""The analog matmul's routes on the card: each route's kernel against the
plain version (``kernels/ref.py``) on the same inputs, a request's rows the
same bits alone as in a batch, and the same bits from launch to launch.

Needs an NVIDIA card and no JAX (the machine with the card has none):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_card.py

Without a card every test here skips. Tolerance: the reference's rule
(``tests/test_kernels.py``), ``atol = 3e-5 * max|y|``, ``rtol = 1e-4``, or one output quantization step
under requant.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.analog import AnalogConfig, SiteQuant  # noqa: E402
from repro_torch.kernels import analog_matmul as am  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.quant.affine import QuantParams  # noqa: E402

#: (route, (B, M, K, N), calibrated quantizers) of calls each route takes:
#: weight at decode (M <= ``M_DECODE``, with and without quantizers) and
#: at prefill, which run different kernels
ROUTE_CASES = [
    ("decode", (3, 1, 64, 40), False),
    ("tc", (3, 9, 64, 40), False),
    ("simt", (2, 9, 36, 20), False),
    ("weight", (3, 1, 64, 40), False),
    ("weight", (3, 2, 64, 40), True),
    ("weight", (3, 9, 64, 40), False),
]


def _minmax(v, dim=None):
    lo = torch.amin(v, dim=dim) if dim is not None else v.min()
    hi = torch.amax(v, dim=dim) if dim is not None else v.max()
    lo = torch.clamp_max(lo, 0.0)
    return QuantParams(lo, torch.maximum(hi, lo + 1e-8))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the route kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("route,shape,quant", ROUTE_CASES,
                         ids=[f"{r}-{'x'.join(map(str, s))}{'-quant' * q}"
                              for r, s, q in ROUTE_CASES])
def test_route_kernel_matches_plain_on_card(route, shape, quant, cuda_device):
    b, m, k, n = shape
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((b, m, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, n)) * 0.2).astype(np.float32))
    weight = route in ("simt", "weight")
    cfg, e = (AnalogConfig.weight(0.1), 5.0) if weight else (AnalogConfig.shot(), 10.0)
    seed = torch.from_numpy(np.arange(4 * b, dtype=np.int32).reshape(b, 4))
    xb, wb = x.to(torch.bfloat16).to(cuda_device), w.to(torch.bfloat16).to(cuda_device)
    sq = None
    if quant:  # per-column weight ranges, tensor ranges of x and of the output
        sq = SiteQuant(wqp=_minmax(wb.float(), 0), xqp=_minmax(xb.float()),
                       oqp=_minmax(torch.matmul(xb.float(), wb.float())))
    o = ops.prepare_operands(xb, wb, energy=torch.tensor(e), seed=seed, cfg=cfg, sq=sq)
    assert (o["quant_x"], o["quant_w"], o["quant_out"]) == (quant,) * 3
    args = [o[t] for t in ("x", "w", "row_scale", "col_scale", "wq", "scalars", "seed")]
    kw = dict(noise_kind=o["noise_kind"], quant_x=o["quant_x"], quant_w=o["quant_w"],
              quant_out=o["quant_out"], n_repeats=4)
    before = am.LAUNCHES[route]
    got = am.analog_matmul_raw(*args, route=route, **kw)
    want = ops.analog_matmul_ref_raw(*args, **kw)
    assert am.LAUNCHES[route] == before + 1
    atol = 3e-5 * (float(want.abs().max()) + 1e-6)
    if quant:  # one output quantization step, as the reference's tests allow
        atol = max(atol, float(sq.oqp.delta) * 1.01)
    torch.testing.assert_close(got, want, atol=atol, rtol=1e-4)
    assert torch.equal(got, am.analog_matmul_raw(*args, route=route, **kw))
    for i in range(b):
        solo = [args[0][i:i + 1], args[1], args[2][i:i + 1], args[3][:1], args[4], args[5],
                args[6][i:i + 1]]
        if args[3].shape[0] == b:
            solo[3] = args[3][i:i + 1]
        y = am.analog_matmul_raw(*solo, route=route, **kw)
        assert torch.equal(y[0], got[i])


@pytest.mark.cuda
@pytest.mark.parametrize("b", [2, 4])
def test_model_ops_same_bits_alone_as_in_a_batch_on_card(b, cuda_device):
    """The model's own sums on the card: a request's row gives the same bits
    alone (B = 1) as in a batch of ``b`` — decode attention at granite-20b's
    MQA (48 query heads on one KV head), prefill attention, RMS norm and
    the shot-noise row norms over K = 12,800 and 24,576, and the lm_head.
    A batched GEMM or a CUDA reduction over a long row may otherwise sum in
    another order for another batch size."""
    from repro_torch.models import layers, lm
    from repro_torch.models.config import ModelConfig
    from repro_torch.reduce import row_norm

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    bf16 = torch.bfloat16
    randn = lambda *s: torch.randn(s, generator=gen, device=cuda_device).to(bf16)  # noqa: E731
    q, k, v = randn(b, 1, 48, 128), randn(b, 80, 1, 128), randn(b, 80, 1, 128)
    pos = torch.full((b,), 70, device=cuda_device)
    full = layers.decode_attention(q, k, v, pos)
    qp, kp = randn(b, 64, 48, 128), randn(b, 64, 1, 128)
    prefill = layers.chunked_attention(qp, kp, kp, q_chunk=1024, kv_chunk=1024)
    scale = randn(6144)
    for kk in (12800, 24576):
        x = randn(b, 1, kk)
        norms = row_norm(x, keepdim=True)
        for i in range(b):
            assert torch.equal(row_norm(x[i:i + 1], keepdim=True), norms[i:i + 1])
    h = randn(b, 1, 6144)
    normed = layers.rms_norm(h, scale)
    cfg = ModelConfig(name="head", family="dense", n_layers=1, d_model=6144, n_heads=48,
                      n_kv_heads=1, d_ff=64, vocab_size=49152)
    params = {"lm_head": randn(6144, cfg.padded_vocab)}
    logits = lm.logits_last(params, h, cfg)
    for i in range(b):
        one = slice(i, i + 1)
        assert torch.equal(layers.decode_attention(q[one], k[one], v[one], pos[one]), full[one])
        assert torch.equal(layers.chunked_attention(qp[one], kp[one], kp[one], q_chunk=1024,
                                                    kv_chunk=1024), prefill[one])
        assert torch.equal(layers.rms_norm(h[one], scale), normed[one])
        assert torch.equal(lm.logits_last(params, h[one], cfg), logits[one])


@pytest.mark.cuda
def test_torch_backend_on_card(cuda_device):
    """The "torch" backend on the card: one generator a request (solo ==
    batched, bit for bit), a finite energy gradient; the "cuda" backend
    refuses an energy that requires grad."""
    from repro_torch.core.analog import analog_dot, key_seed
    from repro_torch.kernels.prng import PRNGKey, fold_in

    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(np.float32)).to(cuda_device)
    w = torch.from_numpy((rng.standard_normal((64, 40)) * 0.2).astype(np.float32)).to(cuda_device)
    seeds = key_seed(fold_in(PRNGKey(3), np.arange(3)), "cpu")
    cfg = AnalogConfig.shot(backend="torch")
    energy = torch.tensor(10.0, device=cuda_device, requires_grad=True)
    batched = analog_dot(x, w, cfg=cfg, energy=energy, seed=seeds)
    for i in range(3):
        assert torch.equal(analog_dot(x[i], w, cfg=cfg, energy=energy, seed=seeds[i]), batched[i])
    batched.square().sum().backward()
    assert torch.isfinite(energy.grad) and float(energy.grad) != 0.0
    with pytest.raises(RuntimeError, match='backend="torch" or "tile"'):
        analog_dot(x, w, cfg=AnalogConfig.shot(backend="cuda"), energy=energy,
                   seed=seeds.to(cuda_device))
