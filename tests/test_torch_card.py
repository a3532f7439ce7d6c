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


class _RowHook:
    """Digital sites one row at a time: a matmul's bits then do not depend
    on how many rows it has (the analog routes keep this themselves)."""

    def __call__(self, site, x, w):
        rows = x.reshape(-1, x.shape[-1])
        w = w.to(x.dtype)
        return torch.cat([rows[i:i + 1] @ w for i in range(rows.shape[0])]).reshape(
            *x.shape[:-1], w.shape[-1])

    def batched(self, site, x, w):
        return torch.stack([self(site, x[e], w[e]) for e in range(w.shape[0])])


@pytest.mark.cuda
@pytest.mark.parametrize("b", [2, 4])
def test_recurrent_and_moe_ops_same_bits_alone_as_in_a_batch_on_card(b, cuda_device):
    """xlstm-1.3b's ops at its widths (4 heads of 512) on the card: mLSTM
    decode's contractions over 512 and the chunk scan, the mLSTM and sLSTM
    blocks (the gate projection, the head norm, the recurrent product of
    every step) give a request's row alone (B = 1) the bits it has in a
    batch of ``b``. And the MoE block (routing softmax, dispatch, the
    combine): two requests' tokens in a group with ``b`` - 2 padding rows
    get the bits they get alone, at a capacity that drops none."""
    from repro_torch.models import lm, moe, xlstm
    from repro_torch.models.config import ModelConfig

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    randn = lambda *s, scale=1.0: torch.randn(s, generator=gen, device=cuda_device) * scale  # noqa: E731
    q, k, v = randn(b, 1, 4, 512), randn(b, 1, 4, 512), randn(b, 1, 4, 512)
    li, lf = randn(b, 1, 4), -torch.rand((b, 1, 4), generator=gen, device=cuda_device)
    st = (randn(b, 4, 512, 512, scale=0.1), randn(b, 4, 512, scale=0.1), randn(b, 4))
    dec, dec_st = xlstm.mlstm_decode(q, k, v, li, lf, st)
    qp, kp, vp = randn(b, 64, 4, 512), randn(b, 64, 4, 512), randn(b, 64, 4, 512)
    lip, lfp = randn(b, 64, 4), -torch.rand((b, 64, 4), generator=gen, device=cuda_device)
    scan, scan_st = xlstm.mlstm_chunkwise(qp, kp, vp, lip, lfp, chunk=512)
    cfg = ModelConfig(name="x", family="xlstm", n_layers=8, d_model=2048, n_heads=4, n_kv_heads=4,
                      d_ff=0, vocab_size=64)
    pm = {n: randn(*leaf.shape, scale=leaf.scale or 0.1).to(torch.bfloat16)
          for n, leaf in lm._mlstm_leaves(cfg, ()).items()}
    ps = {n: randn(*leaf.shape, scale=leaf.scale or 0.1).to(torch.bfloat16)
          for n, leaf in lm._slstm_leaves(cfg, ()).items()}
    x = randn(b, 16, 2048).to(torch.bfloat16)
    mb, mb_st = xlstm.mlstm_block(x, pm, _RowHook(), n_heads=4, chunk=512)
    sb, sb_st = xlstm.slstm_block(x[:, :6], ps, _RowHook(), n_heads=4)
    for i in range(b):
        one = slice(i, i + 1)
        h1, s1 = xlstm.mlstm_decode(q[one], k[one], v[one], li[one], lf[one],
                                    tuple(s[one] for s in st))
        assert torch.equal(h1, dec[one]) and all(torch.equal(a, c[one]) for a, c in zip(s1, dec_st))
        h1, s1 = xlstm.mlstm_chunkwise(qp[one], kp[one], vp[one], lip[one], lfp[one], chunk=512)
        assert torch.equal(h1, scan[one]) and all(torch.equal(a, c[one]) for a, c in zip(s1, scan_st))
        h1, s1 = xlstm.mlstm_block(x[one], pm, _RowHook(), n_heads=4, chunk=512)
        assert torch.equal(h1, mb[one]) and all(torch.equal(a, c[one]) for a, c in zip(s1, mb_st))
        h1, s1 = xlstm.slstm_block(x[one, :6], ps, _RowHook(), n_heads=4)
        assert torch.equal(h1, sb[one]) and all(torch.equal(a, c[one]) for a, c in zip(s1, sb_st))

    mcfg = ModelConfig(name="m", family="moe", n_layers=1, d_model=256, n_heads=2, n_kv_heads=1,
                       d_ff=512, vocab_size=64, n_experts=8, top_k=2, moe_ff_split=2,
                       capacity_factor=4.0, dtype="bfloat16")
    pe = {n: randn(*leaf.shape, scale=leaf.scale).to(torch.bfloat16)
          for n, leaf in lm._moe_leaves(mcfg, ()).items()}
    xm = randn(b, 16, 256).to(torch.bfloat16)
    lengths = torch.tensor([16, 9] + [0] * (b - 2), device=cuda_device)
    pad = torch.arange(16, device=cuda_device)[None, :] >= lengths[:, None]
    alone = moe.moe_block(xm[:2], pe, mcfg, _RowHook(), pad_mask=pad[:2])
    padded = moe.moe_block(xm, pe, mcfg, _RowHook(), pad_mask=pad)
    assert torch.equal(alone[~pad[:2]], padded[:2][~pad[:2]])
