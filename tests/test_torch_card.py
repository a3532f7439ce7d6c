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
#: at prefill, which run different kernels; tc at each cluster size its
#: plan gives (1, 2, 4 and 8 splits of K); decode and tc at ragged K and N,
#: decode at K = 8192 and at 4, 8 and 16 rows a block; rows that fill part
#: of a tile (decode: 5 rows in a tile of 8, 17 in two of 16; tc: 140 rows
#: in two of 128); simt at ResNet-50's conv1 (K = 147: rows of 588 bytes
#: in f32, of odd length in bf16; one split) and its 7x7 stage's 3x3 conv
#: (784 rows, K = 4608: 8 splits), in bf16 and in f32
ROUTE_CASES = [
    ("decode", (3, 1, 64, 40), False),
    ("decode", (3, 1, 1096, 72), True),
    ("decode", (2, 2, 4000, 1000), False),
    ("decode", (5, 1, 2056, 136), False),
    ("decode", (17, 1, 1024, 200), True),
    ("decode", (3, 1, 8192, 512), False),
    ("tc", (3, 9, 64, 40), False),
    ("tc", (3, 9, 520, 40), False),
    ("tc", (3, 40, 1096, 72), False),
    ("tc", (2, 70, 4000, 1000), False),
    ("simt", (2, 9, 36, 20), False),
    ("simt", (2, 1500, 147, 64), False),
    ("simt", (2, 300, 147, 64), True),
    ("simt", (1, 784, 4608, 512), False),
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
    # simt also takes f32 operands (the conv path): both types there
    for dtype in (torch.bfloat16, torch.float32) if route == "simt" else (torch.bfloat16,):
        _route_matches_plain(route, x.to(dtype).to(cuda_device), w.to(dtype).to(cuda_device),
                             quant)


def _route_matches_plain(route, xb, wb, quant):
    b = xb.shape[0]
    weight = route in ("simt", "weight")
    cfg, e = (AnalogConfig.weight(0.1), 5.0) if weight else (AnalogConfig.shot(), 10.0)
    if quant and not weight:  # thermal noise: quantizers of x, w and the output
        cfg, e = AnalogConfig.thermal(0.01), 4.0
    seed = torch.from_numpy(np.arange(4 * b, dtype=np.int32).reshape(b, 4))
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
          for n, leaf in lm._mlstm_leaves(cfg, (), ()).items()}
    ps = {n: randn(*leaf.shape, scale=leaf.scale or 0.1).to(torch.bfloat16)
          for n, leaf in lm._slstm_leaves(cfg, (), ()).items()}
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
          for n, leaf in lm._moe_leaves(mcfg, (), ()).items()}
    xm = randn(b, 16, 256).to(torch.bfloat16)
    lengths = torch.tensor([16, 9] + [0] * (b - 2), device=cuda_device)
    pad = torch.arange(16, device=cuda_device)[None, :] >= lengths[:, None]
    alone = moe.moe_block(xm[:2], pe, mcfg, _RowHook(), pad_mask=pad[:2])
    padded = moe.moe_block(xm, pe, mcfg, _RowHook(), pad_mask=pad)
    assert torch.equal(alone[~pad[:2]], padded[:2][~pad[:2]])


#: (route, (B, M, K, N)) of the shard checks: N / tp a multiple of 8 at tp = 2, 4;
#: tc at 1, 4 and 8 splits of K
SHARD_CASES = [("decode", (3, 1, 256, 128)), ("tc", (3, 9, 256, 128)),
               ("decode", (3, 1, 1096, 512)), ("tc", (3, 9, 1096, 512)),
               ("decode", (3, 1, 4096, 256)), ("tc", (3, 70, 4096, 256)),
               ("simt", (2, 9, 72, 64)), ("weight", (3, 1, 256, 128)),
               ("weight", (3, 9, 256, 128)), ("simt", (2, 500, 147, 64)),
               ("simt", (1, 784, 4608, 512))]


@pytest.mark.cuda
@pytest.mark.parametrize("route,shape", SHARD_CASES,
                         ids=[f"{r}-{'x'.join(map(str, s))}" for r, s in SHARD_CASES])
def test_route_shard_equals_its_slice_on_card(route, shape, cuda_device):
    """A tensor-parallel shard (a column view of the weight, its seed's col0
    at the shard's first column, the whole weight's launch plan) is the
    same bits as its columns of the unsharded call."""
    import functools

    b, m, k, n = shape
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((b, m, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, n)) * 0.2).astype(np.float32))
    cfg, e = (AnalogConfig.weight(0.1), 5.0) if route == "weight" else (AnalogConfig.shot(), 10.0)
    seed = torch.from_numpy(np.arange(4 * b, dtype=np.int32).reshape(b, 4)).to(cuda_device)
    xb, wb = x.to(torch.bfloat16).to(cuda_device), w.to(torch.bfloat16).to(cuda_device)
    energy = torch.tensor(e, device=cuda_device)
    raw = functools.partial(am.analog_matmul_raw, route=route)
    for reps in (1, 4):
        (whole,) = ops.analog_matmul_shards(raw, xb, wb, energy=energy, seed=seed, cfg=cfg,
                                            n_repeats=reps, tp=1, shards=[0])
        for tp in (2, 4):
            nl = n // tp
            shards = ops.analog_matmul_shards(raw, xb, wb, energy=energy, seed=seed, cfg=cfg,
                                              n_repeats=reps, tp=tp, shards=range(tp), plan_n=n)
            for r, y in enumerate(shards):
                assert torch.equal(y, whole[..., r * nl:(r + 1) * nl]), (tp, r, reps)


@pytest.mark.cuda
def test_digital_hook_same_bits_alone_as_in_a_batch_on_card(cuda_device):
    """A served forward's digital sites: a decode step (1 row a request)
    takes the decode route with no noise, within the f32 rule of the plain
    matmul; a prefill runs one matmul a request. Either way a request's
    rows are the same bits alone as in a batch of 4."""
    from repro_torch.models.hooks import ServingMatmulHook

    rng = np.random.default_rng(8)
    w = torch.from_numpy(rng.standard_normal((512, 1280)).astype(np.float32) * 0.05)
    w = w.to(torch.bfloat16).to(cuda_device)
    hook = ServingMatmulHook()
    for t in (1, 64):
        x = torch.from_numpy(rng.standard_normal((4, t, 512)).astype(np.float32))
        x = x.to(torch.bfloat16).to(cuda_device)
        before = am.LAUNCHES["decode"]
        batched = hook("mlp0_up", x, w)
        assert am.LAUNCHES["decode"] - before == (t == 1)
        want = torch.matmul(x.float(), w.float())
        assert float((batched.float() - want).abs().max()) <= 1e-2 * float(want.abs().max())
        for i in range(4):
            assert torch.equal(hook("mlp0_up", x[i:i + 1], w)[0], batched[i]), (t, i)


@pytest.mark.cuda
def test_attention_backward_and_train_step_on_card(cuda_device):
    """The flash-attention Function's dq, dk, dv against autograd through a
    plain masked-softmax attention (f32, TF32 off, within 1e-4 max|g|),
    and two train steps of granite3-smoke from the same state giving the
    same bits (what the driver's bit-exact restart needs)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import TokenTaskConfig, markov_batch
    from repro_torch.launch.steps import TrainConfig, make_opt_init, make_train_step
    from repro_torch.models import layers, lm
    from repro_torch.tree import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(8)
    b, t, h, kh, d = 2, 96, 4, 2, 32
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda_device)
                   for s in ((b, t, h, d), (b, t, kh, d), (b, t, kh, d), (b, t, h, d)))
    q, k, v = (a.requires_grad_() for a in (q, k, v))
    got = torch.autograd.grad(layers.chunked_attention(q, k, v, q_chunk=32, kv_chunk=32),
                              (q, k, v), do)
    q5 = q.reshape(b, t, kh, h // kh, d)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", q5, k) / d**0.5
    mask = torch.ones((t, t), dtype=torch.bool, device=cuda_device).tril()
    plain = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(sc.masked_fill(~mask, -1e30), -1),
                         v).reshape(b, t, h, d)
    want = torch.autograd.grad(plain, (q, k, v), do)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())

    cfg = get_smoke_config("granite-3-8b")
    data = TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4, seed=3)
    tcfg = TrainConfig()
    runs = []
    for _ in range(2):
        params = lm.init_params(cfg, seed=0, device=cuda_device)
        opt = make_opt_init(cfg, None, tcfg)(params)
        step = make_train_step(cfg, None, tcfg)
        for i in range(2):
            params, opt, metrics = step(params, opt, markov_batch(data, i))
        assert torch.isfinite(metrics["loss"])
        runs.append(leaves(params))
    assert all(torch.equal(a, b_) for a, b_ in zip(*runs))


#: a small bf16 dense model whose every analog site takes the decode and tc
#: routes (rows of 16-byte multiples)
GRAPH_MODEL = dict(name="graph-card", family="dense", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256)


def _graph_engine(dev, **kw):
    from repro_torch.models import lm
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving import ServingEngine

    cfg = ModelConfig(**GRAPH_MODEL)
    params = lm.init_params(cfg, seed=0, device=dev)
    energies = lm.init_energy_tree(cfg, 20.0, device=dev)
    return ServingEngine(params, cfg, analog_cfg=AnalogConfig.shot(), energies=energies,
                         device=dev, max_gen=8, batch_buckets=(1, 2, 4), seq_buckets=(16, 32),
                         **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4])
def test_replayed_steps_equal_eager_steps_on_card(k, cuda_device):
    """A tier's captured prefill and decode steps (``build_prefill``,
    ``build_decode``: CUDA graphs, replayed) give the eager steps' logits
    bit for bit over 6 decode steps, and the launches a replay counts are
    the eager step's."""
    from repro_torch.serving.engine import batch_keys
    from repro_torch.tree import map_leaves

    eng = _graph_engine(cuda_device)
    assert eng.graphs
    tier = eng.tiers.get(k)
    rng = np.random.default_rng(9)
    bb, sb, cache_len = 4, 16, 24
    lengths = np.asarray([16, 9, 12, 0])
    toks = rng.integers(0, 256, (bb, sb)) * (np.arange(sb)[None] < lengths[:, None])
    keys = batch_keys([np.asarray([1, i], np.uint32) for i in range(3)], bb)
    scale = eng._scale_arr()
    cache_e, logits_e = tier.prefill(torch.from_numpy(toks).to(cuda_device),
                                     torch.from_numpy(lengths).to(cuda_device), keys, cache_len,
                                     noise_scale=scale)
    prefill = tier.build_prefill(bb, sb, cache_len)
    cache_g = eng._batch_cache(bb, cache_len)
    for _ in range(2):  # the capture's call, then a replay
        tier.fill(prefill, keys, tokens=toks, lengths=lengths)
        logits_g, tok_g = prefill(cache_g)
        assert torch.equal(logits_g, logits_e)
    assert len(prefill.capture_s) == 1
    assert all(torch.equal(a, b) for a, b in zip(
        map_leaves(lambda _p, t: t, cache_g)["groups"].values(), cache_e["groups"].values()))
    decode = tier.build_decode(bb, cache_len)
    tok_e = torch.argmax(logits_e, dim=-1)
    decode.static["tok"].copy_(tok_g)
    for t in range(6):
        pos = lengths + t
        before = dict(am.LAUNCHES)
        logits_e, cache_e = tier.decode(cache_e, tok_e, pos, keys, lengths, noise_scale=scale)
        eager = {r: am.LAUNCHES[r] - before[r] for r in am.ROUTES}
        tier.fill(decode, keys, fold=pos, pos=pos, lengths=lengths)
        before = dict(am.LAUNCHES)
        logits_g, nxt = decode(cache_g)
        torch.cuda.synchronize()
        assert {r: am.LAUNCHES[r] - before[r] for r in am.ROUTES} == eager, t
        assert eager["decode"] > 0
        assert torch.equal(logits_g, logits_e), t
        tok_e = torch.argmax(logits_e, dim=-1)
        decode.static["tok"].copy_(nxt)
    assert len(decode.capture_s) == 1


@pytest.mark.cuda
def test_engine_replays_solo_equal_batched_on_card(cuda_device):
    """Through the engine's cache: a warm replay of the same traffic misses
    nothing and gives the same tokens, each request alone gives its tokens
    in the batch, and a second engine, whose steps this process has run
    before and so are captured without a warm-up, gives them too."""
    eng = _graph_engine(cuda_device)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 14, 9)]

    keys = [np.asarray([7, i], np.uint32) for i in range(len(prompts))]

    def serve(idx):
        uids = [eng.submit(prompts[i], n_repeats=2, max_new_tokens=6, key=keys[i]) for i in idx]
        out = eng.flush()
        return [out[u] for u in uids]

    first = serve(range(3))
    eng.exe_cache.reset_stats()
    again = serve(range(3))
    st = eng.cache_stats()
    assert st["misses"] == 0 and st["hits"] == 2 * 1, st  # one batch: prefill + decode
    assert all(np.array_equal(a, b) for a, b in zip(first, again))
    for i in range(3):
        (solo,) = serve([i])
        assert np.array_equal(solo, first[i]), i
    eng = _graph_engine(cuda_device)
    again = serve(range(3))
    assert all(np.array_equal(a, b) for a, b in zip(first, again))
    assert eng.cache_stats()["misses"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_on_card_matches_plain(stride, cuda_device):
    """``analog_conv2d`` on the card (f32 patches: the simt route) against
    the plain version, shot noise, under the kernel rule."""
    from repro_torch.core.analog import analog_conv2d, key_seed

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((2, 14, 14, 12), generator=gen, device=cuda_device)
    k = torch.randn((3, 3, 12, 40), generator=gen, device=cuda_device) / 18.0
    seed = key_seed(np.asarray([0, 5], np.uint32), cuda_device)
    e = torch.tensor(20.0, device=cuda_device)
    before = am.LAUNCHES["simt"]
    with torch.no_grad():
        y = analog_conv2d(x, k, cfg=AnalogConfig.shot(), stride=stride, energy=e, seed=seed)
        want = analog_conv2d(x, k, cfg=AnalogConfig.shot(backend="tile"), stride=stride,
                             energy=e, seed=seed)
    assert am.LAUNCHES["simt"] == before + 1
    atol = 3e-5 * float(want.abs().max())
    assert bool(((y - want).abs() <= atol + 1e-4 * want.abs()).all())


@pytest.mark.cuda
def test_simt_takes_rows_beyond_the_old_grid_limit(cuda_device):
    """One call of 65,535 * 64 + 64 rows (the old grid's limit, one row
    tile more) runs, and its first and last row tiles equal the plain
    version's under the kernel rule."""
    rows = 65535 * 64 + 64
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn((1, rows, 4), generator=gen, device=cuda_device)
    w = torch.randn((4, 8), generator=gen, device=cuda_device)
    o = ops.prepare_operands(x, w, energy=torch.tensor(10.0, device=cuda_device),
                             seed=torch.arange(4, dtype=torch.int32, device=cuda_device)[None],
                             cfg=AnalogConfig.shot())
    args = [o[t] for t in ("x", "w", "row_scale", "col_scale", "wq", "scalars", "seed")]
    before = am.LAUNCHES["simt"]
    got = am.analog_matmul_raw(*args, noise_kind=o["noise_kind"])
    want = ops.analog_matmul_ref_raw(*args, noise_kind=o["noise_kind"])
    assert am.LAUNCHES["simt"] == before + 1
    for part in (slice(0, 64), slice(rows - 64, rows)):
        g, r = got[0, part], want[0, part]
        atol = 3e-5 * float(r.abs().max())
        assert bool(((g - r).abs() <= atol + 1e-4 * r.abs()).all())
