"""Port vs reference: the training path (``data/pipeline.py``,
``optim/clip.py``, ``optim/compress.py``, the flash-attention backward and
``chunked_xent`` of ``models/layers.py``, ``lm.train_loss``,
``launch/steps.py``).

Inputs are numpy arrays made from a seed and handed to both packages;
weights are numpy at ``lm.param_leaves``' shapes (``repro_torch.bridge``).
Held here:

* ``markov_batch`` bit for bit; ``clip_by_global_norm``, ``int8_quantize``,
  ``ef_int8_roundtrip`` and ``ef_compress`` on the same input: int8 codes
  bit for bit, float values at float32 rounding;
* flash attention (f32): the forward and dq, dk, dv against the
  reference's ``chunked_attention`` (its custom VJP) and against autograd
  through a plain masked-softmax attention, causal, windowed, GQA and MQA,
  a T that no chunk divides, chunk-size invariance, ``atol = 1e-5`` (the
  reference test's); the serving forward (no gradient) keeps its bits;
* ``chunked_xent`` with a padded vocabulary, ``ignore_label`` and two
  codebooks: the loss to 1e-6 relative, its gradients to 1e-5 of max|g|;
* ``train_loss`` and its gradients on granite3-smoke: float32 with and
  without remat (loss 1e-5 relative, every leaf within 1e-4 max|g_ref|),
  bfloat16 (1e-2 relative, 2e-2 max|g_ref| plus the reference's own
  distance from the float32 gradient);
* the train step's clipped gradients (int8_ef off and on), and its
  update in place in the parameters' dtype.

The whole train step against the reference's is held in
``tests/test_torch_driver.py``, ``make_calibrate_step`` in
``tests/test_torch_calibrate_lm.py``.

Each reference function is jitted once for the module.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs as several processes on the cores (pytest-xdist): torch's
# intra-op threads in each would oversubscribe them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import clip as jclip  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.optim import adam, clip, compress  # noqa: E402
from repro_torch.tree import leaves, map_leaves  # noqa: E402

ATTN_ATOL = 1e-5  # tests/test_flash_attention.py:26
XENT_RTOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
BF16_LOSS_RTOL, BF16_GRAD_REL = 1e-2, 2e-2
PARAM_SHARE = 0.999
LR = 1e-3
T, B = 32, 4


def _np(t):
    return t.detach().float().cpu().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _jtree(tree):
    """A nested dict of numpy arrays as the reference's jnp tree."""
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# data, clip, compress
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step,rank,world", [(0, 0, 1), (7, 1, 2), (3, 3, 4)])
def test_markov_batch_bit_equal(step, rank, world):
    cfg = pipeline.TokenTaskConfig(vocab_size=97, seq_len=24, global_batch=8, seed=5)
    jcfg = jpipeline.TokenTaskConfig(vocab_size=97, seq_len=24, global_batch=8, seed=5)
    got, want = pipeline.markov_batch(cfg, step, rank, world), \
        jpipeline.markov_batch(jcfg, step, rank, world)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_prefetches_markov_batches_in_order():
    cfg = pipeline.TokenTaskConfig(vocab_size=64, seq_len=8, global_batch=2, seed=1)
    pipe = pipeline.DataPipeline(cfg, start_step=3, prefetch=2)
    try:
        for want_step in (3, 4, 5):
            step, batch = next(pipe)
            assert step == want_step
            np.testing.assert_array_equal(batch["tokens"],
                                          pipeline.markov_batch(cfg, step)["tokens"])
    finally:
        pipe.close()
    assert not pipe._thread.is_alive()


def _grad_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((6, 5)) * 3).astype(np.float32),
            "b": {"c": (rng.standard_normal((17,)) * 1e-3).astype(np.float32),
                  "d": np.zeros((3, 2), np.float32)}}


@pytest.mark.parametrize("max_norm", [1e-2, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    tree = _grad_tree()
    got, norm = clip.clip_by_global_norm(map_leaves(lambda _p, a: _t(a), tree), max_norm)
    want, jnorm = jclip.clip_by_global_norm(_jtree(tree), max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-6, atol=1e-30)


def test_global_norm_slices_large_leaves(monkeypatch):
    """A leaf above ``SLICE_ELEMS`` is summed slice by slice: the norm is
    the whole-leaf norm to float32 rounding."""
    tree = map_leaves(lambda _p, a: _t(a), _grad_tree(1))
    whole = float(clip.global_norm(tree))
    monkeypatch.setattr(adam, "SLICE_ELEMS", 4)
    assert len(adam.leading_slices(tree["a"])) == 6
    np.testing.assert_allclose(float(clip.global_norm(tree)), whole, rtol=1e-6)


def test_int8_codes_and_roundtrip_match_reference():
    tree = _grad_tree(2)
    for a in leaves(tree):
        q, s = compress.int8_quantize(_t(a))
        jq, js = jcompress.int8_quantize(jnp.asarray(a))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
    got = compress.ef_int8_roundtrip(map_leaves(lambda _p, a: _t(a), tree))
    want = jcompress.ef_int8_roundtrip(_jtree(tree))
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_ef_compress_matches_reference():
    tree, err = _grad_tree(3), None
    jerr = None
    for i in range(3):
        g = map_leaves(lambda _p, a: _t(a * (i + 1)), tree)
        jg = jax.tree.map(lambda a: jnp.asarray(a * (i + 1)), tree)
        out, err = compress.ef_compress(g, err)
        jout, jerr = jcompress.ef_compress(jg, jerr)
        for a, b in zip(leaves(out) + leaves(err), jax.tree.leaves(jout) + jax.tree.leaves(jerr)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def _naive(q, k, v, window=None):
    """Autograd through a plain masked-softmax attention (grouped KV)."""
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    q5 = q.reshape(b, t, kh, h // kh, d)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", q5, k) / d**0.5
    qp, kp = torch.arange(t)[:, None], torch.arange(s)[None, :]
    mask = qp >= kp
    if window is not None:
        mask &= (qp - kp) < window
    p = torch.softmax(sc.masked_fill(~mask, -1e30), dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v).reshape(b, t, h, d)


ATTN_CASES = {
    "causal": dict(t=64, kh=2, qc=16, kc=16, window=None),
    "causal_uneven_chunks": dict(t=64, kh=2, qc=32, kc=16, window=None),
    "window": dict(t=64, kh=2, qc=16, kc=16, window=16),
    "mqa": dict(t=64, kh=1, qc=16, kc=32, window=None),
    "mha": dict(t=48, kh=4, qc=16, kc=16, window=None),
    "t_not_a_multiple": dict(t=40, kh=2, qc=16, kc=16, window=None),
    "t_prime": dict(t=37, kh=1, qc=16, kc=16, window=12),
}


def _qkvo(t, kh, seed=0, b=2, h=4, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, t, h, d), (b, t, kh, d), (b, t, kh, d), (b, t, h, d))]


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attention_matches_reference_and_plain(case):
    c = ATTN_CASES[case]
    q, k, v, do = _qkvo(c["t"], c["kh"])
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = layers.chunked_attention(qt, kt, vt, q_chunk=c["qc"], kv_chunk=c["kc"],
                                   window=c["window"])
    grads = torch.autograd.grad(out, (qt, kt, vt), _t(do))

    @jax.jit
    def ref(q_, k_, v_, do_):
        out_, vjp = jax.vjp(lambda *a: jlayers.chunked_attention(
            *a, q_chunk=c["qc"], kv_chunk=c["kc"], causal=True, window=c["window"]), q_, k_, v_)
        return out_, vjp(do_)

    jout, jgrads = ref(*(jnp.asarray(a) for a in (q, k, v, do)))
    np.testing.assert_allclose(_np(out), np.asarray(jout), atol=ATTN_ATOL)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(_np(g), np.asarray(jg), atol=ATTN_ATOL)

    pq, pk, pv = (_t(a).requires_grad_() for a in (q, k, v))
    plain = _naive(pq, pk, pv, c["window"])
    pgrads = torch.autograd.grad(plain, (pq, pk, pv), _t(do))
    np.testing.assert_allclose(_np(out), _np(plain), atol=ATTN_ATOL)
    for g, pg in zip(grads, pgrads):
        np.testing.assert_allclose(_np(g), _np(pg), atol=ATTN_ATOL)

    with torch.no_grad():  # the serving forward: its own bits, per request
        served = layers.chunked_attention(_t(q), _t(k), _t(v), q_chunk=c["qc"],
                                          kv_chunk=c["kc"], window=c["window"])
    np.testing.assert_allclose(_np(served), _np(out), atol=ATTN_ATOL)
    alone = torch.cat([layers.chunked_attention(_t(q[i:i + 1]), _t(k[i:i + 1]), _t(v[i:i + 1]),
                                                q_chunk=c["qc"], kv_chunk=c["kc"],
                                                window=c["window"]) for i in range(len(q))])
    assert torch.equal(served, alone)


def test_flash_attention_chunk_size_invariance():
    q, k, v, do = _qkvo(64, 2, seed=4)
    outs = []
    for qc, kc in ((8, 8), (64, 64), (16, 64)):
        qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
        o = layers.chunked_attention(qt, kt, vt, q_chunk=qc, kv_chunk=kc)
        outs.append([o] + list(torch.autograd.grad(o, (qt, kt, vt), _t(do))))
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_allclose(_np(a), _np(b), atol=ATTN_ATOL)


def test_flash_attention_saves_only_its_residuals():
    """The autograd graph holds (q, k, v, out, lse): no score block."""
    q, k, v, _ = _qkvo(64, 2, seed=5)
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda x: saved.append(x.shape) or x,
                                                  lambda x: x):
        layers.chunked_attention(qt, kt, vt, q_chunk=16, kv_chunk=16)
    assert sorted(saved) == sorted([qt.shape, kt.shape, vt.shape, qt.shape, (2, 2, 2, 64)])


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cb,vocab,chunk", [(1, 50, 8), (2, 30, 16), (1, 64, 12)])
def test_chunked_xent_matches_reference(cb, vocab, chunk):
    rng = np.random.default_rng(cb * 100 + vocab)
    b, t, d = 2, 24, 16
    vp = -(-vocab // 16) * 16
    h = rng.standard_normal((b, t, d)).astype(np.float32)
    head = (rng.standard_normal((d, cb * vp)) * 0.3).astype(np.float32)
    labels = rng.integers(0, vocab, (b, t, cb) if cb > 1 else (b, t)).astype(np.int32)
    labels[0, :3] = -1  # ignored positions
    ht, headt = _t(h).requires_grad_(), _t(head).requires_grad_()
    loss = layers.chunked_xent(ht, headt, _t(labels), chunk=chunk, n_codebooks=cb, vocab=vocab)
    gh, ghead = torch.autograd.grad(loss, (ht, headt))
    loss = loss.detach()

    def ref(h_, head_):
        return jlayers.chunked_xent(h_, head_, jnp.asarray(labels), chunk=chunk,
                                    n_codebooks=cb, vocab=vocab)

    jloss, (jgh, jghead) = jax.jit(jax.value_and_grad(ref, argnums=(0, 1)))(jnp.asarray(h),
                                                                            jnp.asarray(head))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=XENT_RTOL)
    for g, jg in ((gh, jgh), (ghead, jghead)):
        jg = np.asarray(jg)
        assert np.abs(_np(g) - jg).max() <= 1e-5 * np.abs(jg).max()


# ---------------------------------------------------------------------------
# train_loss
# ---------------------------------------------------------------------------


def _cfgs(dtype="float32", **kw):
    return (dataclasses.replace(get_smoke_config("granite-3-8b"), dtype=dtype, **kw),
            dataclasses.replace(jsmoke("granite-3-8b"), dtype=dtype, **kw))


def _weights(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return lm.map_leaves(lambda _p, leaf: (rng.standard_normal(leaf.shape)
                                           * (leaf.scale or 0.1)).astype(np.float32),
                         lm.param_leaves(cfg))


def _params(tree, cfg):
    return bridge.params_from_numpy(
        map_leaves(lambda _p, a: a.astype(jnp.bfloat16) if cfg.dtype == "bfloat16" else a, tree),
        cfg, "cpu")


def _jparams(tree, jcfg):
    return jax.tree.map(lambda a: jnp.asarray(a, jcfg.compute_dtype), tree)


def _batch(cfg, step=0, rows=B):
    data = pipeline.TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=T, global_batch=rows,
                                    seed=3)
    return pipeline.markov_batch(data, step)


def _port_grads(params, batch, cfg):
    grads = map_leaves(lambda _p, p: torch.zeros_like(p), params)
    loss = lm.train_loss(steps._grad_leaves(params, grads), steps.batch_tensors(batch, "cpu"),
                         cfg)
    loss.backward()
    return loss.detach(), grads


_REF_GRADS = {}


def _ref_grads(dtype, remat):
    """The reference's jitted (loss, gradients) on ``_weights(cfg)`` and
    ``_batch(cfg)``, once per (dtype, remat)."""
    if (dtype, remat) not in _REF_GRADS:
        cfg, jcfg = _cfgs(dtype, remat=remat)
        tree, batch = _weights(cfg), _batch(cfg)
        fn = jax.jit(jax.value_and_grad(lambda p: jlm.train_loss(p, batch, jcfg)))
        _REF_GRADS[dtype, remat] = fn(_jparams(tree, jcfg))
    return _REF_GRADS[dtype, remat]


@pytest.mark.parametrize("dtype,remat", [("float32", True), ("float32", False),
                                         ("bfloat16", True)])
def test_train_loss_and_grads_match_reference(dtype, remat):
    """At bfloat16 both packages round the activations and their gradients
    at other points (XLA keeps fused elementwise chains in float32), and the
    reference's own gradients lie up to ~2.3e-2 max|g| from the float32
    gradient of the same bf16 weights: a leaf's bound is 2e-2 max|g_ref|
    plus that distance of the reference's, measured here."""
    cfg, jcfg = _cfgs(dtype, remat=remat)
    tree, batch = _weights(cfg), _batch(cfg)
    loss, grads = _port_grads(_params(tree, cfg), batch, cfg)
    jloss, jgrads = _ref_grads(dtype, remat)
    rtol, rel = (LOSS_RTOL, GRAD_REL) if dtype == "float32" else (BF16_LOSS_RTOL, BF16_GRAD_REL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=rtol)
    exact = jax.tree.leaves(jgrads)
    if dtype == "bfloat16":  # float32 gradients of the bf16-rounded weights
        _, f32 = _cfgs(remat=remat)
        rounded = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), _jparams(tree, jcfg))
        exact = jax.tree.leaves(jax.jit(jax.grad(lambda p: jlm.train_loss(p, batch, f32)))(rounded))
    paths = leaves(lm.map_leaves(lambda p, _l: "/".join(p), lm.param_leaves(cfg)))
    for path, g, jg, ex in zip(paths, leaves(grads), jax.tree.leaves(jgrads), exact):
        jg, ex = np.asarray(jg, np.float32), np.asarray(ex, np.float32)
        assert g.dtype == cfg.compute_dtype, path
        err = np.abs(_np(g) - jg).max()
        assert err <= rel * np.abs(jg).max() + np.abs(jg - ex).max(), (path, err)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compression", [None, "int8_ef"])
def test_clipped_gradients_match_reference(compression):
    """The step's gradient stage (backward, int8 roundtrip, clip) on the
    same weights: every element within 1e-4 max|g| (and within one int8
    step of the reference's leaf where the codes may round apart)."""
    cfg, _ = _cfgs()
    _, grads = _port_grads(_params(_weights(cfg), cfg), _batch(cfg), cfg)
    _, jgrads = _ref_grads("float32", True)
    if compression:
        grads = compress.ef_int8_roundtrip(grads)
        jgrads = jax.jit(jcompress.ef_int8_roundtrip)(jgrads)
    grads, norm = clip.clip_by_global_norm(grads, 1.0)
    jgrads, jnorm = jax.jit(jclip.clip_by_global_norm, static_argnums=1)(jgrads, 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=LOSS_RTOL)
    for g, jg in zip(leaves(grads), jax.tree.leaves(jgrads)):
        jg = np.asarray(jg)
        tol = GRAD_REL * np.abs(jg).max()
        if compression:
            tol += np.abs(jg).max() / 127.0 * 1.001
        assert np.abs(_np(g) - jg).max() <= tol


def test_train_step_accumulates_in_place_in_the_param_dtype():
    """The step updates the given tensors in place and its gradients keep
    the parameters' dtype (bf16 here), as the reference's donated step."""
    cfg, _ = _cfgs("bfloat16")
    params = _params(_weights(cfg, seed=4), cfg)
    ptrs = [p.data_ptr() for p in leaves(params)]
    before = [p.clone() for p in leaves(params)]
    tcfg = steps.TrainConfig(lr=LR)
    opt = steps.make_opt_init(cfg, None, tcfg)(params)
    new, opt, metrics = steps.make_train_step(cfg, None, tcfg)(params, opt, _batch(cfg))
    assert new is params and [p.data_ptr() for p in leaves(new)] == ptrs
    assert all(p.dtype == torch.bfloat16 for p in leaves(new) + leaves(opt.mu))
    assert any(not torch.equal(a, b) for a, b in zip(before, leaves(new)))
    assert torch.isfinite(metrics["loss"]) and float(metrics["grad_norm"]) > 0


def test_steps_refuse_a_mesh():
    """What still refuses tensor shards: the LM calibration (its analog
    sites under tp, ROADMAP A.6); the train step takes them."""
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.launch.mesh import make_mesh_for_devices

    cfg, _ = _cfgs()
    steps.make_train_step(cfg, make_mesh_for_devices(2))
    with pytest.raises(NotImplementedError, match="ROADMAP A.6"):
        steps.make_calibrate_step(cfg, make_mesh_for_devices(2),
                                  analog_cfg=AnalogConfig.shot(backend="torch"), seq_len=T,
                                  target_e_per_mac=1.0)
