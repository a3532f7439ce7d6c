"""Port vs reference: the xlstm family — the mLSTM and sLSTM blocks, the
xlstm LM (prefill, per-row decode, its recurrent caches), its engine
(batch-synchronous and continuous), profiles and energy.

Blocks run at float32 on numpy inputs: the chunk scan against the
reference's at its own tolerance (``tests/test_recurrent_blocks.py``:
2e-4), the other blocks at 1e-5. Models compute from the same numpy
weights (``lm.param_leaves`` shapes) at float32, analog sites on backend
"tile" on both sides: logits within ``1e-4 * max|logit|``, greedy tokens
exact. The configs are the reference serving tests' (``FAMILY_CONFIGS
["xlstm"]``: 2 layers, one mLSTM and one sLSTM block), the reference's
``xlstm-smoke`` and "xlstm-deep" (2 groups of 3 mLSTM blocks and an sLSTM
block: the (G, m) leaves with m > 1).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.xlstm_1_3b import CONFIG as JXLSTM  # noqa: E402
from repro.configs.xlstm_1_3b import smoke_config as jxlstm_smoke  # noqa: E402
from repro.core import analog as janalog  # noqa: E402
from repro.core import profile as jprofile  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.models import hooks as jhooks  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.xlstm_1_3b import CONFIG as XLSTM  # noqa: E402
from repro_torch.configs.xlstm_1_3b import smoke_config as xlstm_smoke  # noqa: E402
from repro_torch.core import energy  # noqa: E402
from repro_torch.core.analog import AnalogConfig, fold_key  # noqa: E402
from repro_torch.core.profile import PrecisionProfile  # noqa: E402
from repro_torch.kernels.prng import PRNGKey, fold_in  # noqa: E402
from repro_torch.models import hooks, lm, xlstm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.hooks import MatmulHook  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

SCAN_TOL = 2e-4
BLOCK_TOL = 1e-5
REL_TOL = 1e-4
ENERGY_REL = 1e-6
SB = 32  # one seq bucket: pooled and batch-synchronous caches have one length
_TINY = dict(n_heads=2, n_kv_heads=2, head_dim=16, vocab_size=128, d_ff=0, attn_q_chunk=16,
             attn_kv_chunk=16, dtype="float32")
CONFIGS = {
    "xlstm": dict(name="serve-xlstm", family="xlstm", n_layers=2, d_model=32, slstm_ratio=2,
                  **_TINY),
    "xlstm-deep": dict(name="xlstm-deep", family="xlstm", n_layers=8, d_model=32, slstm_ratio=4,
                       **_TINY),
}
NAMES = ["xlstm", "xlstm-deep", "xlstm-smoke"]
PROFILES = {"xlstm": (2, 1), "xlstm-deep": (1, 2, 4, 1, 2, 1, 1, 4), "xlstm-smoke": (1, 2, 2, 1)}
ENGINE_KW = dict(max_gen=8, max_batch=4, max_wait=1.0, batch_buckets=(1, 2, 4), seq_buckets=(SB,))


def configs(name):
    if name == "xlstm-smoke":
        return (dataclasses.replace(xlstm_smoke(), dtype="float32"),
                dataclasses.replace(jxlstm_smoke(), dtype="float32"))
    return ModelConfig(**CONFIGS[name]), JModelConfig(**CONFIGS[name])


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, rel=REL_TOL):
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def _allclose(got, want, tol=BLOCK_TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _mlstm_inputs(b=2, t=32, h=2, d=8, seed=5):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    li = (rng.standard_normal((b, t, h)) * 0.5).astype(np.float32)
    lf = np.asarray(jax.nn.log_sigmoid(rng.standard_normal((b, t, h)) + 1.0), np.float32)
    return q, k, v, li, lf


def _state(rng, b, h, d):
    return (rng.standard_normal((b, h, d, d)).astype(np.float32) * 0.3,
            rng.standard_normal((b, h, d)).astype(np.float32) * 0.3,
            rng.standard_normal((b, h)).astype(np.float32))


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunkwise_matches_reference(chunk, with_state):
    q, k, v, li, lf = _mlstm_inputs()
    st = _state(np.random.default_rng(1), 2, 2, 8) if with_state else None
    want, wst = jxlstm.mlstm_chunkwise(*map(jnp.asarray, (q, k, v, li, lf)), chunk=chunk,
                                       state=None if st is None else tuple(map(jnp.asarray, st)))
    got, gst = xlstm.mlstm_chunkwise(*map(_t, (q, k, v, li, lf)), chunk=chunk,
                                     state=None if st is None else tuple(map(_t, st)))
    _allclose(got, want, SCAN_TOL)
    for a, b in zip(gst, wst):
        _allclose(a, b, SCAN_TOL)


def test_mlstm_chunkwise_equals_stepwise():
    """The chunk scan equals the recurrence one step at a time (the
    reference test's property, on the port)."""
    q, k, v, li, lf = map(_t, _mlstm_inputs())
    b, t, h, d = q.shape
    for chunk in (4, 8, 16, 32):
        out_c, st_c = xlstm.mlstm_chunkwise(q, k, v, li, lf, chunk=chunk)
        st = (torch.zeros((b, h, d, d)), torch.zeros((b, h, d)), torch.full((b, h), -1e30))
        outs = []
        for i in range(t):
            o, st = xlstm.mlstm_decode(q[:, i:i + 1], k[:, i:i + 1], v[:, i:i + 1],
                                       li[:, i:i + 1], lf[:, i:i + 1], st)
            outs.append(o)
        _allclose(out_c, torch.cat(outs, 1), SCAN_TOL)
        for a, b_ in zip(st_c[:2], st[:2]):
            _allclose(a, b_, SCAN_TOL)


def test_mlstm_state_carry_across_segments():
    q, k, v, _, _ = map(_t, _mlstm_inputs(b=1, t=16, h=2, d=4))
    li, lf = torch.zeros((1, 16, 2)), torch.full((1, 16, 2), -0.2)
    full, _ = xlstm.mlstm_chunkwise(q, k, v, li, lf, chunk=4)
    first, st = xlstm.mlstm_chunkwise(q[:, :8], k[:, :8], v[:, :8], li[:, :8], lf[:, :8], chunk=4)
    second, _ = xlstm.mlstm_chunkwise(q[:, 8:], k[:, 8:], v[:, 8:], li[:, 8:], lf[:, 8:], chunk=4,
                                      state=st)
    _allclose(torch.cat([first, second], 1), full, SCAN_TOL)


def test_mlstm_prime_length_keeps_the_chunk():
    """T = 37 has no divisor near the chunk: the reference runs 37 chunks
    of one step, the port chunks of 16 with a short last one; the same
    recurrence, within the scan tolerance, and each request alone equals
    its row of the batch bit for bit."""
    q, k, v, li, lf = _mlstm_inputs(b=3, t=37)
    want, wst = jxlstm.mlstm_chunkwise(*map(jnp.asarray, (q, k, v, li, lf)), chunk=16)
    got, gst = xlstm.mlstm_chunkwise(*map(_t, (q, k, v, li, lf)), chunk=16)
    _allclose(got, want, SCAN_TOL)
    for a, b in zip(gst, wst):
        _allclose(a, b, SCAN_TOL)
    one, _ = xlstm.mlstm_chunkwise(*(_t(a[1:2]) for a in (q, k, v, li, lf)), chunk=16)
    assert torch.equal(one, got[1:2])


def test_mlstm_decode_matches_reference():
    q, k, v, li, lf = _mlstm_inputs(t=1)
    st = _state(np.random.default_rng(2), 2, 2, 8)
    want, wst = jxlstm.mlstm_decode(*map(jnp.asarray, (q, k, v, li, lf)), tuple(map(jnp.asarray, st)))
    got, gst = xlstm.mlstm_decode(*map(_t, (q, k, v, li, lf)), tuple(map(_t, st)))
    _allclose(got, want)
    for a, b in zip(gst, wst):
        _allclose(a, b)


def _block_params(kind, d=16, h=2, seed=0):
    cfg = ModelConfig(name="b", family="xlstm", n_layers=2, d_model=d, n_heads=h, n_kv_heads=h,
                      d_ff=0, vocab_size=16, slstm_ratio=2)
    rng = np.random.default_rng(seed)
    leaves_ = lm._mlstm_leaves(cfg, ()) if kind == "mlstm" else lm._slstm_leaves(cfg, ())
    p = {k: (rng.standard_normal(l.shape) * (l.scale or 0.1)).astype(np.float32)
         for k, l in leaves_.items()}
    return p, {k: _t(v) for k, v in p.items()}, {k: jnp.asarray(v) for k, v in p.items()}


def _pad_mask(b, t, lengths):
    return np.arange(t)[None, :] >= np.asarray(lengths)[:, None]


@pytest.mark.parametrize("case", ["plain", "padded", "decode"])
def test_mlstm_block_matches_reference(case):
    _, p, jp = _block_params("mlstm")
    rng = np.random.default_rng(3)
    t = 1 if case == "decode" else 12
    x = rng.standard_normal((3, t, 16)).astype(np.float32)
    st = _state(rng, 3, 2, 8) if case == "decode" else None
    mask = _pad_mask(3, t, [12, 5, 0]) if case == "padded" else \
        (np.asarray([[False], [True], [False]]) if case == "decode" else None)
    kw = dict(n_heads=2, chunk=4, decode=case == "decode")
    want, wst = jxlstm.mlstm_block(jnp.asarray(x), jp, jhooks.MatmulHook(),
                                   state=None if st is None else tuple(map(jnp.asarray, st)),
                                   pad_mask=None if mask is None else jnp.asarray(mask), **kw)
    got, gst = xlstm.mlstm_block(_t(x), p, MatmulHook(),
                                 state=None if st is None else tuple(map(_t, st)),
                                 pad_mask=None if mask is None else _t(mask), **kw)
    rows = [0, 1] if case == "padded" else [0, 1, 2]  # row 2 of "padded" is all padding
    _close(got[rows], np.asarray(want)[rows])
    for a, b in zip(gst, wst):
        _allclose(a, b, SCAN_TOL)
    if case == "decode":  # the pad row's state did not move
        for a, s in zip(gst, st):
            _allclose(a[1], s[1], 0.0)


@pytest.mark.parametrize("case", ["plain", "padded", "state", "decode"])
def test_slstm_block_matches_reference(case):
    _, p, jp = _block_params("slstm")
    rng = np.random.default_rng(4)
    t = 1 if case == "decode" else 10
    x = rng.standard_normal((3, t, 16)).astype(np.float32)
    st = None
    if case in ("state", "decode"):
        st = tuple(rng.standard_normal((3, 16)).astype(np.float32) * 0.3 for _ in range(3)) + (
            rng.standard_normal((3, 16)).astype(np.float32),)
    mask = _pad_mask(3, t, [10, 4, 0]) if case == "padded" else \
        (np.asarray([[False], [False], [True]]) if case == "decode" else None)
    want, wst = jxlstm.slstm_block(jnp.asarray(x), jp, jhooks.MatmulHook(), n_heads=2,
                                   state=None if st is None else tuple(map(jnp.asarray, st)),
                                   pad_mask=None if mask is None else jnp.asarray(mask),
                                   decode=case == "decode")
    got, gst = xlstm.slstm_block(_t(x), p, MatmulHook(), n_heads=2,
                                 state=None if st is None else tuple(map(_t, st)),
                                 pad_mask=None if mask is None else _t(mask))
    rows = [0, 1] if case == "padded" else ([0, 1] if case == "decode" else [0, 1, 2])
    _close(got[rows], np.asarray(want)[rows])
    for a, b in zip(gst, wst):
        _allclose(a, b)


def test_slstm_padded_state_equals_unpadded_run():
    """A row's state after its real steps does not see the pad suffix: the
    padded run's (c, n, h, m) equal the row's unpadded run's."""
    _, p, _ = _block_params("slstm", seed=1)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 9, 16)).astype(np.float32))
    _, short = xlstm.slstm_block(x[:, :6], p, MatmulHook(), n_heads=2)
    _, padded = xlstm.slstm_block(x, p, MatmulHook(), n_heads=2,
                                  pad_mask=torch.arange(9)[None, :] >= 6)
    for a, b in zip(padded, short):
        _allclose(a, b, 1e-6)


# ---------------------------------------------------------------------------
# models: prefill, per-row decode, caches, seeds
# ---------------------------------------------------------------------------

_weights = {}


def weights(name):
    if name not in _weights:
        cfg, jcfg = configs(name)
        rng = np.random.default_rng(0)
        tree = lm.map_leaves(
            lambda _p, leaf: (rng.standard_normal(leaf.shape) * (leaf.scale or 0.1)).astype(np.float32),
            lm.param_leaves(cfg),
        )
        jenergies = jlm.init_energy_tree(jcfg, 20.0)
        _weights[name] = dict(
            cfg=cfg, jcfg=jcfg, tree=tree, jparams=jax.tree.map(jnp.asarray, tree),
            params=bridge.params_from_numpy(tree, cfg, "cpu"), jenergies=jenergies,
            energies=bridge.energies_from_numpy(jax.tree.map(np.asarray, jenergies), cfg, "cpu"),
        )
    return _weights[name]


def _batch(vocab, t=16, seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.asarray([5, t, 9, 0], np.int32)  # the last row is batch padding
    toks = np.zeros((4, t), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(0, vocab, n)
    return toks, lengths


def _keys():
    return jnp.stack([jax.random.fold_in(jax.random.PRNGKey(5), u) for u in range(3)]
                     + [jax.random.PRNGKey(0)])


def _cache_close(cache, jcache, cfg, rows=3):
    """Every cache leaf of the real rows, along its own batch dim."""
    axes = lm.cache_batch_axes(cfg)
    for name, jleaf in jcache["groups"].items():
        ax = axes["groups"][name]
        _close(cache["groups"][name].narrow(ax, 0, rows), np.asarray(jleaf).take(range(rows), axis=ax))


def _spec(kind, energies, key, k):
    return None if k is None else jlm.AnalogSpec(
        cfg=JAnalogConfig.shot(backend="tile"), energies=energies, key=key, n_repeats=k)


@functools.partial(jax.jit, static_argnames=("cfg", "k", "cache_len"))
def _jprefill(params, toks, lengths, energies, key, *, cfg, k, cache_len):
    cache, h = jlm.prefill(params, {"tokens": toks}, cfg, analog=_spec(0, energies, key, k),
                           cache_len=cache_len, lengths=lengths)
    return cache, jlm.logits_last(params, h, cfg)


@functools.partial(jax.jit, static_argnames=("cfg", "k"))
def _jdecode(params, cache, tok, pos, lengths, energies, key, *, cfg, k):
    return jlm.decode_step(params, cache, {"tokens": tok}, pos, cfg,
                           analog=_spec(0, energies, key, k), lengths=lengths)


MODEL_MODES = [(n, m) for n in NAMES for m in ("digital", "analog-K1")] + [("xlstm-deep", "analog-K4")]


@pytest.mark.parametrize("name,mode", MODEL_MODES)
def test_prefill_and_decode_match_reference(name, mode):
    """Prefill of a padded bucket (a batch-padding row among them) and three
    per-row decode steps with the rows' lengths: logits and every state of
    the real rows, greedy tokens exact."""
    w = weights(name)
    cfg, jcfg = w["cfg"], w["jcfg"]
    toks, lengths = _batch(cfg.vocab_size)
    keys = _keys()
    k = None if mode == "digital" else int(mode[-1])
    spec = None if k is None else lm.AnalogSpec(
        cfg=AnalogConfig.shot(), energies=w["energies"], key=np.asarray(keys), n_repeats=k)
    jcache, jlogits = _jprefill(w["jparams"], jnp.asarray(toks), jnp.asarray(lengths),
                                w["jenergies"], keys, cfg=jcfg, k=k, cache_len=20)
    cache, h = lm.prefill(w["params"], torch.from_numpy(toks), cfg, analog=spec, cache_len=20,
                          lengths=torch.from_numpy(lengths))
    logits = lm.logits_last(w["params"], h, cfg)
    _close(logits[:3], jlogits[:3])
    _cache_close(cache, jcache, cfg)
    tok = np.asarray(jnp.argmax(jlogits[:, 0, 0], axis=-1)).astype(np.int32)
    np.testing.assert_array_equal(_np(torch.argmax(logits[:3, 0, 0], -1)), tok[:3])
    for step in range(3):
        pos = lengths + step
        jlogits, jcache = _jdecode(w["jparams"], jcache, jnp.asarray(tok)[:, None], jnp.asarray(pos),
                                   jnp.asarray(lengths), w["jenergies"],
                                   jax.vmap(jax.random.fold_in)(keys, jnp.asarray(pos)), cfg=jcfg,
                                   k=k)
        step_spec = spec and dataclasses.replace(spec, key=fold_key(np.asarray(keys), pos))
        logits, cache2 = lm.decode_step(w["params"], cache, torch.from_numpy(tok)[:, None],
                                        torch.from_numpy(pos), cfg, analog=step_spec,
                                        lengths=torch.from_numpy(lengths))
        assert cache2 is cache  # updated in place
        _close(logits[:3], jlogits[:3])
        _cache_close(cache, jcache, cfg)
        tok = np.asarray(jnp.argmax(jlogits[:, 0, 0], axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(_np(torch.argmax(logits[:3, 0, 0], -1)), tok[:3])


def test_decode_matches_full_forward():
    """``tests/test_decode.py`` for xlstm-1.3b's smoke config: prefill of T
    tokens then one decode step equals the cache-free forward over T + 1
    (port), and the reference's logits."""
    w = weights("xlstm-smoke")
    cfg = w["cfg"]
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 33)).astype(np.int64)
    full = lm.logits_last(w["params"], lm.hidden(w["params"], torch.from_numpy(toks), cfg)[:, -1:], cfg)
    cache, _ = lm.prefill(w["params"], torch.from_numpy(toks[:, :32]), cfg, cache_len=33)
    dec, _ = lm.decode_step(w["params"], cache, torch.from_numpy(toks[:, 32:]), torch.tensor([32]),
                            cfg)
    err = float((full - dec).abs().max())
    assert err < 3e-2 * float(full.abs().max()) + 1e-3
    jh, _ = jlm.forward_hidden(w["jparams"], {"tokens": jnp.asarray(toks)}, w["jcfg"], mode="train")
    _close(full, jlm.logits_last(w["jparams"], jh[:, -1:], w["jcfg"]))


@pytest.mark.parametrize("cache_len", [4, 100])
@pytest.mark.parametrize("name", NAMES)
def test_init_cache_shapes_match_reference(name, cache_len):
    cfg, jcfg = configs(name)
    cache = lm.init_cache(cfg, 3, cache_len, device="cpu")
    want = jax.tree.map(lambda a: (a.shape, a.dtype.name),
                        jax.eval_shape(lambda: jlm.init_cache(jcfg, 3, cache_len)))
    got = lm.map_leaves(lambda _p, a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), cache)
    assert got == want
    jinit = jlm.init_cache(jcfg, 3, cache_len)
    for a, b in zip(leaves(cache), jax.tree.leaves(jinit)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


@pytest.mark.parametrize("name", NAMES)
def test_scatter_cache_rows_matches_reference(name):
    """Every state leaf along its own batch dim (2 for C/n/m, 1 for the
    sLSTM's); ids past the pool are dropped."""
    cfg, jcfg = configs(name)
    slots, bb = 4, 3
    dst = lm.init_cache(cfg, slots, 12, device="cpu")
    src = lm.init_cache(cfg, bb, 12, device="cpu")
    axes = lm.cache_batch_axes(cfg)
    assert axes["groups"] == {"C": 2, "n": 2, "m": 2, "sc": 1, "sn": 1, "sh": 1, "sm": 1}
    lm.map_leaves(lambda _p, a, ax: [a.select(ax, r).fill_(r + 1) for r in range(bb)], src, axes)
    ids = np.asarray([2, 0, slots])
    jout = jlm.scatter_cache_rows(jcfg, jlm.init_cache(jcfg, slots, 12),
                                  jax.tree.map(lambda a: jnp.asarray(a.numpy()), src), jnp.asarray(ids))
    lm.scatter_cache_rows(cfg, dst, src, ids)
    for g, w_ in zip(leaves(dst), jax.tree.leaves(jout)):
        np.testing.assert_array_equal(_np(g), np.asarray(w_))


@pytest.mark.parametrize("stacked", [False, True])
def test_seed_words_match_reference_chain(stacked, monkeypatch):
    """Every block's hook carries the reference's ``hook_for_layer(key,
    group)`` -> ``site_key`` words, and the mLSTM blocks of a group carry
    the same words at each site: the reference's shared mLSTM stream (bare
    site names, one key a group)."""
    cfg, jcfg = configs("xlstm-deep")
    g, per = lm.group_structure(cfg)
    assert (g, per) == (2, 4) == jlm.group_structure(jcfg)
    jkey = (jnp.stack([jax.random.fold_in(jax.random.PRNGKey(9), u) for u in range(2)])
            if stacked else jax.random.PRNGKey(9))
    calls = []
    real = lm.hook_for_layer
    monkeypatch.setattr(lm, "hook_for_layer",
                        lambda c, e, s, **kw: calls.append((e, s)) or real(c, e, s, **kw))
    w = weights("xlstm-deep")
    spec = lm.AnalogSpec(cfg=AnalogConfig.shot(), energies=w["energies"], key=np.asarray(jkey))
    lm.prefill(w["params"], torch.zeros((2 if stacked else 1, 4), dtype=torch.long), cfg,
               analog=spec)
    assert len(calls) == g * per
    for n, (energies, seeds) in enumerate(calls):
        gi, j = divmod(n, per)
        jh = jhooks.hook_for_layer(JAnalogConfig.shot(), {}, jkey, gi)
        for site in lm.group_sites(cfg):
            words = _np(seeds[site]).view(np.uint32)
            np.testing.assert_array_equal(words[..., :2], np.asarray(janalog.site_key(jh.key, site)))
            assert torch.equal(seeds[site], calls[gi * per][1][site])  # block 0's words
        if j < per - 1:  # block j's energies: entry j of the (m,) leaves
            assert torch.equal(energies["mlstm_q"], w["energies"]["groups"]["mlstm_q"][gi, j])


def test_mlstm_blocks_of_a_group_draw_one_stream(monkeypatch):
    """The shared stream in the numbers: two mLSTM blocks of a group fed the
    same input and weights draw the same noise (equal outputs), and a block
    of the next group draws another."""
    cfg, _ = configs("xlstm-deep")
    w = weights("xlstm-deep")
    params = lm.map_leaves(lambda _p, a: a.clone(), w["params"])
    for leaf in params["blocks"]["mlstm"].values():
        leaf[:] = leaf[0, 0]  # every block of every group: the same weights
    got = []
    real = xlstm.mlstm_block
    monkeypatch.setattr(xlstm, "mlstm_block", lambda x, p, hook, **kw: got.append(
        real(torch.ones_like(x), p, hook, **kw)[0]) or real(x, p, hook, **kw))
    spec = lm.AnalogSpec(cfg=AnalogConfig.shot(), energies=w["energies"], key=PRNGKey(4))
    lm.hidden(params, torch.zeros((1, 6), dtype=torch.long), cfg, analog=spec)
    assert len(got) == 6
    assert torch.equal(got[0], got[1]) and torch.equal(got[1], got[2])
    assert not torch.equal(got[0], got[3])


# ---------------------------------------------------------------------------
# configs, leaves, energies, profiles
# ---------------------------------------------------------------------------


def test_xlstm_config_is_the_reference_config():
    for f in dataclasses.fields(ModelConfig):
        assert getattr(XLSTM, f.name) == getattr(JXLSTM, f.name), f.name
        assert getattr(xlstm_smoke(), f.name) == getattr(jxlstm_smoke(), f.name), f.name
    assert XLSTM.param_count() == JXLSTM.param_count()
    assert XLSTM.sub_quadratic and lm.group_structure(XLSTM) == (6, 8)


@pytest.mark.parametrize("name", NAMES + ["xlstm-1.3b"])
def test_param_leaves_sites_and_energies_match_reference(name):
    cfg, jcfg = (XLSTM, JXLSTM) if name == "xlstm-1.3b" else configs(name)
    got = lm.map_leaves(lambda _p, leaf: (leaf.shape, leaf.scale), lm.param_leaves(cfg))
    want = jax.tree.map(lambda leaf: (tuple(leaf.shape), leaf.scale), jlm.param_leaves(jcfg),
                        is_leaf=lambda x: isinstance(x, jlm.Leaf))
    assert got == want
    assert cfg.param_count() == jcfg.param_count()
    assert lm.group_sites(cfg) == jlm.group_sites(jcfg)
    assert lm.group_site_subs(cfg) == jlm.group_site_subs(jcfg)
    for t in (1, 7):
        for a, b in zip(leaves(lm.energy_macs(cfg, t)), jax.tree.leaves(jlm.energy_macs(jcfg, t))):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=ENERGY_REL)


@pytest.mark.parametrize("kind", ["uniform1", "uniform4", "mixed"])
@pytest.mark.parametrize("name", ["xlstm-deep", "xlstm-1.3b"])
def test_profile_token_energy_matches_reference(name, kind):
    """``sum_l K_l * E_l * MACs_l``: an mLSTM block's K on its own entry of
    the (G, m) leaves, the sLSTM's on the group's."""
    cfg, jcfg = (XLSTM, JXLSTM) if name == "xlstm-1.3b" else configs(name)
    n = cfg.n_layers
    reps = {"uniform1": (1,) * n, "uniform4": (4,) * n,
            "mixed": tuple(1 + (i * 7) % 4 for i in range(n))}[kind]
    p, jp = PrecisionProfile(reps, name="p"), jprofile.PrecisionProfile(reps, name="p")
    for a, b in zip(leaves(lm.profile_repeat_tree(cfg, p)),
                    jax.tree.leaves(jlm.profile_repeat_tree(jcfg, jp))):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    rng = np.random.default_rng(1)
    tree = lm.map_leaves(lambda _p, a: rng.uniform(1.0, 50.0, tuple(a.shape)).astype(np.float32),
                         lm.init_energy_tree(cfg, 1.0, "cpu"))
    got = lm.profile_token_energy(cfg, lm.map_leaves(lambda _p, a: _t(a), tree), p)
    want = jlm.profile_token_energy(jcfg, jax.tree.map(jnp.asarray, tree), jp)
    np.testing.assert_allclose(got, want, rtol=ENERGY_REL)


@functools.partial(jax.jit, static_argnames=("cfg", "profile"))
def _jprofile_prefill(params, toks, lengths, energies, key, *, cfg, profile):
    spec = jlm.AnalogSpec(cfg=JAnalogConfig.shot(backend="tile"), energies=energies, key=key,
                          profile=profile)
    _, h = jlm.prefill(params, {"tokens": toks}, cfg, analog=spec, cache_len=20, lengths=lengths)
    return jlm.logits_last(params, h, cfg)


def _port_prefill(w, toks, lengths, **spec_kw):
    spec = lm.AnalogSpec(cfg=AnalogConfig.shot(), energies=spec_kw.pop("energies", w["energies"]),
                         key=np.asarray(_keys()), **spec_kw)
    cache, h = lm.prefill(w["params"], torch.from_numpy(toks), w["cfg"], analog=spec, cache_len=20,
                          lengths=torch.from_numpy(lengths))
    return lm.logits_last(w["params"], h, w["cfg"]), cache


def test_profile_prefill_matches_reference():
    """``tests/test_profiles.py``'s xlstm case: each mLSTM block and the
    sLSTM at its own K (the reference's profile forward)."""
    w = weights("xlstm-deep")
    reps = PROFILES["xlstm-deep"]
    toks, lengths = _batch(w["cfg"].vocab_size)
    want = _jprofile_prefill(w["jparams"], jnp.asarray(toks), jnp.asarray(lengths), w["jenergies"],
                             _keys(), cfg=w["jcfg"], profile=jprofile.PrecisionProfile(reps, name="p"))
    got, _ = _port_prefill(w, toks, lengths, profile=PrecisionProfile(reps, name="p"))
    _close(got[:3], np.asarray(want)[:3])


@pytest.mark.parametrize("name", NAMES)
def test_profile_matches_scaled_energy_oracle(name, monkeypatch):
    """Serving block l at K_l is serving it at K=1 with its energies scaled
    by K_l (``apply_repeats(E, profile_repeat_tree)``), call by call: the
    same seeds, and ``K_l * E_l`` bit for bit the scaled energy (the
    tile path averages K streams, so the outputs differ; see
    ``tests/test_torch_families.py``)."""
    w = weights(name)
    cfg = w["cfg"]
    profile = PrecisionProfile(PROFILES[name], name="p")
    calls = []
    real = hooks.analog_dot

    def spy(x, w_, *, energy, seed, n_repeats, **kw):
        calls.append((energy, seed, n_repeats))
        return real(x, w_, energy=energy, seed=seed, n_repeats=n_repeats, **kw)

    monkeypatch.setattr(hooks, "analog_dot", spy)
    toks, lengths = _batch(cfg.vocab_size)
    _port_prefill(w, toks, lengths, profile=profile)
    prof_calls, calls[:] = list(calls), []
    scaled = energy.apply_repeats(w["energies"], lm.profile_repeat_tree(cfg, profile))
    _port_prefill(w, toks, lengths, energies=scaled)
    g, per = lm.group_structure(cfg)
    assert len(prof_calls) == len(calls) == g * (5 * (per - 1) + 2)
    assert [k for _, _, k in prof_calls] == [
        profile.repeats[gi * per + j] for gi in range(g) for j in range(per)
        for _ in range(5 if j < per - 1 else 2)]
    for (e_p, s_p, k), (e_s, s_s, _) in zip(prof_calls, calls):
        assert torch.equal(s_p, s_s)
        assert torch.equal(e_p * torch.tensor(float(k)), e_s)


# ---------------------------------------------------------------------------
# engines: the reference's, solo == batched, pooled == sync == solo
# ---------------------------------------------------------------------------


def _requests(vocab, n=3, lens=(7, 19, 28), gens=(2, 5, 8), seed=3):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, n_).astype(np.int32) for n_ in lens[:n]]
    keys = [fold_in(PRNGKey(5), i) for i in range(n)]
    return prompts, list(gens[:n]), keys


def _engine(w, *, analog=True, **kw):
    extra = dict(analog_cfg=AnalogConfig.shot(), energies=w["energies"]) if analog else {}
    return ServingEngine(w["params"], w["cfg"], **extra, **{**ENGINE_KW, **kw}, device="cpu")


@pytest.mark.parametrize("name,analog,continuous", [
    ("xlstm", False, False), ("xlstm", True, False), ("xlstm-smoke", True, False),
    ("xlstm", False, True), ("xlstm", True, True)])
def test_engine_tokens_equal_reference_engine(name, analog, continuous):
    """The reference's ``FAMILY_CONFIGS["xlstm"]`` serving tests, engine to
    engine: batch-synchronous, and continuous through 2-slot pools (the
    third request admitted into a retired slot mid-flight)."""
    w = weights(name)
    prompts, gens, _ = _requests(w["cfg"].vocab_size)
    jextra = dict(analog_cfg=JAnalogConfig.shot(backend="tile"), energies=w["jenergies"]) \
        if analog else {}
    pool = dict(continuous=True, pool_slots=2) if continuous else {}
    jeng = JServingEngine(w["jparams"], w["jcfg"], **jextra, **ENGINE_KW, **pool)
    eng = _engine(w, analog=analog, **pool)
    for p, g in zip(prompts, gens):
        assert jeng.submit(p, max_new_tokens=g, now=0.0) == eng.submit(p, max_new_tokens=g, now=0.0)
    want, got = jeng.flush(), eng.flush()
    assert sorted(want) == sorted(got)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]))
    for stat in ("requests", "batches", "tokens_generated", "decode_steps", "decode_slot_steps"):
        assert eng.stats[stat] == jeng.stats[stat], stat


def _solo_tokens(w, prompt, gen):
    """Greedy tokens of an unpadded batch-1 run, no engine."""
    cfg, params = w["cfg"], w["params"]
    cache, h = lm.prefill(params, torch.from_numpy(prompt[None].astype(np.int64)), cfg,
                          cache_len=len(prompt) + gen)
    tok = torch.argmax(lm.logits_last(params, h, cfg)[:, 0, 0], -1)
    out = [int(tok[0])]
    for t in range(gen - 1):
        logits, cache = lm.decode_step(params, cache, tok[:, None], torch.tensor([len(prompt) + t]),
                                       cfg)
        tok = torch.argmax(logits[:, 0, 0], -1)
        out.append(int(tok[0]))
    return np.asarray(out, np.int32)


def test_family_solo_vs_batched_equivalence():
    """``tests/test_serving.py``'s length-aware prefill contract for xlstm:
    three requests in a padded 4-row bucket give each one's unpadded
    batch-1 run (digital)."""
    w = weights("xlstm")
    prompts, _, _ = _requests(w["cfg"].vocab_size)
    eng = _engine(w, analog=False)
    uids = [eng.submit(p, max_new_tokens=4, now=0.0) for p in prompts]
    batched = eng.flush()
    assert eng.stats["padded_rows"] == 1
    for uid, p in zip(uids, prompts):
        np.testing.assert_array_equal(batched[uid], _solo_tokens(w, p, 4))


@pytest.mark.parametrize("name", NAMES)
def test_solo_equals_batched_bit_exact(name):
    """Analog batch-mates (``tests/test_serving.py``'s xlstm case), at K =
    2: each request's tokens in a padded bucket equal its run alone at the
    same seq bucket, bit for bit."""
    w = weights(name)
    prompts, _, keys = _requests(w["cfg"].vocab_size)
    eng = _engine(w)
    uids = [eng.submit(p, n_repeats=2, max_new_tokens=4, key=k, now=0.0)
            for p, k in zip(prompts, keys)]
    batched = eng.flush()
    for uid, p, k in zip(uids, prompts, keys):
        solo = eng.submit(p, n_repeats=2, max_new_tokens=4, key=k, now=0.0)
        np.testing.assert_array_equal(eng.flush()[solo], batched[uid])


@pytest.mark.parametrize("name", ["xlstm", "xlstm-deep"])
def test_pooled_equals_sync_equals_solo_bit_exact(name):
    """Three requests through a 2-slot pool give the batch-synchronous
    engine's tokens, and each alone through the pool gives the same bits;
    the pool's state tree is the live one, updated in place."""
    w = weights(name)
    prompts, gens, keys = _requests(w["cfg"].vocab_size)
    pooled_eng = _engine(w, continuous=True, pool_slots=2)
    uids = [pooled_eng.submit(p, n_repeats=2, max_new_tokens=g, key=k, now=0.0)
            for p, g, k in zip(prompts, gens, keys)]
    pool_cache, pooled = None, {}
    while pooled_eng.n_in_flight:
        pooled.update(pooled_eng.pump_step(0.0, force=True))
        (pool,) = pooled_eng.pools.values()
        assert pool_cache is None or pool.cache is pool_cache
        pool_cache = pool.cache
    sync_eng = _engine(w)
    sync_uids = [sync_eng.submit(p, n_repeats=2, max_new_tokens=g, key=k, now=0.0)
                 for p, g, k in zip(prompts, gens, keys)]
    sync = sync_eng.flush()
    for pu, su, g in zip(uids, sync_uids, gens):
        assert pooled[pu].shape == (g,)
        np.testing.assert_array_equal(pooled[pu], sync[su])
    for pu, p, g, k in zip(uids, prompts, gens, keys):
        solo = pooled_eng.submit(p, n_repeats=2, max_new_tokens=g, key=k, now=0.0)
        np.testing.assert_array_equal(pooled_eng.flush()[solo], pooled[pu])
