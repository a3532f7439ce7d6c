"""Port vs reference: the griffin blocks, windowed attention, the griffin
and windowed dense LMs, their caches and their noise keys.

Blocks run at float32 on numpy inputs with the reference's own tolerance
(``tests/test_recurrent_blocks.py``: 1e-5). The port's scan is a
Hillis-Steele scan, the reference's ``lax.associative_scan`` groups the
products in another order, so the two agree to float32 rounding; inside
the port a padded row's real positions carry the bits of its unpadded
run. Models compute from the same numpy weights (``lm.param_leaves``
shapes) at float32, analog sites on backend "tile" on both sides: logits
within ``1e-4 * max|logit|``, greedy tokens exact. Seed words of every
group and tail site equal the reference's ``hook_for_layer`` ->
``site_key`` chain bit for bit.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs as several processes on the cores (pytest-xdist): torch's
# intra-op threads in each would oversubscribe them (20x slower when six run)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.recurrentgemma_2b import CONFIG as JRGEMMA  # noqa: E402
from repro.configs.recurrentgemma_2b import smoke_config as jrgemma_smoke  # noqa: E402
from repro.core import analog as janalog  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.models import griffin as jgriffin  # noqa: E402
from repro.models import hooks as jhooks  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.recurrentgemma_2b import CONFIG as RGEMMA  # noqa: E402
from repro_torch.configs.recurrentgemma_2b import smoke_config as rgemma_smoke  # noqa: E402
from repro_torch.core.analog import AnalogConfig, fold_key  # noqa: E402
from repro_torch.models import griffin, layers, lm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.hooks import MatmulHook  # noqa: E402

BLOCK_TOL = 1e-5
REL_TOL = 1e-4
_TINY = dict(n_heads=2, n_kv_heads=1, head_dim=16, vocab_size=128, dtype="float32")
#: the reference's serving configs (tests/test_serving.py FAMILY_CONFIGS):
#: window 8, so a (4, 16) bucket wraps the ring; rgemma-smoke has 2 groups
#: and 2 tail layers (window 32); "griffin-wide" has a window larger than
#: the cache (the recurrentgemma regime: the ring is linear)
CONFIGS = {
    "griffin": dict(name="serve-griffin", family="griffin", n_layers=3, d_model=32, d_ff=64,
                    rnn_width=32, conv_width=4, local_window=8, **_TINY),
    "griffin-wide": dict(name="serve-griffin", family="griffin", n_layers=3, d_model=32, d_ff=64,
                         rnn_width=32, conv_width=4, local_window=64, **_TINY),
    "windowed": dict(name="serve-win", family="dense", n_layers=2, d_model=32, d_ff=64,
                     sliding_window=8, **_TINY),
}


def configs(name):
    """"rgemma-smoke-L4" is rgemma-smoke at its smallest depth that keeps
    every layer kind: one (rec, rec, attn) group and one tail layer."""
    if name.startswith("rgemma-smoke"):
        depth = dict(n_layers=4) if name == "rgemma-smoke-L4" else {}
        return (dataclasses.replace(rgemma_smoke(), dtype="float32", **depth),
                dataclasses.replace(jrgemma_smoke(), dtype="float32", **depth))
    return ModelConfig(**CONFIGS[name]), JModelConfig(**CONFIGS[name])


def numpy_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return lm.map_leaves(
        lambda _p, leaf: (rng.standard_normal(leaf.shape) * (leaf.scale or 0.1)).astype(np.float32),
        lm.param_leaves(cfg),
    )


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
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _rec_params(rng, d=12, r=8, cw=4):
    p = {"w_gate": rng.standard_normal((d, r)) * d**-0.5, "w_x": rng.standard_normal((d, r)) * d**-0.5,
         "w_a": rng.standard_normal((r, r)) * r**-0.5, "b_a": rng.standard_normal(r) * 0.1,
         "w_i": rng.standard_normal((r, r)) * r**-0.5, "b_i": rng.standard_normal(r) * 0.1,
         "lambda": rng.standard_normal(r), "conv_w": rng.standard_normal((cw, r)) * cw**-0.5,
         "conv_b": rng.standard_normal(r) * 0.1, "w_out": rng.standard_normal((r, d)) * r**-0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return p, {k: _t(v) for k, v in p.items()}, {k: jnp.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_scan_matches_reference(with_h0):
    rng = np.random.default_rng(0)
    b, t, r = 2, 24, 8
    a = (1 / (1 + np.exp(-rng.standard_normal((b, t, r))))).astype(np.float32)
    x = rng.standard_normal((b, t, r)).astype(np.float32)
    h0 = rng.standard_normal((b, r)).astype(np.float32) if with_h0 else None
    want = jgriffin.rg_lru_scan(jnp.asarray(a), jnp.asarray(x), None if h0 is None else jnp.asarray(h0))
    got = griffin.rg_lru_scan(_t(a), _t(x), None if h0 is None else _t(h0))
    _allclose(got, want)
    h = np.zeros((b, r), np.float32) if h0 is None else h0  # and the sequential recurrence
    for i in range(t):
        h = a[:, i] * h + x[:, i]
        _allclose(got[:, i], h)


def test_scan_padded_equals_unpadded_bit_exact():
    """Position t's result does not depend on T: an identity-padded row
    gives its real positions the bits of its unpadded run, for every length."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.uniform(0.2, 1.0, (1, 37, 6)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((1, 37, 6)).astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((1, 6)).astype(np.float32))
    full = griffin.rg_lru_scan(a, x, h0)
    for n in (1, 2, 5, 8, 16, 17, 36):
        short = griffin.rg_lru_scan(a[:, :n], x[:, :n], h0)
        assert torch.equal(short, full[:, :n]), n
        pa = torch.cat([a[:, :n], torch.ones((1, 64 - n, 6))], 1)
        pb = torch.cat([x[:, :n], torch.zeros((1, 64 - n, 6))], 1)
        assert torch.equal(griffin.rg_lru_scan(pa, pb, h0)[:, :n], short), n


@pytest.mark.parametrize("case", ["state", "lengths"])
def test_causal_conv1d_matches_reference(case):
    rng = np.random.default_rng(2)
    b, t, r, cw = 3, 16, 4, 4
    w = rng.standard_normal((cw, r)).astype(np.float32)
    bias = rng.standard_normal(r).astype(np.float32)
    x = rng.standard_normal((b, t, r)).astype(np.float32)
    state = rng.standard_normal((b, cw - 1, r)).astype(np.float32)
    lengths = np.asarray([16, 2, 9], np.int32) if case == "lengths" else None
    jy, jst = jgriffin.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                                     jnp.asarray(state),
                                     lengths=None if lengths is None else jnp.asarray(lengths))
    y, st = griffin.causal_conv1d(_t(x), _t(w), _t(bias), _t(state),
                                  lengths=None if lengths is None else _t(lengths))
    _allclose(y, jy)
    np.testing.assert_array_equal(_np(st), np.asarray(jst))  # a gather: exact


def test_rg_lru_coeffs_matches_reference():
    rng = np.random.default_rng(3)
    _, p, jp = _rec_params(rng)
    xr = rng.standard_normal((2, 10, 8)).astype(np.float32)
    ja, jb = jgriffin.rg_lru_coeffs(jnp.asarray(xr), jp, jhooks.MatmulHook())
    a, b_ = griffin.rg_lru_coeffs(_t(xr), p, MatmulHook())
    _allclose(a, ja)
    _allclose(b_, jb)


@pytest.mark.parametrize("padded", [False, True])
def test_recurrent_mix_matches_reference(padded):
    rng = np.random.default_rng(4)
    _, p, jp = _rec_params(rng)
    x = rng.standard_normal((3, 12, 12)).astype(np.float32)
    lengths = np.asarray([12, 5, 1], np.int32) if padded else None
    kw, jkw = {}, {}
    if padded:
        mask = np.arange(12)[None, :] >= lengths[:, None]
        kw = dict(pad_mask=_t(mask), lengths=_t(lengths))
        jkw = dict(pad_mask=jnp.asarray(mask), lengths=jnp.asarray(lengths))
    jy, jh, jc = jgriffin.recurrent_mix(jnp.asarray(x), jp, jhooks.MatmulHook(), **jkw)
    y, h, c = griffin.recurrent_mix(_t(x), p, MatmulHook(), **kw)
    rows = lengths if padded else [12, 12, 12]
    for i, n in enumerate(rows):  # pad-position outputs are garbage on both sides
        _allclose(y[i, :n], jy[i, :n])
    _allclose(h, jh)
    _allclose(c, jc)


def test_recurrent_decode_matches_reference():
    rng = np.random.default_rng(5)
    _, p, jp = _rec_params(rng)
    x = rng.standard_normal((3, 1, 12)).astype(np.float32)
    h0 = rng.standard_normal((3, 8)).astype(np.float32)
    cs = rng.standard_normal((3, 3, 8)).astype(np.float32)
    jy, jh, jc = jgriffin.recurrent_decode(jnp.asarray(x), jp, jhooks.MatmulHook(),
                                           jnp.asarray(h0), jnp.asarray(cs))
    y, h, c = griffin.recurrent_decode(_t(x), p, MatmulHook(), _t(h0), _t(cs))
    _allclose(y, jy)
    _allclose(h, jh)
    _allclose(c, jc)


@pytest.mark.parametrize("t,window", [(6, 8), (13, 4), (16, 4)], ids=["short", "unaligned", "aligned"])
def test_local_attention_matches_reference(t, window):
    """Both branches: masked (t <= window or t % window) and the aligned
    (previous, current) chunk pairs."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, t, 4, 8)).astype(np.float32) for _ in range(3))
    want = jlayers.local_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window)
    got = layers.local_attention(_t(q), _t(k), _t(v), window=window)
    _allclose(got, want)


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention_ring_matches_reference(per_row):
    rng = np.random.default_rng(7)
    b, s, h, kh, d, window = 3, 8, 4, 2, 8, 8
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, s, kh, d)).astype(np.float32) for _ in range(2))
    pos = np.asarray([3, 11, 20], np.int64)
    slot = pos % window
    base = np.arange(s)
    if per_row:
        slot_pos = np.where(base[None] <= slot[:, None], (pos - slot)[:, None] + base,
                            (pos - slot - s)[:, None] + base)
    else:
        slot_pos = np.where(base <= 4, 16 + base, 8 + base)  # one map for every row
    want = jlayers.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                    jnp.asarray(pos), slot_pos=jnp.asarray(slot_pos),
                                    window=window)
    got = layers.decode_attention(_t(q), _t(kc), _t(vc), _t(pos), slot_pos=_t(slot_pos),
                                  window=window)
    _allclose(got, want)


# ---------------------------------------------------------------------------
# keys: every group site and every tail site
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stacked", [False, True])
def test_site_seed_words_match_reference_chain(stacked, monkeypatch):
    """The seeds each site's hook carries in a forward (groups at their
    group index, the tail at G*per + j) equal the reference's
    ``hook_for_layer(key, idx)`` -> ``site_key`` words."""
    cfg, jcfg = configs("rgemma-smoke")
    g, per = lm.group_structure(cfg)
    assert (g, per, lm.n_tail(cfg)) == (2, 3, 2) == (*jlm.group_structure(jcfg), 2)
    jkey = (jnp.stack([jax.random.fold_in(jax.random.PRNGKey(9), u) for u in range(2)])
            if stacked else jax.random.PRNGKey(9))
    calls = []
    real = lm.hook_for_layer
    monkeypatch.setattr(lm, "hook_for_layer", lambda c, e, s, **kw: calls.append(s) or real(c, e, s, **kw))
    params = bridge.params_from_numpy(numpy_params(cfg), cfg, "cpu")
    spec = lm.AnalogSpec(cfg=AnalogConfig.shot(), energies=lm.init_energy_tree(cfg, 20.0, "cpu"),
                         key=np.asarray(jkey))
    b = 2 if stacked else 1
    lm.prefill(params, torch.zeros((b, 4), dtype=torch.long), cfg, analog=spec)
    assert len(calls) == g * per + lm.n_tail(cfg)
    for n, seeds in enumerate(calls):
        idx = n // per if n < g * per else n  # the tail: G*per + j
        jh = jhooks.hook_for_layer(JAnalogConfig.shot(), {}, jkey, idx)
        sites = lm.TAIL_SITES if n >= g * per else tuple(lm.group_sites(cfg))
        assert set(seeds) == set(sites)
        for site in sites:
            words = _np(seeds[site]).view(np.uint32)
            np.testing.assert_array_equal(words[..., :2], np.asarray(janalog.site_key(jh.key, site)))
            np.testing.assert_array_equal(words[..., 2:], 0)


# ---------------------------------------------------------------------------
# models: prefill, per-row decode over the ring, caches
# ---------------------------------------------------------------------------

MODEL_NAMES = ["griffin", "griffin-wide", "windowed", "rgemma-smoke"]
_weights = {}


def weights(name):
    if name not in _weights:
        cfg, jcfg = configs(name)
        tree = numpy_params(cfg)
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


def _cache_close(cache, jcache, rows=3):
    """Every cache leaf of the real rows (batch dim per leaf)."""
    for sub in jcache:
        for name, jleaf in jcache[sub].items():
            leaf = cache[sub][name]
            ax = 2 if jleaf.ndim == 6 else 1
            _close(leaf.narrow(ax, 0, rows), np.asarray(jleaf).take(range(rows), axis=ax))


@functools.partial(jax.jit, static_argnames=("cfg", "k", "cache_len"))
def _jprefill(params, toks, lengths, energies, key, *, cfg, k, cache_len):
    spec = None if k is None else jlm.AnalogSpec(
        cfg=JAnalogConfig.shot(backend="tile"), energies=energies, key=key, n_repeats=k)
    cache, h = jlm.prefill(params, {"tokens": toks}, cfg, analog=spec, cache_len=cache_len,
                           lengths=lengths)
    return cache, jlm.logits_last(params, h, cfg)


@functools.partial(jax.jit, static_argnames=("cfg", "k"))
def _jdecode(params, cache, tok, pos, lengths, energies, key, *, cfg, k):
    spec = None if k is None else jlm.AnalogSpec(
        cfg=JAnalogConfig.shot(backend="tile"), energies=energies, key=key, n_repeats=k)
    return jlm.decode_step(params, cache, {"tokens": tok}, pos, cfg, analog=spec, lengths=lengths)


#: K = 4 on the config with the tail only, at its smallest depth that keeps
#: every layer kind: the reference's tile path takes ~15 s a compile at
#: K = 4, and K-repeat averaging is per site (tests/test_torch_kernels.py)
MODEL_MODES = [(n, m) for n in MODEL_NAMES for m in ("digital", "analog-K1")] + [
    ("rgemma-smoke", "analog-K4")]


@pytest.mark.parametrize("name,mode", MODEL_MODES)
def test_prefill_and_ring_decode_match_reference(name, mode):
    """Prefill of a padded bucket and three per-row decode steps (the
    window-8 rings wrap: rows at positions 5..18), logits and every cache
    leaf, greedy tokens exact."""
    w = weights(f"{name}-L4" if mode == "analog-K4" else name)
    cfg, jcfg = w["cfg"], w["jcfg"]
    toks, lengths = _batch(cfg.vocab_size)
    cache_len = 20
    keys = _keys()
    k = None if mode == "digital" else int(mode[-1])
    spec = None if k is None else lm.AnalogSpec(
        cfg=AnalogConfig.shot(), energies=w["energies"], key=np.asarray(keys), n_repeats=k)
    jcache, jlogits = _jprefill(w["jparams"], jnp.asarray(toks), jnp.asarray(lengths),
                                w["jenergies"], keys, cfg=jcfg, k=k, cache_len=cache_len)
    cache, h = lm.prefill(w["params"], torch.from_numpy(toks), cfg, analog=spec,
                          cache_len=cache_len, lengths=torch.from_numpy(lengths))
    logits = lm.logits_last(w["params"], h, cfg)
    _close(logits[:3], jlogits[:3])
    _cache_close(cache, jcache)
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
                                        torch.from_numpy(pos), cfg, analog=step_spec)
        assert cache2 is cache  # updated in place
        _close(logits[:3], jlogits[:3])
        _cache_close(cache, jcache)
        tok = np.asarray(jnp.argmax(jlogits[:, 0, 0], axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(_np(torch.argmax(logits[:3, 0, 0], -1)), tok[:3])


@pytest.mark.parametrize("cache_len", [4, 20, 100])
@pytest.mark.parametrize("name", MODEL_NAMES)
def test_init_cache_shapes_match_reference(name, cache_len):
    """Including a window larger than the cache (the ring is then the
    cache's length) and one smaller."""
    cfg, jcfg = configs(name)
    cache = lm.init_cache(cfg, 3, cache_len, device="cpu")
    want = jax.tree.map(lambda a: (a.shape, a.dtype.name),
                        jax.eval_shape(lambda: jlm.init_cache(jcfg, 3, cache_len)))
    got = lm.map_leaves(lambda _p, a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), cache)
    assert got == want


@pytest.mark.parametrize("name", ["griffin", "windowed", "rgemma-smoke"])
def test_prefill_without_cache_len_matches_reference_shapes(name):
    """Without ``cache_len`` a ring holds the whole window, as the
    reference sizes it, and decode continues from it."""
    w = weights(name)
    toks = np.random.default_rng(3).integers(0, 128, (2, 6)).astype(np.int32)
    jcache, jh = jlm.prefill(w["jparams"], {"tokens": jnp.asarray(toks)}, w["jcfg"])
    cache, h = lm.prefill(w["params"], torch.from_numpy(toks), w["cfg"])
    assert lm.map_leaves(lambda _p, a: tuple(a.shape), cache) == \
        jax.tree.map(lambda a: tuple(a.shape), jcache)
    _close(h, jh)


def test_tail_layers_run_after_the_groups():
    """rgemma-smoke's tail: 2 layers outside the groups, their own params,
    cache and energies; zeroing a tail layer's output projections changes
    the logits (the tail is on the path)."""
    w = weights("rgemma-smoke")
    cfg = w["cfg"]
    assert set(w["params"]["tail"]) == {"ln1", "ln2", "rec", "mlp"}
    assert w["params"]["tail"]["rec"]["w_a"].shape == (2, 64, 64)
    assert set(w["energies"]["tail"]) == set(lm.TAIL_SITES)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (1, 8)))
    _, h = lm.prefill(w["params"], toks, cfg)
    cut = lm.map_leaves(lambda _p, a: a.clone(), w["params"])
    cut["tail"]["mlp"]["w_down"][1].zero_()
    cut["tail"]["rec"]["w_out"][1].zero_()
    _, h_cut = lm.prefill(cut, toks, cfg)
    assert not torch.equal(h, h_cut)


# ---------------------------------------------------------------------------
# configs, leaves, bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODEL_NAMES + ["recurrentgemma-2b"])
def test_param_leaves_and_count_match_reference(name):
    cfg, jcfg = (RGEMMA, JRGEMMA) if name == "recurrentgemma-2b" else configs(name)
    got = lm.map_leaves(lambda _p, leaf: (leaf.shape, leaf.scale), lm.param_leaves(cfg))
    want = jax.tree.map(lambda leaf: (leaf.shape, leaf.scale), jlm.param_leaves(jcfg),
                        is_leaf=lambda x: isinstance(x, jlm.Leaf))
    assert got == want
    assert cfg.param_count() == jcfg.param_count()
    assert lm.group_structure(cfg) == jlm.group_structure(jcfg)


def test_recurrentgemma_config_is_the_reference_config():
    for f in dataclasses.fields(RGEMMA):
        assert getattr(RGEMMA, f.name) == getattr(JRGEMMA, f.name), f.name
    assert lm.group_structure(RGEMMA) == (8, 3) and lm.n_tail(RGEMMA) == 2
    assert "tail" in lm.param_leaves(RGEMMA) and "lm_head" not in lm.param_leaves(RGEMMA)


@pytest.mark.parametrize("kw", [dict(family="moe"), dict(family="xlstm"), dict(family="rnn"),
                                dict(family="griffin", mlp_type="gelu"),
                                dict(family="griffin", griffin_pattern=("rec", "mlstm"))])
def test_config_raises_for_unported_families(kw):
    """Every family of the reference is ported; what raises is a family the
    reference does not have, or a config its family cannot run: moe with
    no experts, xlstm with no whole group of ``slstm_ratio`` (8) layers,
    griffin with a GELU MLP or an unknown sublayer."""
    base = dict(name="x", family="dense", n_layers=2, d_model=32, d_ff=64, **_TINY)
    with pytest.raises(ValueError):
        ModelConfig(**{**base, **kw})


def test_bridge_carries_tail_and_checks_energy_sites():
    w = weights("rgemma-smoke")
    np.testing.assert_array_equal(_np(w["params"]["tail"]["rec"]["lambda"]),
                                  w["tree"]["tail"]["rec"]["lambda"])
    jenergies = jax.tree.map(np.asarray, w["jenergies"])
    no_tail = {k: v for k, v in jenergies.items() if k != "tail"}
    with pytest.raises(ValueError):
        bridge.energies_from_numpy(no_tail, w["cfg"], "cpu")
    bad = dict(jenergies, tail={s: v for s, v in jenergies["tail"].items() if s != "rec0_rec_a"})
    with pytest.raises(ValueError):
        bridge.energies_from_numpy(bad, w["cfg"], "cpu")
