"""Port vs reference: the moe family — ``split``, top-k routing (ties
included), GShard dispatch with capacity and the pad mask, the MoE block
with virtual and shared experts, the expert sites' batch-level noise
keys, the moe LM (prefill and per-row decode), its engine, profiles and
energy, and the grok-1 and llama4-maverick configs.

Blocks and models run at float32 from the same numpy weights
(``lm.param_leaves`` shapes), analog sites on backend "tile" on both
sides: logits within ``1e-4 * max|logit|``, expert ids and greedy tokens
exact, key words bit for bit. Configs: the reference serving tests'
``FAMILY_CONFIGS["moe"]`` (4 experts, top 2, capacity factor 2.0: no
token is dropped) and the reference's grok-1 and llama4 smoke configs.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import analog as janalog  # noqa: E402
from repro.core import profile as jprofile  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.models import hooks as jhooks  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.core import energy  # noqa: E402
from repro_torch.core.analog import AnalogConfig, fold_key  # noqa: E402
from repro_torch.core.profile import PrecisionProfile  # noqa: E402
from repro_torch.kernels import prng  # noqa: E402
from repro_torch.kernels.prng import PRNGKey, fold_in  # noqa: E402
from repro_torch.models import hooks, lm, moe  # noqa: E402
from repro_torch.models.config import FAMILIES, ModelConfig  # noqa: E402
from repro_torch.models.hooks import MatmulHook  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

REL_TOL = 1e-4
ENERGY_REL = 1e-6
SB = 32
_BASE = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, head_dim=16, vocab_size=128,
             attn_q_chunk=16, attn_kv_chunk=16, dtype="float32")
CONFIGS = {
    "moe": dict(name="serve-moe", family="moe", d_ff=64, n_experts=4, top_k=2, moe_every=1,
                capacity_factor=2.0, moe_group_size=64, **_BASE),
}
NAMES = ["moe", "grok-smoke", "llama4-smoke"]
SMOKE = {"grok-smoke": "grok-1-314b", "llama4-smoke": "llama4-maverick-400b-a17b"}
ENGINE_KW = dict(max_gen=8, max_batch=4, max_wait=1.0, batch_buckets=(1, 2, 4), seq_buckets=(SB,))


def configs_of(name):
    if name in SMOKE:
        return (dataclasses.replace(configs.get_smoke_config(SMOKE[name]), dtype="float32"),
                dataclasses.replace(jconfigs.get_smoke_config(SMOKE[name]), dtype="float32"))
    return ModelConfig(**CONFIGS[name]), JModelConfig(**CONFIGS[name])


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, rel=REL_TOL):
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# split, routing, dispatch
# ---------------------------------------------------------------------------


def test_split_known_answer():
    assert prng.split(PRNGKey(0), 4).tolist() == [
        [1797259609, 2579123966], [928981903, 3453687069], [4146024105, 2718843009],
        [2467461003, 3840466878]]


@pytest.mark.parametrize("num", [1, 3, 16, 128])
def test_split_matches_jax(num):
    for key in (jax.random.PRNGKey(0), jax.random.PRNGKey(2**31 + 5),
                jax.random.fold_in(jax.random.PRNGKey(7), 12345)):
        np.testing.assert_array_equal(prng.split(np.asarray(key), num),
                                      np.asarray(jax.random.split(key, num)))


def test_topk_weights_normalized_and_match_reference():
    logits = np.random.default_rng(3).standard_normal((4, 16, 8)).astype(np.float32)
    for k in (1, 2, 3):
        gates, ids = moe.router_topk(_t(logits), k)
        jg, jids = jmoe.router_topk(jnp.asarray(logits), k)
        np.testing.assert_array_equal(_np(ids), np.asarray(jids))
        np.testing.assert_allclose(_np(gates), np.asarray(jg), rtol=1e-6)
        if k > 1:
            np.testing.assert_allclose(_np(gates.sum(-1)), 1.0, rtol=1e-5)


@pytest.mark.parametrize("n_experts", [8, 128])
def test_topk_ties_go_to_the_lower_index(n_experts):
    """Router logits leave an analog site in bf16, so equal probabilities
    are common: the lowest expert index first, as ``jax.lax.top_k``."""
    rng = np.random.default_rng(4)
    logits = rng.integers(-2, 3, (64, n_experts)).astype(np.float32)  # many ties
    logits[0] = 1.0  # every expert tied
    for k in (1, 2, 4):
        _, ids = moe.router_topk(_t(logits), k)
        _, jids = jmoe.router_topk(jnp.asarray(logits), k)
        np.testing.assert_array_equal(_np(ids), np.asarray(jids))
        assert _np(ids)[0].tolist() == list(range(k))


def _routes(g=2, s=64, e=4, k=2, seed=3):
    logits = np.random.default_rng(seed).standard_normal((g, s, e)).astype(np.float32)
    return logits, moe.router_topk(_t(logits), k), jmoe.router_topk(jnp.asarray(logits), k)


@pytest.mark.parametrize("capacity", [3, 8, 128])
@pytest.mark.parametrize("with_valid", [False, True])
def test_make_dispatch_matches_reference(capacity, with_valid):
    """Capacity drops (positions past the capacity are zero rows), earlier
    slots first, and pad tokens out of the queues."""
    _, (gates, ids), (jg, jids) = _routes()
    valid = np.random.default_rng(5).random((2, 64)) > 0.3 if with_valid else None
    d, c = moe.make_dispatch(ids, gates, 4, capacity, None if valid is None else _t(valid))
    jd, jc = jmoe.make_dispatch(jids, jg, 4, capacity, None if valid is None else jnp.asarray(valid))
    np.testing.assert_array_equal(_np(d), np.asarray(jd))
    np.testing.assert_allclose(_np(c), np.asarray(jc), rtol=1e-6)
    if valid is not None:
        assert float(_np(d)[~valid].sum()) == 0.0


def test_dispatch_capacity_respected():
    _, (gates, ids), _ = _routes()
    dispatch, combine = moe.make_dispatch(ids, gates, 4, 8)
    assert float(dispatch.sum(dim=1).max()) <= 1.0  # each (expert, slot) holds one token
    assert float(dispatch.sum(dim=(2, 3)).max()) <= 2  # each token at most k slots
    assert float(combine.sum(dim=(2, 3)).max()) <= 1.0 + 1e-5


def test_high_capacity_drops_nothing():
    _, (gates, ids), _ = _routes(g=1, s=32)
    dispatch, _ = moe.make_dispatch(ids, gates, 4, capacity=64)
    np.testing.assert_allclose(_np(dispatch.sum(dim=(2, 3))), 2.0)


def _block_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    p = lm.map_leaves(lambda _p, l: (rng.standard_normal(l.shape) * (l.scale or 0.1)).astype(
        np.float32), lm._moe_leaves(cfg, ()))
    return p, lm.map_leaves(lambda _p, a: _t(a), p), jax.tree.map(jnp.asarray, p)


def _moe_cfg(**kw):
    base = dict(name="m", family="moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
                d_ff=64, vocab_size=64, n_experts=4, top_k=2, moe_every=1, capacity_factor=8.0,
                moe_group_size=64, attn_q_chunk=16, attn_kv_chunk=16, dtype="float32")
    base.update(kw)
    return ModelConfig(**base), JModelConfig(**base)


def test_moe_block_matches_dense_reference():
    """With capacity that drops nothing, the dispatch and combine equal
    every expert computed and mixed by its gate weight."""
    cfg, _ = _moe_cfg()
    _, p, _ = _block_params(cfg)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 16, 32)).astype(np.float32))
    got = moe.moe_block(x, p, cfg, MatmulHook())
    gates, ids = moe.router_topk(torch.matmul(x, p["router"]), 2)
    h = torch.nn.functional.silu(torch.einsum("btd,edf->ebtf", x, p["w_gate"])) * \
        torch.einsum("btd,edf->ebtf", x, p["w_up"])
    ye = torch.einsum("ebtf,efd->ebtd", h, p["w_down"])
    w = torch.einsum("btke,btk->ebt", torch.nn.functional.one_hot(ids, 4).float(), gates)
    torch.testing.assert_close(got, torch.einsum("ebtd,ebt->btd", ye, w), atol=2e-4, rtol=0)


@pytest.mark.parametrize("kw", [dict(), dict(moe_ff_split=2), dict(n_shared_experts=1),
                                dict(capacity_factor=1.0, top_k=1), dict(mlp_type="gelu")],
                         ids=["plain", "split", "shared", "drops", "gelu"])
def test_moe_block_matches_reference(kw):
    """The block against the reference's, with pad tokens, capacity drops,
    virtual experts, shared experts and the GELU experts."""
    cfg, jcfg = _moe_cfg(**{"capacity_factor": 1.25, **kw})
    _, p, jp = _block_params(cfg)
    x = np.random.default_rng(6).standard_normal((3, 12, 32)).astype(np.float32)
    mask = np.arange(12)[None, :] >= np.asarray([12, 5, 0])[:, None]
    got = moe.moe_block(_t(x), p, cfg, MatmulHook(), pad_mask=_t(mask))
    want = jmoe.moe_block(jnp.asarray(x), jp, jcfg, jhooks.MatmulHook(), pad_mask=jnp.asarray(mask))
    _close(got[~_t(mask)], np.asarray(want)[~mask])
    assert float(got[~_t(mask)].abs().max()) > 0


def test_virtual_expert_split_equivalence():
    """moe_ff_split=2 with the experts' FF halves as the virtual experts
    gives the unsplit model's logits (the reference test, on the port)."""
    cfg1, _ = _moe_cfg(capacity_factor=8.0)
    cfg2 = dataclasses.replace(cfg1, moe_ff_split=2)
    rng = np.random.default_rng(0)
    tree = lm.map_leaves(lambda _p, l: (rng.standard_normal(l.shape) * (l.scale or 0.1)).astype(
        np.float32), lm.param_leaves(cfg1))
    m = tree["blocks"]["moe"]
    g, e, d, ff = m["w_gate"].shape
    split_ff = lambda w: np.moveaxis(w.reshape(g, e, d, 2, ff // 2), 3, 2).reshape(g, 2 * e, d, ff // 2)
    tree2 = dict(tree, blocks=dict(tree["blocks"], moe=dict(
        m, w_gate=split_ff(m["w_gate"]), w_up=split_ff(m["w_up"]),
        w_down=m["w_down"].reshape(g, 2 * e, ff // 2, d))))
    toks = torch.from_numpy(rng.integers(0, 64, (2, 32)))
    h1 = lm.hidden(bridge.params_from_numpy(tree, cfg1, "cpu"), toks, cfg1)
    h2 = lm.hidden(bridge.params_from_numpy(tree2, cfg2, "cpu"), toks, cfg2)
    torch.testing.assert_close(h1, h2, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

_weights = {}


def weights(name):
    if name not in _weights:
        cfg, jcfg = configs_of(name)
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
    lengths = np.asarray([5, t, 9, 0], np.int32)
    toks = np.zeros((4, t), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(0, vocab, n)
    return toks, lengths


def _keys(pad_seed=0):
    return jnp.stack([jax.random.fold_in(jax.random.PRNGKey(5), u) for u in range(3)]
                     + [jax.random.PRNGKey(pad_seed)])


def _spec(energies, key, k):
    return None if k is None else jlm.AnalogSpec(
        cfg=JAnalogConfig.shot(backend="tile"), energies=energies, key=key, n_repeats=k)


@functools.partial(jax.jit, static_argnames=("cfg", "k", "cache_len"))
def _jprefill(params, toks, lengths, energies, key, *, cfg, k, cache_len):
    cache, h = jlm.prefill(params, {"tokens": toks}, cfg, analog=_spec(energies, key, k),
                           cache_len=cache_len, lengths=lengths)
    return cache, jlm.logits_last(params, h, cfg)


@functools.partial(jax.jit, static_argnames=("cfg", "k"))
def _jdecode(params, cache, tok, pos, lengths, energies, key, *, cfg, k):
    return jlm.decode_step(params, cache, {"tokens": tok}, pos, cfg,
                           analog=_spec(energies, key, k), lengths=lengths)


@pytest.mark.parametrize("name,mode", [(n, m) for n in NAMES for m in ("digital", "analog-K1")]
                         + [("moe", "analog-K4")])
def test_prefill_and_decode_match_reference(name, mode):
    """A padded bucket (a batch-padding row among them) and three per-row
    decode steps with the rows' lengths: logits and the KV caches of the
    real rows, greedy tokens exact."""
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
    for leaf, jleaf in zip(leaves(cache), jax.tree.leaves(jcache)):
        _close(leaf[:, :, :3], np.asarray(jleaf)[:, :, :3])
    tok = np.asarray(jnp.argmax(jlogits[:, 0, 0], axis=-1)).astype(np.int32)
    np.testing.assert_array_equal(_np(torch.argmax(logits[:3, 0, 0], -1)), tok[:3])
    for step in range(3):
        pos = lengths + step
        jlogits, jcache = _jdecode(w["jparams"], jcache, jnp.asarray(tok)[:, None], jnp.asarray(pos),
                                   jnp.asarray(lengths), w["jenergies"],
                                   jax.vmap(jax.random.fold_in)(keys, jnp.asarray(pos)), cfg=jcfg,
                                   k=k)
        step_spec = spec and dataclasses.replace(spec, key=fold_key(np.asarray(keys), pos))
        logits, _ = lm.decode_step(w["params"], cache, torch.from_numpy(tok)[:, None],
                                   torch.from_numpy(pos), cfg, analog=step_spec,
                                   lengths=torch.from_numpy(lengths))
        _close(logits[:3], jlogits[:3])
        tok = np.asarray(jnp.argmax(jlogits[:, 0, 0], axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(_np(torch.argmax(logits[:3, 0, 0], -1)), tok[:3])


@pytest.mark.parametrize("name", ["grok-smoke", "llama4-smoke"])
def test_decode_matches_full_forward(name):
    """``tests/test_decode.py`` for the grok-1 and llama4 smoke configs at
    a capacity factor that drops nothing: prefill of T then a decode step
    equals the cache-free forward over T + 1 (port), and the reference's."""
    w = weights(name)
    cfg = dataclasses.replace(w["cfg"], capacity_factor=float(w["cfg"].n_experts))
    jcfg = dataclasses.replace(w["jcfg"], capacity_factor=float(w["cfg"].n_experts))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 33)).astype(np.int64)
    full = lm.logits_last(w["params"], lm.hidden(w["params"], torch.from_numpy(toks), cfg)[:, -1:], cfg)
    cache, _ = lm.prefill(w["params"], torch.from_numpy(toks[:, :32]), cfg, cache_len=33)
    dec, _ = lm.decode_step(w["params"], cache, torch.from_numpy(toks[:, 32:]), torch.tensor([32]),
                            cfg)
    assert float((full - dec).abs().max()) < 3e-2 * float(full.abs().max()) + 1e-3
    jh, _ = jlm.forward_hidden(w["jparams"], {"tokens": jnp.asarray(toks)}, jcfg, mode="train")
    _close(full, jlm.logits_last(w["jparams"], jh[:, -1:], jcfg))


@pytest.mark.parametrize("stacked", [False, True])
def test_expert_seed_words_match_reference_chain(stacked, monkeypatch):
    """The expert sites' keys: the reference's ``collapse_keys(fold_key(key,
    g), valid)`` -> ``site_key`` -> ``split(.., E * split)``, bit for bit,
    with the batch-padding row folded out."""
    name = "grok-smoke"
    w = weights(name)
    cfg = dataclasses.replace(w["cfg"], moe_ff_split=2)
    n_e = cfg.n_experts * 2
    calls = []
    real = lm.hook_for_layer
    monkeypatch.setattr(lm, "hook_for_layer", lambda *a, **kw: calls.append(kw["expert_seeds"])
                        or real(*a, **kw))
    jkey = _keys() if stacked else jax.random.PRNGKey(9)
    lengths = np.asarray([5, 16, 9, 0])
    energies = lm.init_energy_tree(cfg, 20.0, "cpu")
    params = bridge.params_from_numpy(lm.map_leaves(
        lambda _p, l: np.zeros(l.shape, np.float32), lm.param_leaves(cfg)), cfg, "cpu")
    spec = lm.AnalogSpec(cfg=AnalogConfig.shot(), energies=energies, key=np.asarray(jkey))
    lm.prefill(params, torch.zeros((4, 16), dtype=torch.long), cfg, analog=spec,
               lengths=torch.from_numpy(lengths))
    assert len(calls) == lm.group_structure(cfg)[0]
    valid = jnp.asarray(lengths > 0)
    for gi, seeds in enumerate(calls):
        jh = jhooks.hook_for_layer(JAnalogConfig.shot(), {}, jkey, gi, valid=valid)
        assert list(seeds) == ["moe_gate", "moe_up", "moe_down"] == lm.expert_sites(cfg)
        for site, words in seeds.items():
            want = jax.random.split(janalog.site_key(janalog.collapse_keys(jh.key, jh.valid), site),
                                    n_e)
            assert words.shape == (n_e, 4)
            np.testing.assert_array_equal(_np(words).view(np.uint32)[:, :2], np.asarray(want))


def test_pad_rows_do_not_change_expert_noise():
    """``tests/test_serving.py``'s pad-row regression: two real requests in
    a bucket with two batch-padding rows; the padding rows' keys must not
    change the real rows' tokens, prefill and decode."""
    w = weights("moe")
    cfg, energies = w["cfg"], w["energies"]
    rng = np.random.default_rng(1)
    toks = np.zeros((4, 16), np.int64)
    for i, n in enumerate((5, 9)):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    lengths = np.asarray([5, 9, 0, 0])

    def run(pad_seed):
        keys = np.stack([fold_in(PRNGKey(0), i) for i in range(2)] + [PRNGKey(pad_seed)] * 2)
        spec = lm.AnalogSpec(cfg=AnalogConfig.shot(), energies=energies, key=keys)
        cache, h = lm.prefill(w["params"], torch.from_numpy(toks), cfg, analog=spec, cache_len=20,
                              lengths=torch.from_numpy(lengths))
        tok = torch.argmax(lm.logits_last(w["params"], h, cfg)[:, 0, 0], -1)
        out = [tok]
        for t in range(3):
            pos = lengths + t
            logits, cache = lm.decode_step(
                w["params"], cache, tok[:, None], torch.from_numpy(pos), cfg,
                analog=dataclasses.replace(spec, key=fold_key(keys, pos)),
                lengths=torch.from_numpy(lengths))
            tok = torch.argmax(logits[:, 0, 0], -1)
            out.append(tok)
        return torch.stack(out, 1)

    assert torch.equal(run(0)[:2], run(12345)[:2])


def test_pad_count_does_not_change_tokens_without_drops():
    """The same two requests in a bucket of 2 and of 4 rows (capacity that
    drops nothing): equal tokens, prefill and decode. The padding rows
    take no capacity and fold out of the expert key, and the combine adds
    a token's experts in a fixed order whatever the group's size."""
    w = weights("moe")
    cfg = w["cfg"]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (7, 12)]

    def run(bb):
        toks = np.zeros((bb, 16), np.int64)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        lengths = np.asarray([7, 12] + [0] * (bb - 2))
        keys = np.stack([fold_in(PRNGKey(0), i) for i in range(2)] + [PRNGKey(0)] * (bb - 2))
        spec = lm.AnalogSpec(cfg=AnalogConfig.shot(), energies=w["energies"], key=keys)
        cache, h = lm.prefill(w["params"], torch.from_numpy(toks), cfg, analog=spec, cache_len=20,
                              lengths=torch.from_numpy(lengths))
        logits = lm.logits_last(w["params"], h, cfg)[:2]
        tok = torch.argmax(logits[:, 0, 0], -1)
        out = [logits]
        for t in range(3):
            pos = lengths + t
            full = torch.cat([tok, torch.zeros(bb - 2, dtype=tok.dtype)])
            step, cache = lm.decode_step(
                w["params"], cache, full[:, None], torch.from_numpy(pos), cfg,
                analog=dataclasses.replace(spec, key=fold_key(keys, pos)),
                lengths=torch.from_numpy(lengths))
            out.append(step[:2])
            tok = torch.argmax(step[:2, 0, 0], -1)
        return out

    for a, b in zip(run(2), run(4)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def _requests(vocab, n=3, lens=(7, 19, 28), gens=(2, 5, 8), seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n_).astype(np.int32) for n_ in lens[:n]], list(gens[:n])


@pytest.mark.parametrize("name,analog", [("moe", False), ("moe", True), ("llama4-smoke", True)])
def test_engine_tokens_equal_reference_engine(name, analog):
    w = weights(name)
    prompts, gens = _requests(w["cfg"].vocab_size)
    jextra = dict(analog_cfg=JAnalogConfig.shot(backend="tile"), energies=w["jenergies"]) \
        if analog else {}
    extra = dict(analog_cfg=AnalogConfig.shot(), energies=w["energies"]) if analog else {}
    jeng = JServingEngine(w["jparams"], w["jcfg"], **jextra, **ENGINE_KW)
    eng = ServingEngine(w["params"], w["cfg"], **extra, **ENGINE_KW, device="cpu")
    for p, g in zip(prompts, gens):
        assert jeng.submit(p, max_new_tokens=g, now=0.0) == eng.submit(p, max_new_tokens=g, now=0.0)
    want, got = jeng.flush(), eng.flush()
    assert sorted(want) == sorted(got)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]))
    for stat in ("requests", "batches", "tokens_generated", "padded_rows", "decode_steps"):
        assert eng.stats[stat] == jeng.stats[stat], stat


def test_family_solo_vs_batched_equivalence():
    """``tests/test_serving.py``'s length-aware contract for moe (digital,
    no drops): each request in a padded 4-row bucket gives its unpadded
    batch-1 run."""
    w = weights("moe")
    cfg, params = w["cfg"], w["params"]
    prompts, _ = _requests(cfg.vocab_size)
    eng = ServingEngine(params, cfg, **ENGINE_KW, device="cpu")
    uids = [eng.submit(p, max_new_tokens=4, now=0.0) for p in prompts]
    batched = eng.flush()
    assert eng.stats["padded_rows"] == 1
    for uid, p in zip(uids, prompts):
        cache, h = lm.prefill(params, torch.from_numpy(p[None].astype(np.int64)), cfg,
                              cache_len=len(p) + 4)
        tok = torch.argmax(lm.logits_last(params, h, cfg)[:, 0, 0], -1)
        solo = [int(tok[0])]
        for t in range(3):
            logits, cache = lm.decode_step(params, cache, tok[:, None], torch.tensor([len(p) + t]),
                                           cfg)
            tok = torch.argmax(logits[:, 0, 0], -1)
            solo.append(int(tok[0]))
        np.testing.assert_array_equal(batched[uid], solo)


def test_moe_continuous_rejected():
    w = weights("moe")
    with pytest.raises(ValueError, match="moe"):
        ServingEngine(w["params"], w["cfg"], continuous=True, device="cpu")


def test_stacked_noise_samples_route_each_sample_alone():
    """Calibration's S noise samples stacked over a batch (``probe_apply``
    with an (S, 2) key): each sample's tokens are routed, and its experts
    keyed, as that batch alone under its key, bit for bit."""
    w = weights("grok-smoke")
    eng = ServingEngine(w["params"], w["cfg"], analog_cfg=AnalogConfig.shot(),
                        energies=w["energies"], device="cpu")
    probe = eng.probe_apply()
    toks = np.random.default_rng(6).integers(0, w["cfg"].vocab_size, (2, 16))
    keys = np.stack([fold_in(PRNGKey(8), s) for s in range(3)])
    stacked = probe(w["energies"], np.broadcast_to(toks, (3, 2, 16)), keys)
    for s in range(3):
        torch.testing.assert_close(stacked[s], probe(w["energies"], toks, keys[s]), rtol=0, atol=0)
    assert not torch.equal(stacked[0], stacked[1])


def test_same_batch_twice_equal_bits():
    """MoE is reproducible per batch: the same batch served twice gives the
    same tokens (analog, K = 2)."""
    w = weights("llama4-smoke")
    prompts, gens = _requests(w["cfg"].vocab_size)
    runs = []
    for _ in range(2):
        eng = ServingEngine(w["params"], w["cfg"], analog_cfg=AnalogConfig.shot(),
                            energies=w["energies"], **ENGINE_KW, device="cpu")
        for p, g in zip(prompts, gens):
            eng.submit(p, n_repeats=2, max_new_tokens=g, now=0.0)
        runs.append(eng.flush())
    for uid in runs[0]:
        np.testing.assert_array_equal(runs[0][uid], runs[1][uid])


# ---------------------------------------------------------------------------
# profiles, energy, configs
# ---------------------------------------------------------------------------

_PROFILE_CFG = dict(name="prof-moe", family="moe", d_ff=64, n_experts=4, top_k=2, moe_every=2,
                    capacity_factor=2.0, moe_group_size=64, **_BASE)


@functools.partial(jax.jit, static_argnames=("cfg", "profile"))
def _jprofile_prefill(params, toks, lengths, energies, key, *, cfg, profile):
    spec = jlm.AnalogSpec(cfg=JAnalogConfig.shot(backend="tile"), energies=energies, key=key,
                          profile=profile)
    _, h = jlm.prefill(params, {"tokens": toks}, cfg, analog=spec, cache_len=20, lengths=lengths)
    return jlm.logits_last(params, h, cfg)


def test_profile_prefill_matches_reference(monkeypatch):
    """``tests/test_profiles.py``'s MoE case ((attn + mlp, attn + moe) at
    K = (2, 1)): the reference's profile forward, and serving at K_l is
    serving at K = 1 with the energies scaled by K_l, call by call (router,
    expert and shared sites)."""
    cfg, jcfg = ModelConfig(**_PROFILE_CFG), JModelConfig(**_PROFILE_CFG)
    rng = np.random.default_rng(0)
    tree = lm.map_leaves(lambda _p, l: (rng.standard_normal(l.shape) * (l.scale or 0.1)).astype(
        np.float32), lm.param_leaves(cfg))
    params = bridge.params_from_numpy(tree, cfg, "cpu")
    jenergies = jlm.init_energy_tree(jcfg, 20.0)
    energies = bridge.energies_from_numpy(jax.tree.map(np.asarray, jenergies), cfg, "cpu")
    reps = (2, 1)
    toks, lengths = _batch(cfg.vocab_size)
    want = _jprofile_prefill(jax.tree.map(jnp.asarray, tree), jnp.asarray(toks), jnp.asarray(lengths),
                             jenergies, _keys(), cfg=jcfg,
                             profile=jprofile.PrecisionProfile(reps, name="p"))
    calls = []
    real = hooks.analog_dot

    def spy(x, w_, *, energy, seed, n_repeats, **kw):
        calls.append((energy, seed, n_repeats))
        return real(x, w_, energy=energy, seed=seed, n_repeats=n_repeats, **kw)

    monkeypatch.setattr(hooks, "analog_dot", spy)
    profile = PrecisionProfile(reps, name="p")

    def run(**kw):
        spec = lm.AnalogSpec(cfg=AnalogConfig.shot(), key=np.asarray(_keys()), **kw)
        _, h = lm.prefill(params, torch.from_numpy(toks), cfg, analog=spec, cache_len=20,
                          lengths=torch.from_numpy(lengths))
        return lm.logits_last(params, h, cfg)

    _close(run(energies=energies, profile=profile)[:3], np.asarray(want)[:3])
    prof_calls, calls[:] = list(calls), []
    run(energies=energy.apply_repeats(energies, lm.profile_repeat_tree(cfg, profile)))
    assert len(prof_calls) == len(calls) == 4 + 3 + 4 + 1 + 3 * 4
    assert [k for _, _, k in prof_calls] == [2] * 7 + [1] * 17
    for (e_p, s_p, k), (e_s, s_s, _) in zip(prof_calls, calls):
        assert torch.equal(s_p, s_s)
        assert torch.equal(e_p * torch.tensor(float(k)), e_s)


def test_families_and_every_config_load():
    """Every config of the reference loads, field for field, with its
    counts; the smoke configs of the three families' new configs too."""
    assert set(FAMILIES) == {"dense", "griffin", "xlstm", "moe"}
    assert list(configs.ARCHS) == list(jconfigs.ARCHS)
    pairs = [(configs.get_config(a), jconfigs.get_config(a))
             for a in list(configs.ARCHS) + list(configs.EXTRA_ARCHS)]
    pairs += [(configs.get_smoke_config(a), jconfigs.get_smoke_config(a))
              for a in ("xlstm-1.3b", *SMOKE.values())]
    assert len(pairs) == 14
    for cfg, jcfg in pairs:
        for f in dataclasses.fields(ModelConfig):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), (cfg.name, f.name)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert cfg.sub_quadratic == jcfg.sub_quadratic


@pytest.mark.parametrize("arch", ["grok-1-314b", "llama4-maverick-400b-a17b", "grok-smoke",
                                  "llama4-smoke", "moe"])
def test_leaves_sites_and_energies_match_reference(arch):
    cfg, jcfg = (configs.get_config(arch), jconfigs.get_config(arch)) if arch in configs.ARCHS \
        else configs_of(arch)
    got = lm.map_leaves(lambda _p, leaf: (leaf.shape, leaf.scale), lm.param_leaves(cfg))
    want = jax.tree.map(lambda leaf: (tuple(leaf.shape), leaf.scale), jlm.param_leaves(jcfg),
                        is_leaf=lambda x: isinstance(x, jlm.Leaf))
    assert got == want
    assert lm.group_structure(cfg) == jlm.group_structure(jcfg)
    assert lm.group_sites(cfg) == jlm.group_sites(jcfg)
    assert lm.group_site_subs(cfg) == jlm.group_site_subs(jcfg)
    for t in (1, 64):
        for a, b in zip(leaves(lm.energy_macs(cfg, t)), jax.tree.leaves(jlm.energy_macs(jcfg, t))):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=ENERGY_REL)
    n = cfg.n_layers
    for reps in ((1,) * n, (4,) * n, tuple(1 + (i * 7) % 4 for i in range(n))):
        p, jp = PrecisionProfile(reps, name="p"), jprofile.PrecisionProfile(reps, name="p")
        e = lm.init_energy_tree(cfg, 20.0, "cpu")
        np.testing.assert_allclose(
            lm.profile_token_energy(cfg, e, p),
            jlm.profile_token_energy(jcfg, jlm.init_energy_tree(jcfg, 20.0), jp), rtol=ENERGY_REL)


def test_bridge_checks_expert_energy_shapes():
    w = weights("llama4-smoke")
    jenergies = jax.tree.map(np.asarray, w["jenergies"])
    assert tuple(w["energies"]["groups"]["moe_gate"].shape) == (2, 4)
    bad = dict(jenergies, groups=dict(jenergies["groups"], moe_up=jenergies["groups"]["moe_up"][:, :2]))
    with pytest.raises(ValueError, match="moe_up"):
        bridge.energies_from_numpy(bad, w["cfg"], "cpu")


@pytest.mark.parametrize("kw", [dict(n_experts=0), dict(top_k=5), dict(moe_every=3),
                                dict(moe_ff_split=3), dict(mlp_type="gelu", n_shared_experts=1)])
def test_moe_config_rules(kw):
    base = dict(name="x", family="moe", n_layers=4, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
                vocab_size=64, n_experts=4, top_k=2)
    ModelConfig(**base)
    with pytest.raises(ValueError):
        ModelConfig(**{**base, **kw})
