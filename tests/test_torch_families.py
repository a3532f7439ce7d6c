"""Port vs reference: serving the griffin and windowed dense families —
engines, continuous pools, per-layer profiles and energy with griffin's
tail layers.

The configs are the reference serving tests' (``tests/test_serving.py``
FAMILY_CONFIGS: griffin of 3 layers and windowed dense, window 8, so a
32-token bucket wraps the ring) and the reference's ``rgemma-smoke`` (2
groups and 2 tail layers), at float32 from the same numpy weights; the
reference runs on backend "tile", the port's plain path on the CPU.
Engine tokens equal the reference's; inside the port solo == batched and
pooled == sync == solo hold bit for bit at one seq bucket; energies match
at rel 1e-6.
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
from repro.core import energy as jenergy  # noqa: E402
from repro.core import profile as jprofile  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.recurrentgemma_2b import CONFIG as RGEMMA  # noqa: E402
from repro_torch.configs.recurrentgemma_2b import smoke_config as rgemma_smoke  # noqa: E402
from repro_torch.core import energy  # noqa: E402
from repro_torch.core.analog import AnalogConfig, fold_key  # noqa: E402
from repro_torch.core.profile import PrecisionProfile  # noqa: E402
from repro_torch.kernels.prng import PRNGKey, fold_in  # noqa: E402
from repro_torch.models import hooks, lm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ENERGY_REL = 1e-6
LOGIT_REL = 1e-4
SB = 32  # one seq bucket: pooled and batch-synchronous caches have one length
_TINY = dict(n_heads=2, n_kv_heads=1, head_dim=16, vocab_size=128, dtype="float32")
CONFIGS = {
    "griffin": dict(name="serve-griffin", family="griffin", n_layers=3, d_model=32, d_ff=64,
                    rnn_width=32, conv_width=4, local_window=8, **_TINY),
    "windowed": dict(name="serve-win", family="dense", n_layers=2, d_model=32, d_ff=64,
                     sliding_window=8, **_TINY),
}
NAMES = ["griffin", "windowed", "rgemma-smoke"]
#: a non-uniform profile per config: K = 2 on the rgemma-smoke tail layers
PROFILES = {"griffin": (2, 1, 2), "windowed": (1, 2), "rgemma-smoke": (1, 2, 1, 1, 1, 2, 2, 2)}
ENGINE_KW = dict(max_gen=8, max_batch=4, max_wait=1.0, batch_buckets=(1, 2, 4), seq_buckets=(SB,))


def configs(name):
    if name == "rgemma-smoke":
        return (dataclasses.replace(rgemma_smoke(), dtype="float32"),
                dataclasses.replace(jrgemma_smoke(), dtype="float32"))
    return ModelConfig(**CONFIGS[name]), JModelConfig(**CONFIGS[name])


_models = {}


def model(name):
    if name not in _models:
        cfg, jcfg = configs(name)
        rng = np.random.default_rng(0)
        tree = lm.map_leaves(
            lambda _p, leaf: (rng.standard_normal(leaf.shape) * (leaf.scale or 0.1)).astype(np.float32),
            lm.param_leaves(cfg),
        )
        jenergies = jlm.init_energy_tree(jcfg, 20.0)
        _models[name] = dict(
            cfg=cfg, jcfg=jcfg, jparams=jax.tree.map(jnp.asarray, tree),
            params=bridge.params_from_numpy(tree, cfg, "cpu"), jenergies=jenergies,
            energies=bridge.energies_from_numpy(jax.tree.map(np.asarray, jenergies), cfg, "cpu"),
        )
    return _models[name]


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel_close(got, want, rel=ENERGY_REL):
    got, want = np.asarray(_np(got), np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rel, atol=0)


def _requests(vocab, n=3, lens=(7, 19, 28), gens=(2, 5, 8), seed=3):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, n_).astype(np.int32) for n_ in lens[:n]]
    keys = [fold_in(PRNGKey(5), i) for i in range(n)]
    return prompts, list(gens[:n]), keys


def _engine(m, *, analog=True, **kw):
    extra = dict(analog_cfg=AnalogConfig.shot(), energies=m["energies"]) if analog else {}
    return ServingEngine(m["params"], m["cfg"], **extra, **{**ENGINE_KW, **kw}, device="cpu")


# ---------------------------------------------------------------------------
# the engines against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,analog", [("griffin", False), ("griffin", True), ("windowed", False),
                                         ("windowed", True), ("rgemma-smoke", False)])
def test_engine_tokens_equal_reference_engine(name, analog):
    m = model(name)
    prompts, gens, _ = _requests(m["cfg"].vocab_size)
    jextra = dict(analog_cfg=JAnalogConfig.shot(backend="tile"), energies=m["jenergies"]) \
        if analog else {}
    jeng = JServingEngine(m["jparams"], m["jcfg"], **jextra, **ENGINE_KW)
    eng = _engine(m, analog=analog)
    for p, g in zip(prompts, gens):
        assert jeng.submit(p, max_new_tokens=g, now=0.0) == eng.submit(p, max_new_tokens=g, now=0.0)
    want, got = jeng.flush(), eng.flush()
    assert sorted(want) == sorted(got)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]))
    for stat in ("requests", "batches", "tokens_generated", "padded_rows", "decode_steps"):
        assert eng.stats[stat] == jeng.stats[stat], stat


def test_continuous_tokens_equal_reference_engine():
    """griffin through 2-slot pools (the third request admitted into a
    retired slot mid-flight): the reference continuous engine's tokens."""
    m = model("griffin")
    prompts, gens, _ = _requests(m["cfg"].vocab_size)
    jeng = JServingEngine(m["jparams"], m["jcfg"], **ENGINE_KW, continuous=True, pool_slots=2)
    eng = _engine(m, analog=False, continuous=True, pool_slots=2)
    for p, g in zip(prompts, gens):
        jeng.submit(p, max_new_tokens=g, now=0.0)
        eng.submit(p, max_new_tokens=g, now=0.0)
    want, got = jeng.flush(), eng.flush()
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]))
    for stat in ("decode_steps", "decode_slot_steps", "admitted", "retired"):
        assert eng.stats[stat] == jeng.stats[stat], stat


# ---------------------------------------------------------------------------
# inside the port: solo == batched, pooled == sync == solo
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_solo_equals_batched_bit_exact(name):
    """Three requests in a padded 4-row bucket (K = 2): each one's tokens
    equal its run alone at the same seq bucket."""
    m = model(name)
    prompts, _, keys = _requests(m["cfg"].vocab_size)
    eng = _engine(m)
    uids = [eng.submit(p, n_repeats=2, max_new_tokens=4, key=k, now=0.0)
            for p, k in zip(prompts, keys)]
    batched = eng.flush()
    assert eng.stats["padded_rows"] == 1
    for uid, p, k in zip(uids, prompts, keys):
        solo = eng.submit(p, n_repeats=2, max_new_tokens=4, key=k, now=0.0)
        np.testing.assert_array_equal(eng.flush()[solo], batched[uid])


@pytest.mark.parametrize("name", NAMES)
def test_pooled_equals_sync_equals_solo_bit_exact(name):
    """Three requests through a 2-slot pool give the batch-synchronous
    engine's tokens, and each re-run alone through the same pool gives the
    same bits: the pool's cache tree (rings, recurrent and conv states) is
    the live one, updated in place."""
    m = model(name)
    prompts, gens, keys = _requests(m["cfg"].vocab_size)
    pooled_eng = _engine(m, continuous=True, pool_slots=2)
    uids = [pooled_eng.submit(p, n_repeats=2, max_new_tokens=g, key=k, now=0.0)
            for p, g, k in zip(prompts, gens, keys)]
    pool_cache = None
    pooled = {}
    while pooled_eng.n_in_flight:
        pooled.update(pooled_eng.pump_step(0.0, force=True))
        (pool,) = pooled_eng.pools.values()
        assert pool_cache is None or pool.cache is pool_cache  # never replaced
        pool_cache = pool.cache
    assert pooled_eng.stats["admitted"] == 3 and pooled_eng.stats["retired"] == 3
    sync_eng = _engine(m)
    sync_uids = [sync_eng.submit(p, n_repeats=2, max_new_tokens=g, key=k, now=0.0)
                 for p, g, k in zip(prompts, gens, keys)]
    sync = sync_eng.flush()
    for pu, su, g in zip(uids, sync_uids, gens):
        assert pooled[pu].shape == (g,)
        np.testing.assert_array_equal(pooled[pu], sync[su])
    for pu, p, g, k in zip(uids, prompts, gens, keys):
        solo = pooled_eng.submit(p, n_repeats=2, max_new_tokens=g, key=k, now=0.0)
        np.testing.assert_array_equal(pooled_eng.flush()[solo], pooled[pu])


@pytest.mark.parametrize("name", NAMES)
def test_scatter_cache_rows_matches_reference(name):
    """Every leaf along its own batch dim; ids past the pool are dropped."""
    m = model(name)
    cfg, jcfg = m["cfg"], m["jcfg"]
    slots, bb, cache_len = 4, 3, 12
    dst = lm.init_cache(cfg, slots, cache_len, device="cpu")
    src = lm.init_cache(cfg, bb, cache_len, device="cpu")
    axes = lm.cache_batch_axes(cfg)
    lm.map_leaves(lambda _p, a, ax: [a.select(ax, r).fill_(r + 1) for r in range(bb)], src, axes)
    ids = np.asarray([2, 0, slots])  # the last row aims past the pool: dropped
    jout = jlm.scatter_cache_rows(jcfg, jlm.init_cache(jcfg, slots, cache_len),
                                  jax.tree.map(lambda a: jnp.asarray(a.numpy()), src), jnp.asarray(ids))
    out = lm.scatter_cache_rows(cfg, dst, src, ids)
    assert out is dst
    got = lm.map_leaves(lambda _p, a: a.numpy(), dst)
    assert jax.tree.structure(got) == jax.tree.structure(jout)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jout)):
        np.testing.assert_array_equal(g, np.asarray(w))
    for a, ax in zip(leaves(dst), leaves(axes)):  # request 0 landed in slot 2
        assert bool((a.select(ax, 2) == 1).all()) and bool((a.select(ax, 1) == 0).all())


# ---------------------------------------------------------------------------
# profiles with the tail
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("cfg", "profile"))
def _jprofile_prefill(params, toks, lengths, energies, key, *, cfg, profile):
    spec = jlm.AnalogSpec(cfg=JAnalogConfig.shot(backend="tile"), energies=energies, key=key,
                          profile=profile)
    _, h = jlm.prefill(params, {"tokens": toks}, cfg, analog=spec, cache_len=20, lengths=lengths)
    return jlm.logits_last(params, h, cfg)


def _batch(vocab):
    rng = np.random.default_rng(0)
    lengths = np.asarray([5, 16, 9, 0], np.int32)
    toks = np.zeros((4, 16), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(0, vocab, n)
    return toks, lengths


def _keys():
    return np.asarray(jnp.stack([jax.random.fold_in(jax.random.PRNGKey(5), u) for u in range(3)]
                                + [jax.random.PRNGKey(0)]))


def _port_prefill(m, toks, lengths, **spec_kw):
    spec = lm.AnalogSpec(cfg=AnalogConfig.shot(), energies=spec_kw.pop("energies", m["energies"]),
                         key=_keys(), **spec_kw)
    cache, h = lm.prefill(m["params"], torch.from_numpy(toks), m["cfg"], analog=spec, cache_len=20,
                          lengths=torch.from_numpy(lengths))
    return lm.logits_last(m["params"], h, m["cfg"]), cache


def test_profile_prefill_matches_reference():
    """rgemma-smoke under a profile with K = 2 on both tail layers."""
    m = model("rgemma-smoke")
    reps = PROFILES["rgemma-smoke"]
    toks, lengths = _batch(m["cfg"].vocab_size)
    want = _jprofile_prefill(m["jparams"], jnp.asarray(toks), jnp.asarray(lengths), m["jenergies"],
                             jnp.asarray(_keys()), cfg=m["jcfg"],
                             profile=jprofile.PrecisionProfile(reps, name="p"))
    got, _ = _port_prefill(m, toks, lengths, profile=PrecisionProfile(reps, name="p"))
    want = np.asarray(want[:3], np.float32)
    assert float(np.abs(_np(got[:3]) - want).max()) <= LOGIT_REL * float(np.abs(want).max())


@pytest.mark.parametrize("name", NAMES)
def test_profile_matches_scaled_energy_oracle(name, monkeypatch):
    """Serving layer l at K_l is serving it at K=1 with its energies scaled
    by K_l (``apply_repeats(E, profile_repeat_tree)``), site by site: every
    call of a profile forward, the tail's included, carries the same seed
    as the scaled forward's call at the same place, and ``K_l * E_l`` is
    bit for bit the scaled energy. (On the tile path the outputs differ:
    K streams averaged are not one stream at K times the energy; the
    reference's bit-exact form of this oracle runs on its "jnp" backend,
    which the port does not have.)"""
    m = model(name)
    cfg = m["cfg"]
    profile = PrecisionProfile(PROFILES[name], name="p")
    calls = []
    real = hooks.analog_dot

    def spy(x, w, *, energy, seed, n_repeats, **kw):
        calls.append((energy, seed, n_repeats))
        return real(x, w, energy=energy, seed=seed, n_repeats=n_repeats, **kw)

    monkeypatch.setattr(hooks, "analog_dot", spy)
    toks, lengths = _batch(cfg.vocab_size)
    _port_prefill(m, toks, lengths, profile=profile)
    prof_calls, calls[:] = list(calls), []
    scaled = energy.apply_repeats(m["energies"], lm.profile_repeat_tree(cfg, profile))
    _port_prefill(m, toks, lengths, energies=scaled)
    n_calls = len(lm.group_sites(cfg)) * lm.group_structure(cfg)[0] + \
        len(lm.TAIL_SITES) * lm.n_tail(cfg)
    assert len(prof_calls) == len(calls) == n_calls
    ks = [k for _, _, k in prof_calls]
    assert set(ks) == set(PROFILES[name]) and all(k == 1 for _, _, k in calls)
    for (e_p, s_p, k), (e_s, s_s, _) in zip(prof_calls, calls):
        assert torch.equal(s_p, s_s)
        assert torch.equal(e_p * torch.tensor(float(k)), e_s)
    # each layer's sites run at its K (rgemma-smoke: the last sites are the tail's)
    if name == "rgemma-smoke":
        assert ks[-2 * len(lm.TAIL_SITES):] == [2] * (2 * len(lm.TAIL_SITES))


def test_uniform_profile_is_n_repeats_bit_exact():
    m = model("rgemma-smoke")
    toks, lengths = _batch(m["cfg"].vocab_size)
    want, wcache = _port_prefill(m, toks, lengths, n_repeats=2)
    got, gcache = _port_prefill(m, toks, lengths, profile=PrecisionProfile.uniform(2, 8))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for a, b in zip(leaves(gcache), leaves(wcache)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    tail_only = PrecisionProfile((2,) * 6 + (1, 1), name="t")  # the tail's K reaches it
    other, _ = _port_prefill(m, toks, lengths, profile=tail_only)
    assert not torch.equal(other, want)


@pytest.mark.parametrize("name", NAMES)
def test_profile_solo_equals_batched_bit_exact(name):
    m = model(name)
    profile = PrecisionProfile(PROFILES[name], name="learned")
    eng = _engine(m, profiles=[profile])
    prompts, _, keys = _requests(m["cfg"].vocab_size)
    uids = [eng.submit(p, profile="learned", max_new_tokens=4, key=k, now=0.0)
            for p, k in zip(prompts, keys)]
    batched = eng.flush()
    assert eng.stats["padded_rows"] == 1
    for uid, p, k in zip(uids, prompts, keys):
        solo = eng.submit(p, profile="learned", max_new_tokens=4, key=k, now=0.0)
        np.testing.assert_array_equal(eng.flush()[solo], batched[uid])


# ---------------------------------------------------------------------------
# energy accounting over every layer, the tail's included
# ---------------------------------------------------------------------------

ENERGY_NAMES = NAMES + ["recurrentgemma-2b"]


def _cfgs(name):
    return (RGEMMA, JRGEMMA) if name == "recurrentgemma-2b" else configs(name)


def _trees_close(got, want, rel=ENERGY_REL):
    assert lm.map_leaves(lambda _p, a: None, got) == jax.tree.map(lambda a: None, want)
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        _rel_close(a, b, rel)


@pytest.mark.parametrize("seq_len", [1, 7])
@pytest.mark.parametrize("name", ENERGY_NAMES)
def test_energy_macs_and_tree_match_reference(name, seq_len):
    cfg, jcfg = _cfgs(name)
    _trees_close(lm.energy_macs(cfg, seq_len), jlm.energy_macs(jcfg, seq_len))
    _trees_close(lm.init_energy_tree(cfg, 12.5, "cpu"), jlm.init_energy_tree(jcfg, 12.5))
    _trees_close(energy.total_energy(lm.init_energy_tree(cfg, 3.0, "cpu"), lm.energy_macs(cfg, seq_len)),
                 jenergy.total_energy(jlm.init_energy_tree(jcfg, 3.0), jlm.energy_macs(jcfg, seq_len)))


def _random_energies(cfg, seed=1):
    """A random positive energy tree in both packages (groups and tail)."""
    rng = np.random.default_rng(seed)
    tree = lm.map_leaves(lambda _p, a: rng.uniform(1.0, 50.0, tuple(a.shape)).astype(np.float32),
                         lm.init_energy_tree(cfg, 1.0, "cpu"))
    return (lm.map_leaves(lambda _p, a: torch.from_numpy(np.asarray(a)), tree),
            jax.tree.map(jnp.asarray, tree))


@pytest.mark.parametrize("kind", ["uniform1", "uniform4", "mixed", "tail4"])
@pytest.mark.parametrize("name", ["rgemma-smoke", "recurrentgemma-2b"])
def test_profile_token_energy_matches_reference(name, kind):
    """``sum_l K_l * E_l * MACs_l`` over all layers, the tail's included."""
    cfg, jcfg = _cfgs(name)
    n = cfg.n_layers
    reps = {"uniform1": (1,) * n, "uniform4": (4,) * n,
            "mixed": tuple(1 + (i * 7) % 4 for i in range(n)),
            "tail4": (1,) * (n - 2) + (4, 4)}[kind]
    p, jp = PrecisionProfile(reps, name="p"), jprofile.PrecisionProfile(reps, name="p")
    assert lm.profile_rows(cfg, p) == jlm.profile_rows(jcfg, jp)
    _trees_close(lm.profile_repeat_tree(cfg, p), jlm.profile_repeat_tree(jcfg, jp))
    e, je = _random_energies(cfg)
    _rel_close(lm.profile_token_energy(cfg, e, p), jlm.profile_token_energy(jcfg, je, jp))


def test_tier_energy_per_token_matches_reference():
    m = model("rgemma-smoke")
    reps = PROFILES["rgemma-smoke"]
    jeng = JServingEngine(m["jparams"], m["jcfg"], analog_cfg=JAnalogConfig.shot(backend="tile"),
                          energies=m["jenergies"], profiles=[jprofile.PrecisionProfile(reps, name="p")],
                          **ENGINE_KW)
    eng = _engine(m, profiles=[PrecisionProfile(reps, name="p")])
    for tier in (1, 2, 4, "p"):
        _rel_close(eng.tier_energy_per_token(tier), jeng.tier_energy_per_token(tier))
    e1, ep, e2 = (eng.tier_energy_per_token(t) for t in (1, "p", 2))
    assert e1 < ep < e2


def test_recurrentgemma_prices_200_sites_a_forward():
    """26 layers: 8 groups of 23 sites and 2 tail layers of 8."""
    sites = len(lm.group_sites(RGEMMA)) * lm.group_structure(RGEMMA)[0] + len(lm.TAIL_SITES) * 2
    assert sites == 200
    macs = lm.energy_macs(RGEMMA, 1)
    assert float(sum(float(a.sum()) for a in leaves(macs["tail"]))) == \
        2 * (2 * 2560 * 2560 + 2 * 2560 * 2560 + 2560 * 2560 + 3 * 2560 * 7680)
