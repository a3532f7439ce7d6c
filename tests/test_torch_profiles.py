"""Port vs reference: energy accounting, noise bits, per-layer precision
profiles and profile tiers.

Energy and MAC trees are held to the reference at rel 1e-6 (both sum in
float32, leaf by leaf in the same order). Profile forwards run the port's
plain path on the CPU against the reference on backend "tile" from the
same numpy weights at float32: logits within ``1e-4 * max|logit|``. Inside
the port a uniform profile is the ``n_repeats=K`` forward bit for bit, and
a profile request's tokens are the same bits solo and batched.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs as several processes on the cores (pytest-xdist): torch's
# intra-op threads in each would oversubscribe them (20x slower when six run)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import energy as jenergy  # noqa: E402
from repro.core import precision as jprecision  # noqa: E402
from repro.core import profile as jprofile  # noqa: E402
from repro.configs.granite_3_8b import CONFIG as JGRANITE  # noqa: E402
from repro.configs.granite_3_8b import smoke_config as jsmoke_config  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro.serving.tiers import DigitalTier as JDigitalTier  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.granite_3_8b import CONFIG as GRANITE  # noqa: E402
from repro_torch.configs.granite_3_8b import smoke_config  # noqa: E402
from repro_torch.core import energy, precision  # noqa: E402
from repro_torch.core.analog import AnalogConfig, fold_key  # noqa: E402
from repro_torch.core.profile import DEFAULT_K_LEVELS, PrecisionProfile, coalesce_runs  # noqa: E402
from repro_torch.kernels import analog_matmul as am  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.tiers import DigitalTier  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ENERGY_REL = 1e-6
LOGIT_REL = 1e-4
CFG = dataclasses.replace(smoke_config(), dtype="float32")
JCFG = dataclasses.replace(jsmoke_config(), dtype="float32")
PROFILE = PrecisionProfile((2, 1, 4, 1), name="mixed")  # the 4-layer smoke model
JPROFILE = jprofile.PrecisionProfile((2, 1, 4, 1), name="mixed")
_DENSE = dict(name="serve-dense", family="dense", n_layers=2, d_model=32, n_heads=2,
              n_kv_heads=1, head_dim=16, d_ff=64, vocab_size=128, dtype="float32")
SCFG = ModelConfig(**_DENSE)
JSCFG = JModelConfig(**_DENSE)
ENGINE_KW = dict(max_gen=6, max_wait=1.0, batch_buckets=(1, 2, 4), seq_buckets=(32,), seed=3)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel_close(got, want, rel=ENERGY_REL):
    got, want = np.asarray(_np(got), np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rel, atol=0)


def _trees_close(got, want, rel=ENERGY_REL):
    g, w = leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        _rel_close(a, b, rel)


def _numpy_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return lm.map_leaves(
        lambda _p, leaf: (rng.standard_normal(leaf.shape) * (leaf.scale or 0.1)).astype(np.float32),
        lm.param_leaves(cfg),
    )


def _energy_trees(cfg, seed=1):
    """A random positive energy tree (per layer and site) in both packages."""
    rng = np.random.default_rng(seed)
    tree = {"groups": {s: rng.uniform(1.0, 50.0, cfg.n_layers).astype(np.float32)
                       for s in lm.group_sites(cfg)},
            "lm_head": np.float32(rng.uniform(1.0, 50.0))}
    return (lm.map_leaves(lambda _p, a: torch.from_numpy(np.asarray(a)), tree),
            jax.tree.map(jnp.asarray, tree))


# ---------------------------------------------------------------------------
# core/energy.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq_len", [1, 7])
def test_energy_macs_match_reference(seq_len):
    for cfg, jcfg in ((CFG, JCFG), (GRANITE, JGRANITE)):
        _trees_close(lm.energy_macs(cfg, seq_len), jlm.energy_macs(jcfg, seq_len))
        assert lm.group_site_subs(cfg) == jlm.group_site_subs(jcfg)


def test_energy_functions_match_reference():
    e, je = _energy_trees(CFG)
    macs, jmacs = lm.energy_macs(CFG, 5), jlm.energy_macs(JCFG, 5)
    reps, jreps = lm.profile_repeat_tree(CFG, PROFILE), jlm.profile_repeat_tree(JCFG, JPROFILE)
    _rel_close(energy.total_energy(e, macs), jenergy.total_energy(je, jmacs))
    _rel_close(energy.total_macs(macs), jenergy.total_macs(jmacs))
    _rel_close(energy.avg_energy_per_mac(e, macs), jenergy.avg_energy_per_mac(je, jmacs))
    _trees_close(energy.apply_repeats(e, reps), jenergy.apply_repeats(je, jreps))
    _rel_close(energy.repeat_total_energy(e, macs, reps),
               jenergy.repeat_total_energy(je, jmacs, jreps))
    for got, want in zip(energy.describe(e, macs), jenergy.describe(je, jmacs)):
        _rel_close(got, want)
    for target in (5.0, 25.0, 80.0):  # over, near and under budget
        _rel_close(energy.log_energy_penalty(e, macs, target, 0.3),
                   jenergy.log_energy_penalty(je, jmacs, target, 0.3))
    _trees_close(energy.uniform_log_energies(macs, 12.5), jenergy.uniform_log_energies(jmacs, 12.5))
    for discrete in (False, True):
        log_e = energy.uniform_log_energies(macs, 12.3)
        _trees_close(energy.to_energy(log_e, discrete=discrete, quantum=2.0),
                     jenergy.to_energy(jenergy.uniform_log_energies(jmacs, 12.3),
                                       discrete=discrete, quantum=2.0))
    for per_channel in (False, True):
        _rel_close(energy.dense_site_macs(7, 32, 48, per_channel=per_channel),
                   jenergy.dense_site_macs(7, 32, 48, per_channel=per_channel))
    assert energy.DIGITAL_INT8_AJ_PER_MAC == jenergy.DIGITAL_INT8_AJ_PER_MAC
    assert energy.DIGITAL_BF16_AJ_PER_MAC == jenergy.DIGITAL_BF16_AJ_PER_MAC


@pytest.mark.parametrize("reps", [(1, 1, 1, 1), (4, 4, 4, 4), (2, 1, 4, 1), (8, 1, 1, 2)])
def test_profile_repeat_tree_and_token_energy_match_reference(reps):
    e, je = _energy_trees(CFG, seed=2)
    p, jp = PrecisionProfile(reps, name="p"), jprofile.PrecisionProfile(reps, name="p")
    _trees_close(lm.profile_repeat_tree(CFG, p), jlm.profile_repeat_tree(JCFG, jp))
    assert lm.profile_rows(CFG, p) == jlm.profile_rows(JCFG, jp)
    got, want = lm.profile_token_energy(CFG, e, p), jlm.profile_token_energy(JCFG, je, jp)
    assert isinstance(got, float)
    _rel_close(got, want)


def test_granite_token_energies():
    """granite-3-8b at 20 aJ/MAC: the lm_head's 4.03e9 aJ at K=1 in every
    tier, and sum_l K_l E_l MACs_l over 40 layers of 199.2M MACs each."""
    e = lm.init_energy_tree(GRANITE, 20.0, device="cpu")
    je = jlm.init_energy_tree(JGRANITE, 20.0)
    edge = (4,) * 4 + (1,) * 32 + (4,) * 4
    for reps in ((1,) * 40, (4,) * 40, edge):
        got = lm.profile_token_energy(GRANITE, e, PrecisionProfile(reps, name="p"))
        _rel_close(got, jlm.profile_token_energy(JGRANITE, je, jprofile.PrecisionProfile(reps, name="p")))
        layer_macs = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 3 * 4096 * 12800
        _rel_close(got, 20.0 * (layer_macs * sum(reps) + 4096 * 49155))


# ---------------------------------------------------------------------------
# core/precision.py
# ---------------------------------------------------------------------------


def test_precision_functions_match_reference():
    rng = np.random.default_rng(4)
    rng_, var, bits = (rng.uniform(0.5, 8.0, 16).astype(np.float32),
                       rng.uniform(1e-6, 1e-1, 16).astype(np.float32),
                       rng.uniform(1.0, 12.0, 16).astype(np.float32))
    t = torch.from_numpy
    _rel_close(precision.noise_bits(t(rng_), t(var)), jprecision.noise_bits(rng_, var))
    _rel_close(precision.noise_var_from_bits(t(rng_), t(bits)),
               jprecision.noise_var_from_bits(rng_, bits))
    _rel_close(precision.thermal_noise_bits(t(rng_), 4096.0, 0.4, t(var), 0.01, t(bits)),
               jprecision.thermal_noise_bits(rng_, 4096.0, 0.4, var, 0.01, bits))
    _rel_close(precision.snr_noise_bits(t(bits)), jprecision.snr_noise_bits(bits))
    clean = rng.standard_normal((8, 12)).astype(np.float32)
    noisy = clean + 0.1 * rng.standard_normal((8, 12)).astype(np.float32)
    _rel_close(precision.empirical_noise_var(t(clean), t(noisy)),
               jprecision.empirical_noise_var(jnp.asarray(clean), jnp.asarray(noisy)))
    per_bits = {"a": bits[:4], "b": 6.0, "c": bits[4:6]}
    per_macs = {"a": var[:4] * 1e6, "b": 3e4, "c": var[4:6] * 1e5}
    tb = {k: torch.as_tensor(v) for k, v in per_bits.items()}
    tm = {k: torch.as_tensor(v) for k, v in per_macs.items()}
    _rel_close(precision.average_bits(tb), jprecision.average_bits(per_bits))
    _rel_close(precision.average_bits(tb, tm, weighted=True),
               jprecision.average_bits(per_bits, per_macs, weighted=True))
    with pytest.raises(ValueError, match="per_layer_macs"):
        precision.average_bits(tb, weighted=True)


# ---------------------------------------------------------------------------
# core/profile.py
# ---------------------------------------------------------------------------


def test_profile_validation_and_uniform_mirror_reference():
    for cls in (PrecisionProfile, jprofile.PrecisionProfile):
        p = cls((2, 1, 4), name="p")
        assert (p.n_layers, p.max_k, p.is_uniform) == (3, 4, False)
        u = cls.uniform(2, 3)
        assert u.is_uniform and u.repeats == (2, 2, 2) and u.name == "uniform-2"
        with pytest.raises(ValueError, match=">= 1"):
            cls((1, 0), name="bad")
        with pytest.raises(ValueError, match="at least one"):
            cls((), name="empty")
        with pytest.raises(ValueError, match="name"):
            cls((1,), name="")
    assert DEFAULT_K_LEVELS == jprofile.DEFAULT_K_LEVELS


@pytest.mark.parametrize("reps,coalesce", [((4, 4, 4), True), ((2, 1), True), ((2, 1), False),
                                           ((3, 3), False), ((1, 2, 2, 8), True)])
def test_profile_cache_key_matches_reference(reps, coalesce):
    got = PrecisionProfile(reps, name="p", coalesce=coalesce).cache_key()
    assert got == jprofile.PrecisionProfile(reps, name="p", coalesce=coalesce).cache_key()
    assert got == PrecisionProfile(reps, name="other", coalesce=coalesce).cache_key()


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_profile_json_round_trips_across_packages(tmp_path, direction):
    fields = dict(repeats=(4, 2, 1, 1), name="resnet-ish", accuracy=0.93)
    path = str(tmp_path / "profile.json")
    if direction == "port_to_reference":
        src, dst = PrecisionProfile(**fields), jprofile.PrecisionProfile
    else:
        src, dst = jprofile.PrecisionProfile(**fields), PrecisionProfile
    src.save(path)
    got = dst.load(path)
    assert (got.repeats, got.name, got.accuracy, got.coalesce) == (
        src.repeats, src.name, src.accuracy, src.coalesce)
    assert got.to_json() == src.to_json() == json.load(open(path))
    assert type(src).from_json(got.to_json()) == src


@pytest.mark.parametrize("rows", [[(2,), (2,), (1,), (1,), (2,)], [], [(1,)], [(1, 2), (1, 2), (2, 1)]])
@pytest.mark.parametrize("coalesce", [True, False])
def test_coalesce_runs_matches_reference(rows, coalesce):
    assert coalesce_runs(rows, coalesce) == jprofile.coalesce_runs(rows, coalesce)


# ---------------------------------------------------------------------------
# models/lm.py: per-layer K in the layer loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    tree = _numpy_params(CFG)
    jenergies = jlm.init_energy_tree(JCFG, 20.0)
    return dict(
        jparams=jax.tree.map(jnp.asarray, tree),
        params=bridge.params_from_numpy(tree, CFG, "cpu"),
        jenergies=jenergies,
        energies=bridge.energies_from_numpy(jax.tree.map(np.asarray, jenergies), CFG, "cpu"),
    )


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.asarray([5, 16, 9, 0], np.int32)  # the last row is batch padding
    toks = np.zeros((4, 16), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(0, CFG.vocab_size, n)
    return toks, lengths


def _keys():
    return jnp.stack([jax.random.fold_in(jax.random.PRNGKey(5), u) for u in range(3)]
                     + [jax.random.PRNGKey(0)])


def _close(got, want, rel=LOGIT_REL):
    want = np.asarray(want, np.float32)
    err = float(np.abs(_np(got) - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


@functools.partial(jax.jit, static_argnames=("profile",))
def _jdecode(params, cache, tok, pos, lengths, energies, key, *, profile):
    """The reference's profile decode step, compiled once: a test's decode
    steps share one executable."""
    spec = jlm.AnalogSpec(cfg=JAnalogConfig.shot(backend="tile"), energies=energies, key=key,
                          profile=profile)
    return jlm.decode_step(params, cache, {"tokens": tok}, pos, JCFG, analog=spec, lengths=lengths)


def test_profile_prefill_and_decode_match_reference(weights):
    toks, lengths = _batch()
    keys, cache_len = _keys(), 20
    jspec = jlm.AnalogSpec(cfg=JAnalogConfig.shot(backend="tile"), energies=weights["jenergies"],
                           key=keys, profile=JPROFILE)
    spec = lm.AnalogSpec(cfg=AnalogConfig.shot(), energies=weights["energies"],
                         key=np.asarray(keys), profile=PROFILE)
    jcache, jh = jlm.prefill(weights["jparams"], {"tokens": jnp.asarray(toks)}, JCFG, analog=jspec,
                             cache_len=cache_len, lengths=jnp.asarray(lengths))
    jlogits = jlm.logits_last(weights["jparams"], jh, JCFG)
    cache, h = lm.prefill(weights["params"], torch.from_numpy(toks), CFG, analog=spec,
                          cache_len=cache_len, lengths=torch.from_numpy(lengths))
    _close(lm.logits_last(weights["params"], h, CFG)[:3], jlogits[:3])
    tok = np.asarray(jnp.argmax(jlogits[:, 0, 0], axis=-1)).astype(np.int32)
    for step in range(2):
        pos = lengths + step
        pstep = dataclasses.replace(spec, key=fold_key(np.asarray(keys), pos))
        jlogits, jcache = _jdecode(weights["jparams"], jcache, jnp.asarray(tok)[:, None],
                                   jnp.asarray(pos), jnp.asarray(lengths), weights["jenergies"],
                                   jax.vmap(jax.random.fold_in)(keys, jnp.asarray(pos)),
                                   profile=JPROFILE)
        logits, cache = lm.decode_step(weights["params"], cache, torch.from_numpy(tok)[:, None],
                                       torch.from_numpy(pos), CFG, analog=pstep)
        _close(logits[:3], jlogits[:3])
        tok = np.asarray(jnp.argmax(jlogits[:, 0, 0], axis=-1)).astype(np.int32)


def _port_prefill(weights, **spec_kw):
    toks, lengths = _batch(1)
    spec = lm.AnalogSpec(cfg=AnalogConfig.shot(), energies=weights["energies"],
                         key=np.asarray(_keys()), **spec_kw)
    cache, h = lm.prefill(weights["params"], torch.from_numpy(toks), CFG, analog=spec,
                          cache_len=20, lengths=torch.from_numpy(lengths))
    return lm.logits_last(weights["params"], h, CFG), cache


@pytest.mark.parametrize("coalesce", [True, False])
def test_uniform_profile_is_n_repeats_bit_exact(weights, coalesce):
    want, wcache = _port_prefill(weights, n_repeats=2)
    profile = dataclasses.replace(PrecisionProfile.uniform(2, CFG.n_layers), coalesce=coalesce)
    got, gcache = _port_prefill(weights, profile=profile)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for name in ("k", "v"):
        torch.testing.assert_close(gcache["groups"][name], wcache["groups"][name], rtol=0, atol=0)
    other, _ = _port_prefill(weights, profile=PROFILE)
    assert not torch.equal(other, want)  # the profile's K reached the layers


def test_profile_spec_validation(weights):
    with pytest.raises(ValueError, match="overrides n_repeats"):
        lm.AnalogSpec(cfg=AnalogConfig.shot(), energies=weights["energies"],
                      key=np.asarray(_keys()), n_repeats=2, profile=PROFILE)
    with pytest.raises(ValueError, match="layers"):
        _port_prefill(weights, profile=PrecisionProfile((2, 1), name="short"))


def test_profile_forward_calls_each_site_at_its_layers_k(weights, monkeypatch):
    """The plain path records one call per site at each layer's K, in
    layer order; nothing counts as a kernel launch on the CPU."""
    calls = []
    real = ops.analog_matmul_ref_raw

    def spy(*args, **kw):
        calls.append(kw["n_repeats"])
        return real(*args, **kw)

    monkeypatch.setattr(ops, "analog_matmul_ref_raw", spy)
    launches_by_k = dict(am.LAUNCHES_BY_K)
    _port_prefill(weights, profile=PROFILE)
    n_sites = len(lm.group_sites(CFG))
    assert calls == [k for k in PROFILE.repeats for _ in range(n_sites)]
    assert am.LAUNCHES_BY_K == launches_by_k


# ---------------------------------------------------------------------------
# serving: profile tiers and their energy
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    tree = _numpy_params(SCFG)
    jenergies = jlm.init_energy_tree(JSCFG, 20.0)
    return dict(
        jparams=jax.tree.map(jnp.asarray, tree),
        params=bridge.params_from_numpy(tree, SCFG, "cpu"),
        jenergies=jenergies,
        energies=bridge.energies_from_numpy(jax.tree.map(np.asarray, jenergies), SCFG, "cpu"),
    )


def _engine(model, analog=True, **kw):
    extra = dict(analog_cfg=AnalogConfig.shot(), energies=model["energies"]) if analog else {}
    return ServingEngine(model["params"], SCFG, **extra, **ENGINE_KW, device="cpu", **kw)


def _prompts(seed=3, lengths=(7, 19, 28)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, SCFG.vocab_size, n).astype(np.int32) for n in lengths]


def test_profile_tier_tokens_equal_reference_engine(model):
    profile, jp = PrecisionProfile((2, 1), name="lop"), jprofile.PrecisionProfile((2, 1), name="lop")
    jeng = JServingEngine(model["jparams"], JSCFG, analog_cfg=JAnalogConfig.shot(backend="tile"),
                          energies=model["jenergies"], profiles=[jp], **ENGINE_KW)
    eng = _engine(model, profiles=[profile])
    for p in _prompts():
        assert jeng.submit(p, profile="lop", max_new_tokens=4, now=0.0) == \
            eng.submit(p, profile="lop", max_new_tokens=4, now=0.0)
    want, got = jeng.flush(), eng.flush()
    assert sorted(want) == sorted(got)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]))


def test_profile_solo_equals_batched_bit_exact(model):
    eng = _engine(model, profiles=[PrecisionProfile((1, 2), name="learned")])
    prompts = _prompts()
    uids = [eng.submit(p, profile="learned", max_new_tokens=4, now=0.0) for p in prompts]
    batched = eng.flush()
    assert eng.stats["padded_rows"] == 1  # three requests in a 4-row bucket
    for uid, p in zip(uids, prompts):
        solo_eng = _engine(model, profiles=[PrecisionProfile((1, 2), name="learned")])
        solo_eng._uid = uid  # same uid -> same request key as in the batch
        solo_eng.submit(p, profile="learned", max_new_tokens=4, now=0.0)
        np.testing.assert_array_equal(solo_eng.flush()[uid], batched[uid])


def test_profile_tier_never_shares_a_batch_and_uniform_profile_is_k(model):
    eng = _engine(model, profiles=[PrecisionProfile((1, 2), name="learned")])
    prompts = _prompts()
    for p in prompts:
        eng.submit(p, profile="learned", max_new_tokens=4, now=0.0)
        eng.submit(p, n_repeats=2, max_new_tokens=4, now=0.0)
    eng.flush()
    assert eng.stats["batches"] == 2  # one batch per tier
    # a uniform profile is the K tier: one shared batch, the same bits
    u0 = eng.submit(prompts[0], profile=PrecisionProfile.uniform(2, 2), max_new_tokens=4,
                    key=eng._base_key, now=0.0)
    u1 = eng.submit(prompts[1], n_repeats=2, max_new_tokens=4, now=0.0)
    out = eng.flush()
    assert eng.stats["batches"] == 3 and set(out) == {u0, u1}
    s0 = eng.submit(prompts[0], n_repeats=2, max_new_tokens=4, key=eng._base_key, now=0.0)
    np.testing.assert_array_equal(eng.flush()[s0], out[u0])
    # an unrolled uniform profile stays its own tier, with the same bits
    oracle = dataclasses.replace(PrecisionProfile.uniform(2, 2), name="oracle", coalesce=False)
    o0 = eng.submit(prompts[0], profile=oracle, max_new_tokens=4, key=eng._base_key, now=0.0)
    eng.submit(prompts[1], n_repeats=2, max_new_tokens=4, now=0.0)
    out2 = eng.flush()
    assert eng.stats["batches"] == 6  # the oracle and the K tier: two batches
    np.testing.assert_array_equal(out2[o0], out[u0])


def test_engine_profile_registry_validation(model):
    eng = _engine(model)
    with pytest.raises(ValueError, match="layers"):
        eng.register_profile(PrecisionProfile((1, 2, 4), name="wrong-depth"))
    assert eng.register_profile(PrecisionProfile((1, 2), name="p")) == "p"
    assert eng.register_profile(PrecisionProfile((1, 2), name="p")) == "p"  # idempotent
    with pytest.raises(ValueError, match="frozen"):
        eng.register_profile(PrecisionProfile((4, 4), name="p"))
    with pytest.raises(ValueError, match="unknown profile"):
        eng.submit(np.arange(4), profile="never-registered", now=0.0)
    with pytest.raises(ValueError, match="not both"):
        eng.submit(np.arange(4), profile="p", n_repeats=2, now=0.0)
    with pytest.raises(ValueError, match="unknown profile"):
        eng.tier_energy_per_token("never-registered")
    with pytest.raises(ValueError, match="unknown profile"):
        eng.tiers.get("never-registered")
    assert eng.scheduler.n_pending == 0 and eng._uid == 0  # nothing half-enqueued
    assert list(eng.profiles) == ["p"]
    assert eng.tiers.resolve_profile(PrecisionProfile.uniform(4, 2, name="u4")) == 4


def test_digital_engine_serves_profiles_on_its_one_tier(model):
    eng = _engine(model, analog=False, profiles=[PrecisionProfile((1, 2), name="p")])
    u0 = eng.submit(np.arange(10) % SCFG.vocab_size, profile="p", max_new_tokens=3, now=0.0)
    u1 = eng.submit(np.arange(4) % SCFG.vocab_size, n_repeats=4, max_new_tokens=3, now=0.0)
    assert set(eng.flush()) == {u0, u1}
    assert eng.stats["batches"] == 1
    for tier in ("p", 1, PrecisionProfile((1, 2), name="q")):
        with pytest.raises(ValueError, match="digital"):
            eng.tier_energy_per_token(tier)


def test_tier_energy_per_token_matches_reference(model):
    profile = PrecisionProfile((4, 1), name="learned")
    jeng = JServingEngine(model["jparams"], JSCFG, analog_cfg=JAnalogConfig.shot(backend="tile"),
                          energies=model["jenergies"],
                          profiles=[jprofile.PrecisionProfile((4, 1), name="learned")], **ENGINE_KW)
    eng = _engine(model, profiles=[profile])
    for tier in (1, 2, 4, "learned"):
        _rel_close(eng.tier_energy_per_token(tier), jeng.tier_energy_per_token(tier))
    adhoc = ((2, 8), "adhoc")
    _rel_close(eng.tier_energy_per_token(PrecisionProfile(*adhoc)),
               jeng.tier_energy_per_token(jprofile.PrecisionProfile(*adhoc)))
    e1, ep, e4 = (eng.tier_energy_per_token(t) for t in (1, "learned", 4))
    assert e1 < ep < e4
    assert ep == lm.profile_token_energy(SCFG, model["energies"], profile)
    # a digital tier prices through its per-MAC constant, never the energy tree
    jdigital = JDigitalTier(tier_id="bf16")
    jeng.register_tier(jdigital)
    _rel_close(DigitalTier(eng, "bf16").energy_per_token(), jdigital.energy_per_token())
    with pytest.raises(ValueError, match="digital"):
        DigitalTier(eng, "bf16", aj_per_mac=None).energy_per_token()
