"""Port vs reference: the rest of the dense family — the GELU MLP with
biases, QKV bias, MQA, the ``frames`` and ``patch`` frontends and
``n_codebooks`` LM heads — at the reference's configs.

Full configs (bert-base, granite-20b, qwen2.5-14b, qwen2.5-32b,
musicgen-large, internvl2-2b): the port's copies equal the reference's,
and so do their parameter shapes, parameter counts, analog sites and
energies (rel 1e-6); nothing is allocated at full size. Smoke configs, at
float32 from the same numpy weights (``bridge.params_from_numpy``), the
reference on backend "tile" and the port's plain path on the CPU:
prefill and per-row decode logits within ``1e-4 * max|logit|`` under shot
noise; engine tokens exact; decode against the full forward (the port's
``tests/test_decode.py``); and, inside the port, solo == batched and
padded == unpadded bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import profile as jprofile  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.core.analog import AnalogConfig, fold_key  # noqa: E402
from repro_torch.core.profile import PrecisionProfile  # noqa: E402
from repro_torch.kernels.prng import PRNGKey, fold_in  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ENERGY_REL = 1e-6
LOGIT_REL = 1e-4
NEW = ["bert-base", "granite-20b", "qwen2.5-14b", "qwen2.5-32b", "musicgen-large", "internvl2-2b"]
#: the token-input configs the engine serves
SERVED = ["bert-base", "granite-20b", "qwen2.5-14b"]
ENGINE_KW = dict(max_gen=8, max_batch=4, max_wait=1.0, batch_buckets=(1, 2, 4), seq_buckets=(32,))


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


_models = {}


def model(arch):
    """Smoke config of ``arch`` at float32: numpy weights in both packages."""
    if arch not in _models:
        cfg, jcfg = _f32(configs.get_smoke_config(arch)), _f32(jconfigs.get_smoke_config(arch))
        rng = np.random.default_rng(0)
        tree = lm.map_leaves(
            lambda _p, leaf: (rng.standard_normal(leaf.shape) * (leaf.scale or 0.1)).astype(np.float32),
            lm.param_leaves(cfg),
        )
        jenergies = jlm.init_energy_tree(jcfg, 20.0)
        _models[arch] = dict(
            cfg=cfg, jcfg=jcfg, tree=tree, jparams=jax.tree.map(jnp.asarray, tree),
            params=bridge.params_from_numpy(tree, cfg, "cpu"), jenergies=jenergies,
            energies=bridge.energies_from_numpy(jax.tree.map(np.asarray, jenergies), cfg, "cpu"),
        )
    return _models[arch]


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, rel=LOGIT_REL):
    got, want = _np(got).astype(np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# full configs: values, shapes, counts, sites, energies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW)
def test_config_is_the_reference_config(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    for f in dataclasses.fields(ModelConfig):
        smoke, jsmoke = configs.get_smoke_config(arch), jconfigs.get_smoke_config(arch)
        assert getattr(smoke, f.name) == getattr(jsmoke, f.name), f.name
    assert cfg.param_count() == jcfg.param_count()


def test_registry_covers_the_port_configs():
    """The port's registry is the reference's: every family is ported."""
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.EXTRA_ARCHS == jconfigs.EXTRA_ARCHS
    assert set(NEW) <= set(configs.ARCHS) | set(configs.EXTRA_ARCHS)
    with pytest.raises(KeyError):
        configs.get_config("xlstm-7b")


@pytest.mark.parametrize("arch", NEW)
def test_param_leaves_equal_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    got = lm.map_leaves(lambda _p, leaf: (leaf.shape, leaf.scale), lm.param_leaves(cfg))
    want = jax.tree.map(lambda leaf: (tuple(leaf.shape), leaf.scale), jlm.param_leaves(jcfg),
                        is_leaf=lambda x: isinstance(x, jlm.Leaf))
    assert got == want


@pytest.mark.parametrize("arch", NEW)
def test_sites_and_energies_equal_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert list(lm.group_sites(cfg)) == list(jlm.group_sites(jcfg))
    for t in (1, 64):
        got, want = lm.energy_macs(cfg, t), jlm.energy_macs(jcfg, t)
        for g, w in zip(leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=ENERGY_REL)
    e = lm.init_energy_tree(cfg, 20.0, device="cpu")
    je = jlm.init_energy_tree(jcfg, 20.0)
    for k in (1, 4):
        got = lm.profile_token_energy(cfg, e, PrecisionProfile.uniform(k, cfg.n_layers))
        want = jlm.profile_token_energy(jcfg, je, jprofile.PrecisionProfile.uniform(k, cfg.n_layers))
        np.testing.assert_allclose(got, want, rtol=ENERGY_REL)


def test_gelu_config_rules():
    base = dict(name="x", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64)
    assert ModelConfig(family="dense", mlp_type="gelu", qkv_bias=True, frontend="frames",
                       n_codebooks=4, **base).n_codebooks == 4
    assert ModelConfig(family="moe", mlp_type="gelu", n_experts=4, **base).mlp_type == "gelu"
    for kw in (dict(family="griffin", qkv_bias=True), dict(family="griffin", frontend="patch"),
               dict(family="griffin", n_codebooks=2), dict(family="dense", frontend="audio"),
               dict(family="moe", mlp_type="gelu", n_experts=4, n_shared_experts=1)):
        with pytest.raises(ValueError):
            ModelConfig(**{**base, **kw})


def test_reduced_depth_is_the_reference_rule():
    for arch in ("granite-20b", "recurrentgemma-2b"):
        got = configs.reduced_depth(configs.get_config(arch), n_layers=4, width_divisor=8)
        want = jconfigs.shapes.reduced_depth(jconfigs.get_config(arch), n_layers=4,
                                             width_divisor=8)
        for f in dataclasses.fields(ModelConfig):
            assert getattr(got, f.name) == getattr(want, f.name), (arch, f.name)


def test_engine_refuses_frontend_configs():
    for arch in ("musicgen-large", "internvl2-2b"):
        m = model(arch)
        with pytest.raises(ValueError, match="frontend"):
            ServingEngine(m["params"], m["cfg"], device="cpu")


# ---------------------------------------------------------------------------
# smoke configs: logits, tokens, decode vs full forward
# ---------------------------------------------------------------------------


def _batch(cfg, seed=0, t=16):
    """A right-padded 4-row bucket (the last row batch padding) as both
    packages' batch dicts, and its lengths (the patch prefix counted)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "frames":
        lengths = np.asarray([5, t, 9, 0], np.int32)
        embeds = rng.standard_normal((4, t, cfg.d_model)).astype(np.float32)
        return {"embeds": embeds}, lengths
    p = cfg.n_frontend_tokens if cfg.frontend == "patch" else 0
    text = np.asarray([5, t - p, 9 - p if p else 9, 0], np.int32)
    toks = np.zeros((4, t - p), np.int32)
    for i, n in enumerate(text):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    lengths = np.where(text > 0, text + p, 0).astype(np.int32)
    if p:
        patches = rng.standard_normal((4, p, cfg.d_model)).astype(np.float32)
        return {"tokens": toks, "patch_embeds": patches}, lengths
    return {"tokens": toks}, lengths


def _step_input(cfg, tok, seed):
    """One decode step's batch: the greedy tokens, or a frame embedding."""
    if cfg.frontend == "frames":
        return {"embeds": np.random.default_rng(seed).standard_normal(
            (4, 1, cfg.d_model)).astype(np.float32)}
    return {"tokens": tok[:, None]}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _keys():
    return jnp.stack([jax.random.fold_in(jax.random.PRNGKey(5), u) for u in range(3)]
                     + [jax.random.PRNGKey(0)])


@pytest.mark.parametrize("n_repeats", [1, 4], ids=["K1", "K4"])
@pytest.mark.parametrize("arch", NEW)
def test_prefill_and_decode_match_reference(arch, n_repeats):
    m = model(arch)
    cfg, jcfg = m["cfg"], m["jcfg"]
    batch, lengths = _batch(cfg)
    keys = _keys()
    jspec = jlm.AnalogSpec(cfg=JAnalogConfig.shot(backend="tile"), energies=m["jenergies"],
                           key=keys, n_repeats=n_repeats)
    spec = lm.AnalogSpec(cfg=AnalogConfig.shot(), energies=m["energies"], key=np.asarray(keys),
                         n_repeats=n_repeats)
    cache_len = 20
    jcache, jh = jlm.prefill(m["jparams"], _j(batch), jcfg, analog=jspec, cache_len=cache_len,
                             lengths=jnp.asarray(lengths))
    jlogits = jlm.logits_last(m["jparams"], jh, jcfg)
    cache, h = lm.prefill(m["params"], _t(batch), cfg, analog=spec, cache_len=cache_len,
                          lengths=torch.from_numpy(lengths))
    logits = lm.logits_last(m["params"], h, cfg)
    assert tuple(logits.shape) == (4, 1, cfg.n_codebooks, cfg.vocab_size)
    _close(logits[:3], jlogits[:3])
    for name in ("k", "v"):
        _close(cache["groups"][name][:, :, :3], jcache["groups"][name][:, :, :3])

    tok = np.asarray(jnp.argmax(jlogits[:, 0, 0], axis=-1)).astype(np.int32)
    for step in range(2):
        pos = lengths + step
        step_in = _step_input(cfg, tok, seed=10 + step)
        jstep = dataclasses.replace(jspec, key=jax.vmap(jax.random.fold_in)(keys, jnp.asarray(pos)))
        sspec = dataclasses.replace(spec, key=fold_key(np.asarray(keys), pos))
        jlogits, jcache = jlm.decode_step(m["jparams"], jcache, _j(step_in), jnp.asarray(pos), jcfg,
                                          analog=jstep, lengths=jnp.asarray(lengths))
        logits, cache = lm.decode_step(m["params"], cache, _t(step_in), torch.from_numpy(pos), cfg,
                                       analog=sspec)
        _close(logits[:3], jlogits[:3])
        tok = np.asarray(jnp.argmax(jlogits[:, 0, 0], axis=-1)).astype(np.int32)


def _requests(vocab, lens=(7, 19, 28), gens=(2, 5, 8), seed=3):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    keys = [fold_in(PRNGKey(5), i) for i in range(len(lens))]
    return prompts, list(gens), keys


@pytest.mark.parametrize("n_repeats", [1, 4], ids=["K1", "K4"])
@pytest.mark.parametrize("arch", SERVED)
def test_engine_tokens_equal_reference_engine(arch, n_repeats):
    m = model(arch)
    prompts, gens, _ = _requests(m["cfg"].vocab_size)
    jeng = JServingEngine(m["jparams"], m["jcfg"], analog_cfg=JAnalogConfig.shot(backend="tile"),
                          energies=m["jenergies"], **ENGINE_KW)
    eng = ServingEngine(m["params"], m["cfg"], analog_cfg=AnalogConfig.shot(),
                        energies=m["energies"], **ENGINE_KW, device="cpu")
    for p, g in zip(prompts, gens):
        assert (jeng.submit(p, n_repeats=n_repeats, max_new_tokens=g, now=0.0)
                == eng.submit(p, n_repeats=n_repeats, max_new_tokens=g, now=0.0))
    want, got = jeng.flush(), eng.flush()
    assert sorted(want) == sorted(got)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]))
    for stat in ("requests", "batches", "tokens_generated", "padded_rows", "decode_steps"):
        assert eng.stats[stat] == jeng.stats[stat], stat
    for k in (1, n_repeats):
        np.testing.assert_allclose(eng.tier_energy_per_token(k), jeng.tier_energy_per_token(k),
                                   rtol=ENERGY_REL)


B, T = 2, 32


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "musicgen-large", "internvl2-2b", "bert-base",
                                  "granite-20b", "qwen2.5-14b"])
def test_decode_matches_full_forward(arch):
    """Prefill of T inputs then one decode step against a prefill of all
    T + 1 (the reference's ``tests/test_decode.py``), digital, f32."""
    m = model(arch)
    cfg = m["cfg"]
    rng = np.random.default_rng(4)
    if cfg.frontend == "frames":
        embeds = rng.standard_normal((B, T + 1, cfg.d_model)).astype(np.float32)
        full, pre, dec = {"embeds": embeds}, {"embeds": embeds[:, :T]}, {"embeds": embeds[:, T:]}
    elif cfg.frontend == "patch":
        p = cfg.n_frontend_tokens
        toks = rng.integers(0, cfg.vocab_size, (B, T + 1 - p))
        patches = rng.standard_normal((B, p, cfg.d_model)).astype(np.float32)
        full = {"tokens": toks, "patch_embeds": patches}
        pre, dec = {"tokens": toks[:, :-1], "patch_embeds": patches}, {"tokens": toks[:, -1:]}
    else:
        toks = rng.integers(0, cfg.vocab_size, (B, T + 1))
        full, pre, dec = {"tokens": toks}, {"tokens": toks[:, :T]}, {"tokens": toks[:, T:]}
    _, h_full = lm.prefill(m["params"], _t(full), cfg)
    want = lm.logits_last(m["params"], h_full, cfg)
    cache, _ = lm.prefill(m["params"], _t(pre), cfg, cache_len=T + 1)
    got, new_cache = lm.decode_step(m["params"], cache, _t(dec), torch.full((B,), T), cfg)
    _close(got, want.numpy())
    assert new_cache is cache
    jcache, _ = jlm.prefill(m["jparams"], _j(pre), m["jcfg"], cache_len=T + 1)
    jgot, _ = jlm.decode_step(m["jparams"], jcache, _j(dec), T, m["jcfg"])
    _close(got, jgot)


# ---------------------------------------------------------------------------
# inside the port: solo == batched, padded == unpadded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW)
def test_solo_equals_batched_bit_exact(arch, monkeypatch):
    """Each real row of a padded 4-row bucket (K = 4): its prefill's last
    hidden against the same row alone at the same bucket, and its decode
    step's hidden against the same row in the bucket with the rows in
    another order, bit for bit. (The digital lm_head is a plain matmul,
    made the identity here so the hidden state is compared; on the CPU a
    1-row matmul sums in another order than a 4-row one, so a decode step,
    one row a request, is held at a fixed batch shape.)"""
    monkeypatch.setattr(lm, "logits_last", lambda _params, h, _cfg: h)
    m = model(arch)
    cfg = m["cfg"]
    batch, lengths = _batch(cfg, seed=1)
    keys = np.asarray(_keys())
    spec = lm.AnalogSpec(cfg=AnalogConfig.shot(), energies=m["energies"], key=keys, n_repeats=4)
    step_in = _step_input(cfg, np.arange(4, dtype=np.int32), seed=11)

    def run(order):
        rows = lambda b: {k: v[order] for k, v in b.items()}  # noqa: E731
        sp = dataclasses.replace(spec, key=keys[order])
        cache, h = lm.prefill(m["params"], _t(rows(batch)), cfg, analog=sp, cache_len=20,
                              lengths=torch.from_numpy(lengths[order]))
        step = dataclasses.replace(spec, key=fold_key(keys[order], lengths[order]))
        dh, _ = lm.decode_step(m["params"], cache, _t(rows(step_in)),
                               torch.from_numpy(lengths[order]), cfg, analog=step)
        return h, dh

    order = np.asarray([2, 1, 0, 3])
    h, dh = run(np.arange(4))
    _, dh_perm = run(order)
    for r in range(3):
        hs, _ = run(np.asarray([r]))
        torch.testing.assert_close(h[r:r + 1], hs, rtol=0, atol=0)
        torch.testing.assert_close(dh[r], dh_perm[int(np.flatnonzero(order == r)[0])],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("arch", NEW)
def test_padded_equals_unpadded_bit_exact(arch):
    """A row right-padded to the 16 bucket against the same inputs at their
    own length, no padding (K = 4): the same last-token logits, bit for bit;
    pad positions are inert."""
    m = model(arch)
    cfg = m["cfg"]
    batch, lengths = _batch(cfg, seed=2)
    keys = np.asarray(_keys())
    spec = lm.AnalogSpec(cfg=AnalogConfig.shot(), energies=m["energies"], key=keys[:1],
                         n_repeats=4)
    r, n = 2, int(lengths[2])
    text_n = n - (cfg.n_frontend_tokens if cfg.frontend == "patch" else 0)
    padded = {k: v[r:r + 1] for k, v in batch.items()}
    exact = {k: (v[r:r + 1, :n] if k == "embeds" else v[r:r + 1, :text_n] if k == "tokens"
                 else v[r:r + 1]) for k, v in batch.items()}
    _, hp = lm.prefill(m["params"], _t(padded), cfg, analog=spec, cache_len=20,
                       lengths=torch.from_numpy(lengths[r:r + 1]))
    _, he = lm.prefill(m["params"], _t(exact), cfg, analog=spec, cache_len=20)
    torch.testing.assert_close(lm.logits_last(m["params"], hp, cfg),
                               lm.logits_last(m["params"], he, cfg), rtol=0, atol=0)


@pytest.mark.parametrize("arch", SERVED)
def test_engine_solo_equals_batched_bit_exact(arch):
    """Three requests in a padded 4-row bucket (K = 2) through the engine:
    each one's tokens equal its run alone at the same seq bucket."""
    m = model(arch)
    prompts, _, keys = _requests(m["cfg"].vocab_size)
    eng = ServingEngine(m["params"], m["cfg"], analog_cfg=AnalogConfig.shot(),
                        energies=m["energies"], **ENGINE_KW, device="cpu")
    uids = [eng.submit(p, n_repeats=2, max_new_tokens=4, key=k, now=0.0)
            for p, k in zip(prompts, keys)]
    batched = eng.flush()
    assert eng.stats["padded_rows"] == 1
    for uid, p, k in zip(uids, prompts, keys):
        solo = eng.submit(p, n_repeats=2, max_new_tokens=4, key=k, now=0.0)
        np.testing.assert_array_equal(eng.flush()[solo], batched[uid])


@pytest.mark.parametrize("row0", [0, 0xFFFFFFF0], ids=["row0", "row0-wraps"])
def test_plain_noise_blocks_change_nothing(row0, monkeypatch):
    """A large plain tile is drawn in blocks of rows (``TILE_ELEMS``): the
    same words as one block, per-request counters and the 2**32 wrap
    included."""
    from repro_torch.kernels import prng

    k0, k1 = torch.tensor([[[5]], [[7]]]), torch.tensor([[[9]], [[11]]])
    r0 = torch.tensor([[[row0]], [[3]]])
    whole = prng.repeat_averaged_gaussian_tile(k0, k1, r0, 2, (300, 70), 2)
    monkeypatch.setattr(prng, "TILE_ELEMS", 1000)
    blocks = prng.repeat_averaged_gaussian_tile(k0, k1, r0, 2, (300, 70), 2)
    assert torch.equal(whole, blocks)
