"""Port vs reference: int8 weight storage and the int8 digital tier
(mirrors tests/test_int8_serving.py and the int8 cases of
tests/test_tiers.py).

``quant/weights.py``: codes and scales bit-equal to the reference's
``quantize_weight`` on the same numpy weights, the round-trip bound, the
bytes kept (< 0.62x). The model on an int8 tree (``lm._maybe_dequant``,
one layer slice at a time): decode logits against the reference's int8
decode at f32 within 1e-4 max|logit|, and against the port's bf16-free
(f32) decode within the reference's own bound (0.25 max|logit|, top-1
agreement >= 0.5), for the granite, recurrentgemma and grok smoke
configs. ``Int8DigitalTier``: pooled == sync == solo bit for bit, analog
and digital tiers on one engine with each tier's own energy model, the
governor demoting across domains to it, drift promotion leaving it where
it is.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs as several processes on the cores (pytest-xdist): torch's
# intra-op threads in each would oversubscribe them (20x slower when six run)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.quant import weights as jweights  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.core.energy import DIGITAL_INT8_AJ_PER_MAC, total_macs  # noqa: E402
from repro_torch.core.profile import PrecisionProfile  # noqa: E402
from repro_torch.kernels.prng import PRNGKey, fold_in  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.quant import weights  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    DriftEvent,
    Int8DigitalTier,
    PolicyConfig,
    PrecisionGovernor,
    ServingEngine,
    TierSpec,
)

B, T = 2, 32
LOGIT_REL = 1e-4  # port vs reference at f32: float order only
ARCHS = ["granite-3-8b", "recurrentgemma-2b", "grok-1-314b"]
SB = 32
MODEL = ModelConfig(name="tier-test", family="dense", n_layers=2, d_model=32, n_heads=2,
                    n_kv_heads=1, d_ff=64, vocab_size=128, attn_q_chunk=16, attn_kv_chunk=16,
                    dtype="float32")


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _numpy_tree(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return lm.map_leaves(
        lambda _p, leaf: (rng.standard_normal(leaf.shape) * (leaf.scale or 0.1)).astype(np.float32),
        lm.param_leaves(cfg))


# ---------------------------------------------------------------------------
# quant/weights.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codes_and_scales_bit_equal_reference(dtype):
    w = (np.random.default_rng(1).standard_normal((4, 64, 32)) * 0.3).astype(np.float32)
    w[1, :, 3] = 0.0  # an all-zero channel takes the 1e-30 floor
    jw = jnp.asarray(w, getattr(jnp, dtype))
    tw = bridge._to_torch(np.asarray(jw), "cpu")
    got, want = weights.quantize_weight(tw), jweights.quantize_weight(jw)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(_np(got.q), np.asarray(want.q))
    np.testing.assert_array_equal(_np(got.scale), np.asarray(want.scale))
    back = weights.dequantize_weight(got)
    want_back = jweights.dequantize_weight(want)
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(back.float()), np.asarray(want_back, np.float32))


def test_weight_roundtrip_error_bound():
    w = torch.from_numpy((np.random.default_rng(0).standard_normal((4, 64, 32)) * 0.3)
                         .astype(np.float32))
    iw = weights.quantize_weight(w)
    back = weights.dequantize_weight(iw, torch.float32)
    bound = torch.amax(w.abs(), dim=-2, keepdim=True) / 127.0
    assert float((back - w).abs().sub(bound / 2).max()) < 1e-5
    assert iw.scale.shape == (4, 1, 32) and iw[2].q.shape == (64, 32)


# ---------------------------------------------------------------------------
# the model on an int8 tree, against the reference
# ---------------------------------------------------------------------------


def _smoke(arch):
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), dtype="float32")
    if cfg.family == "moe":  # no token dropped, as the reference test
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
        jcfg = dataclasses.replace(jcfg, capacity_factor=float(jcfg.n_experts))
    return cfg, jcfg


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_decode_matches_reference_and_bf16(arch):
    cfg, jcfg = _smoke(arch)
    tree = _numpy_tree(cfg)
    params = bridge.params_from_numpy(tree, cfg, "cpu")
    qparams = weights.quantize_params(params)
    jq = jweights.quantize_params(jax.tree.map(jnp.asarray, tree))
    assert weights.param_bytes(qparams) == jweights.param_bytes(jq)
    assert weights.param_bytes(qparams) < 0.62 * weights.param_bytes(params)

    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    jcache, _ = jlm.prefill(jq, {"tokens": jnp.asarray(toks[:, :T])}, jcfg, cache_len=T + 1)
    jgot, _ = jlm.decode_step(jq, jcache, {"tokens": jnp.asarray(toks[:, T:])}, T, jcfg)
    pos = torch.full((B,), T, dtype=torch.long)
    t = torch.from_numpy(toks).long()

    def decode(p):
        cache, _ = lm.prefill(p, t[:, :T], cfg, cache_len=T + 1)
        logits, _ = lm.decode_step(p, cache, t[:, T:], pos, cfg)
        return _np(logits).reshape(B, -1)

    got, want = decode(qparams), decode(params)
    jgot = np.asarray(jgot, np.float32).reshape(B, -1)
    scale = float(np.abs(jgot).max())
    assert float(np.abs(got - jgot).max()) <= LOGIT_REL * scale
    # int8 against full precision: the reference's serving bound
    scale = float(np.abs(want).max()) + 1e-6
    assert float(np.abs(got - want).max()) < 0.25 * scale, arch
    assert float(np.mean(got.argmax(-1) == want.argmax(-1))) >= 0.5, arch


def test_dequantization_is_per_layer_slice(monkeypatch):
    """No forward dequantizes a whole stacked leaf: each call takes one
    layer's slice (or the lm_head)."""
    cfg, _ = _smoke("recurrentgemma-2b")
    params = bridge.params_from_numpy(_numpy_tree(cfg), cfg, "cpu")
    qparams = weights.quantize_params(params)
    stacked = {tuple(a.q.shape) for a in leaves(qparams) if isinstance(a, weights.Int8Weight)}
    seen = []
    real = weights.dequantize_weight
    monkeypatch.setattr(weights, "dequantize_weight",
                        lambda iw, dtype=torch.bfloat16: seen.append(tuple(iw.q.shape))
                        or real(iw, dtype))
    cache, h = lm.prefill(qparams, torch.zeros((1, 8), dtype=torch.long), cfg, cache_len=9)
    lm.logits_last(qparams, h, cfg)
    head = tuple(qparams["lm_head"].q.shape) if "lm_head" in qparams else None
    assert seen and all(s == head or s not in stacked for s in seen)


# ---------------------------------------------------------------------------
# the int8 digital tier
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def env():
    tree = _numpy_tree(MODEL)
    return dict(params=bridge.params_from_numpy(tree, MODEL, "cpu"),
                energies=lm.init_energy_tree(MODEL, 20.0, device="cpu"))


def _engine(env, **kw):
    kw.setdefault("max_gen", 8)
    kw.setdefault("max_wait", 0.0)
    kw.setdefault("max_batch", 4)
    return ServingEngine(env["params"], MODEL, analog_cfg=AnalogConfig.shot(),
                         energies=env["energies"], batch_buckets=(1, 2, 4), seq_buckets=(SB,),
                         k_ladder=(1, 2, 4), device="cpu", **kw)


def _prompts(n, seed=3, lens=(7, 19, 28)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, lens[i % len(lens)]).astype(np.int32) for i in range(n)]


def _drain(eng, t=0.0, dt=0.01, max_iters=400):
    results = {}
    for _ in range(max_iters):
        if not eng.n_in_flight:
            break
        t += dt
        results.update(eng.pump_step(now=t) if eng.continuous else eng.poll(now=t))
    assert not eng.n_in_flight, "engine failed to drain (hang)"
    return results


def test_int8_tier_pooled_equals_sync_and_solo(env):
    prompts = _prompts(6, seed=11)
    keys = [fold_in(PRNGKey(5), i) for i in range(len(prompts))]
    out = {}
    for continuous in (True, False):
        eng = _engine(env, continuous=continuous, pool_slots=4)
        eng.register_tier(Int8DigitalTier(eng))
        uids = [eng.submit(p, tier="int8", max_new_tokens=4, key=k, now=0.0)
                for p, k in zip(prompts, keys)]
        res = _drain(eng)
        out[continuous] = [res[u] for u in uids]
        if continuous:  # solo through the same pool, and key-independent
            for i in (0, 3, 5):
                uid = eng.submit(prompts[i], tier="int8", max_new_tokens=4, key=keys[i],
                                 now=0.0)
                assert np.array_equal(_drain(eng)[uid], out[True][i]), i
            uid = eng.submit(prompts[0], tier="int8", max_new_tokens=4, key=PRNGKey(999),
                             now=0.0)
            assert np.array_equal(_drain(eng)[uid], out[True][0])
    assert all(np.array_equal(a, b) for a, b in zip(out[True], out[False]))


def test_int8_tier_requantizes_when_params_are_swapped(env):
    eng = _engine(env)
    tier = Int8DigitalTier(eng)
    eng.register_tier(tier)
    first = tier.params
    assert tier.params is first  # made once
    assert tier.drift_exempt and tier.tier_id == "int8"
    eng.params = dict(env["params"])
    assert tier.params is not first
    assert torch.equal(tier.params["lm_head"].q, first["lm_head"].q)


def test_analog_and_digital_tiers_share_one_engine(env):
    eng = _engine(env, continuous=True, pool_slots=4,
                  profiles=[PrecisionProfile((2, 1), name="mix")])
    eng.register_tier(Int8DigitalTier(eng))
    tiers = [1, "mix", "int8", 1, "mix", "int8"]
    uids = [eng.submit(p, tier=t, max_new_tokens=4, now=0.0)
            for p, t in zip(_prompts(len(tiers), seed=7), tiers)]
    results = _drain(eng)
    assert all(isinstance(results[u], np.ndarray) for u in uids)
    assert [eng.served_tiers[u] for u in uids] == tiers
    toks = eng.stats["tier_tokens"]
    assert toks[1] == toks["mix"] == toks["int8"] == 8
    macs = float(total_macs(lm.energy_macs(MODEL, 1)))
    jmacs = float(jenergy.total_macs(jlm.energy_macs(jconfigs_model(), 1)))
    assert macs == pytest.approx(jmacs, rel=1e-6)
    assert eng.tier_energy_per_token("int8") == pytest.approx(DIGITAL_INT8_AJ_PER_MAC * macs)
    e1, e_mix, e4 = (eng.tier_energy_per_token(t) for t in (1, "mix", 4))
    assert e1 < e_mix < e4 < eng.tier_energy_per_token("int8")


def jconfigs_model():
    from repro.models.config import ModelConfig as JModelConfig

    return JModelConfig(**{f.name: getattr(MODEL, f.name) for f in dataclasses.fields(MODEL)
                           if f.name in {g.name for g in dataclasses.fields(JModelConfig)}})


def test_governor_demotes_across_domains_to_digital(env):
    eng = _engine(env, continuous=True, pool_slots=2)
    eng.register_tier(Int8DigitalTier(eng, aj_per_mac=1.0))
    policy = PolicyConfig(
        tiers=(TierSpec(1, 0.8), TierSpec(2, 0.9), TierSpec(4, 0.97), TierSpec("int8", 1.0)),
        demote_at=1.0, promote_at=0.25, shed_at=6.0, min_dwell=2)
    eng.governor = PrecisionGovernor(eng, policy)
    assert [row[2] for row in eng.governor._table][0] == "int8"  # cheapest
    uids = [eng.submit(p, n_repeats=4, now=0.0, max_new_tokens=4, target_latency=5.0)
            for p in _prompts(9)]
    results = _drain(eng)
    assert eng.stats["demoted"] > 0
    assert all(isinstance(results[u], np.ndarray) for u in uids)
    assert "int8" in {eng.served_tiers[u] for u in uids}


def test_drift_promotion_skips_the_int8_tier(env):
    eng = _engine(env, continuous=True, pool_slots=2)
    eng.register_tier(Int8DigitalTier(eng))
    eng.promote_tiers(DriftEvent(step=0, probe_idx=0, estimate=1.8, band=(0.8, 1.2)))
    entry = next(e for e in eng.fault_log if e["kind"] == "drift_promotion")
    assert entry["exempt_tiers"] == ["int8"]
    u_k = eng.submit(_prompts(1)[0], n_repeats=1, max_new_tokens=2, now=0.0)
    u_d = eng.submit(_prompts(1)[0], tier="int8", max_new_tokens=2, now=0.0)
    _drain(eng)
    assert eng.served_tiers[u_k] == 2 and eng.served_tiers[u_d] == "int8"
