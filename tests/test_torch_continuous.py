"""Port vs reference: continuous batching.

The slot allocator never aliases two requests, slot-aware admission
follows the reference scheduler case by case, ``scatter_cache_rows``
places prefilled rows and drops out-of-range ids, and the continuous
engine emits exactly the reference continuous engine's tokens (port plain
path on the CPU, reference on backend "tile", same numpy weights at
float32). Inside the port, with one seq bucket (equal cache lengths),
pooled == batch-synchronous == solo, bit-exact.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
# the suite runs as several processes on the cores (pytest-xdist): torch's
# intra-op threads in each would oversubscribe them (20x slower when six run)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.core.profile import PrecisionProfile as JPrecisionProfile  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.serving import bucketing as jbucketing  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro.serving.pool import SlotAllocator as JSlotAllocator  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro.serving.scheduler import TierScheduler as JTierScheduler  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.core.profile import PrecisionProfile  # noqa: E402
from repro_torch.kernels.prng import PRNGKey, fold_in  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving import bucketing  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.pool import DecodePool, SlotAllocator  # noqa: E402
from repro_torch.serving.scheduler import Request, TierScheduler  # noqa: E402

SB = 32  # one seq bucket: pooled and batch-synchronous caches have one length
_DENSE = dict(name="serve-dense", family="dense", n_layers=2, d_model=32, n_heads=2,
              n_kv_heads=1, head_dim=16, d_ff=64, vocab_size=128, dtype="float32")
CFG = ModelConfig(**_DENSE)
JCFG = JModelConfig(**_DENSE)
ENGINE_KW = dict(max_gen=8, max_batch=4, max_wait=1.0, batch_buckets=(1, 2, 4), seq_buckets=(SB,))


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(0)
    tree = lm.map_leaves(
        lambda _p, leaf: (rng.standard_normal(leaf.shape) * (leaf.scale or 0.1)).astype(np.float32),
        lm.param_leaves(CFG),
    )
    jenergies = jlm.init_energy_tree(JCFG, 20.0)
    return dict(
        jparams=jax.tree.map(jnp.asarray, tree),
        params=bridge.params_from_numpy(tree, CFG, "cpu"),
        jenergies=jenergies,
        energies=bridge.energies_from_numpy(jax.tree.map(np.asarray, jenergies), CFG, "cpu"),
    )


def _engine(model, *, analog=True, continuous=True, pool_slots=2, **kw):
    extra = dict(analog_cfg=AnalogConfig.shot(), energies=model["energies"]) if analog else {}
    opts = dict(ENGINE_KW, continuous=continuous, pool_slots=pool_slots)
    opts.update(kw)
    return ServingEngine(model["params"], CFG, **extra, **opts, device="cpu")


def _requests(n=3, lens=(7, 19, 28), gens=(2, 5, 8), seed=3):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, CFG.vocab_size, n_).astype(np.int32) for n_ in lens[:n]]
    keys = [fold_in(PRNGKey(5), i) for i in range(n)]
    return prompts, list(gens[:n]), keys


# ---------------------------------------------------------------------------
# pool_shape, slot allocator, decode pool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slots,buckets,gen", [(4, (32,), 8), (1, (16, 64), 1), (8, (32, 128, 64), 16)])
def test_pool_shape_matches_reference(slots, buckets, gen):
    assert bucketing.pool_shape(slots, buckets, gen) == jbucketing.pool_shape(slots, buckets, gen)


@pytest.mark.parametrize("slots,gen", [(0, 8), (4, 0)])
def test_pool_shape_rejects_what_reference_rejects(slots, gen):
    with pytest.raises(ValueError):
        jbucketing.pool_shape(slots, (32,), gen)
    with pytest.raises(ValueError):
        bucketing.pool_shape(slots, (32,), gen)


@settings(max_examples=30, deadline=None)
@given(n_slots=st.integers(1, 8), seed=st.integers(0, 2**16))
def test_slot_allocator_property(n_slots, seed):
    """Random take/release traffic: no slot is handed out while held, only
    held slots release, free + held always cover the pool, and the port
    hands out the reference allocator's slots."""
    rng = np.random.default_rng(seed)
    alloc, jalloc = SlotAllocator(n_slots), JSlotAllocator(n_slots)
    held = {}  # slot -> owning uid
    uid = 0
    for _ in range(200):
        if rng.random() < 0.55 and alloc.n_free:
            k = int(rng.integers(1, alloc.n_free + 1))
            got = alloc.take(k)
            assert got == jalloc.take(k)
            assert len(got) == len(set(got)) == k
            assert not set(got) & set(held)
            for s in got:
                assert 0 <= s < n_slots
                held[s] = uid
                uid += 1
        elif held:
            s = int(rng.choice(sorted(held)))
            alloc.release(s)
            jalloc.release(s)
            del held[s]
        assert alloc.n_free + len(held) == n_slots == alloc.n_free + alloc.n_held
        assert alloc.held() == set(held)
    with pytest.raises(ValueError):
        alloc.take(alloc.n_free + 1)
    if held:
        s = next(iter(held))
        alloc.release(s)
        with pytest.raises(ValueError, match="not held"):
            alloc.release(s)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**16))
def test_pool_reuse_never_aliases_rows_or_keys(seed):
    """Retire -> admit slot reuse: an active slot always carries its own
    request's token, position, length and key; a free slot is an inert
    length-0 row at position 0 with key (0, 0)."""
    rng = np.random.default_rng(seed)
    pool = DecodePool(tier=1, slots=4, cache_len=40, cache=None)
    uid, live = 0, {}
    for _ in range(60):
        if rng.random() < 0.5 and pool.n_free:
            (s,) = pool.take(1)
            req = Request(uid=uid, tokens=np.arange(1 + uid % 7, dtype=np.int32), max_new_tokens=4)
            pool.activate(s, req, first_token=100 + uid, key_row=[uid, uid ^ 0xFF])
            live[s] = uid
            uid += 1
        elif live:
            s = int(rng.choice(sorted(live)))
            assert pool.retire(s).request.uid == live.pop(s)
        assert set(pool.active_slots()) == set(live)
        for s, u in live.items():
            assert pool.record(s).request.uid == u
            assert pool.tok[s] == 100 + u and pool.pos[s] == pool.lengths[s] == 1 + u % 7
            np.testing.assert_array_equal(pool.keys[s], [u, u ^ 0xFF])
        for s in set(range(4)) - set(live):
            assert pool.lengths[s] == pool.pos[s] == 0 and not pool.keys[s].any()


# ---------------------------------------------------------------------------
# scheduler: slot-aware admission, case by case against the reference
# ---------------------------------------------------------------------------


def _schedulers(max_wait, seq_buckets):
    return (TierScheduler(max_batch=4, max_wait=max_wait, seq_buckets=seq_buckets),
            JTierScheduler(max_batch=4, max_wait=max_wait, seq_buckets=seq_buckets))


def _submit(scheds, uid, length, tier, arrival=0.0):
    port, ref = scheds
    port.submit(Request(uid=uid, tokens=np.zeros(length, np.int32), tier=tier, arrival=arrival))
    jreq = JRequest(uid=uid, tokens=np.zeros(length, np.int32), arrival=arrival)
    jreq.retier(tier)
    ref.submit(jreq)


def _admit(scheds, now, free, force=False):
    port, ref = scheds
    jfree = dict(free)
    got = [[r.uid for r in b] for b in port.pop_admissible(now, free, force=force)]
    assert got == [[r.uid for r in b] for b in ref.pop_admissible(now, jfree, force=force)]
    assert free == jfree and port.n_pending == ref.n_pending
    return got


def test_pop_admissible_caps_at_free_slots():
    scheds = _schedulers(10.0, (32,))
    for uid in range(6):
        _submit(scheds, uid, 8, 1)
    free = {1: 3}
    assert _admit(scheds, 0.0, free, force=True) == [[0, 1, 2]]
    assert free[1] == 0 and scheds[0].n_pending == 3
    assert _admit(scheds, 0.0, {1: 0}, force=True) == []  # the pool is full
    assert _admit(scheds, 0.0, {1: 6}, force=True) == [[3, 4, 5]]
    assert scheds[0].n_pending == 0


def test_pop_admissible_deadline_over_partial_pool():
    scheds = _schedulers(5.0, (32,))
    for uid in range(2):
        _submit(scheds, uid, 8, "edge")
    assert _admit(scheds, 4.9, {"edge": 4}) == []  # not full, not aged
    assert _admit(scheds, 5.0, {"edge": 1}) == [[0]]  # aged: what fits now
    assert scheds[0].pending_tiers() == scheds[1].pending_tiers() == {"edge"}


def test_pop_admissible_shares_tier_slots_across_seq_buckets():
    scheds = _schedulers(10.0, (16, 32))
    for uid, length in enumerate((8, 8, 30, 30)):
        _submit(scheds, uid, length, 1)
    _submit(scheds, 4, 8, "lop")
    free = {1: 3, "lop": 2}
    assert _admit(scheds, 0.0, free, force=True) == [[0, 1], [2], [4]]
    assert free == {1: 0, "lop": 1} and scheds[0].n_pending == 1


# ---------------------------------------------------------------------------
# scatter_cache_rows
# ---------------------------------------------------------------------------


def test_scatter_cache_rows_places_and_drops():
    slots, bb, cache_len = 4, 3, 12
    dst = lm.init_cache(CFG, slots, cache_len, device="cpu")
    src = lm.init_cache(CFG, bb, cache_len, device="cpu")
    for name in ("k", "v"):
        for r in range(bb):
            src["groups"][name][:, :, r] = r + 1
    ids = np.asarray([2, slots, 0], np.int32)  # row 1 is batch padding: dropped
    out = lm.scatter_cache_rows(CFG, dst, src, ids)
    assert out is dst  # in place
    jdst, jsrc = jlm.init_cache(JCFG, slots, cache_len), jax.tree.map(jnp.asarray, {
        "groups": {n: src["groups"][n].numpy() for n in ("k", "v")}})
    jout = jlm.scatter_cache_rows(JCFG, jdst, jsrc, jnp.asarray(ids))
    for name in ("k", "v"):
        leaf = dst["groups"][name]  # (L, 1, slots, S, KH, hd)
        assert (leaf[:, :, 2] == 1).all() and (leaf[:, :, 0] == 3).all()
        assert (leaf[:, :, [1, 3]] == 0).all()
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jout["groups"][name]))
    lm.scatter_cache_rows(CFG, dst, src, np.full((bb,), slots))  # all dropped: a no-op
    np.testing.assert_array_equal(dst["groups"]["k"].numpy(), np.asarray(jout["groups"]["k"]))


# ---------------------------------------------------------------------------
# the continuous engine against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("analog", [False, True], ids=["digital", "analog-K2"])
def test_continuous_tokens_equal_reference_engine(model, analog):
    prompts, gens, _ = _requests()
    extra = dict(analog_cfg=JAnalogConfig.shot(backend="tile"), energies=model["jenergies"]) \
        if analog else {}
    jeng = JServingEngine(model["jparams"], JCFG, **extra, **ENGINE_KW, continuous=True,
                          pool_slots=2)
    eng = _engine(model, analog=analog)
    for p, g in zip(prompts, gens):
        assert jeng.submit(p, n_repeats=2, max_new_tokens=g, now=0.0) == \
            eng.submit(p, n_repeats=2, max_new_tokens=g, now=0.0)
    want, got = jeng.flush(), eng.flush()
    assert sorted(want) == sorted(got)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]))
    for stat in ("requests", "batches", "tokens_generated", "padded_rows", "decode_steps",
                 "decode_slot_steps", "active_slot_steps", "admitted", "retired"):
        assert eng.stats[stat] == jeng.stats[stat], stat
    assert set(eng.pools) == set(jeng.pools)


def test_continuous_profile_tier_equals_reference_engine(model):
    prompts, gens, _ = _requests()
    jeng = JServingEngine(model["jparams"], JCFG, analog_cfg=JAnalogConfig.shot(backend="tile"),
                          energies=model["jenergies"], **ENGINE_KW, continuous=True, pool_slots=2,
                          profiles=[JPrecisionProfile((2, 1), name="lop")])
    eng = _engine(model, profiles=[PrecisionProfile((2, 1), name="lop")])
    for p, g in zip(prompts, gens):
        jeng.submit(p, profile="lop", max_new_tokens=g, now=0.0)
        eng.submit(p, profile="lop", max_new_tokens=g, now=0.0)
    want, got = jeng.flush(), eng.flush()
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]))


# ---------------------------------------------------------------------------
# inside the port: pooled == sync == solo, pools, retirement
# ---------------------------------------------------------------------------


def test_pooled_equals_sync_equals_solo_bit_exact(model):
    """Three requests through a 2-slot pool (the third admitted mid-flight
    into a retired slot) give the batch-synchronous engine's tokens, and
    each one re-run alone through the same pool gives the same bits."""
    prompts, gens, keys = _requests()
    pooled_eng = _engine(model)
    uids = [pooled_eng.submit(p, n_repeats=2, max_new_tokens=g, key=k, now=0.0)
            for p, g, k in zip(prompts, gens, keys)]
    pooled = pooled_eng.flush()
    assert pooled_eng.stats["admitted"] == 3 and pooled_eng.stats["retired"] == 3
    sync_eng = _engine(model, continuous=False)
    sync_uids = [sync_eng.submit(p, n_repeats=2, max_new_tokens=g, key=k, now=0.0)
                 for p, g, k in zip(prompts, gens, keys)]
    sync = sync_eng.flush()
    for pu, su, g in zip(uids, sync_uids, gens):
        assert pooled[pu].shape == (g,)
        np.testing.assert_array_equal(pooled[pu], sync[su])
    for pu, p, g, k in zip(uids, prompts, gens, keys):
        solo = pooled_eng.submit(p, n_repeats=2, max_new_tokens=g, key=k, now=0.0)
        np.testing.assert_array_equal(pooled_eng.flush()[solo], pooled[pu])


def test_profile_and_uniform_pools_coexist(model):
    profile = PrecisionProfile((2, 1), name="lop")
    prompts, gens, keys = _requests()
    tiers = [{"profile": profile}, {"n_repeats": 2}, {"profile": "lop"}]
    out = {}
    for continuous in (True, False):
        eng = _engine(model, continuous=continuous, profiles=[profile])
        uids = [eng.submit(p, max_new_tokens=g, key=k, now=0.0, **t)
                for p, g, k, t in zip(prompts, gens, keys, tiers)]
        done = eng.flush()
        out[continuous] = [done[u] for u in uids]
        if continuous:
            assert set(eng.pools) == {"lop", 2}  # one persistent pool per tier
            assert set(eng.stats["tier_tokens"]) == {"lop", 2}
    for a, b in zip(out[True], out[False]):
        np.testing.assert_array_equal(a, b)


def test_continuous_uses_fewer_decode_slot_steps(model):
    """Mixed budgets: the pool dispatches less decode work (row-slots) than
    batch-synchronous batches of the same traffic, with the same tokens."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, CFG.vocab_size, n).astype(np.int32) for n in rng.integers(4, SB + 1, 8)]
    gens = [2, 2, 8, 2, 4, 2, 8, 2]
    keys = [fold_in(PRNGKey(11), i) for i in range(8)]
    outputs, slot_steps = {}, {}
    for continuous in (False, True):
        eng = _engine(model, analog=False, continuous=continuous, pool_slots=4, max_batch=8,
                      batch_buckets=(1, 2, 4, 8))
        uids = [eng.submit(p, max_new_tokens=g, key=k, now=0.0) for p, g, k in zip(prompts, gens, keys)]
        done = eng.flush()
        outputs[continuous] = [done[u] for u in uids]
        slot_steps[continuous] = eng.stats["decode_slot_steps"]
        if continuous:
            assert eng.stats["active_slot_steps"] == sum(g - 1 for g in gens)
    for a, b in zip(outputs[False], outputs[True]):
        np.testing.assert_array_equal(a, b)
    assert slot_steps[True] < slot_steps[False], slot_steps


def test_pump_step_drains_incrementally(model):
    prompts, gens, keys = _requests()
    with pytest.raises(ValueError, match="continuous"):
        _engine(model, continuous=False).pump_step()
    eng = _engine(model)
    uids = [eng.submit(p, n_repeats=2, max_new_tokens=g, key=k, now=0.0)
            for p, g, k in zip(prompts, gens, keys)]
    assert eng.n_in_flight == 3
    results, steps = {}, 0
    while eng.n_in_flight:
        results.update(eng.pump_step(now=1.0, force=True))
        steps += 1
        assert steps < 50
    assert set(results) == set(uids) and steps > 1
    sync_eng = _engine(model, continuous=False)
    for p, g, k in zip(prompts, gens, keys):
        sync_eng.submit(p, n_repeats=2, max_new_tokens=g, key=k, now=0.0)
    sync = sync_eng.flush()
    for u in uids:
        np.testing.assert_array_equal(results[u], sync[u])


def test_poll_admits_by_readiness(model):
    prompts, gens, _ = _requests()
    eng = _engine(model, max_wait=1.0)
    uids = [eng.submit(p, max_new_tokens=g, now=0.0) for p, g in zip(prompts, gens)]
    assert eng.poll(now=0.5) == {}  # nothing aged, no group full
    assert eng.n_in_flight == 3
    assert set(eng.poll(now=1.0)) == set(uids)  # aged: admitted and drained
    assert eng.n_in_flight == 0


@pytest.mark.parametrize("continuous", [False, True])
def test_stop_tokens_retire_early(model, continuous):
    prompts, _, keys = _requests()
    eng = _engine(model, continuous=continuous, pool_slots=4)
    probe = eng.submit(prompts[2], max_new_tokens=8, key=keys[2], now=0.0)
    full = eng.flush()[probe]
    stop = int(full[3])
    first = int(np.flatnonzero(full == stop)[0])
    before = eng.stats["tokens_generated"]
    u_stop = eng.submit(prompts[2], max_new_tokens=8, stop_tokens=(stop,), key=keys[2], now=0.0)
    u_free = eng.submit(prompts[2], max_new_tokens=8, key=keys[2], now=0.0)
    out = eng.flush()
    # the stop id is the last token; the twin without it runs its budget
    np.testing.assert_array_equal(out[u_stop], full[: first + 1])
    np.testing.assert_array_equal(out[u_free], full)
    assert eng.stats["tokens_generated"] - before == first + 1 + 8


def test_stop_at_first_token_and_budget_one_never_decode(model):
    prompts, _, keys = _requests()
    eng = _engine(model)
    probe = eng.submit(prompts[0], max_new_tokens=1, key=keys[0], now=0.0)
    first = int(eng.flush()[probe][0])
    u0 = eng.submit(prompts[0], max_new_tokens=8, stop_tokens=(first,), key=keys[0], now=0.0)
    u1 = eng.submit(prompts[1], max_new_tokens=1, key=keys[1], now=0.0)
    out = eng.flush()
    np.testing.assert_array_equal(out[u0], [first])
    assert out[u1].shape == (1,)
    assert eng.stats["decode_steps"] == 0  # nothing ever decoded
    assert eng.stats["admitted"] == eng.stats["retired"] == 3
    assert all(p.n_active == 0 and p.n_free == p.slots for p in eng.pools.values())


def test_pool_cache_len_override_and_fit_check(model):
    prompts, _, keys = _requests()
    with pytest.raises(ValueError, match="pool_cache_len"):
        _engine(model, pool_cache_len=SB)  # <= the smallest bucket
    eng = _engine(model, pool_cache_len=SB + 4)
    assert eng.pool_cache_len == SB + 4
    with pytest.raises(ValueError, match="decode"):
        eng.submit(prompts[0], max_new_tokens=8, now=0.0)  # 32 + 8 > 36
    assert eng.scheduler.n_pending == 0
    uid = eng.submit(prompts[0], max_new_tokens=4, key=keys[0], now=0.0)
    got = eng.flush()[uid]
    assert got.shape == (4,)
    assert eng.pools[1].cache_len == SB + 4
    assert _engine(model).pool_cache_len == SB + 8  # default: max(seq_buckets) + max_gen
