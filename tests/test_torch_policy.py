"""Port vs reference: the SLA precision governor (mirrors tests/test_policy.py).

Hysteresis and dwell, accuracy floors, shed-last ordering, the power
budget, tier reassignment in FIFO order, the bounded fault log, the
DriftEvent's clock, the drift estimate as demote pressure, the online
profile re-trim and a random load-ramp property. Held against the JAX
package on the tiny dense config (backend "tile" on both sides, same
traffic and fake clock): the governor's ``PolicyEvent`` sequence, the
tier each request was served at and its tokens are equal; the tier
table's energies agree to rtol 1e-6; the load signals, the scheduler's
moves and the online search's results are equal. The reference episodes
run once, in a module fixture, over one shared executable cache.
"""
import dataclasses
import types

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
# the suite runs as several processes on the cores (pytest-xdist): torch's
# intra-op threads in each would oversubscribe them (20x slower when six run)
torch.set_num_threads(1)


from repro.core.search import online_repeat_profile_search as j_online_search  # noqa: E402
from repro.serving import ExecutableCache as JExecutableCache  # noqa: E402
from repro.serving import MetricsFeed as JMetricsFeed  # noqa: E402
from repro.serving import PolicyConfig as JPolicyConfig  # noqa: E402
from repro.serving import QueueFull as JQueueFull  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import TierScheduler as JTierScheduler  # noqa: E402
from repro.serving import TierSpec as JTierSpec  # noqa: E402
from repro.serving import load_signals as j_load_signals  # noqa: E402
from repro_torch.core.search import online_repeat_profile_search  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    BoundedLog,
    ClusterRouter,
    MetricsFeed,
    NoiseDriftWatchdog,
    PolicyConfig,
    QueueFull,
    ReplicaCrash,
    Request,
    TierScheduler,
    TierSpec,
    WatchdogConfig,
    load_signals,
)
from repro_torch.serving.policy import TRANSITIONS  # noqa: E402
from test_torch_faults import SB, make_env, port_engine, ref_engine  # noqa: E402

ACCS = {1: 0.80, 2: 0.90, 4: 0.97}

PORT = types.SimpleNamespace(PolicyConfig=PolicyConfig, TierSpec=TierSpec,
                             MetricsFeed=MetricsFeed, QueueFull=QueueFull)
REF = types.SimpleNamespace(PolicyConfig=JPolicyConfig, TierSpec=JTierSpec,
                            MetricsFeed=JMetricsFeed, QueueFull=JQueueFull)


def _policy(ns=PORT, **kw):
    kw.setdefault("tiers", tuple(ns.TierSpec(k, a) for k, a in sorted(ACCS.items())))
    kw.setdefault("demote_at", 1.0)
    kw.setdefault("promote_at", 0.25)
    kw.setdefault("shed_at", 3.0)
    kw.setdefault("min_dwell", 2)
    return ns.PolicyConfig(**kw)


def _prompts(n, seed=3, length=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, length).astype(np.int32) for _ in range(n)]


def _drain(eng, t, dt=0.01, max_iters=400):
    results = {}
    for _ in range(max_iters):
        if not eng.n_in_flight:
            break
        t += dt
        results.update(eng.pump_step(now=t))
    assert not eng.n_in_flight, "engine failed to drain (hang)"
    return results, t


@pytest.fixture(scope="module")
def env():
    return make_env()


def _port_ns(env):
    return types.SimpleNamespace(**vars(PORT), engine=lambda **kw: port_engine(env, **kw))


def _ref_ns(env):
    """Reference engines sharing one executable cache (same weights,
    energies and shapes, no fault hook): each executable compiles once."""
    cache = JExecutableCache()

    def engine(**kw):
        eng = ref_engine(env, **kw)
        eng.exe_cache = cache
        return eng

    return types.SimpleNamespace(**vars(REF), engine=engine)


# --------------------------------------------------------------------------
# the governor episodes, run on either package
# --------------------------------------------------------------------------


def _record(eng, results):
    return dict(
        events=[dataclasses.astuple(e) for e in eng.governor.events],
        served=dict(eng.served_tiers),
        tokens={u: np.asarray(v).tolist() for u, v in results.items()},
        stats={k: eng.stats[k] for k in ("demoted", "promoted_back", "policy_transitions", "shed",
                                         "timed_out")},
        mode=eng.governor.mode,
    )


def ep_demotion(ns):
    eng = ns.engine(policy=_policy(ns, min_dwell=2))
    floors = {}
    for i, p in enumerate(_prompts(9)):
        floor = (None, 0.85, 0.95)[i % 3]
        uid = eng.submit(p, n_repeats=4, now=0.0, max_new_tokens=4, target_latency=5.0,
                         accuracy_floor=floor)
        floors[uid] = floor
    results, _t = _drain(eng, 0.0)
    return dict(_record(eng, results), floors=floors)


def ep_promote_back(ns):
    eng = ns.engine(policy=_policy(ns, demote_at=2.0, promote_at=1.75, shed_at=4.0, min_dwell=1))
    uids = [eng.submit(p, n_repeats=4, now=0.0, max_new_tokens=4) for p in _prompts(6)]
    results, _t = _drain(eng, 0.0)
    return dict(_record(eng, results), uids=uids)


def ep_shedding(ns):
    eng = ns.engine(policy=_policy(ns, demote_at=1.0, promote_at=0.25, shed_at=2.0, min_dwell=1))
    uids = [eng.submit(p, n_repeats=4, now=0.0, max_new_tokens=4, accuracy_floor=ACCS[4])
            for p in _prompts(8)]
    eng.pump_step(now=0.01)
    eng.pump_step(now=0.02)
    kinds_before = [e.kind for e in eng.governor.events]
    shedding = eng.governor.shedding
    with pytest.raises(ns.QueueFull, match="shedding"):
        eng.submit(_prompts(1, seed=9)[0], n_repeats=4, now=0.03)
    shed_log = [e for e in eng.fault_log if e["kind"] == "shed"]
    results, t = _drain(eng, 0.03)
    for _ in range(6):
        t += 0.01
        eng.pump_step(now=t)
    uid = eng.submit(_prompts(1, seed=11)[0], n_repeats=4, now=t)
    res, _t = _drain(eng, t)
    results.update(res)
    return dict(_record(eng, results), uids=uids, late=uid, kinds_before=kinds_before,
                shedding=shedding, shed_log=shed_log)


def ep_power_budget(ns):
    probe = ns.engine(policy=_policy(ns))
    energy = {t: e for e, _a, t in probe.governor.tiers}
    eng = ns.engine(policy=_policy(ns, demote_at=50.0, promote_at=0.25, shed_at=50.0, min_dwell=1,
                                      power_budget_aj=(energy[1] + energy[4]) / 2))
    uid = eng.submit(_prompts(1)[0], n_repeats=4, now=0.0, max_new_tokens=4)
    eng.pump_step(now=0.01)
    results, t = _drain(eng, 0.01)
    for _ in range(4):
        t += 0.01
        eng.pump_step(now=t)
    return dict(_record(eng, results), uid=uid, table=probe.governor.tiers)


def ep_drift(ns):
    feed = ns.MetricsFeed(capacity=64)
    eng = ns.engine(metrics=feed, policy=_policy(
        ns, demote_at=50.0, promote_at=0.25, shed_at=60.0, min_dwell=1,
        drift_band=(0.8, 1.25), drift_patience=2))
    modes = []
    eng.pump_step(now=0.01)
    feed.note_drift(1.05)
    eng.pump_step(now=0.02)
    modes.append((eng.governor.mode, len(eng.governor.events)))
    feed.note_drift(1.6)
    eng.pump_step(now=0.03)
    modes.append((eng.governor.mode, len(eng.governor.events)))
    eng.pump_step(now=0.04)
    modes.append((eng.governor.mode, len(eng.governor.events)))
    uid = eng.submit(_prompts(1)[0], n_repeats=4, now=0.05, max_new_tokens=4)
    results, t = _drain(eng, 0.05)
    for _ in range(4):
        t += 0.01
        eng.pump_step(now=t)
    modes.append((eng.governor.mode, len(eng.governor.events)))
    feed.note_drift(1.0)
    t += 0.01
    eng.pump_step(now=t)
    modes.append((eng.governor.mode, len(eng.governor.events)))
    return dict(_record(eng, results), uid=uid, modes=modes)


EPISODES = dict(demotion=ep_demotion, promote_back=ep_promote_back, shedding=ep_shedding,
                power_budget=ep_power_budget, drift=ep_drift)


@pytest.fixture(scope="module")
def ref(env):
    ns = _ref_ns(env)
    return {name: ep(ns) for name, ep in EPISODES.items()}


def _port_episode(env, ref, name):
    got = EPISODES[name](_port_ns(env))
    want = ref[name]
    assert got["events"] == want["events"]  # the governor's PolicyEvent sequence
    assert got["served"] == want["served"]
    assert got["tokens"] == want["tokens"]
    assert got["stats"] == want["stats"]
    return got


# --------------------------------------------------------------------------
# config validation + governor construction
# --------------------------------------------------------------------------


def test_policy_config_validation():
    with pytest.raises(ValueError, match="at least one tier"):
        PolicyConfig(tiers=())
    with pytest.raises(ValueError, match="hysteresis"):
        _policy(demote_at=0.5, promote_at=0.5)
    with pytest.raises(ValueError, match="hysteresis"):
        _policy(shed_at=0.5)
    with pytest.raises(ValueError, match="min_dwell"):
        _policy(min_dwell=0)
    with pytest.raises(ValueError, match="power_budget"):
        _policy(power_budget_aj=0.0)
    with pytest.raises(ValueError, match="urgency_weight"):
        _policy(urgency_weight=-1.0)
    with pytest.raises(ValueError, match="drift_band"):
        _policy(drift_band=(1.1, 1.4))
    with pytest.raises(ValueError, match="drift_patience"):
        _policy(drift_band=(0.8, 1.25), drift_patience=0)
    cfg = PolicyConfig(tiers=(1, TierSpec(2, 0.9)))
    assert all(isinstance(t, TierSpec) for t in cfg.tiers)


def test_governor_requires_analog_and_metadata(env):
    with pytest.raises(ValueError, match="analog"):
        port_engine(env, analog=False, policy=_policy())
    with pytest.raises(ValueError, match="accuracy metadata"):
        port_engine(env, policy=_policy(tiers=(TierSpec(1), TierSpec(4, 0.97))))
    with pytest.raises(ValueError, match="registered profile"):
        port_engine(env, policy=_policy(tiers=(TierSpec("ghost", 0.9),)))


def test_governor_ladder_sorted_by_energy(env):
    eng = port_engine(env, policy=_policy())
    energies = [e for e, _a, _t in eng.governor.tiers]
    assert energies == sorted(energies)
    assert [t for _e, _a, t in eng.governor.tiers] == [1, 2, 4]
    assert eng.governor.tier_accuracy(2) == ACCS[2]
    with pytest.raises(ValueError, match="not in the policy table"):
        eng.governor.tier_accuracy(8)
    jtable = ref_engine(env, policy=_policy(REF)).governor.tiers
    assert [(a, t) for _e, a, t in eng.governor.tiers] == [(a, t) for _e, a, t in jtable]
    np.testing.assert_allclose(energies, [e for e, _a, _t in jtable], rtol=1e-6)


def _ladder_ids(eng, ns_digital, ns_profile):
    """The registry's ladder, drift exemption and promotions with a learned
    profile (accuracy 0.93) and a digital tier registered."""
    eng.register_tier(ns_digital)
    eng.register_profile(ns_profile((1, 4), name="learned", accuracy=0.93))
    eng.register_profile(ns_profile((1, 2), name="raw"))
    t = eng.tiers
    return dict(
        ladder=[x.tier_id for x in t.ladder()], exempt=t.drift_exempt_ids(),
        promote={k: t.get(k).promote() for k in (1, 2, 4, "learned", "raw", "bf16")},
        drift={k: t.drift_promote(k) for k in (1, 2, 4, "learned", "bf16")},
        retrim=t.profiles["raw+retrim"].repeats,
    )


def test_registry_ladder_promotion_and_drift_exemption(env):
    from repro.core.profile import PrecisionProfile as JPrecisionProfile
    from repro.serving import DigitalTier as JDigitalTier
    from repro_torch.core.profile import PrecisionProfile
    from repro_torch.serving import DigitalTier

    eng = port_engine(env)
    for k, a in ACCS.items():
        eng.tiers.get(k).accuracy = a
    got = _ladder_ids(eng, DigitalTier(eng, "bf16"), PrecisionProfile)
    assert got["ladder"] == [1, 2, "learned", 4, "bf16"]
    assert got["exempt"] == ["bf16"]
    assert got["promote"] == {1: 2, 2: 4, 4: 4, "learned": 4, "raw": "raw+retrim", "bf16": "bf16"}
    assert got["drift"] == {1: 2, 2: 4, 4: 4, "learned": "learned", "bf16": "bf16"}
    jeng = ref_engine(env)
    for k, a in ACCS.items():
        jeng.tiers.get(k).accuracy = a
    assert got == _ladder_ids(jeng, JDigitalTier("bf16"), JPrecisionProfile)


# --------------------------------------------------------------------------
# bounded fault log + attributable events
# --------------------------------------------------------------------------


def test_bounded_log_is_a_list_with_a_ring_bound():
    log = BoundedLog(maxlen=3)
    assert log == []
    for i in range(7):
        log.append(i)
    assert list(log) == [4, 5, 6] and log.dropped == 4
    assert BoundedLog(maxlen=None).maxlen is None
    with pytest.raises(ValueError, match="maxlen"):
        BoundedLog(maxlen=0)


def test_engine_fault_log_bound_and_dropped_stat(env):
    eng = port_engine(env, fault_log_maxlen=4)
    for i in range(10):
        eng.fault_log.append({"kind": "synthetic", "i": i})
    assert len(eng.fault_log) == 4
    assert [e["i"] for e in eng.fault_log] == [6, 7, 8, 9]
    assert eng.stats["dropped_events"] == 6


def test_drift_event_carries_clock_and_measurement(env):
    eng = port_engine(env)
    eng._fault_clock = 17  # as if decode steps had already run
    eng.set_noise_scale(3.0)
    wd = NoiseDriftWatchdog(eng, np.zeros((1, 8), np.int32),
                            config=WatchdogConfig(interval=1, n_samples=2, band=(0.7, 1.4)))
    event = wd.probe(step=0)
    assert event is not None and event.estimate > 1.4
    assert event.clock == 17
    assert event.residual_rms > 0.0


# --------------------------------------------------------------------------
# scheduler: tier reassignment
# --------------------------------------------------------------------------


def _sched_moves(sched_cls, req_cls, tier_kw):
    sched = sched_cls(max_batch=4, max_wait=0.0, seq_buckets=(SB,))
    for uid in range(6):
        sched.submit(req_cls(uid=uid, tokens=np.zeros(8, np.int32), arrival=float(uid % 3),
                             **{tier_kw: 4}))
    moved = sched.reassign(lambda r: 1 if r.uid % 2 == 0 else None)
    back = sched.reassign(lambda r: "prof-x" if r.tier == 1 else None)
    return sched, [(r.uid, o, n) for r, o, n in moved], [(r.uid, o, n) for r, o, n in back]


def test_reassign_moves_tiers_and_preserves_fifo():
    sched = TierScheduler(max_batch=4, max_wait=0.0, seq_buckets=(SB,))
    for uid in range(6):
        sched.submit(Request(uid=uid, tokens=np.zeros(8, np.int32), tier=4,
                             arrival=float(uid % 3)))
    moved = sched.reassign(lambda r: 1 if r.uid % 2 == 0 else None)
    assert [(r.uid, old, new) for r, old, new in moved] == [(0, 4, 1), (2, 4, 1), (4, 4, 1)]
    assert {r.uid: r.tier for r in sched.queued_requests()} == {0: 1, 1: 4, 2: 1, 3: 4, 4: 1, 5: 4}
    q1 = [r.uid for r in sched.queued_requests() if r.tier == 1]
    assert q1 == sorted(q1, key=lambda u: (float(u % 3), u))
    assert sched.reassign(lambda r: r.tier) == []
    back = sched.reassign(lambda r: "prof-x" if r.tier == 1 else None)
    assert len(back) == 3
    assert all(r.tier == "prof-x" for r, _o, _n in back)
    # the reference scheduler makes the same moves in the same order
    port, pm, pb = _sched_moves(TierScheduler, Request, "tier")
    jsched, jm, jb = _sched_moves(JTierScheduler, JRequest, "n_repeats")
    assert (pm, pb) == (jm, jb)
    assert [(r.uid, r.tier) for r in port.queued_requests()] == \
        [(r.uid, r.tier) for r in jsched.queued_requests()]


def test_cross_engine_redispatch_preserves_fifo(env):
    """A dead replica's journal replays onto the survivor's tier queue in
    (arrival, cuid) order."""
    cluster = ClusterRouter(
        [port_engine(env), port_engine(env)],
        suspect_after=1, dead_after=3, backoff_rounds=0, backoff_jitter=0,
        faults=(ReplicaCrash(replica=0, at=1),),
    )
    for i, p in enumerate(_prompts(8, seed=5)):
        cluster.submit(p, tier=4, now=0.001 * i)
    t = 0.01
    results = {}
    for _ in range(10):
        results.update(cluster.pump_step(now=t))
        if cluster.health[0] == "dead":
            break
        t += 0.01
    assert cluster.health[0] == "dead" and cluster.stats["failed_over"] > 0
    survivor = cluster.replicas[1]
    orphans = {c for c, e in cluster.journal.items() if e.failed_over and not e.done}
    queued = [survivor.uids[r.uid] for r in survivor.engine.scheduler.queued_requests()
              if survivor.uids.get(r.uid) in orphans]
    assert len(queued) == len(orphans) > 0
    assert queued == sorted(queued, key=lambda c: (cluster.journal[c].arrival, c))
    for _ in range(400):
        if not cluster.n_in_flight:
            break
        t += 0.01
        results.update(cluster.pump_step(now=t))
    assert set(results) == set(range(8))
    assert cluster.stats["prefix_mismatches"] == 0


# --------------------------------------------------------------------------
# monitor: load / headroom signals
# --------------------------------------------------------------------------


def _load_traffic(eng):
    for p in _prompts(3):
        eng.submit(p, n_repeats=4, now=0.0, target_latency=1.0)
    eng.submit(_prompts(1)[0], n_repeats=4, now=0.0)  # no SLO
    return eng


def test_load_signals_counts_queue_and_urgency(env):
    eng = _load_traffic(port_engine(env))
    sig = load_signals(eng, now=0.6)
    assert sig.queue_depth == 4
    assert sig.queue_pressure == pytest.approx(4 / 2)
    assert sig.urgent_frac == pytest.approx(1.0)
    assert sig.min_slack == pytest.approx(0.4)
    assert sig.active == 0 and sig.occupancy == 0.0
    assert load_signals(eng, now=0.1).urgent_frac == 0.0
    jeng = _load_traffic(ref_engine(env))
    for now in (0.1, 0.6):
        assert dataclasses.asdict(load_signals(eng, now=now)) == \
            dataclasses.asdict(j_load_signals(jeng, now=now))


# --------------------------------------------------------------------------
# submit: SLO plumbing
# --------------------------------------------------------------------------


def test_submit_slo_validation_and_conversion(env):
    eng = port_engine(env, policy=_policy())
    with pytest.raises(ValueError, match="target_latency"):
        eng.submit(_prompts(1)[0], now=0.0, target_latency=0.0)
    with pytest.raises(ValueError, match="not both"):
        eng.submit(_prompts(1)[0], now=0.0, accuracy_floor=0.9, max_degradation=0.05)
    eng.submit(_prompts(1)[0], n_repeats=4, now=0.0, max_degradation=0.05)
    (r,) = eng.scheduler.queued_requests()
    assert r.accuracy_floor == pytest.approx(ACCS[4] - 0.05)
    eng.submit(_prompts(1)[0], n_repeats=4, now=1.0, target_latency=2.5)
    r2 = eng.scheduler.queued_requests()[-1]
    assert r2.deadline == pytest.approx(3.5)
    assert r2.target_latency == pytest.approx(2.5)
    eng.submit(_prompts(1)[0], now=1.0, target_latency=2.5, deadline=9.0)
    assert eng.scheduler.queued_requests()[-1].deadline == 9.0


def test_max_degradation_needs_a_governor(env):
    with pytest.raises(ValueError, match="governor"):
        port_engine(env).submit(_prompts(1)[0], now=0.0, max_degradation=0.05)


# --------------------------------------------------------------------------
# the governor episodes, held against the reference
# --------------------------------------------------------------------------


def test_demotion_respects_floors_and_recovers(env, ref):
    got = _port_episode(env, ref, "demotion")
    floors = got["floors"]
    assert set(got["tokens"]) == set(floors)
    kinds = [e[0] for e in got["events"]]
    assert "demote" in kinds and "promote" in kinds
    assert got["mode"] == "nominal" and got["stats"]["demoted"] > 0
    for uid, floor in floors.items():
        if floor is not None:
            assert ACCS[got["served"][uid]] >= floor, (uid, floor)
    assert any(got["served"][u] == 1 for u, f in floors.items() if f is None)
    assert all(got["served"][u] == 4 for u, f in floors.items() if f == 0.95)
    assert got["stats"]["timed_out"] == 0


def test_promote_back_restores_original_tier(env, ref):
    got = _port_episode(env, ref, "promote_back")
    promotes = [e for e in got["events"] if e[0] == "promote"]
    assert promotes and any(e[6] > 0 for e in promotes)  # PolicyEvent.moved
    restored = [u for e in promotes for u in e[7]]  # PolicyEvent.uids
    assert restored and all(got["served"][u] == 4 for u in restored)
    assert set(got["tokens"]) == set(got["uids"])


def test_shedding_is_the_last_rung(env, ref):
    got = _port_episode(env, ref, "shedding")
    assert got["kinds_before"][:2] == ["demote", "shed_on"]
    assert got["shedding"]
    assert got["stats"]["shed"] == 1
    assert got["shed_log"] and got["shed_log"][0]["queue_depth"] > 0
    assert got["shed_log"] == ref["shedding"]["shed_log"]
    assert got["mode"] == "nominal"
    assert set(got["tokens"]) == set(got["uids"]) | {got["late"]}
    assert all(got["served"][u] == 4 for u in got["uids"])


def test_power_budget_demotes_and_blocks_promotion(env, ref):
    got = _port_episode(env, ref, "power_budget")
    demotes = [e for e in got["events"] if e[0] == "demote"]
    assert demotes and demotes[0][8] == "power budget"  # PolicyEvent.detail
    assert got["served"][got["uid"]] == 1
    assert got["mode"] == "nominal"
    assert got["uid"] in got["tokens"]


# --------------------------------------------------------------------------
# drift estimate as a demotion / promotion signal
# --------------------------------------------------------------------------


def test_load_signals_carry_the_feed_drift_estimate(env):
    feed = MetricsFeed(capacity=8)
    eng = port_engine(env, metrics=feed)
    assert load_signals(eng, now=0.0).drift is None
    feed.note_drift(1.3)
    assert load_signals(eng, now=0.0).drift == pytest.approx(1.3)
    feed.note_drift(None)
    assert load_signals(eng, now=0.0).drift is None
    assert load_signals(port_engine(env), now=0.0).drift is None


def test_drift_excursion_demotes_and_blocks_promotion(env, ref):
    got = _port_episode(env, ref, "drift")
    assert got["modes"] == [("nominal", 0), ("nominal", 0), ("demoted", 1), ("demoted", 2),
                            ("nominal", 3)]
    kinds = [e[0] for e in got["events"]]
    assert got["events"][0][8] == "drift"
    assert got["served"][got["uid"]] == 1
    assert kinds[0] == "demote" and kinds[-1] == "promote" and "retier" in kinds


# --------------------------------------------------------------------------
# core/search.py: online re-trim between serving epochs
# --------------------------------------------------------------------------


def _acc_by_total(reps):
    return sum(reps) / 10.0


def _online(fn, acc_fn, **kw):
    res = fn(acc_fn, float_acc=0.6, max_degradation=0.0, k_levels=(1, 2, 4), **kw)
    return res, (tuple(res.repeats), res.feasible, res.repaired, res.n_evals, res.accuracy,
                 res.cost)


def test_online_search_descends_from_frozen():
    kw = dict(frozen=(4, 4, 4), weights=(3.0, 2.0, 1.0))
    res, got = _online(online_repeat_profile_search, _acc_by_total, **kw)
    assert res.feasible and not res.repaired
    assert sum(res.repeats) >= 6 and res.cost < 24.0
    assert res.accuracy == pytest.approx(sum(res.repeats) / 10.0)
    assert got == _online(j_online_search, _acc_by_total, **kw)[1]


def test_online_search_repairs_a_drifted_floor():
    kw = dict(frozen=(1, 1, 1), weights=(3.0, 2.0, 1.0))
    res, got = _online(online_repeat_profile_search, _acc_by_total, **kw)
    assert res.feasible and res.repaired
    assert res.repeats == (1, 1, 4)
    assert got == _online(j_online_search, _acc_by_total, **kw)[1]


def test_online_search_budget_keeps_the_vetted_profile():
    res, got = _online(online_repeat_profile_search, _acc_by_total, frozen=(1, 1, 1), max_evals=2)
    assert not res.feasible and res.repeats == (1, 1, 1)
    assert res.n_evals == 2
    assert got == _online(j_online_search, _acc_by_total, frozen=(1, 1, 1), max_evals=2)[1]
    res2, _ = _online(online_repeat_profile_search, lambda reps: 0.0, frozen=(4, 4, 4))
    assert not res2.feasible and res2.repeats == (4, 4, 4)


# --------------------------------------------------------------------------
# hypothesis property: random load ramps through the governor
# --------------------------------------------------------------------------

_RAMP = {}


def _ramp_engine():
    """One shared engine across the property's examples."""
    if not _RAMP:
        env = make_env()
        eng = port_engine(env, policy=_policy(demote_at=1.0, promote_at=0.25, shed_at=6.0,
                                              min_dwell=3))
        _RAMP.update(eng=eng, t=0.0)
    return _RAMP["eng"]


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 2**16))
def test_random_load_ramp_property(seed):
    eng = _ramp_engine()
    gov = eng.governor
    rng = np.random.default_rng(seed)
    t = _RAMP["t"]
    floors = {}
    for _tick in range(12):
        for _ in range(int(rng.integers(0, 4))):
            p = rng.integers(0, 128, 8).astype(np.int32)
            floor = (None, ACCS[2], ACCS[4])[int(rng.integers(0, 3))]
            uid = eng.submit(p, n_repeats=4, now=t, target_latency=50.0, accuracy_floor=floor,
                             max_new_tokens=int(rng.integers(1, 5)))
            floors[uid] = floor
        t += 0.01
        eng.pump_step(now=t)
    _, t = _drain(eng, t)
    for _ in range(2 * gov.config.min_dwell + 2):
        t += 0.01
        eng.pump_step(now=t)
    _RAMP["t"] = t
    assert gov.mode == "nominal" and not gov.shedding
    flips = [e for e in gov.events if e.kind in TRANSITIONS]
    for a, b in zip(flips, flips[1:]):
        assert b.step - a.step >= gov.config.min_dwell, (a, b)
    for uid, floor in floors.items():
        if floor is not None:
            assert ACCS[eng.served_tiers[uid]] >= floor, (uid, floor)
    for e in gov.events:
        assert e.clock >= 0 and e.pressure >= 0.0
