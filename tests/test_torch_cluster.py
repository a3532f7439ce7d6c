"""Port vs reference: the replicated serving cluster (mirrors
tests/test_cluster.py).

Router validation, healthy routing, crash failover with bit-identical
re-dispatch, hang suspect/recover hysteresis, degraded-replica
quarantine, hedged dispatch and cancellation, the engine's ``cancel``,
the MetricsFeed's ``replica_id``/``heartbeat_step`` schema and the
cluster power-budget governor. Held against the JAX package on the tiny
dense config (backend "tile" on both sides, same fault schedule and fake
clock): the cluster's event log, its stats, the replicas' health and
every request's tokens are equal, the degraded-replica quarantine
included; cluster keys are ``fold_in(PRNGKey(seed), cuid)`` in both.
The replicas of a port cluster share one set of weight tensors. The
reference episodes run once, in a module fixture, over one shared
executable cache.
"""
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs as several processes on the cores (pytest-xdist): torch's
# intra-op threads in each would oversubscribe them (20x slower when six run)
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.serving import ClusterRouter as JClusterRouter  # noqa: E402
from repro.serving import ExecutableCache as JExecutableCache  # noqa: E402
from repro.serving import ReplicaCrash as JReplicaCrash  # noqa: E402
from repro.serving import ReplicaDegraded as JReplicaDegraded  # noqa: E402
from repro.serving import ReplicaHang as JReplicaHang  # noqa: E402
from repro.serving import RequestFailure as JRequestFailure  # noqa: E402
from repro_torch.kernels.prng import PRNGKey, fold_in  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ClusterRouter,
    Failed,
    MetricsFeed,
    ReplicaCrash,
    ReplicaDegraded,
    ReplicaHang,
    RequestFailure,
    ServingEngine,
)
from repro_torch.serving.cluster import DEAD, DEGRADED, HEALTHY, SUSPECT  # noqa: E402
from test_torch_faults import SB, make_env, port_engine, ref_engine  # noqa: E402
from test_torch_policy import PORT, REF, _policy, _prompts  # noqa: E402

PORT_C = types.SimpleNamespace(**vars(PORT), ClusterRouter=ClusterRouter, Crash=ReplicaCrash,
                               Hang=ReplicaHang, Degraded=ReplicaDegraded,
                               Failure=RequestFailure)
REF_C = types.SimpleNamespace(**vars(REF), ClusterRouter=JClusterRouter, Crash=JReplicaCrash,
                              Hang=JReplicaHang, Degraded=JReplicaDegraded,
                              Failure=JRequestFailure)


@pytest.fixture(scope="module")
def env():
    return make_env()


def _port_ns(env):
    return types.SimpleNamespace(**vars(PORT_C),
                                 engine=lambda **kw: port_engine(env, **dict(kw, max_gen=6)))


def _ref_ns(env):
    """Reference engines sharing one executable cache (same weights,
    energies and shapes, no fault hook): each executable compiles once."""
    cache = JExecutableCache()

    def engine(**kw):
        eng = ref_engine(env, **dict(kw, max_gen=6))
        eng.exe_cache = cache
        return eng

    return types.SimpleNamespace(**vars(REF_C), engine=engine)


def _cluster(ns, n=2, *, pool_slots=2, policy=None, **kw):
    kw.setdefault("backoff_jitter", 0)  # deterministic retry rounds
    engines = [ns.engine(pool_slots=pool_slots, policy=policy) for _ in range(n)]
    return ns.ClusterRouter(engines, **kw)


def _entries(n, seed=3):
    tiers = (1, 2, 4)
    return [(p, tiers[i % 3]) for i, p in enumerate(_prompts(n, seed=seed))]


def _solo_reference(env, entries, *, seed=0, cuids=None):
    """The same (prompt, tier) list on one port engine under the router's
    keys: a cluster request's tokens must equal these, whatever replica
    served it."""
    eng = port_engine(env, max_gen=6)
    base = PRNGKey(seed)
    uid_to_cuid = {}
    for i, (prompt, tier) in enumerate(entries):
        cuid = i if cuids is None else cuids[i]
        uid_to_cuid[eng.submit(prompt, tier=tier, now=0.0, key=fold_in(base, cuid))] = cuid
    results, t = {}, 0.0
    for _ in range(400):
        if not eng.n_in_flight:
            break
        t += 0.01
        results.update(eng.pump_step(now=t))
    assert not eng.n_in_flight
    return {uid_to_cuid[u]: np.asarray(v) for u, v in results.items()}


def _result(v, ns):
    if isinstance(v, ns.Failure):
        return (type(v).__name__, v.detail, np.asarray(v.tokens).tolist())
    return np.asarray(v).tolist()


JOURNAL_FIELDS = ("replica", "engine_uid", "hedge_replica", "hedge_uid", "delivered", "attempts",
                  "retry_at", "failed_over", "hedged", "done")


def _record(cluster, results, ns):
    return dict(
        results={c: _result(v, ns) for c, v in results.items()},
        events=list(cluster.events),
        stats=dict(cluster.stats),
        health=dict(cluster.health),
        dispatched=[h.dispatched for h in cluster.replicas],
        rounds=cluster.round,
        journal={c: tuple(getattr(e, f) for f in JOURNAL_FIELDS)
                 for c, e in cluster.journal.items()},
    )


# --------------------------------------------------------------------------
# the cluster episodes, run on either package
# --------------------------------------------------------------------------


def ep_healthy(ns):
    cluster = _cluster(ns, 2, seed=0)
    for prompt, tier in _entries(6):
        cluster.submit(prompt, tier=tier, now=0.0)
    results, _ = cluster.run_until_drained(0.0)
    return _record(cluster, results, ns)


def ep_crash(ns):
    cluster = _cluster(ns, 3, seed=0, suspect_after=2, dead_after=4,
                       faults=(ns.Crash(replica=0, at=2),))
    for prompt, tier in _entries(9):
        cluster.submit(prompt, tier=tier, now=0.0)
    results, _ = cluster.run_until_drained(0.0)
    return _record(cluster, results, ns)


def ep_hang(ns):
    cluster = _cluster(ns, 2, suspect_after=2, dead_after=8, recover_after=2,
                       faults=(ns.Hang(replica=1, at=1, steps=3),))
    for prompt, tier in _entries(6):
        cluster.submit(prompt, tier=tier, now=0.0)
    states, t, results = [], 0.0, {}
    for _ in range(400):
        if not cluster.n_in_flight and cluster.health[1] == HEALTHY:
            break
        t += 0.01
        results.update(cluster.pump_step(now=t))
        states.append(cluster.health[1])
    return dict(_record(cluster, results, ns), states=states)


def ep_degraded(ns):
    cluster = _cluster(ns, 2, pool_slots=1, drift_patience=2, recover_after=2,
                       faults=(ns.Degraded(replica=0, at=0, scale=2.5),))
    for prompt, tier in _entries(8):
        cluster.submit(prompt, tier=tier, now=0.0)
    results, t = cluster.run_until_drained(0.0)
    health_after = dict(cluster.health)
    before = cluster.replicas[0].dispatched
    late = [(p, 1) for p in _prompts(3, seed=11)]
    late_uids = [cluster.submit(p, tier=tr, now=t) for p, tr in late]
    late_results, t = cluster.run_until_drained(t)
    results.update(late_results)
    cluster.clear_degradation(0)
    for _ in range(6):
        t += 0.01
        cluster.pump_step(now=t)
    return dict(_record(cluster, results, ns), health_after=health_after, before=before,
                late=late, late_uids=late_uids)


def ep_hedge(ns):
    cluster = _cluster(ns, 2)
    cuid = cluster.submit(_prompts(1)[0], tier=2, now=0.0, hedge=True)
    placed = (cluster.stats["hedges"], cluster.stats["dispatches"])
    results, t = cluster.run_until_drained(0.0)
    ghosts = []
    for _ in range(5):
        t += 0.01
        ghosts.append(cluster.pump_step(now=t))
    return dict(_record(cluster, results, ns), cuid=cuid, placed=placed, ghosts=ghosts)


def ep_hedge_promoted(ns):
    cluster = _cluster(ns, 2, dead_after=3, faults=(ns.Crash(replica=0, at=1),))
    cuid = cluster.submit(_prompts(1)[0], tier=2, now=0.0, hedge=True)
    primary = cluster.journal[cuid].replica
    results, _ = cluster.run_until_drained(0.0)
    return dict(_record(cluster, results, ns), cuid=cuid, primary=primary)


def ep_governor_death(ns):
    budget = 400.0
    cluster = _cluster(ns, 2, policy=_policy(ns, power_budget_aj=budget), power_budget_aj=budget,
                       dead_after=3, faults=(ns.Crash(replica=0, at=2),))
    for prompt, tier in _entries(6):
        cluster.submit(prompt, tier=tier, now=0.0)
    cluster.pump_step(now=0.01)
    first = (cluster.stats["rebalances"], dict(cluster.governor.split),
             [h.engine.governor.power_budget_aj for h in cluster.replicas])
    results, _ = cluster.run_until_drained(0.02)
    return dict(_record(cluster, results, ns), first=first, split=dict(cluster.governor.split))


#: the episodes held against the reference
EPISODES = dict(healthy=ep_healthy, crash=ep_crash, hang=ep_hang, degraded=ep_degraded,
                hedge=ep_hedge, hedge_promoted=ep_hedge_promoted,
                governor_death=ep_governor_death)


@pytest.fixture(scope="module")
def ref(env):
    ns = _ref_ns(env)
    return {name: ep(ns) for name, ep in EPISODES.items()}


def _port_episode(env, ref, name):
    got = EPISODES[name](_port_ns(env))
    want = ref[name]
    assert got["events"] == want["events"]  # the cluster's event log
    assert got["stats"] == want["stats"]
    assert got["health"] == want["health"]
    assert got["results"] == want["results"]  # every request's tokens
    assert got["dispatched"] == want["dispatched"]
    assert got["journal"] == want["journal"]  # every request's assignment history
    assert got["rounds"] == want["rounds"]
    return got


def _assert_solo(env, results, entries, cuids=None):
    ref = _solo_reference(env, entries, seed=0, cuids=cuids)
    for cuid, toks in ref.items():
        assert results[cuid] == toks.tolist()


# --------------------------------------------------------------------------
# validation
# --------------------------------------------------------------------------


def test_cluster_validation(env):
    ns = _port_ns(env)
    with pytest.raises(ValueError, match="at least one"):
        ClusterRouter([])
    batch_eng = ServingEngine(env["params"], port_engine(env).model_cfg, max_batch=2,
                              batch_buckets=(1, 2), seq_buckets=(SB,), max_gen=4, device="cpu")
    with pytest.raises(ValueError, match="continuous"):
        ClusterRouter([batch_eng])
    with pytest.raises(ValueError, match="dead_after"):
        _cluster(ns, 1, suspect_after=3, dead_after=3)
    with pytest.raises(ValueError, match="drift_band"):
        _cluster(ns, 1, drift_band=(1.1, 1.4))
    with pytest.raises(ValueError, match="hedge_slack"):
        _cluster(ns, 1, hedge_slack=0.0)
    with pytest.raises(ValueError, match="replica 4"):
        _cluster(ns, 2, faults=(ReplicaCrash(replica=4, at=0),))
    with pytest.raises(ValueError, match="power_budget"):
        _cluster(ns, 1, power_budget_aj=0.0)


def test_replica_fault_validation():
    with pytest.raises(ValueError, match="replica"):
        ReplicaCrash(replica=-1, at=0)
    with pytest.raises(ValueError, match="round"):
        ReplicaCrash(replica=0, at=-2)
    with pytest.raises(ValueError, match="steps"):
        ReplicaHang(replica=0, at=0, steps=0)
    with pytest.raises(ValueError, match="scale"):
        ReplicaDegraded(replica=0, at=0, scale=1.0)
    with pytest.raises(ValueError, match="scale"):
        ReplicaDegraded(replica=0, at=0, scale=-0.5)


# --------------------------------------------------------------------------
# healthy routing
# --------------------------------------------------------------------------


def test_healthy_cluster_matches_solo_engine(env, ref):
    got = _port_episode(env, ref, "healthy")
    entries = _entries(6)
    assert set(got["results"]) == set(range(6))
    assert got["stats"]["delivered"] == 6 and got["stats"]["failed"] == 0
    assert got["stats"]["prefix_mismatches"] == 0
    assert got["health"] == {0: HEALTHY, 1: HEALTHY}
    assert all(d > 0 for d in got["dispatched"])
    _assert_solo(env, got["results"], entries)


def test_replicas_share_one_copy_of_the_weights(env):
    cluster = _cluster(_port_ns(env), 3)
    for h in cluster.replicas:
        assert h.engine.params is env["params"]
    cluster.submit(_prompts(1)[0], tier=2, now=0.0)
    before = {k: v.clone() for k, v in env["params"]["blocks"]["attn0"].items()}
    cluster.run_until_drained(0.0)
    for k, v in env["params"]["blocks"]["attn0"].items():
        assert torch.equal(v, before[k])  # serving never writes the shared weights


def test_results_land_in_router_results_map(env):
    cluster = _cluster(_port_ns(env), 2)
    cuid = cluster.submit(_prompts(1)[0], tier=2, now=0.0)
    results, _ = cluster.run_until_drained(0.0)
    assert cuid in results and cuid in cluster.results
    np.testing.assert_array_equal(results[cuid], cluster.results[cuid])


# --------------------------------------------------------------------------
# crash failover
# --------------------------------------------------------------------------


def test_crash_failover_bit_identical(env, ref):
    got = _port_episode(env, ref, "crash")
    assert set(got["results"]) == set(range(9))
    assert all(isinstance(v, list) for v in got["results"].values())
    st = got["stats"]
    assert st["failed"] == 0 and st["replicas_dead"] == 1
    assert st["failed_over"] > 0 and st["redispatched"] > 0
    assert st["prefix_mismatches"] == 0
    assert got["health"][0] == DEAD
    _assert_solo(env, got["results"], _entries(9))
    kinds = [e["kind"] for e in got["events"]]
    assert "crash_injected" in kinds and "failover" in kinds


def test_all_replicas_dead_fails_structurally(env):
    cluster = _cluster(_port_ns(env), 1, dead_after=3, faults=(ReplicaCrash(replica=0, at=1),))
    cuid = cluster.submit(_prompts(1)[0], tier=1, now=0.0)
    t, results = 0.0, {}
    for _ in range(30):
        t += 0.01
        results.update(cluster.pump_step(now=t))
        if cuid in results:
            break
    assert isinstance(results[cuid], Failed)
    assert "no live replicas" in results[cuid].detail
    assert cluster.stats["failed"] == 1 and cluster.n_in_flight == 0


def test_redispatch_budget_bounded(env):
    cluster = _cluster(_port_ns(env), 2, dead_after=3, max_redispatch=0, backoff_rounds=0,
                       faults=(ReplicaCrash(replica=0, at=0), ReplicaCrash(replica=1, at=0)))
    cuid = cluster.submit(_prompts(1)[0], tier=1, now=0.0)
    results, _ = cluster.run_until_drained(0.0, max_rounds=50)
    assert isinstance(results[cuid], RequestFailure)


# --------------------------------------------------------------------------
# hang: suspect -> recover, no failover
# --------------------------------------------------------------------------


def test_hang_suspects_then_recovers_without_failover(env, ref):
    got = _port_episode(env, ref, "hang")
    assert got["states"] == ref["hang"]["states"]
    assert SUSPECT in got["states"] and DEAD not in got["states"]
    assert got["health"][1] == HEALTHY
    assert got["stats"]["failed_over"] == 0 and got["stats"]["replicas_dead"] == 0
    transitions = [(e["frm"], e["to"]) for e in got["events"] if e["kind"] == "health"]
    assert transitions == [(HEALTHY, SUSPECT), (SUSPECT, HEALTHY)]
    assert set(got["results"]) == set(range(6))
    assert got["stats"]["prefix_mismatches"] == 0


# --------------------------------------------------------------------------
# degradation: quarantine of queued work
# --------------------------------------------------------------------------


def test_degraded_replica_quarantines_queued_work(env, ref):
    got = _port_episode(env, ref, "degraded")
    want = ref["degraded"]
    for key in ("health_after", "before", "late_uids"):
        assert got[key] == want[key]
    assert got["stats"]["prefix_mismatches"] == 0
    assert set(range(8)) <= set(got["results"])
    assert got["stats"]["replicas_degraded"] == 1 and got["stats"]["quarantined"] > 0
    assert got["health_after"][0] == DEGRADED
    assert got["dispatched"][0] == got["before"]  # late traffic routed around it
    _assert_solo(env, got["results"], got["late"], cuids=got["late_uids"])
    assert got["health"][0] == HEALTHY  # recalibrated, walked back with hysteresis


# --------------------------------------------------------------------------
# hedged dispatch
# --------------------------------------------------------------------------


def test_hedged_dispatch_winner_once_loser_cancelled(env, ref):
    got = _port_episode(env, ref, "hedge")
    st = got["stats"]
    assert got["placed"] == (1, 2)
    assert list(got["results"]) == [got["cuid"]] and st["delivered"] == 1
    assert st["hedge_wins_primary"] + st["hedge_wins_backup"] == 1
    assert st["hedge_cancelled"] + st["duplicates_discarded"] >= 1
    _assert_solo(env, got["results"], [(_prompts(1)[0], 2)])
    assert got["ghosts"] == [{}] * 5
    assert st["prefix_mismatches"] == 0


def test_hedge_counts_one_serve_in_journal(env):
    cluster = _cluster(_port_ns(env), 2)
    cuid = cluster.submit(_prompts(1)[0], tier=1, now=0.0, hedge=True)
    cluster.run_until_drained(0.0)
    entry = cluster.journal[cuid]
    assert entry.done and entry.hedge_uid is None and entry.replica is not None
    assert sum(h.engine.stats["requests"] for h in cluster.replicas) == 2
    assert cluster.stats["delivered"] == 1


def test_auto_hedge_fires_on_deadline_pressure(env):
    cluster = _cluster(_port_ns(env), 2, hedge_slack=10.0)
    cluster.submit(_prompts(1)[0], tier=1, now=0.0, target_latency=5.0)
    cluster.pump_step(now=0.01)
    assert cluster.stats["hedges"] == 1
    cluster.run_until_drained(0.02)
    assert cluster.stats["delivered"] == 1


def test_hedge_promoted_when_primary_replica_dies(env, ref):
    got = _port_episode(env, ref, "hedge_promoted")
    assert got["primary"] == 0  # least-loaded routing: the crashing replica
    assert isinstance(got["results"][got["cuid"]], list)
    assert got["stats"]["hedge_promoted"] == 1 and got["stats"]["redispatched"] == 0
    _assert_solo(env, got["results"], [(_prompts(1)[0], 2)])


# --------------------------------------------------------------------------
# engine cancel()
# --------------------------------------------------------------------------


def test_engine_cancel_queued_and_pooled(env):
    eng = port_engine(env, pool_slots=1, max_gen=6)
    uids = [eng.submit(p, tier=1, now=0.0) for p in _prompts(3, seed=7)]
    eng.pump_step(now=0.01)  # admits one row; the rest stay queued
    pooled = next(pool.record(s).request.uid for pool in eng.pools.values()
                  for s in pool.active_slots())
    queued = [u for u in uids if u != pooled]
    assert eng.cancel(queued[0]) is True
    assert eng.cancel(pooled) is True
    assert eng.cancel(10_000) is False
    assert eng.stats["cancelled"] == 2
    results, t = {}, 0.01
    while eng.n_in_flight:
        t += 0.01
        results.update(eng.pump_step(now=t))
    assert set(results) == {queued[1]}
    assert eng.cancel(queued[1]) is False
    for pool in eng.pools.values():
        assert pool.n_active == 0 and pool.allocator.n_free == pool.slots


# --------------------------------------------------------------------------
# MetricsFeed schema (replica_id + heartbeat_step appended last)
# --------------------------------------------------------------------------

LEGACY_FIELDS = [
    "step", "clock", "now", "dt", "queue_depth", "in_flight", "pool_active",
    "pool_slots", "occupancy", "queue_pressure", "urgent_frac", "policy_mode",
    "noise_scale", "drift_promoted", "drift_estimate", "traces",
    "tokens_total", "tiers",
]


def test_metrics_schema_appends_cluster_fields_last(env, tmp_path):
    path = tmp_path / "metrics.jsonl"
    feed = MetricsFeed(capacity=8, jsonl_path=path, replica_id=3)
    eng = port_engine(env, metrics=feed, max_gen=6)
    eng.submit(_prompts(1)[0], tier=1, now=0.0)
    t = 0.0
    while eng.n_in_flight:
        t += 0.01
        eng.pump_step(now=t)
    feed.close()
    sample = feed.samples()[-1]
    assert list(sample)[: len(LEGACY_FIELDS)] == LEGACY_FIELDS
    assert list(sample)[len(LEGACY_FIELDS):] == ["replica_id", "heartbeat_step"]
    assert sample["replica_id"] == 3
    steps = [s["heartbeat_step"] for s in feed.samples()]
    assert steps == list(range(1, len(steps) + 1))
    assert feed.heartbeat_step == steps[-1]
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert lines and all(list(d)[: len(LEGACY_FIELDS)] == LEGACY_FIELDS for d in lines)
    assert lines[-1]["heartbeat_step"] == feed.heartbeat_step


def test_metrics_replica_id_defaults_none(env):
    feed = MetricsFeed(capacity=4)
    eng = port_engine(env, metrics=feed, max_gen=6)
    eng.submit(_prompts(1)[0], tier=1, now=0.0)
    eng.pump_step(now=0.01)
    assert feed.samples()[-1]["replica_id"] is None
    assert feed.heartbeat_step >= 1


def test_router_stamps_replica_ids(env):
    cluster = _cluster(_port_ns(env), 3)
    assert [h.feed.replica_id for h in cluster.replicas] == [0, 1, 2]
    cluster.pump_step(now=0.01)
    assert all(h.feed.heartbeat_step == 1 for h in cluster.replicas)


# --------------------------------------------------------------------------
# cluster power-budget governor
# --------------------------------------------------------------------------


def test_cluster_governor_splits_and_rebalances_on_death(env, ref):
    budget = 400.0
    got = _port_episode(env, ref, "governor_death")
    assert got["first"] == (1, {0: budget, 1: budget}, [budget, budget])
    assert got["stats"]["rebalances"] >= 2
    assert got["split"] == {1: budget}
    assert got["stats"]["failed"] == 0


def test_cluster_governor_lends_headroom_to_demoted_replica(env):
    budget = 400.0
    cluster = _cluster(_port_ns(env), 2, policy=_policy(power_budget_aj=budget),
                       power_budget_aj=budget)
    cluster.pump_step(now=0.01)
    cluster.replicas[0].engine.governor.mode = "demoted"
    cluster.governor.step(cluster.round)
    split = cluster.governor.split
    assert split[0] == pytest.approx(budget * 4 / 3)
    assert split[1] == pytest.approx(budget * 2 / 3)
    assert (split[0] + split[1]) / 2 == pytest.approx(budget)
    ev = [e for e in cluster.events if e["kind"] == "rebalance"][-1]
    assert ev["reason"] == "demotion" and ev["demoted"] == [0]
    assert cluster.replicas[0].engine.governor.power_budget_aj == pytest.approx(budget * 4 / 3)
    cluster.replicas[0].engine.governor.mode = "nominal"
    cluster.governor.step(cluster.round)
    assert cluster.governor.split == {0: budget, 1: budget}


def test_governor_budget_override_roundtrip(env):
    gov = port_engine(env, policy=_policy(power_budget_aj=100.0)).governor
    assert gov.power_budget_aj == 100.0
    gov.set_power_budget(250.0)
    assert gov.power_budget_aj == 250.0
    assert gov.config.power_budget_aj == 100.0
    with pytest.raises(ValueError, match="power budget"):
        gov.set_power_budget(0.0)
    gov.set_power_budget(None)
    assert gov.power_budget_aj == 100.0


def test_cluster_keys_match_reference():
    for seed in (0, 7):
        for cuid in (0, 1, 5, 1000):
            np.testing.assert_array_equal(
                fold_in(PRNGKey(seed), cuid),
                np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), cuid)))
