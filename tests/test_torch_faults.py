"""Port vs reference: fault tolerance (mirrors tests/test_faults.py).

Deterministic injection (``FaultPlan`` schedules equal the reference's
event for event), structured ``TimedOut``/``Failed`` results, bounded
retry at a promoted K, poisoned rows retired alone, the drift factor as a
runtime tensor operand (scale 1.0 bit-identical to no scale; a drifted
engine equals one whose energies are set to E/d**2 by hand) and the
noise-drift watchdog. Held against the JAX package on the tiny dense
config with backend "tile" on both sides: plan schedules, the tokens
served under drift (exact), the transient-retry, retry-budget,
poisoned-row and pooled-deadline episodes on the same fake clock (every
outcome, the fault log, the fault counters and the plan's log, exact),
the watchdog's keys (bit-exact) and probe RMS (rtol 1e-4). The
reference episodes run once, in a module fixture.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs as several processes on the cores (pytest-xdist): torch's
# intra-op threads in each would oversubscribe them (20x slower when six run)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.serving import DriftRamp as JDriftRamp  # noqa: E402
from repro.serving import ExecutableCache as JExecutableCache  # noqa: E402
from repro.serving import FaultPlan as JFaultPlan  # noqa: E402
from repro.serving import NoiseDriftWatchdog as JNoiseDriftWatchdog  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.serving import TransientExecutableFault as JTransientExecutableFault  # noqa: E402
from repro.serving import WatchdogConfig as JWatchdogConfig  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.kernels.prng import PRNGKey, fold_in  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.hooks import AnalogHook  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    DriftRamp,
    Failed,
    FaultPlan,
    NoiseDriftWatchdog,
    QueueFull,
    ServingEngine,
    TimedOut,
    TransientExecutableFault,
    WatchdogConfig,
)

SB = 32
ENERGY_AJ = 20.0
_MODEL = dict(name="fault-test", family="dense", n_layers=2, d_model=32, n_heads=2,
              n_kv_heads=1, d_ff=64, vocab_size=128, attn_q_chunk=16, attn_kv_chunk=16,
              dtype="float32")
CFG = ModelConfig(**_MODEL)
JCFG = JModelConfig(**_MODEL, loss_chunk=32)
PROBE = np.arange(2 * 16, dtype=np.int32).reshape(2, 16) % 128
ONSET = 6  # fault-clock step of the drift episodes' 2x step


def make_env(cfg=CFG, jcfg=JCFG):
    """Seeded numpy weights and the 20 aJ/MAC energy tree, for both packages."""
    rng = np.random.default_rng(0)
    tree = lm.map_leaves(
        lambda _p, leaf: (rng.standard_normal(leaf.shape) * (leaf.scale or 0.1)).astype(np.float32),
        lm.param_leaves(cfg),
    )
    jenergies = jlm.init_energy_tree(jcfg, ENERGY_AJ)
    return dict(
        params=bridge.params_from_numpy(tree, cfg, "cpu"),
        energies=bridge.energies_from_numpy(jax.tree.map(np.asarray, jenergies), cfg, "cpu"),
        jparams=jax.tree.map(jnp.asarray, tree),
        jenergies=jenergies,
    )


def engine_kw(**kw):
    kw.setdefault("max_gen", 8)
    kw.setdefault("max_wait", 0.0)  # instant admission on the virtual clock
    kw.setdefault("pool_slots", 2)
    kw.setdefault("continuous", True)
    return dict(max_batch=4, batch_buckets=(1, 2, 4), seq_buckets=(SB,), k_ladder=(1, 2, 4), **kw)


def port_engine(env, *, analog=True, plan=None, cfg=CFG, **kw):
    extra = dict(analog_cfg=AnalogConfig.shot(backend="tile"), energies=env["energies"]) \
        if analog else {}
    return ServingEngine(env["params"], cfg, fault_plan=plan, **extra, **engine_kw(**kw),
                         device="cpu")


def ref_engine(env, *, plan=None, cfg=JCFG, **kw):
    return JServingEngine(env["jparams"], cfg, analog_cfg=JAnalogConfig.shot(backend="tile"),
                          energies=env["jenergies"], fault_plan=plan, **engine_kw(**kw))


@pytest.fixture(scope="module")
def env():
    return make_env()


def _traffic(n=3, lens=(7, 19, 28), seed=3):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 128, L).astype(np.int32) for L in lens[:n]]
    return prompts, [fold_in(PRNGKey(5), i) for i in range(n)]


def _serve(eng, submits, max_iters=300):
    """Submit (prompt, kwargs) pairs at t=0 and poll a virtual clock until
    everything resolves; bounded, so a hang fails the test."""
    uids = [eng.submit(p, now=0.0, **kw) for p, kw in submits]
    results, t = {}, 0.0
    for _ in range(max_iters):
        if not eng.n_in_flight:
            break
        t += 1e-3
        results.update(eng.poll(now=t))
    assert not eng.n_in_flight, "engine failed to drain (hang)"
    return uids, results


def _assert_slot_hygiene(eng):
    for pool in eng.pools.values():
        assert pool.allocator.n_free == pool.slots
        assert pool.n_active == 0
        assert (pool.lengths == 0).all()
    assert eng.scheduler.n_pending == 0


def _drift_submits():
    prompts, keys = _traffic(3)
    return [(p, dict(n_repeats=2, max_new_tokens=8, key=k)) for p, k in zip(prompts, keys)]


def _drift_episodes(make, plan_cls, ramp_cls):
    """The drift episode, then the same traffic at nominal on the same
    engine: {"drift": tokens, "nominal": tokens} by submission order."""
    eng = make(plan_cls(drift=ramp_cls(start=ONSET, rate=None, max_scale=2.0)))
    uids, res = _serve(eng, _drift_submits())
    out = {"drift": [np.asarray(res[u]) for u in uids], "scale": eng.noise_scale}
    eng.fault_plan = None
    eng.set_noise_scale(1.0)
    uids, res = _serve(eng, _drift_submits())
    out["nominal"] = [np.asarray(res[u]) for u in uids]
    return out


def _outcome(v):
    if isinstance(v, np.ndarray):
        return np.asarray(v).tolist()
    return (type(v).__name__, v.detail, np.asarray(v.tokens).tolist(),
            getattr(v, "retries", None))


#: the counters both engines keep for faults and the pool
FAULT_STATS = ("requests", "batches", "tokens_generated", "decode_steps", "admitted", "retired",
               "timed_out", "failed", "retried", "stalled_steps", "exe_faults", "poisoned_rows")


def _fault_record(eng, uids, results):
    """What an episode is held to: every request's outcome by submission
    order, the engine's fault log, its fault counters and the plan's log."""
    return dict(
        results=[_outcome(results[u]) for u in uids],
        fault_log=[dict(e) for e in eng.fault_log],
        stats={k: eng.stats[k] for k in FAULT_STATS},
        plan_log=list(eng.fault_plan.log),
        engine=eng,
    )


def _transient_submits():
    prompts, keys = _traffic(3)
    return [(p, dict(n_repeats=k, max_new_tokens=6, key=key))
            for p, k, key in zip(prompts, (1, 2, 2), keys)]


def ep_transient(make, plan_cls):
    """A decode call faults once: its rows retry one rung up."""
    eng = make(plan_cls(exe_faults=[("decode", 2)]))
    return _fault_record(eng, *_serve(eng, _transient_submits()))


def ep_beyond_budget(make, plan_cls):
    """Every call faults: one retry, then a structured Failed."""
    prompts, keys = _traffic(1)
    eng = make(plan_cls(exe_fault_rate=1.0), max_retries=1)
    return _fault_record(eng, *_serve(eng, [
        (prompts[0], dict(n_repeats=1, max_new_tokens=4, key=keys[0]))]))


def _poison_submits():
    prompts, keys = _traffic(2, lens=(7, 19))
    return [(p, dict(n_repeats=2, max_new_tokens=8, key=k)) for p, k in zip(prompts, keys)]


def ep_poison(make, plan_cls):
    """Row 0 of the clock-2 decode step is poisoned: that row alone retires."""
    eng = make(plan_cls(poison={(2, 0): -9}))
    return _fault_record(eng, *_serve(eng, _poison_submits()))


def ep_pooled_deadline(make, plan_cls):
    """Every decode step from clock 1 on stalls: the deadline ends the row
    with the prefix it had."""
    prompts, keys = _traffic(1)
    eng = make(plan_cls(stall_steps=range(1, 1000)))
    u = eng.submit(prompts[0], n_repeats=2, max_new_tokens=8, key=keys[0], now=0.0,
                   deadline=0.004)
    res, t = {}, 0.0
    for _ in range(50):
        t += 1e-3
        res.update(eng.pump_step(now=t))
        if u in res:
            break
    return _fault_record(eng, [u], res)


#: the fault episodes held against the reference
FAULT_EPISODES = dict(transient=ep_transient, beyond_budget=ep_beyond_budget, poison=ep_poison,
                      pooled_deadline=ep_pooled_deadline)


@pytest.fixture(scope="module")
def ref(env):
    """The reference's episodes, run once: tokens under a 2x drift step and
    at nominal, the watchdog's baseline and nominal probes, and the fault
    episodes. Its engines share one executable cache (each keeps its own
    fault hook), so each executable compiles once."""
    cache = JExecutableCache()

    def make(plan=None, **kw):
        eng = ref_engine(env, plan=plan, **kw)
        cache.fault_hook = eng.exe_cache.fault_hook
        eng.exe_cache = cache
        return eng

    out = _drift_episodes(make, JFaultPlan, JDriftRamp)
    for name, ep in FAULT_EPISODES.items():
        out[name] = ep(make, JFaultPlan)
        del out[name]["engine"]
    jeng = make()
    wd = JNoiseDriftWatchdog(jeng, PROBE, config=JWatchdogConfig(n_samples=4),
                             key=jax.random.PRNGKey(3))
    for step in (0, 8, 16):
        wd.probe(step=step)
    jeng.set_noise_scale(2.0)
    wd.probe(step=24)
    out["baseline_rms"] = wd.baseline_rms
    out["estimates"] = list(wd.estimates)
    return out


def _port_fault_episode(env, ref, name):
    """Run a fault episode on the port and hold it to the reference's: the
    same outcomes (tokens, or the same structured failure), fault log,
    counters and plan log; every slot is free after it."""
    got = FAULT_EPISODES[name](lambda plan, **kw: port_engine(env, plan=plan, **kw), FaultPlan)
    _assert_slot_hygiene(got.pop("engine"))
    want = ref[name]
    assert got["plan_log"] == want["plan_log"]
    assert got["fault_log"] == want["fault_log"]
    assert got["stats"] == want["stats"]
    assert got["results"] == want["results"]
    return got


# --------------------------------------------------------------------------
# FaultPlan: deterministic, seedable, logged
# --------------------------------------------------------------------------


def _drive(plan, fault_type):
    fired = []
    for i in range(20):
        try:
            plan.check_executable(("decode", 4, 40, 2))
        except fault_type as f:
            fired.append(("exe", f.phase, f.call_index))
        if plan.stalled(i):
            fired.append(("stall", i))
        tok = np.zeros(4, np.int32)
        for s in plan.poison_rows(i, tok):
            fired.append(("poison", i, s, int(tok[s])))
    return fired


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_fault_plan_schedules_are_deterministic(rate):
    kw = dict(seed=7, exe_faults=[("decode", 3), ("decode", 11)], exe_fault_rate=rate,
              stall_steps=(2, 5), poison={(4, 1): -9})
    a, b, j = FaultPlan(**kw), FaultPlan(**kw), JFaultPlan(**kw)
    fired = _drive(a, TransientExecutableFault)
    assert fired == _drive(b, TransientExecutableFault)  # same seed -> same faults
    assert fired == _drive(j, JTransientExecutableFault)  # the reference's schedule
    assert ("exe", "decode", 3) in fired
    assert ("stall", 2) in fired and ("poison", 4, 1, -9) in fired
    assert a.log == b.log == j.log and len(a.log) > 0


def test_drift_ramp_shapes():
    step = DriftRamp(start=5, rate=None, max_scale=2.0)
    assert step.scale_at(4) == 1.0 and step.scale_at(5) == 2.0
    ramp = DriftRamp(start=0, rate=0.5, max_scale=3.0)
    assert ramp.scale_at(0) == 1.0
    assert ramp.scale_at(1) == 1.5
    assert ramp.scale_at(100) == 3.0
    assert FaultPlan().noise_scale_at(123) == 1.0
    jramp = JDriftRamp(start=3, rate=0.25, max_scale=2.0)
    port = DriftRamp(start=3, rate=0.25, max_scale=2.0)
    assert [port.scale_at(c) for c in range(12)] == [jramp.scale_at(c) for c in range(12)]


def test_call_guard_fires_pre_dispatch(env):
    """The executable cache's guard: a scheduled prefill fault raises before
    the tier's prefill step runs (and so before any launch and before a
    cache is touched); the fault names the call by its cache key, which is
    the reference cache's key, and the phase counter is the reference's."""
    plan = FaultPlan(exe_faults=[("prefill", 1)])
    eng = port_engine(env, plan=plan)
    calls = []
    tier = eng.tiers.get(2)
    build = tier.build_prefill

    def counted(*shape):
        step = build(*shape)
        fn = step.fn
        step.fn = lambda *a: calls.append(shape) or fn(*a)
        return step

    tier.build_prefill = counted
    prompts, keys = _traffic(2)
    submits = [[(prompts[i], dict(n_repeats=2, max_new_tokens=2, key=keys[i]))] for i in (0, 1)]
    _serve(eng, submits[0])
    assert len(calls) == 1 and not eng.fault_log
    uids, res = _serve(eng, submits[1])
    # call #1 raised before dispatch; its retry (at K=4, another tier) ran
    assert len(calls) == 1 and eng.stats["exe_faults"] == 1
    assert eng.fault_log[0]["kind"] == "exe_fault" and eng.fault_log[0]["promoted"] == {1: 4}
    assert isinstance(res[uids[0]], np.ndarray)
    # the reference engine faults the same call under the same cache key
    jplan = JFaultPlan(exe_faults=[("prefill", 1)])
    jeng = ref_engine(env, plan=jplan)
    for sub in submits:
        _serve(jeng, sub)
    key = ("prefill", 1, SB, SB + 8, 2, "tile", "shot")
    assert eng.fault_log[0]["detail"] == jeng.fault_log[0]["detail"] == str(
        TransientExecutableFault("prefill", 1, key))
    assert [(e["phase"], e["call"]) for e in jplan.log] == \
        [(e["phase"], e["call"]) for e in plan.log] == [("prefill", 1)]


@pytest.fixture(scope="module")
def guard_cache():
    """One executable cache for the reference engines of the guard test, so
    each executable compiles once (an engine keeps the hook it armed)."""
    return JExecutableCache()


@pytest.mark.parametrize("when", ["construction", "after", "cleared"])
def test_guard_armed_as_the_reference(env, guard_cache, when):
    """The executable guard is armed only by a plan given at construction,
    in both packages: such a plan fires its call fault (no retry budget: a
    structured ``Failed``); a plan set on a running engine leaves the guard
    unarmed (no fault: the served token); a plan given and then set to
    None is silent. Both engines give the same outcome and count the same
    faults. One new token a request: only the prefill is built."""
    prompts, keys = _traffic(1)
    sub = [(prompts[0], dict(n_repeats=1, max_new_tokens=1, key=keys[0]))]
    out = []
    for make, plan_cls in ((port_engine, FaultPlan), (ref_engine, JFaultPlan)):
        plan = plan_cls(exe_faults=[("prefill", 0)])
        eng = make(env, plan=plan if when != "after" else None, max_retries=0)
        if make is ref_engine:
            guard_cache.fault_hook = eng.exe_cache.fault_hook
            eng.exe_cache = guard_cache
        eng.fault_plan = {"construction": plan, "after": plan, "cleared": None}[when]
        uids, res = _serve(eng, sub)
        out.append((eng.stats["exe_faults"], eng.stats["failed"], _outcome(res[uids[0]])))
    assert out[0] == out[1]
    faults, failed, outcome = out[0]
    assert (faults, failed) == ((1, 1) if when == "construction" else (0, 0))
    if when == "construction":
        assert outcome[0] == "Failed"
    else:
        assert len(outcome) == 1  # the request's token


# --------------------------------------------------------------------------
# submit validation + backpressure
# --------------------------------------------------------------------------


def test_submit_rejects_unservable_requests(env):
    eng = port_engine(env, analog=False)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit([], now=0.0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit([1, 2], max_new_tokens=0, now=0.0)
    with pytest.raises(ValueError, match="max_gen"):
        eng.submit([1, 2], max_new_tokens=eng.max_gen + 1, now=0.0)
    with pytest.raises(ValueError, match="largest seq bucket"):
        eng.submit(np.zeros(SB + 1, np.int32), now=0.0)
    assert eng.scheduler.n_pending == 0  # nothing half-enqueued


def test_queue_full_backpressure(env):
    eng = port_engine(env, analog=False, max_queue=2)
    p = np.arange(4, dtype=np.int32)
    eng.submit(p, now=0.0)
    eng.submit(p, now=0.0)
    with pytest.raises(QueueFull, match="high-water"):
        eng.submit(p, now=0.0)
    eng.poll(now=1.0)
    eng.flush()
    eng.submit(p, now=2.0)  # capacity is back


# --------------------------------------------------------------------------
# deadlines -> structured TimedOut, slots released
# --------------------------------------------------------------------------


def test_queued_deadline_times_out_with_empty_result(env):
    eng = port_engine(env, analog=False, max_wait=10.0)  # keeps the request queued
    u = eng.submit(np.arange(5, dtype=np.int32), now=0.0, deadline=0.5)
    assert eng.poll(now=0.1) == {}
    res = eng.poll(now=0.6)
    assert isinstance(res[u], TimedOut) and res[u].tokens.size == 0
    assert not res[u].ok
    assert eng.stats["timed_out"] == 1
    _assert_slot_hygiene(eng)


def test_pooled_deadline_keeps_partial_prefix(env, ref):
    prompts, keys = _traffic(1)
    got = _port_fault_episode(env, ref, "pooled_deadline")
    (u_b,), res_b = _serve(port_engine(env), [
        (prompts[0], dict(n_repeats=2, max_new_tokens=8, key=keys[0]))])
    kind, _, tokens, _ = got["results"][0]
    assert kind == "TimedOut" and 1 <= len(tokens) < 8
    assert tokens == res_b[u_b][: len(tokens)].tolist()  # a prefix
    assert got["stats"]["stalled_steps"] > 0
    assert got["stats"]["timed_out"] == 1


# --------------------------------------------------------------------------
# transient faults -> bounded retry at a promoted K
# --------------------------------------------------------------------------


def test_transient_decode_fault_retries_promoted_and_preserves_neighbors(env, ref):
    got = _port_fault_episode(env, ref, "transient")
    base_uids, base_res = _serve(port_engine(env), _transient_submits())
    assert got["stats"]["exe_faults"] == 1 and got["stats"]["retried"] >= 1
    entry = next(e for e in got["fault_log"] if e["kind"] == "exe_fault")
    affected = set(entry["uids"])
    assert affected
    for u, (r, b) in enumerate(zip(got["results"], base_uids)):
        assert isinstance(r, list), r
        if u not in affected:
            assert r == base_res[b].tolist()
    for u in entry["retried"]:
        assert entry["promoted"][u] > 1


def test_fault_beyond_retry_budget_fails_structured(env, ref):
    got = _port_fault_episode(env, ref, "beyond_budget")
    kind, _, tokens, retries = got["results"][0]
    assert kind == "Failed" and retries == 1 and tokens == []
    assert got["stats"]["failed"] == 1 and got["stats"]["retried"] == 1


def test_poisoned_row_retires_only_that_row(env, ref):
    got = _port_fault_episode(env, ref, "poison")
    base_uids, base_res = _serve(port_engine(env), _poison_submits())
    assert got["stats"]["poisoned_rows"] == 1
    affected = set().union(*(e.get("uids", ()) for e in got["fault_log"]))
    assert len(affected) == 1
    for u, (r, b) in enumerate(zip(got["results"], base_uids)):
        assert isinstance(r, list)
        if u not in affected:
            assert r == base_res[b].tolist()


# --------------------------------------------------------------------------
# no-fault path: bit-identical, no extra work
# --------------------------------------------------------------------------


def test_empty_fault_plan_is_bit_identical(env):
    prompts, keys = _traffic(3)
    submits = [(p, dict(n_repeats=2, max_new_tokens=g, key=k))
               for p, g, k in zip(prompts, (2, 5, 8), keys)]
    base_uids, base_res = _serve(port_engine(env), list(submits))
    eng = port_engine(env, plan=FaultPlan())  # armed but empty
    uids, res = _serve(eng, list(submits))
    for u, b in zip(uids, base_uids):
        np.testing.assert_array_equal(res[u], base_res[b])
    steps = eng.stats["decode_steps"]
    uids2, res2 = _serve(eng, list(submits))  # replay
    for u, b in zip(uids2, base_uids):
        np.testing.assert_array_equal(res2[u], base_res[b])
    assert eng.stats["decode_steps"] == 2 * steps
    assert eng.fault_log == [] and eng.stats["exe_faults"] == 0


# --------------------------------------------------------------------------
# drift: a runtime tensor operand, E / d**2
# --------------------------------------------------------------------------


def test_tokens_under_drift_match_reference(env, ref):
    port = _drift_episodes(lambda plan: port_engine(env, plan=plan), FaultPlan, DriftRamp)
    assert port["scale"] == ref["scale"] == 2.0
    for key in ("drift", "nominal"):
        for p, j in zip(port[key], ref[key]):
            np.testing.assert_array_equal(p, j)
    # the drift changed what was served after the onset
    assert any(not np.array_equal(a, b) for a, b in zip(port["drift"], port["nominal"]))


def test_drift_is_a_runtime_operand(env):
    """A drifted engine serves exactly what an engine whose energies are
    set to E/d**2 by hand serves, and scale 1.0 is the plain engine."""
    submits = _drift_submits()
    _, res = _serve(port_engine(env, plan=FaultPlan(drift=DriftRamp(start=0, rate=None,
                                                                     max_scale=2.0))),
                    list(submits))
    hand = dict(env, energies=lm.map_leaves(lambda _p, e: e / 4.0, env["energies"]))
    _, want = _serve(port_engine(hand), list(submits))
    eng = port_engine(env)
    eng.set_noise_scale(1.0)
    _, plain = _serve(eng, list(submits))
    _, base = _serve(port_engine(env), list(submits))
    for u in res:
        np.testing.assert_array_equal(res[u], want[u])
        np.testing.assert_array_equal(plain[u], base[u])
    with pytest.raises(ValueError, match="> 0"):
        eng.set_noise_scale(0.0)


@pytest.mark.parametrize("scale", [1.0, 1.7])
def test_hook_noise_scale_is_exact(scale):
    """The site energy is E / (d * d) in float32: at d = 1 the bits of a
    hook without the scale, at any d those of a hook given E/d**2."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 3, 32)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((32, 24)) * 0.2).astype(np.float32))
    e = torch.tensor(7.3, dtype=torch.float32)
    d = torch.tensor(scale, dtype=torch.float32)
    seeds = {"s": torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int64)}
    cfg = AnalogConfig.shot(backend="tile")
    drifted = AnalogHook(cfg=cfg, energies={"s": e}, seeds=seeds, noise_scale=d)("s", x, w)
    by_hand = AnalogHook(cfg=cfg, energies={"s": e / (d * d)}, seeds=seeds)("s", x, w)
    assert torch.equal(drifted, by_hand)
    # the forward's once-a-leaf division has the hook's bits
    assert torch.equal(lm.drifted_energies({"g": {"s": e}}, d)["g"]["s"], e / (d * d))
    if scale == 1.0:
        assert torch.equal(drifted, AnalogHook(cfg=cfg, energies={"s": e}, seeds=seeds)("s", x, w))


# --------------------------------------------------------------------------
# noise-drift watchdog + the drift response
# --------------------------------------------------------------------------


def test_watchdog_quiet_at_nominal_and_config_validation(env, ref):
    eng = port_engine(env)
    key = PRNGKey(3)
    wd = NoiseDriftWatchdog(eng, PROBE, key=key)
    assert wd.baseline_rms > 0
    # the probe keys are the reference's, bit for bit; the RMS agrees
    jkey = jax.random.PRNGKey(3)
    for data in (0xB43E, 0, 1):
        np.testing.assert_array_equal(fold_in(key, data), np.asarray(jax.random.fold_in(jkey, data)))
    np.testing.assert_allclose(wd.baseline_rms, ref["baseline_rms"], rtol=1e-4)
    for step in range(0, 3 * wd.config.interval, wd.config.interval):
        assert wd.maybe_probe(step) is None
    assert all(0.7 < e < 1.4 for _, e in wd.estimates)
    n = len(wd.estimates)
    assert wd.maybe_probe(wd.estimates[-1][0] + 1) is None  # interval honoured
    assert len(wd.estimates) == n
    eng.set_noise_scale(2.0)
    event = wd.probe(step=24)
    assert [s for s, _ in wd.estimates] == [s for s, _ in ref["estimates"]]
    np.testing.assert_allclose([e for _, e in wd.estimates], [e for _, e in ref["estimates"]],
                               rtol=1e-4)
    assert event is not None and event.estimate > 1.4
    with pytest.raises(ValueError, match="band"):
        WatchdogConfig(band=(1.1, 1.4))
    with pytest.raises(ValueError, match="analog"):
        NoiseDriftWatchdog(port_engine(env, analog=False), PROBE)


def test_watchdog_detects_injected_drift_within_budget(env):
    prompts, keys = _traffic(2, lens=(7, 19))
    eng = port_engine(env, plan=FaultPlan(drift=DriftRamp(start=ONSET, rate=None, max_scale=2.0)))
    cfg = WatchdogConfig(interval=2, n_samples=4)
    wd = NoiseDriftWatchdog(eng, PROBE, config=cfg, key=PRNGKey(3))
    for p, k in zip(prompts, keys):
        eng.submit(p, n_repeats=2, max_new_tokens=8, key=k, now=0.0)
    event, t = None, 0.0
    for step in range(60):
        t += 1e-3
        eng.pump_step(now=t)
        if eng.n_in_flight == 0:  # keep the pools decoding under drift
            eng.submit(prompts[0], n_repeats=2, max_new_tokens=8, key=keys[0], now=t)
        event = event or wd.maybe_probe(step)
        if event is not None:
            break
    assert event is not None, "watchdog missed a 2x drift"
    assert event.estimate > cfg.band[1]
    assert event.step <= ONSET + 2 * cfg.interval
    eng.promote_tiers(event)
    assert eng.promoted and eng.stats["promotions"] == 1
    eng.submit(prompts[0], n_repeats=2, max_new_tokens=2, key=keys[0], now=t + 1e-3)
    assert 4 in eng.scheduler.pending_tiers()  # K=2 -> K=4
    eng.flush()
    eng.fault_plan = None
    eng.recalibrate()
    wd.clear()
    assert not eng.promoted and eng.noise_scale == 1.0
    assert wd.probe(step=100) is None
    assert 0.7 < wd.estimates[-1][1] < 1.4
    eng.submit(prompts[0], n_repeats=2, max_new_tokens=2, key=keys[0], now=t + 2e-3)
    assert 2 in eng.scheduler.pending_tiers()
    eng.flush()
    _assert_slot_hygiene(eng)
