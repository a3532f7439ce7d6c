"""Port vs reference: an unexpected exception of a prefill, decode or insert
call is contained (mirrors tests/test_continuous.py's generic-exception
fault property).

The reference counts such an exception in ``stats["exe_errors"]`` and
sends the batch or pool into the bounded-retry path, which ends in a
structured ``Failed``; so does the port. The episodes inject a plain
``RuntimeError`` (not the plan's ``TransientExecutableFault``) at the
plan's scheduled calls, on the tiny dense config with backend "tile" on
both sides: batch-synchronous and pooled, a decode, a prefill and an
insert call, and every call past the retry budget. Held to the
reference's run of the same plan: every outcome, the fault log, the
counters and the plan's log; every uid resolves exactly once and every
pool slot is free after the drain.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs as several processes on the cores (pytest-xdist): torch's
# intra-op threads in each would oversubscribe them (20x slower when six run)
torch.set_num_threads(1)

from repro.serving import ExecutableCache as JExecutableCache  # noqa: E402
from repro.serving import FaultPlan as JFaultPlan  # noqa: E402
from repro.serving import TransientExecutableFault as JTransientExecutableFault  # noqa: E402
from repro_torch.serving import Failed, FaultPlan, TransientExecutableFault  # noqa: E402
from test_torch_faults import (  # noqa: E402
    FAULT_STATS,
    _assert_slot_hygiene,
    _outcome,
    _serve,
    _traffic,
    make_env,
    port_engine,
    ref_engine,
)


def _generic(plan_cls, fault_cls):
    """``plan_cls`` whose scheduled call faults raise a plain RuntimeError."""

    class GenericExeFaultPlan(plan_cls):
        def check_executable(self, key) -> None:
            try:
                super().check_executable(key)
            except fault_cls as e:
                raise RuntimeError(
                    f"unplanned executable crash: {e.phase} call #{e.call_index}") from None

    return GenericExeFaultPlan


PORT_PLAN = _generic(FaultPlan, TransientExecutableFault)
REF_PLAN = _generic(JFaultPlan, JTransientExecutableFault)


def _submits(n=3, gens=(6, 6, 6)):
    prompts, keys = _traffic(n)
    return [(p, dict(n_repeats=k, max_new_tokens=g, key=key))
            for p, k, g, key in zip(prompts, (1, 2, 2), gens, keys)]


#: name -> (plan kwargs, engine kwargs, submits)
EPISODES = {
    "pooled_decode": (dict(exe_faults=[("decode", 2)]), {}, _submits()),
    "pooled_prefill_insert": (dict(exe_faults=[("prefill", 0), ("insert", 1)]), {}, _submits()),
    "sync_decode": (dict(exe_faults=[("decode", 3)]), dict(continuous=False), _submits()),
    "sync_prefill": (dict(exe_faults=[("prefill", 1)]), dict(continuous=False), _submits()),
    "beyond_budget": (dict(exe_fault_rate=1.0), dict(max_retries=1), _submits(1, (4,))),
}


def _episode(make, plan_cls, name):
    plan_kw, eng_kw, submits = EPISODES[name]
    eng = make(plan_cls(**plan_kw), **eng_kw)
    errs0 = eng.stats["exe_errors"]
    uids, results = _serve(eng, submits)
    return dict(
        results=[_outcome(results[u]) for u in uids],
        resolved=sorted(results) == sorted(uids),
        fault_log=[dict(e) for e in eng.fault_log],
        stats={k: eng.stats[k] for k in FAULT_STATS + ("exe_errors",)},
        new_errors=eng.stats["exe_errors"] - errs0,
        plan_log=list(eng.fault_plan.log),
        engine=eng,
    )


@pytest.fixture(scope="module")
def env():
    return make_env()


@pytest.fixture(scope="module")
def ref(env):
    """The reference's episodes, run once over one shared executable cache
    (each engine keeps its own fault hook)."""
    cache = JExecutableCache()

    def make(plan=None, **kw):
        eng = ref_engine(env, plan=plan, **kw)
        cache.fault_hook = eng.exe_cache.fault_hook
        eng.exe_cache = cache
        return eng

    out = {}
    for name in EPISODES:
        out[name] = _episode(make, REF_PLAN, name)
        del out[name]["engine"]
    return out


@pytest.mark.parametrize("name", list(EPISODES))
def test_generic_exception_is_contained_as_reference(env, ref, name):
    got = _episode(lambda plan, **kw: port_engine(env, plan=plan, **kw), PORT_PLAN, name)
    eng = got.pop("engine")
    want = ref[name]
    assert got["resolved"] and want["resolved"]  # every uid exactly once
    assert got["new_errors"] >= 1 and got["stats"]["exe_faults"] == 0
    _assert_slot_hygiene(eng)
    assert all(e["kind"] == "exe_error" for e in got["fault_log"])
    assert all(e["detail"].startswith("RuntimeError('unplanned executable crash")
               for e in got["fault_log"])
    for key in ("plan_log", "fault_log", "stats", "results"):
        assert got[key] == want[key], key


def test_generic_exception_past_budget_fails_structured(env):
    got = _episode(lambda plan, **kw: port_engine(env, plan=plan, **kw), PORT_PLAN,
                   "beyond_budget")
    kind, detail, tokens, retries = got["results"][0]
    assert kind == Failed.__name__ and retries == 1 and tokens == []
    assert detail.startswith("RuntimeError(")
    assert got["stats"]["failed"] == 1 and got["stats"]["exe_errors"] == 2


def test_neighbours_of_a_contained_exception_equal_plain(env):
    """A generic decode exception in the K=1 pool retires only that pool's
    rows; the K=2 pool's requests give the fault-free tokens."""
    got = _episode(lambda plan, **kw: port_engine(env, plan=plan, **kw), PORT_PLAN,
                   "pooled_decode")
    base_uids, base = _serve(port_engine(env), _submits())
    affected = set().union(*(e["uids"] for e in got["fault_log"]))
    assert affected and len(affected) < len(base_uids)
    for u, (r, b) in enumerate(zip(got["results"], base_uids)):
        assert isinstance(r, list)
        if u not in affected:
            assert r == np.asarray(base[b]).tolist()
