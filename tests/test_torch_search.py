"""Port vs reference: the searches of ``core/search.py``.

They are pure Python, and the port keeps its own copy. Both packages'
``min_energy_search``, ``repeat_profile_search`` and
``online_repeat_profile_search`` run on the reference tests' synthetic
accuracy functions (``tests/test_profiles.py``, ``tests/test_calibrate.py``,
``tests/test_policy.py``) and on a smooth one that makes the bisection
loop run, and give identical traces and results (exact equality: the same
arithmetic on the same Python floats). A ``PrecisionProfile`` saved by one
package loads in the other.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")
# the suite runs as several processes on the cores (pytest-xdist): torch's
# intra-op threads in each would oversubscribe them (20x slower when six run)
torch.set_num_threads(1)

from repro.core import profile as jprofile  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro_torch.core import profile, search  # noqa: E402


def _both(fn_name, *args, **kw):
    """(reference result, port result) as dicts of their fields."""
    return tuple(dataclasses.asdict(getattr(m, fn_name)(*args, **kw)) for m in (jsearch, search))


def _needs_acc_fn(needs, drop=0.05):
    """Each layer below its required K costs ``drop`` (tests/test_profiles.py)."""
    return lambda reps: 1.0 - drop * sum(k < n for k, n in zip(reps, needs))


def _acc_by_total(reps):
    """accuracy = sum(K) / 10 (tests/test_policy.py)."""
    return sum(reps) / 10.0


PROFILE_CASES = {
    "layer_needs": (_needs_acc_fn((4, 1, 2)), dict(n_layers=3, float_acc=1.0, k_levels=(1, 2, 4))),
    "weights_a": (_needs_acc_fn((2, 1)), dict(n_layers=2, float_acc=1.0, k_levels=(1, 2, 4),
                                              weights=(1.0, 100.0))),
    "weights_b": (_needs_acc_fn((2, 1)), dict(n_layers=2, float_acc=1.0, k_levels=(1, 2, 4),
                                              weights=(100.0, 1.0))),
    "infeasible": (lambda reps: 0.5, dict(n_layers=2, float_acc=1.0, k_levels=(1, 2))),
    "warm_init": (_needs_acc_fn((2, 1, 1)), dict(n_layers=3, float_acc=1.0, k_levels=(1, 2, 4),
                                                 init=(2, 2, 1))),
    "by_total": (_acc_by_total, dict(n_layers=4, float_acc=0.9, max_degradation=0.0,
                                     k_levels=(1, 2, 4, 8), weights=(3.0, 2.0, 1.0, 0.5))),
}


@pytest.mark.parametrize("case", sorted(PROFILE_CASES))
def test_repeat_profile_search_identical(case):
    acc, kw = PROFILE_CASES[case]
    ref, port = _both("repeat_profile_search", acc, **kw)
    assert port == ref


def test_repeat_profile_search_rejects_off_ladder_init_in_both():
    for m in (jsearch, search):
        with pytest.raises(ValueError, match="ladder"):
            m.repeat_profile_search(_needs_acc_fn((2, 1, 1)), n_layers=3, float_acc=1.0,
                                    k_levels=(1, 2, 4), init=(3, 1, 1))


ONLINE_CASES = {
    "descends": dict(frozen=(4, 4, 4), float_acc=0.6, max_degradation=0.0, k_levels=(1, 2, 4),
                     weights=(3.0, 2.0, 1.0)),
    "repairs": dict(frozen=(1, 1, 1), float_acc=0.6, max_degradation=0.0, k_levels=(1, 2, 4),
                    weights=(3.0, 2.0, 1.0)),
    "budget": dict(frozen=(1, 1, 1), float_acc=0.6, max_degradation=0.0, k_levels=(1, 2, 4),
                   max_evals=2),
    "budget_in_descent": dict(frozen=(4, 4, 4), float_acc=0.6, max_degradation=0.0,
                              k_levels=(1, 2, 4), max_evals=5),
}


@pytest.mark.parametrize("case", sorted(ONLINE_CASES))
def test_online_repeat_profile_search_identical(case):
    ref, port = _both("online_repeat_profile_search", _acc_by_total, **ONLINE_CASES[case])
    assert port == ref


def test_online_search_unreachable_identical():
    ref, port = _both("online_repeat_profile_search", lambda reps: 0.0, frozen=(4, 4, 4),
                      float_acc=0.6, max_degradation=0.0, k_levels=(1, 2, 4))
    assert port == ref and not port["feasible"]


def _smooth_acc(art):
    """A monotone accuracy in the energy: 0.95 * (1 - exp(-E))."""
    return 0.95 * (1.0 - math.exp(-art["e"]))


def _search_pair(make_fns, **kw):
    out = []
    for m, make in zip((jsearch, search), make_fns):
        res = m.min_energy_search(make, _smooth_acc, **kw)
        out.append((res.min_e_per_mac, res.accuracy, res.achieved_e_per_mac, res.trace,
                    res.artifact))
    return out


@pytest.mark.parametrize("max_iters", [1, 5, 12])
def test_min_energy_search_bisection_identical(max_iters):
    make = lambda t: ({"e": t}, t)  # noqa: E731
    ref, port = _search_pair((make, make), float_acc=0.95, lo=1e-3, hi=1e3,
                             max_iters=max_iters)
    assert port == ref
    assert len(port[3]) >= 3


def test_min_energy_search_warm_start_identical():
    """A make_fn taking ``init`` gets the best feasible artifact in both."""
    seen = {"ref": [], "port": []}

    def warm(tag):
        def make(target, init=None):
            seen[tag].append(None if init is None else init["e"])
            return {"e": target}, target * 0.9
        return make

    ref, port = _search_pair((warm("ref"), warm("port")), float_acc=0.95, lo=1e-3, hi=1e3,
                             max_iters=6)
    assert port == ref
    assert seen["port"] == seen["ref"] and seen["port"][0] is None


@pytest.mark.parametrize("achieved", ["undershoots", "tracks"])
def test_min_energy_search_lo_feasible_identical(achieved):
    """tests/test_calibrate.py: both bracket probes feasible, one coherent
    probe reported."""
    f = (lambda t: 10.0 / t) if achieved == "undershoots" else (lambda t: t)
    make = lambda t: ({"target": t}, f(t))  # noqa: E731
    res = [m.min_energy_search(make, lambda art: 0.9, float_acc=0.9, max_degradation=0.02,
                               lo=1.0, hi=10.0) for m in (jsearch, search)]
    assert [dataclasses.astuple(r) for r in res[1:]] == [dataclasses.astuple(res[0])]


def test_min_energy_search_infeasible_hi_identical():
    make = lambda t: ({"e": t}, t)  # noqa: E731
    ref, port = _search_pair((make, make), float_acc=0.99, lo=1e-3, hi=1.0)
    assert port == ref and math.isinf(port[0])


def test_profile_json_round_trips_between_packages(tmp_path):
    p = profile.PrecisionProfile((4, 1, 2, 2, 1), name="learned", accuracy=0.981)
    p.save(str(tmp_path / "port.json"))
    j = jprofile.PrecisionProfile.load(str(tmp_path / "port.json"))
    assert (j.repeats, j.name, j.accuracy) == (p.repeats, p.name, p.accuracy)
    j.save(str(tmp_path / "ref.json"))
    back = profile.PrecisionProfile.load(str(tmp_path / "ref.json"))
    assert back == p and back.cache_key() == p.cache_key()
