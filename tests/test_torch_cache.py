"""Port vs reference: the executable cache (``serving/cache.py``) and the
engine's use of it.

``ExecutableCache`` runs the same scripted gets on both packages' classes
(LRU and evictions, the ``max_entries`` bound, the miss log's cap,
``reset_stats``, the fault hook before every call). The engines, on one
small dense and one small griffin config (weights made with numpy and
carried across with ``repro_torch.bridge``, backend "tile" on both sides),
serve the same traffic; after each episode the port's ``cache_stats()``
and ``trace_count`` must equal the reference's: sync traffic of two tiers,
a profile tier, a warm replay (zero misses), continuous traffic with
admissions, and sync traffic under ``max_entries=2``; the keys, in LRU
order, and the tokens must be equal too. The reference engines of a module
share their compiled executables through their caches' builds (equal keys
are interchangeable executables: the reference's own contract), so each
compiles once; a reference engine's trace count is then its cache's
builds. On the CPU a port entry is the eager step (a CUDA graph on the
card: ``tests/test_torch_card.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # several test processes share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.core.profile import PrecisionProfile as JPrecisionProfile  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.serving.cache import ExecutableCache as JExecutableCache  # noqa: E402
from repro.serving.cache import mesh_fingerprint as jmesh_fingerprint  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro.serving.tiers import Int8DigitalTier as JInt8DigitalTier  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.core.profile import PrecisionProfile  # noqa: E402
from repro_torch.kernels.prng import PRNGKey, fold_in  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for_devices  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ExecutableCache,
    Int8DigitalTier,
    ServingEngine,
    mesh_fingerprint,
)

STAT_KEYS = ("hits", "misses", "entries", "evictions", "max_entries")


# --------------------------------------------------------------------------
# ExecutableCache: the same script on both classes
# --------------------------------------------------------------------------


def _lru(cls):
    cache = cls(max_entries=2)
    built = []

    def build(name):
        return lambda: built.append(name) or name

    got = [cache.get(k, build(k)) for k in ("a", "b", "a", "c", "b")]
    return dict(got=got, built=built, stats=cache.stats(), keys=sorted(k for k in "abc"
                                                                       if k in cache))


def _unbounded(cls):
    cache = cls()
    for i in range(10):
        cache.get(i, lambda i=i: i)
    for i in range(10):
        cache.get(i, lambda: None)
    return dict(stats=cache.stats(), n=len(cache), log=[k for k, _ in cache.miss_log])


def _refused(cls):
    out = []
    for bound in (0, -1):
        with pytest.raises(ValueError):
            cls(max_entries=bound)
        out.append(bound)
    return out


def _miss_log_cap(cls):
    cache = cls(max_entries=2)
    for i in range(100):
        cache.get(i, lambda i=i: i)
    return dict(n=len(cache.miss_log), first=cache.miss_log[0][0], cap=cache.miss_log.maxlen,
                unbounded_cap=cls().miss_log.maxlen, stats=cache.stats())


def _reset(cls):
    cache = cls(max_entries=3)
    for k in ("a", "b", "a", "d", "e", "f"):
        cache.get(k, lambda k=k: k)
    cache.reset_stats()
    cache.get("f", lambda: None)
    return dict(stats=cache.stats(), log=list(cache.miss_log), n=len(cache))


def _hook(cls):
    calls = []

    def hook(key):
        calls.append(("hook", key))
        if key == "boom":
            raise RuntimeError("before the call")

    cache = cls(fault_hook=hook)
    fn = cache.get("ok", lambda: (lambda x: calls.append(("call", x)) or x * 2))
    out = [fn(3), fn(4)]
    boom = cache.get("boom", lambda: (lambda x: calls.append(("call", x))))
    with pytest.raises(RuntimeError):
        boom(5)
    return dict(out=out, calls=calls, stats=cache.stats())


CACHE_SCRIPTS = dict(lru=_lru, unbounded=_unbounded, refused=_refused,
                     miss_log_cap=_miss_log_cap, reset_stats=_reset, fault_hook=_hook)


def _no_time(out):
    if isinstance(out, dict):
        return {k: _no_time(v) for k, v in out.items() if k != "compile_s"}
    if isinstance(out, list):
        return [(e[0],) if isinstance(e, tuple) and len(e) == 2 and isinstance(e[1], float)
                else e for e in out]
    return out


@pytest.mark.parametrize("name", list(CACHE_SCRIPTS))
def test_executable_cache_matches_reference(name):
    script = CACHE_SCRIPTS[name]
    assert _no_time(script(ExecutableCache)) == _no_time(script(JExecutableCache))


def test_mesh_fingerprint():
    assert mesh_fingerprint(None) == jmesh_fingerprint(None) == ()
    fp = mesh_fingerprint(make_mesh_for_devices(2))
    assert fp == (("tp",), (2,), ("local:0", "local:1"))
    assert mesh_fingerprint(make_mesh_for_devices(2)) == fp  # equal meshes, equal keys
    assert mesh_fingerprint(make_mesh_for_devices(4)) != fp
    # the reference's shape: (axis names, axis sizes, device order)
    jfp = jmesh_fingerprint(jax.make_mesh((1,), ("tp",)))
    assert [type(p) for p in jfp] == [type(p) for p in fp] and jfp[0] == fp[0]


# --------------------------------------------------------------------------
# the engine's counters against the reference engine's
# --------------------------------------------------------------------------

_TINY = dict(n_heads=2, n_kv_heads=1, head_dim=16, vocab_size=128, dtype="float32")
CONFIGS = {
    "dense": dict(name="cache-dense", family="dense", n_layers=2, d_model=32, d_ff=64, **_TINY),
    "griffin": dict(name="cache-griffin", family="griffin", n_layers=3, d_model=32, d_ff=64,
                    rnn_width=32, conv_width=4, local_window=8, **_TINY),
}
#: one batch and one seq bucket: few distinct keys, so few reference compiles
ENGINE_KW = dict(max_gen=4, max_batch=4, max_wait=0.0, batch_buckets=(4,), seq_buckets=(32,),
                 seed=3)
#: the dense engine is analog (shot noise): its two tiers are K=1 and the
#: int8 digital tier, its profile tier a schedule over its 2 layers. The
#: griffin engine is digital, so the reference's steps compile in about a
#: second each (its analog ones take about 8 s on the CPU): the bf16 base
#: tier and int8, and a profile there resolves to the base tier.
ANALOG = {"dense": True, "griffin": False}
PROFILE = {"dense": (2, 1), "griffin": (2, 1, 2)}


@pytest.fixture(scope="module", params=list(CONFIGS))
def models(request):
    fam = request.param
    cfg, jcfg = ModelConfig(**CONFIGS[fam]), JModelConfig(**CONFIGS[fam])
    rng = np.random.default_rng(0)
    tree = lm.map_leaves(
        lambda _p, leaf: (rng.standard_normal(leaf.shape) * (leaf.scale or 0.1)).astype(np.float32),
        lm.param_leaves(cfg))
    jenergies = jlm.init_energy_tree(jcfg, 20.0)
    return dict(
        fam=fam, cfg=cfg, jcfg=jcfg,
        params=bridge.params_from_numpy(tree, cfg, "cpu"),
        energies=bridge.energies_from_numpy(jax.tree.map(np.asarray, jenergies), cfg, "cpu"),
        jparams=jax.tree.map(jnp.asarray, tree), jenergies=jenergies)


#: (family, key) -> the reference's compiled executable, shared by its engines
_COMPILED: dict = {}


class _SharedBuilds(JExecutableCache):
    """The reference's cache, counting exactly as it does, whose builds
    take a compiled executable of an earlier engine of the same family and
    key when there is one; ``builds`` counts the builds it asked for (the
    engine's traces)."""

    def __init__(self, fam, **kw):
        super().__init__(**kw)
        self.fam = fam
        self.builds = 0

    def get(self, key, build):
        def shared():
            self.builds += 1
            if (self.fam, key) not in _COMPILED:
                _COMPILED[(self.fam, key)] = build()
            return _COMPILED[(self.fam, key)]

        return super().get(key, shared)


def _engines(m, **kw):
    fam = m["fam"]
    port_a = dict(analog_cfg=AnalogConfig.shot(backend="tile"), energies=m["energies"])
    ref_a = dict(analog_cfg=JAnalogConfig.shot(backend="tile"), energies=m["jenergies"])
    port = ServingEngine(m["params"], m["cfg"], device="cpu", **(port_a if ANALOG[fam] else {}),
                         **ENGINE_KW, **kw)
    ref = JServingEngine(m["jparams"], m["jcfg"], **(ref_a if ANALOG[fam] else {}), **ENGINE_KW,
                         **kw)
    ref.exe_cache = _SharedBuilds(fam, max_entries=kw.get("max_entries"))
    port.register_tier(Int8DigitalTier(port))
    ref.register_tier(JInt8DigitalTier())
    port.register_profile(PrecisionProfile(PROFILE[fam], name="edge"))
    ref.register_profile(JPrecisionProfile(PROFILE[fam], name="edge"))
    return port, ref


def _traffic(n, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 30, n)
    return [rng.integers(0, 128, int(L)).astype(np.int32) for L in lens]


def _serve(eng, prompts, tiers, gens, continuous):
    base = PRNGKey(11)
    uids = []
    for i, (p, t, g) in enumerate(zip(prompts, tiers, gens)):
        kw = dict(profile=t) if t == "edge" else dict(tier=t)
        uids.append(eng.submit(p, max_new_tokens=g, key=fold_in(base, i), now=0.0, **kw))
    if continuous:
        out, t = {}, 0.0
        while eng.n_in_flight:
            t += 0.01
            out.update(eng.pump_step(now=t))
    else:
        out = eng.flush()
    return [np.asarray(out[u]).tolist() for u in uids]


def _record(eng, toks):
    port = isinstance(eng, ServingEngine)
    return dict(stats={k: eng.cache_stats()[k] for k in STAT_KEYS},
                traces=int(eng.trace_count if port else eng.exe_cache.builds),
                keys=[k for k, _ in eng.exe_cache.entries()] if port else list(eng.exe_cache._exes),
                tokens=toks)


def _episode_pair(m, episodes, **kw):
    """Run ``episodes`` (name -> (prompts, tiers, gens, reset_first)) on a
    fresh port and reference engine pair; the records after each."""
    out = {}
    port, ref = _engines(m, **kw)
    continuous = kw.get("continuous", False)
    for name, (prompts, tiers, gens, reset) in episodes.items():
        rec = []
        for eng in (port, ref):
            if reset:
                eng.exe_cache.reset_stats()
            rec.append(_record(eng, _serve(eng, prompts, tiers, gens, continuous)))
        out[name] = rec
    return out


@pytest.fixture(scope="module")
def records(models):
    p = _traffic(6, seed=1)
    two = [1, "int8", 1, "int8"]
    sync = {
        "two_tiers": (p[:4], two, [4, 3, 1, 4], False),
        "profile": (p[2:5], ["edge"] * 3, [4, 2, 4], False),
        "warm_replay": (p[:4], two, [4, 3, 1, 4], True),
    }
    out = _episode_pair(models, sync)
    out.update(_episode_pair(models, {"continuous": (p, [1, "int8", 1, 1, "int8", 1],
                                                     [4, 2, 3, 1, 4, 2], False)},
                             continuous=True, pool_slots=4))
    out.update(_episode_pair(models, {"max_entries_2": (p, [1, "int8", "edge", 1, "int8", 1],
                                                        [4, 3, 2, 4, 1, 3], False)},
                             max_entries=2))
    return out


@pytest.mark.parametrize("episode", ["two_tiers", "profile", "warm_replay", "continuous",
                                     "max_entries_2"])
def test_engine_cache_counters_match_reference(records, episode):
    port, ref = records[episode]
    assert port == ref
    if episode == "warm_replay":
        assert port["stats"]["misses"] == 0 and port["stats"]["hits"] > 0
    if episode == "max_entries_2":
        assert port["stats"]["evictions"] > 0 and port["stats"]["entries"] == 2


def test_engine_cache_keys_are_the_reference_keys(records):
    """Key for key: the port's cache keys (phase, shape, mesh fingerprint,
    the tier's ``cache_key()``) equal the reference's on the same traffic,
    the tier-free insert among them."""
    port, ref = records["continuous"]
    assert port["keys"] == ref["keys"]
    assert {k[0] for k in port["keys"]} == {"prefill", "decode", "insert"}
    assert [k for k in port["keys"] if k[0] == "insert"] == [("insert", 4, 36, 4)]
