"""Port vs reference: the batch-synchronous serving engine.

The port's engine must emit exactly the reference engine's tokens on the
same requests and seed (reference on backend "tile", the port's plain path
on the CPU), keep a request's tokens bit-identical solo and batched, and
reject the same malformed requests. The dense config is the size of the
reference serving tests' (``tests/test_serving.py`` FAMILY_CONFIGS), in
float32.
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

from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.serving import bucketing as jbucketing  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving import bucketing  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import Request, TierScheduler  # noqa: E402

_DENSE = dict(name="serve-dense", family="dense", n_layers=2, d_model=32, n_heads=2,
              n_kv_heads=1, head_dim=16, d_ff=64, vocab_size=128, dtype="float32")
CFG = ModelConfig(**_DENSE)
JCFG = JModelConfig(**_DENSE)
ENGINE_KW = dict(max_gen=6, batch_buckets=(1, 2, 4), seq_buckets=(16, 32), seed=3)


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


def _prompts(seed=0, lengths=(5, 12, 9, 14)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, n).astype(np.int32) for n in lengths]


def _engines(model, analog):
    jkw = dict(analog_cfg=JAnalogConfig.shot(backend="tile"), energies=model["jenergies"]) if analog else {}
    kw = dict(analog_cfg=AnalogConfig.shot(), energies=model["energies"]) if analog else {}
    return (JServingEngine(model["jparams"], JCFG, **jkw, **ENGINE_KW),
            ServingEngine(model["params"], CFG, **kw, **ENGINE_KW, device="cpu"))


@pytest.mark.parametrize("analog", [False, True], ids=["digital", "analog"])
def test_engine_tokens_equal_reference_engine(model, analog):
    jeng, eng = _engines(model, analog)
    tiers = [1, 4, 1, 4] if analog else [1, 1, 1, 1]
    for p, k in zip(_prompts(), tiers):
        assert jeng.submit(p, n_repeats=k, max_new_tokens=5) == eng.submit(p, n_repeats=k, max_new_tokens=5)
    want, got = jeng.flush(), eng.flush()
    assert sorted(want) == sorted(got)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]))
    for stat in ("requests", "batches", "tokens_generated", "padded_rows", "decode_steps",
                 "decode_slot_steps"):
        assert eng.stats[stat] == jeng.stats[stat], stat


def test_solo_equals_padded_batch_bit_exact(model):
    """A request's tokens do not depend on its batch-mates or batch padding."""
    prompts = _prompts(1, lengths=(7, 3, 11))
    _, batched = _engines(model, analog=True)
    uids = [batched.submit(p, n_repeats=4) for p in prompts]
    together = batched.flush()
    assert batched.stats["padded_rows"] == 1  # three requests in a 4-row bucket
    for uid, p in zip(uids, prompts):
        _, solo = _engines(model, analog=True)
        solo._uid = uid  # same uid -> same request key as in the batch
        solo.submit(p, n_repeats=4)
        np.testing.assert_array_equal(solo.flush()[uid], together[uid])


def test_stop_tokens_truncate_inside_the_port(model):
    _, eng = _engines(model, analog=True)
    full_uid = eng.submit(_prompts()[0], max_new_tokens=6)
    full = eng.flush()[full_uid]
    stop = int(full[2])
    _, eng2 = _engines(model, analog=True)
    uid = eng2.submit(_prompts()[0], max_new_tokens=6, stop_tokens=(stop,))
    got = eng2.flush()[uid]
    first = int(np.flatnonzero(full == stop)[0])
    np.testing.assert_array_equal(got, full[: first + 1])


BAD_REQUESTS = {
    "empty": dict(tokens=[]),
    "too_long": dict(tokens=list(range(33))),
    "zero_budget": dict(tokens=[1, 2], max_new_tokens=0),
    "over_budget": dict(tokens=[1, 2], max_new_tokens=7),
    "zero_repeats": dict(tokens=[1, 2], n_repeats=0),
}


@pytest.mark.parametrize("case", list(BAD_REQUESTS))
def test_submit_validation_mirrors_reference(model, case):
    jeng, eng = _engines(model, analog=True)
    kw = dict(BAD_REQUESTS[case])
    tokens = kw.pop("tokens")
    with pytest.raises(ValueError):
        jeng.submit(tokens, **kw)
    with pytest.raises(ValueError):
        eng.submit(tokens, **kw)


def test_clock_domains_do_not_mix(model):
    _, eng = _engines(model, analog=False)
    eng.submit([1, 2, 3], now=0.0)
    with pytest.raises(ValueError):
        eng.poll()  # real clock while a virtual-clock request is pending
    assert eng.poll(now=0.0) == {}  # max_wait not reached
    assert len(eng.poll(now=1.0)) == 1


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError):
        ServingEngine({}, CFG)


@pytest.mark.parametrize("n,rows,seq", [(1, 1, 5), (3, 3, 16), (4, 4, 17), (2, 2, 32)])
def test_bucketing_matches_reference(n, rows, seq):
    kw = dict(batch_buckets=(1, 2, 4), seq_buckets=(16, 32))
    assert bucketing.bucket_shape(rows, seq, **kw) == jbucketing.bucket_shape(rows, seq, **kw)
    prompts = _prompts(2, lengths=[max(1, seq - i) for i in range(n)])
    bucket = bucketing.bucket_shape(n, seq, **kw)
    for a, b in zip(bucketing.pad_to_bucket(prompts, bucket, pad_id=7),
                    jbucketing.pad_to_bucket(prompts, bucket, pad_id=7)):
        np.testing.assert_array_equal(a, b)


def test_scheduler_groups_by_tier_and_bucket_with_deadline():
    s = TierScheduler(max_batch=2, max_wait=1.0, seq_buckets=(16, 32))
    reqs = [Request(uid=i, tokens=np.ones(n, np.int32), tier=k, arrival=0.0)
            for i, (n, k) in enumerate([(5, 1), (20, 1), (6, 1), (7, 4)])]
    for r in reqs:
        s.submit(r)
    ready = s.pop_ready(0.5)  # only the full (K=1, 16) group
    assert [[r.uid for r in b] for b in ready] == [[0, 2]]
    assert [[r.uid for r in b] for b in s.pop_ready(1.0)] == [[1], [3]]
    assert s.n_pending == 0
    s.submit(dataclasses.replace(reqs[0]))
    assert [[r.uid for r in b] for b in s.flush()] == [[0]]
