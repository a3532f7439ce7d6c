"""Port vs reference: tensor-parallel analog serving, the tile-salted noise
contract (mirrors tests/test_sharded_serving.py).

Shard r of tp draws its noise at the global column offset r N / tp, so
it computes exactly its tile of the unsharded stream. Held here:

  * words: the port's Threefry words at (r0, c0) equal the reference's and
    the [r0:, c0:] slice of the (0, 0) grid, bit for bit; the port's
    gaussian tiles at an offset equal the slice of its own (0, 0) tile;
  * each port shard (the plain "tile" path, shot, thermal and weight noise,
    K = 1 and 4) against the reference's own per-shard function
    (``analog_matmul_reference(..., offsets=(0, r N / tp))`` on the
    shard's columns) within the parity rule, without a JAX mesh;
  * ``analog_dot`` under a local mesh at tp = 2 and 4 equals the unsharded
    call bit for bit, and each reference fallback (N % tp, calibrated
    quantizers, a per-channel energy, the "torch" backend) is the
    unsharded result, as is the port's own on the card (a shard that would
    change route); the decode and weight launch plans of a shard split
    K as the whole call does;
  * engine tokens at tp = 2 and 4 equal the unsharded oracle for the
    reference's DENSE and GRIFFIN configs under the non-uniform profile,
    batch-synchronous and pooled; ``attach_mesh`` refuses in flight and
    detaches; the moe and xlstm smoke configs' tokens at tp = 2 and 4 equal
    the unsharded engine's, whose tokens equal the reference engine's;
  * a distributed mesh of 2 gloo ranks on the CPU (one shard a rank,
    ``all_gather``), each rank's tokens equal to the oracle.

Torch runs on one thread: with several, a CPU matmul of a column slice may
sum in another order than the whole (seen at (4, 4096) @ (4096, 1024) with
8 threads), and the bit-for-bit checks are of the sharding, not of the
CPU GEMM's threading.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread: see the docstring (and xdist's workers share the cores)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import prng as jprng  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.analog import AnalogConfig, SiteQuant, analog_dot, key_seed  # noqa: E402
from repro_torch.core.profile import PrecisionProfile  # noqa: E402
from repro_torch.kernels import analog_matmul as am  # noqa: E402
from repro_torch.kernels import ops, prng  # noqa: E402
from repro_torch.kernels.ref import analog_matmul_ref_raw  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_mesh_for_devices  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.sharding import get_mesh, use_mesh  # noqa: E402
from repro_torch.quant.affine import QuantParams  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

SB = 32
ENERGY_AJ = 20.0
REL_ATOL = 3e-5  # the parity rule (tests/test_kernels.py:47-52)
DENSE = ModelConfig(name="shard-dense", family="dense", n_layers=2, d_model=32, n_heads=2,
                    n_kv_heads=1, d_ff=64, vocab_size=128, attn_q_chunk=16, attn_kv_chunk=16,
                    dtype="float32")
GRIFFIN = ModelConfig(name="shard-griffin", family="griffin", n_layers=3, d_model=32,
                      n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64, vocab_size=128,
                      rnn_width=32, conv_width=4, local_window=8, attn_q_chunk=16,
                      attn_kv_chunk=16, dtype="float32")
#: non-uniform per-layer repeat profiles (the reference test's)
PROFILES = {"shard-dense": (2, 1), "shard-griffin": (2, 1, 1)}
CONFIGS = {"dense": DENSE, "griffin": GRIFFIN}


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------------
# words and tiles at an offset
# ---------------------------------------------------------------------------


def test_words_at_offset_equal_reference_and_slice():
    k0, k1 = 0xA5A5A5A5, 0x1234
    rows, cols = np.meshgrid(np.arange(16, dtype=np.uint32), np.arange(24, dtype=np.uint32),
                             indexing="ij")
    full = prng.threefry2x32(k0, k1, rows, cols)
    for r0, c0, m, n in [(0, 0, 16, 24), (4, 8, 8, 8), (12, 16, 4, 8), (0, 12, 16, 12)]:
        r, c = rows[:m, :n] + np.uint32(r0), cols[:m, :n] + np.uint32(c0)
        got = prng.threefry2x32(k0, k1, r, c)
        want = jprng.threefry2x32(jnp.uint32(k0), jnp.uint32(k1), jnp.asarray(r), jnp.asarray(c))
        for g, w, f in zip(got, want, full):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
            np.testing.assert_array_equal(np.asarray(g), np.asarray(f)[r0:r0 + m, c0:c0 + n])


@pytest.mark.parametrize("n_repeats", [1, 3])
def test_gaussian_tile_at_offset_is_the_slice(n_repeats):
    k0, k1 = 0xA5A5A5A5, 0x1234
    full = prng.repeat_averaged_gaussian_tile(k0, k1, 0, 0, (16, 24), n_repeats)
    shards = [prng.repeat_averaged_gaussian_tile(k0, k1, 0, j * 12, (16, 12), n_repeats)
              for j in range(2)]
    assert torch.equal(torch.cat(shards, dim=1), full)
    tile = prng.repeat_averaged_gaussian_tile(k0, k1, 4, 8, (8, 8), n_repeats)
    assert torch.equal(tile, full[4:12, 8:16])
    wk0 = k0 ^ prng.WEIGHT_STREAM_SALT  # the weight-noise stream tiles the same way
    assert torch.equal(prng.gaussian_tile(wk0, k1, 0, 8, (8, 8)),
                       prng.gaussian_tile(wk0, k1, 0, 0, (8, 16))[:, 8:16])


# ---------------------------------------------------------------------------
# one analog matmul, sharded
# ---------------------------------------------------------------------------

NOISE = {
    "shot": (AnalogConfig.shot(), JAnalogConfig.shot()),
    "thermal": (AnalogConfig.thermal(0.01), JAnalogConfig.thermal(0.01)),
    "weight": (AnalogConfig.weight(0.1), JAnalogConfig.weight(0.1)),
}


def _operands(b=3, m=5, k=64, n=48, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    keys = prng.fold_in(prng.PRNGKey(1), list(range(b)))
    return x, w, keys


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("n_repeats", [1, 4])
@pytest.mark.parametrize("kind", list(NOISE))
def test_port_shard_matches_reference_shard_function(kind, n_repeats, tp):
    cfg, jcfg = NOISE[kind]
    x, w, keys = _operands()
    n_local = w.shape[1] // tp
    outs = ops.analog_matmul_shards(
        analog_matmul_ref_raw, torch.from_numpy(x), torch.from_numpy(w),
        energy=torch.tensor(ENERGY_AJ), seed=key_seed(keys, "cpu"), cfg=cfg,
        n_repeats=n_repeats, tp=tp, shards=range(tp))
    for r, y in enumerate(outs):
        cols = slice(r * n_local, (r + 1) * n_local)
        want = np.stack([np.asarray(jops.analog_matmul_reference(
            jnp.asarray(x[b]), jnp.asarray(w[:, cols]), energy=jnp.float32(ENERGY_AJ),
            key=jnp.asarray(keys[b]), cfg=jcfg, n_repeats=n_repeats, offsets=(0, r * n_local)))
            for b in range(x.shape[0])])
        err = float(np.abs(_np(y) - want).max())
        assert err <= REL_ATOL * float(np.abs(want).max()), (r, err)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("n_repeats", [1, 4])
@pytest.mark.parametrize("kind", list(NOISE))
def test_analog_dot_sharded_equals_unsharded(kind, n_repeats, tp):
    cfg = NOISE[kind][0]
    x, w, keys = _operands(seed=tp)
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    e = torch.tensor(ENERGY_AJ)
    for seed in (key_seed(keys, "cpu"), key_seed(keys[0], "cpu")):  # stacked, and one key
        xx = x if seed.dim() == 2 else x[0]
        want = analog_dot(xx, w, cfg=cfg, energy=e, seed=seed, n_repeats=n_repeats)
        with use_mesh(make_mesh_for_devices(tp)):
            got = analog_dot(xx, w, cfg=cfg, energy=e, seed=seed, n_repeats=n_repeats)
        assert get_mesh() is None
        assert torch.equal(got, want)


def test_shard_col0_wraps_as_uint32():
    seed = key_seed(np.asarray([[1, 2], [3, 4]], np.uint32), "cpu")
    seed[1, 3] = -8  # col0 word 0xFFFFFFF8
    s = ops.shard_seeds(seed, 4, 4)
    words = s.to(torch.int64) & prng.MASK
    assert words[:, :, :3].eq(seed.to(torch.int64)[None, :, :3] & prng.MASK).all()
    assert words[:, 0, 3].tolist() == [0, 4, 8, 12]
    assert words[:, 1, 3].tolist() == [0xFFFFFFF8, 0xFFFFFFFC, 0, 4]


def _qparams(v, dim=None):
    lo = torch.amin(v, dim=dim) if dim is not None else v.min()
    hi = torch.amax(v, dim=dim) if dim is not None else v.max()
    return QuantParams(torch.clamp_max(lo, 0.0), torch.maximum(hi, lo + 1e-6))


def _fallbacks(x, w):
    """(name, w, cfg, energy, sq) of each reference fallback."""
    thermal = NOISE["thermal"][0]
    sq = SiteQuant(wqp=_qparams(w, 0), xqp=_qparams(x), oqp=_qparams(x @ w))
    return [
        ("N % tp", w[:, :46], NOISE["shot"][0], torch.tensor(ENERGY_AJ), None),
        ("sq", w, thermal, torch.tensor(ENERGY_AJ), sq),
        ("per-channel energy", w, thermal, torch.linspace(5.0, 40.0, w.shape[1]), None),
        ("torch backend", w, AnalogConfig.shot(backend="torch"), torch.tensor(ENERGY_AJ), None),
    ]


@pytest.mark.parametrize("case", range(4), ids=["n_mod_tp", "sq", "per_channel", "torch"])
def test_fallbacks_equal_unsharded(case, monkeypatch):
    x, w, keys = _operands()
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    name, ww, cfg, e, sq = _fallbacks(x, w)[case]
    seed = key_seed(keys, "cpu")
    want = analog_dot(x, ww, cfg=cfg, energy=e, seed=seed, sq=sq)
    called = []
    real = ops.analog_matmul_shards
    monkeypatch.setattr(ops, "analog_matmul_shards",
                        lambda *a, **k: called.append(k["tp"]) or real(*a, **k))
    with use_mesh(make_mesh_for_devices(4)):
        got = analog_dot(x, ww, cfg=cfg, energy=e, seed=seed, sq=sq)
    assert 4 not in called, name  # the whole call (tp = 1) where the backend has one
    assert torch.equal(got, want), name


def test_a_shard_that_would_change_route_runs_whole():
    """On the card a shard narrower than a 16-byte row would take simt
    where the whole call takes decode or tc (grok-1's 8-column router at
    tp = 2, 4): such a site falls back to the whole call."""
    from repro_torch.core import analog as core_analog

    bf = torch.bfloat16
    assert am.shard_keeps_route(4096, 1024, 4, bf) and am.shard_keeps_route(6144, 8, 1, bf)
    assert not am.shard_keeps_route(6144, 8, 2, bf) and not am.shard_keeps_route(6144, 8, 4, bf)
    assert am.shard_keeps_route(64, 12, 2, bf) and am.shard_keeps_route(64, 8, 4, torch.float32)
    x, w = torch.zeros((1, 2, 64), dtype=bf), torch.zeros((64, 8), dtype=bf)
    with use_mesh(make_mesh_for_devices(2)):
        assert core_analog._maybe_sharded_analog_dot(
            x, w, backend="cuda", cfg=AnalogConfig.shot(), energy=torch.tensor(1.0),
            seed=torch.zeros(4, dtype=torch.int32), sq=None, n_repeats=1) is None


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("k,n", [(4096, 12800), (4096, 4096), (12800, 4096), (4096, 1024),
                                 (2560, 256), (2560, 7680)])
def test_shard_launch_plans_split_k_as_the_whole(k, n, tp):
    for rows in (1, 4, 16):
        whole, shard = am.decode_plan(k, n, rows), am.decode_plan(k, n // tp, rows, plan_n=n)
        assert (shard["kc"], shard["splits"]) == (whole["kc"], whole["splits"])
        assert shard["col_tiles"] == -(-(n // tp) // (32 * shard["cpt"]))
    for rows in (1, 32):
        whole, shard = am.weight_plan(k, n, rows), am.weight_plan(k, n // tp, rows, plan_n=n)
        assert (shard["kc"], shard["splits"]) == (whole["kc"], whole["splits"])
        assert shard["col_tiles"] == -(-(n // tp) // am.WEIGHT_BN)
    for rows in (64, 256):
        whole, shard = am.tc_plan(rows, k, n), am.tc_plan(rows, k, n // tp, plan_n=n)
        assert (shard["k_tiles"], shard["splits"]) == (whole["k_tiles"], whole["splits"])
        assert shard["grid_n"] == -(-(n // tp) // am.TC_BN)
    if n >= 4096:  # granite's sites: without plan_n a shard would split K another way
        assert am.decode_plan(k, n // tp, 4)["kc"] != am.decode_plan(k, n, 4)["kc"]
        assert am.weight_plan(k, n // tp, 1)["kc"] != am.weight_plan(k, n, 1)["kc"]
    if n in (12800, 7680):  # ... and so would the tc route at gate/up
        assert am.tc_plan(64, k, n // tp)["splits"] != am.tc_plan(64, k, n)["splits"]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

_ENVS = {}


def _env(cfg):
    if cfg.name not in _ENVS:
        rng = np.random.default_rng(0)
        tree = lm.map_leaves(
            lambda _p, leaf: (rng.standard_normal(leaf.shape) * (leaf.scale or 0.1))
            .astype(np.float32), lm.param_leaves(cfg))
        _ENVS[cfg.name] = dict(params=bridge.params_from_numpy(tree, cfg, "cpu"),
                               energies=lm.init_energy_tree(cfg, ENERGY_AJ, device="cpu"))
    return _ENVS[cfg.name]


def _engine(cfg, mesh=None, **kw):
    env = _env(cfg)
    return ServingEngine(
        env["params"], cfg, analog_cfg=AnalogConfig.shot(backend="tile"),
        energies=env["energies"], max_gen=4, max_batch=2, max_wait=0.0, batch_buckets=(1, 2),
        seq_buckets=(SB,), k_ladder=(1, 2),
        profiles=[PrecisionProfile(PROFILES[cfg.name], name="nu")], mesh=mesh, device="cpu",
        **kw)


def _serve_tokens(cfg, mesh=None, **kw):
    """The reference test's trace: uniform K=2 and the non-uniform profile
    tier, explicit per-request keys; {i: tokens}."""
    eng = _engine(cfg, mesh, **kw)
    rng = np.random.default_rng(7)
    uids = {}
    for i, tier in enumerate([2, "nu", "nu", 2]):
        prompt = rng.integers(0, cfg.vocab_size, 6 + 3 * i).astype(np.int32)
        uids[i] = eng.submit(prompt, tier=tier, max_new_tokens=3,
                             key=prng.fold_in(prng.PRNGKey(0), 100 + i))
    results = eng.flush()
    return {i: np.asarray(results[u]).tolist() for i, u in uids.items()}


_ORACLES = {}


def _oracle(family):
    if family not in _ORACLES:
        _ORACLES[family] = _serve_tokens(CONFIGS[family])
    return _ORACLES[family]


@pytest.mark.parametrize("continuous", [False, True], ids=["sync", "pooled"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("family", list(CONFIGS))
def test_sharded_tokens_match_unsharded_oracle(family, tp, continuous):
    cfg = CONFIGS[family]
    kw = dict(continuous=True, pool_slots=2) if continuous else {}
    calls = []
    real = ops.analog_matmul_shards
    try:
        ops.analog_matmul_shards = lambda *a, **k: calls.append(k["tp"]) or real(*a, **k)
        sharded = _serve_tokens(cfg, make_mesh_for_devices(tp), **kw)
    finally:
        ops.analog_matmul_shards = real
    assert calls and set(calls) == {tp}  # every analog site ran sharded
    assert sharded == _oracle(family)
    if continuous:  # pooled == sync at one seq bucket
        assert sharded == _serve_tokens(cfg, **kw)


def test_attach_mesh_refuses_in_flight_and_detaches():
    eng = _engine(DENSE)
    assert eng.mesh is None
    eng.submit(np.arange(5, dtype=np.int32), n_repeats=2, max_new_tokens=2)
    with pytest.raises(ValueError, match="in flight"):
        eng.attach_mesh(make_mesh_for_devices(2))
    eng.flush()
    params = eng.params
    eng.attach_mesh(make_mesh_for_devices(2))
    assert eng.mesh.tp == 2 and not eng.mesh.distributed
    assert eng.params is params  # replicated: the engine's own tree
    eng.attach_mesh(None)
    assert eng.mesh is None


#: the moe and xlstm smoke configs at float32 (the reference engine's
#: tokens are compared at float32, as tests/test_torch_moe.py does)
FAMILIES = {arch: dataclasses.replace(get_smoke_config(arch), dtype="float32")
            for arch in ("grok-1-314b", "xlstm-1.3b")}
_FAMILY_TOKENS = {}


def _family_tokens(arch, mesh=None, reference=False):
    """Four requests at K = 2 with explicit keys (two batches of two: one
    prefill and one decode shape, which the reference compiles once each)
    through the port's engine, or the reference's (``reference``), on the
    numpy weights of ``_env``; {i: tokens}."""
    cfg = FAMILIES[arch]
    env = _env(cfg)
    kw = dict(max_gen=4, max_batch=2, max_wait=0.0, batch_buckets=(2,), seq_buckets=(SB,),
              k_ladder=(2,))
    if reference:
        jcfg = dataclasses.replace(jsmoke(arch), dtype="float32")
        to_np = lambda tree: {k: to_np(v) if isinstance(v, dict) else _np(v)  # noqa: E731
                              for k, v in tree.items()}
        eng = JServingEngine(jax_tree(to_np(env["params"])), jcfg,
                             analog_cfg=JAnalogConfig.shot(backend="tile"),
                             energies=jax_tree(to_np(env["energies"])), **kw)
        fold = lambda i: jax.random.fold_in(jax.random.PRNGKey(0), 100 + i)  # noqa: E731
    else:
        eng = ServingEngine(env["params"], cfg, analog_cfg=AnalogConfig.shot(backend="tile"),
                            energies=env["energies"], mesh=mesh, device="cpu", **kw)
        fold = lambda i: prng.fold_in(prng.PRNGKey(0), 100 + i)  # noqa: E731
    rng = np.random.default_rng(7)
    uids = {}
    for i in range(4):
        prompt = rng.integers(0, cfg.vocab_size, 6 + 3 * i).astype(np.int32)
        uids[i] = eng.submit(prompt, n_repeats=2, max_new_tokens=3, key=fold(i))
    results = eng.flush()
    return {i: np.asarray(results[u]).tolist() for i, u in uids.items()}


def jax_tree(tree):
    return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_family_tokens_under_a_mesh_equal_unsharded(arch, tp):
    """moe (every expert site one column-split analog_dot an expert: the
    batch-level expert stream, shard by shard) and xlstm (the shared
    mLSTM stream): tokens at tp equal the unsharded engine's bit for bit,
    every analog site sharded."""
    if arch not in _FAMILY_TOKENS:
        _FAMILY_TOKENS[arch] = _family_tokens(arch)
    calls = []
    real = ops.analog_matmul_shards
    try:
        ops.analog_matmul_shards = lambda *a, **k: calls.append(k["tp"]) or real(*a, **k)
        sharded = _family_tokens(arch, make_mesh_for_devices(tp))
    finally:
        ops.analog_matmul_shards = real
    assert calls and set(calls) == {tp}
    assert sharded == _FAMILY_TOKENS[arch]


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_family_unsharded_tokens_equal_reference(arch):
    if arch not in _FAMILY_TOKENS:
        _FAMILY_TOKENS[arch] = _family_tokens(arch)
    assert _FAMILY_TOKENS[arch] == _family_tokens(arch, reference=True)


@pytest.mark.parametrize("arch", ["grok-1-314b", "xlstm-1.3b"])
def test_moe_and_xlstm_under_a_mesh_raise(arch):
    """The refusal this test once held is gone: an engine of either family
    takes a mesh, at construction and through ``attach_mesh``, and
    detaches (its tokens: ``test_family_tokens_under_a_mesh_equal_unsharded``)."""
    cfg = get_smoke_config(arch)
    eng = ServingEngine({}, cfg, mesh=make_mesh_for_devices(2), device="cpu")
    assert eng.mesh.tp == 2
    eng.attach_mesh(make_mesh_for_devices(4))
    assert eng.mesh.tp == 4
    eng.attach_mesh(None)
    assert eng.mesh is None


def test_mesh_shapes():
    mesh = make_mesh_for_devices(4)
    assert mesh.tp == 4 and list(mesh.shards()) == [0, 1, 2, 3] and not mesh.distributed
    with pytest.raises(ValueError):
        Mesh(tp=0)


# ---------------------------------------------------------------------------
# the distributed form: 2 gloo ranks on the CPU
# ---------------------------------------------------------------------------


def _dist_worker(rank: int, world: int, store: str, out: str) -> None:
    """One rank of the distributed mesh: serve the trace, write the tokens.
    The ranks meet at the file ``store`` (a ``file://`` rendezvous: no port
    is chosen ahead of its bind, so no other process can take it)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        mesh = make_mesh_for_devices(world, group=dist.group.WORLD)
        assert list(mesh.shards()) == [rank]
        toks = {f: _serve_tokens(cfg, mesh) for f, cfg in CONFIGS.items()}
        with open(out, "w") as f:
            json.dump(toks, f)
    finally:
        dist.destroy_process_group()


def test_distributed_mesh_tokens_equal_oracle(tmp_path):
    world, store = 2, str(tmp_path / "rendezvous")
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import test_torch_sharded as t; "
            "t._dist_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])")
    outs = [str(tmp_path / f"rank{r}.json") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", code, here, str(r), str(world), store,
                               outs[r]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    for out in outs:
        with open(out) as f:
            got = json.load(f)
        for family in CONFIGS:
            want = {str(i): t for i, t in _oracle(family).items()}
            assert got[family] == want, family
