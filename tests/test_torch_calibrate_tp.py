"""The LM calibration on a mesh of data x tensor shards, the local form
(``launch/steps.py`` ``make_calibrate_step(cfg, make_mesh_for_devices(tp,
data=...))``; the analog sites' forms under tp: ``models/hooks.py``,
``core/analog.py`` ``analog_dot(cols=)`` and ``analog_dot_rows``,
``models/sharding.py`` ``energy_sums``).

At the sites, on ``"tile"`` and ``"torch"``, tp 2 and 4, shot, thermal
and weight noise: a column shard's output is its window of the unsharded
call's bit for bit, and so is a whole site's on a shard (the whole call);
a row-cut site summed by *g* (noise drawn once after the sum) and a
reduce-scattered one (each shard its columns of the noise after the sum)
lie within the kernel rule, ``3e-5·max|y|``, of the unsharded call; on a
data shard (shot, weight) the row-cut site gives the unsharded call's
rows of that shard within the same rule.

The step: float32 smoke configs without remat, numpy weights, 2 steps of
4 x 32 from a uniform start at 8 aJ/MAC, keys ``fold_in(key, i)``. The
local form at tp 2 and at data 2 x tp 2 (granite3-smoke, rgemma-smoke
with tied embeddings, grok1-smoke; xlstm-smoke under its ``"dp"``
profile, whose 1 x 2 and 2 x 2 meshes are 2 and 4 data shards), shot
noise on ``"torch"`` (granite3 also on ``"tile"``), weight noise, and
thermal noise on the tensor axis, against the port's one-device step:
loss and NLL within ``REL`` relative, log energies within ``LOG_E``
(shot and weight) or ``THERMAL_LOG_E`` absolute. The bounds are about 4x
the largest distance these cases measured on the CPU (losses 1.6e-7, log
energies 1.2e-7: one float32 ulp at |log E| ~ 2; thermal 2.9e-6 at
rgemma on "torch": its std reads the input range through a max and a
min, and Adam's second step normalises a small gradient that reaches
through them); two planted faults land at least 5x outside them: a
column shard that draws the noise of columns 0.. (every column-cut site)
and row-cut sites that draw their noise on each partial before the sum.
On a data axis of the local form thermal noise still raises
``ThermalRangeAcrossShards``. The granite3 case on ``"tile"`` at data 2
x tp 2 is held to the reference's one-device ``make_calibrate_step`` in
``tests/test_torch_calibrate_dp.py`` (beside the data mesh's check, whose
reference run it shares).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

# the port only: the gloo ranks of tests/test_torch_calibrate_tp_dist.py
# import this module
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import analog  # noqa: E402
from repro_torch.core.analog import AnalogConfig, ThermalRangeAcrossShards, key_seed  # noqa: E402
from repro_torch.core.energy import uniform_log_energies  # noqa: E402
from repro_torch.data.pipeline import TokenTaskConfig, markov_batch  # noqa: E402
from repro_torch.kernels import prng  # noqa: E402
from repro_torch.launch import collectives, steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for_devices  # noqa: E402
from repro_torch.models import hooks, lm  # noqa: E402
from repro_torch.models.sharding import (  # noqa: E402
    DataShard,
    Shards,
    TensorShard,
    energy_sums,
    use_data_shard,
)
from repro_torch.optim import adam  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

T, B, STEPS, LR, E0 = 32, 4, 2, 0.1, 8.0
#: the kernel rule for an after-sum site: |y - y_one| <= RULE * max|y_one|
RULE = 3e-5
#: the local form against the one-device step (module docstring)
REL, LOG_E, THERMAL_LOG_E = 1e-6, 5e-7, 1.2e-5
#: a planted fault lies this many times outside the bounds
FAULT_MARGIN = 5.0
ARCHS = {"granite3": ("granite-3-8b", {}),
         "rgemma": ("recurrentgemma-2b", {"tie_embeddings": True}),
         "grok1": ("grok-1-314b", {}),
         "xlstm_dp": ("xlstm-1.3b", {"sharding_profile": "dp"})}
MESHES = {"tp2": (1, 2), "data2_tp2": (2, 2)}  # name -> (data, tp)
STEP_CASES = (
    [(a, m, "shot", "torch") for a in ARCHS for m in MESHES]
    + [("granite3", m, "shot", "tile") for m in MESHES]
    + [(a, m, "weight", "torch") for a in ("granite3", "rgemma") for m in MESHES]
    + [(a, "tp2", "thermal", b) for a in ("granite3", "rgemma", "grok1") for b in ("torch", "tile")])


def _cfg(name):
    arch, kw = ARCHS[name]
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", remat=False, **kw)


@functools.lru_cache(maxsize=None)
def _tree(name):
    rng = np.random.default_rng(5)
    return lm.map_leaves(lambda _p, leaf: (rng.standard_normal(leaf.shape)
                                           * (leaf.scale or 0.1)).astype(np.float32),
                         lm.param_leaves(_cfg(name)))


def _batch(cfg):
    return markov_batch(TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=T, global_batch=B,
                                        seed=3), 0)


def _run(name, noise, backend, mesh):
    """``STEPS`` calibrate steps on ``mesh`` (None: one device; a rank's
    tensor shard of the weights in the distributed form): ([(loss, nll)],
    log-energy leaves)."""
    cfg = _cfg(name)
    step = steps.make_calibrate_step(cfg, mesh, analog_cfg=getattr(AnalogConfig, noise)(
        backend=backend), seq_len=T, target_e_per_mac=1.0, lam=20.0, lr=LR)
    params = bridge.params_from_numpy(_tree(name), cfg, "cpu")
    if mesh is not None:
        params = steps.shard_params(params, cfg, mesh)
    log_e = uniform_log_energies(step.macs, E0)
    opt = adam.adam_init(log_e, adam.AdamConfig(lr=LR))
    metrics = []
    for i in range(STEPS):
        log_e, opt, m = step(log_e, opt, params, _batch(cfg), prng.fold_in(prng.PRNGKey(0), i))
        metrics.append((float(m["loss"]), float(m["nll"])))
    return metrics, leaves(log_e)


@functools.lru_cache(maxsize=None)
def _one_device(name, noise, backend):
    return _run(name, noise, backend, None)


@functools.lru_cache(maxsize=None)
def _local(name, mesh_name, noise, backend):
    data, tp = MESHES[mesh_name]
    return _run(name, noise, backend, make_mesh_for_devices(tp, data=data))


def _distance(got, want) -> tuple:
    """(largest relative distance of a loss or NLL, largest absolute
    distance of a log energy)."""
    rel = max(abs(a - b) / abs(b) for g, w in zip(got[0], want[0]) for a, b in zip(g, w))
    log_e = max(float((a - b).abs().max()) for a, b in zip(got[1], want[1]))
    return rel, log_e


def _bounds(noise) -> tuple:
    return REL, THERMAL_LOG_E if noise == "thermal" else LOG_E


# ---------------------------------------------------------------------------
# the sites
# ---------------------------------------------------------------------------

SITE_NOISE = ("shot", "thermal", "weight")


def _site(backend, tp, seed_key=7):
    """(hook, x (2, 16, 64), w (64, 64), shards): one site ``"s"`` on tp
    local tensor shards, its energy a ``Shards`` leaf of one tensor a
    shard (the calibration's per-shard energy leaves)."""
    rng = np.random.default_rng(seed_key)
    x = torch.from_numpy(rng.standard_normal((2, 16, 64)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((64, 64)) * 0.125).astype(np.float32))
    shards = tuple(TensorShard(t, tp) for t in range(tp))
    energy = Shards([torch.tensor(6.0) for _ in shards], shards)
    seed = key_seed(analog.site_key(prng.PRNGKey(seed_key), "s"), "cpu")
    return backend, x, w, shards, energy, seed


def _hook(noise, backend, energy, seed):
    return hooks.AnalogHook(cfg=getattr(AnalogConfig, noise)(backend=backend),
                            energies={"s": energy}, seeds={"s": seed})


def _within_rule(got, want) -> bool:
    return float((got - want).abs().max()) <= RULE * float(want.abs().max())


@pytest.mark.parametrize("backend", ["tile", "torch"])
@pytest.mark.parametrize("tp", [2, 4])
def test_column_shard_is_the_unsharded_window(backend, tp):
    for noise in SITE_NOISE:
        _, x, w, shards, energy, seed = _site(backend, tp)
        hook = _hook(noise, backend, energy, seed)
        whole = hook("s", x, w)
        n = w.shape[1] // tp
        for s in shards:
            part = hook("s", x, w[:, s.t * n:(s.t + 1) * n].contiguous(), shard=s)
            assert torch.equal(part, whole[..., s.t * n:(s.t + 1) * n]), (noise, s)


@pytest.mark.parametrize("backend", ["tile", "torch"])
@pytest.mark.parametrize("tp", [2, 4])
def test_whole_site_on_a_shard_is_the_unsharded_call(backend, tp):
    for noise in SITE_NOISE:
        _, x, w, shards, energy, seed = _site(backend, tp)
        hook = _hook(noise, backend, energy, seed)
        whole = hook("s", x, w)
        for s in shards:
            assert torch.equal(hook("s", x, w, shard=s, cut=False), whole), (noise, s)


def _row_parts(x, w, shards):
    k = w.shape[0] // len(shards)
    return ([x[..., s.t * k:(s.t + 1) * k].contiguous() for s in shards],
            [w[s.t * k:(s.t + 1) * k].contiguous() for s in shards])


@pytest.mark.parametrize("backend", ["tile", "torch"])
@pytest.mark.parametrize("tp", [2, 4])
def test_row_cut_site_noise_after_the_sum(backend, tp):
    for noise in SITE_NOISE:
        _, x, w, shards, energy, seed = _site(backend, tp)
        hook = _hook(noise, backend, energy, seed)
        whole = hook("s", x, w)
        xs, ws = _row_parts(x, w, shards)
        assert _within_rule(hook.row_parallel("s", xs, ws, shards), whole), noise


@pytest.mark.parametrize("backend", ["tile", "torch"])
@pytest.mark.parametrize("tp", [2, 4])
def test_reduce_scattered_site_is_the_unsharded_columns(backend, tp):
    for noise in SITE_NOISE:
        _, x, w, shards, energy, seed = _site(backend, tp)
        hook = _hook(noise, backend, energy, seed)
        whole = hook("s", x, w)
        xs, ws = _row_parts(x, w, shards)
        got = torch.cat(hook.reduce_scatter("s", xs, ws, shards), dim=-1)
        assert _within_rule(got, whole), noise


@pytest.mark.parametrize("backend", ["tile", "torch"])
def test_row_cut_site_on_a_data_shard_is_its_rows(backend):
    for noise in ("shot", "weight"):
        _, x, w, shards, energy, seed = _site(backend, 2)
        hook = _hook(noise, backend, energy, seed)
        whole = hook("s", x, w)
        for r in range(2):
            xs, ws = _row_parts(x[r:r + 1], w, shards)
            with use_data_shard(DataShard(r, 2)):
                got = hook.row_parallel("s", xs, ws, shards)
            assert _within_rule(got, whole[r:r + 1]), (noise, r)


def test_quantizers_on_a_shard_raise():
    from repro_torch.core.analog import QuantizersUnderTensorShards, SiteQuant

    _, x, w, shards, energy, seed = _site("tile", 2)
    with pytest.raises(QuantizersUnderTensorShards):
        analog.analog_dot(x, w[:, :32], cfg=AnalogConfig.shot(backend="tile"), energy=6.0,
                          seed=seed, sq=SiteQuant(), cols=(0, 2))
    xs, ws = _row_parts(x, w, shards)
    with pytest.raises(QuantizersUnderTensorShards):
        analog.analog_dot_rows(xs, ws, shards, cfg=AnalogConfig.shot(backend="tile"),
                               energies=[6.0], seed=seed, sq=SiteQuant())


def test_energy_sums_follow_the_plan():
    """Column-cut, reduce-scattered and summed-kv sites are summed over tp;
    row-cut and whole sites are taken once."""
    g = energy_sums(_cfg("granite3"), 4)["groups"]  # 4 heads, 2 kv heads: kv whole, summed
    assert g["attn0_q"] and g["attn0_k"] and g["mlp0_gate"] and not g["attn0_o"]
    assert not g["mlp0_out"]
    rg = energy_sums(_cfg("rgemma"), 2)
    assert rg["groups"]["rec0_rec_a"] and rg["groups"]["rec0_rec_in"]
    assert not rg["groups"]["rec0_rec_out"] and rg["lm_head"] and rg["tail"]["mlp0_up"]
    grok = energy_sums(_cfg("grok1"), 2)["groups"]
    assert not grok["router"] and grok["moe_gate"] and not grok["moe_down"]
    six = energy_sums(dataclasses.replace(_cfg("granite3"), n_heads=6), 4)["groups"]
    assert not six["attn0_q"] and not six["attn0_o"] and six["mlp0_up"]


# ---------------------------------------------------------------------------
# the step's local form against one device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,mesh_name,noise,backend", STEP_CASES)
def test_local_form_matches_one_device(name, mesh_name, noise, backend):
    got = _local(name, mesh_name, noise, backend)
    rel, log_e = _distance(got, _one_device(name, noise, backend))
    print(f"{name} {mesh_name} {noise} {backend}: rel {rel:.3g}, log E {log_e:.3g}")
    bound_rel, bound_log_e = _bounds(noise)
    assert rel <= bound_rel and log_e <= bound_log_e


def test_thermal_on_a_local_data_axis_raises():
    with pytest.raises(ThermalRangeAcrossShards):
        _local("granite3", "data2_tp2", "thermal", "torch")
    with pytest.raises(ThermalRangeAcrossShards):
        _local("xlstm_dp", "tp2", "thermal", "torch")


def _columns_from_zero(monkeypatch):
    real = hooks.analog_dot
    monkeypatch.setattr(hooks, "analog_dot", lambda *a, cols=None, **kw: real(*a, **kw))


def _noise_before_the_sum(monkeypatch):
    def rows(xs, ws, shards, *, energies, scatter=False, **kw):
        parts = [analog.analog_dot(x, w, energy=energies[0], **kw) for x, w in zip(xs, ws)]
        if scatter:
            return collectives.reduce_scatter_tp(parts, shards)
        return collectives.reduce_from_tp(parts, shards)

    monkeypatch.setattr(hooks, "analog_dot_rows", rows)


@pytest.mark.parametrize("fault", [_columns_from_zero, _noise_before_the_sum])
def test_planted_faults_fall_outside_the_bounds(fault, monkeypatch):
    want = _one_device("granite3", "shot", "torch")
    fault(monkeypatch)
    data, tp = MESHES["tp2"]
    rel, log_e = _distance(_run("granite3", "shot", "torch", make_mesh_for_devices(tp, data=data)),
                           want)
    print(f"{fault.__name__}: rel {rel:.3g}, log E {log_e:.3g}")
    assert rel >= FAULT_MARGIN * REL or log_e >= FAULT_MARGIN * LOG_E
