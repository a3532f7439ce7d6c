"""The LM calibration on a mesh of data shards (``launch/steps.py``
``make_calibrate_step(cfg, make_mesh_for_devices(1, data=2))``), on the
smoke configs of the dense, griffin, xlstm and moe families at float32
without remat, numpy weights, 2 steps of 4 x 32 from a uniform start at
8 aJ/MAC, keys ``fold_in(key, i)``:

* shot and weight noise on ``"tile"`` and ``"torch"``: the local form
  (the shards one after another) equals two gloo ranks bit for bit
  (metrics and log energies, on both ranks), and the one-device step
  within ``ONE_DEVICE_RTOL`` relative (loss, NLL, log energies: the
  shards' rows sum their NLLs and gradients in another order);
* thermal noise on the ranks (its input range reduced across them): the
  ranks agree bit for bit and match the one-device step within
  ``THERMAL_RTOL``; the local form refuses it (``ThermalRangeAcrossShards``);
* on ``"tile"`` the data mesh matches the reference's one-device step
  (``make_local_mesh``) within the rule ``tests/test_torch_calibrate_lm.py``
  holds the one-device step to: loss, NLL and log energies at ``rtol``
  1e-5 (dense and xlstm; every family's local form is held to its own
  one-device step above, and the moe reference's NaN energy gradients,
  ROADMAP C, keep moe out), and so does dense on a data 2 x tp 2 mesh
  (its local form; ``tests/test_torch_calibrate_tp.py`` holds the tp
  forms to the port's one-device step), sharing the reference's run;
* at the hooks: every site's noise of each shard is the one-device noise's
  rows bit for bit (``"tile"``: the counter-based gaussians at row0 + r ×
  the call's rows; ``"torch"``: the whole call's draw, the shard's rows),
  shot and weight noise;
* an MoE shard that would split an expert group raises
  ``MoEGroupsAcrossShards``.

The ranks meet at a ``file://`` store under the test's temporary
directory (no port is chosen ahead of its bind).
"""
import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

# the reference is imported inside the tests that call it: the spawned
# ranks import this module, and need only the port
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import noise as noise_lib  # noqa: E402
from repro_torch.core.analog import AnalogConfig, ThermalRangeAcrossShards  # noqa: E402
from repro_torch.core.energy import uniform_log_energies  # noqa: E402
from repro_torch.data.pipeline import TokenTaskConfig, markov_batch  # noqa: E402
from repro_torch.kernels import prng  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for_devices  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.sharding import DataShard, use_data_shard  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

T, B, DP, STEPS = 32, 4, 2, 2
LR, E0 = 0.1, 8.0
LOSS_RTOL = 1e-5
#: the data mesh against the one-device step: the same noise, the shards'
#: NLLs and gradients summed in another order (measured: log energies
#: within 1.2e-7, losses equal, over these cases on the CPU)
ONE_DEVICE_RTOL = 1e-5
#: thermal noise on the ranks against the one-device step: its std reads
#: the input range through a max and a min reduced across the ranks, and
#: Adam's second step normalises a small gradient that reaches through
#: them (measured: 1.07e-5 relative at one log energy, "torch" backend)
THERMAL_RTOL = 5e-5
ARCHS = ("granite-3-8b", "recurrentgemma-2b", "xlstm-1.3b", "grok-1-314b")
CASES = [(a, n, b) for a in ARCHS for n in ("shot", "weight") for b in ("tile", "torch")]
THERMAL = [("granite-3-8b", "tile"), ("granite-3-8b", "torch")]


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", remat=False)


@functools.lru_cache(maxsize=None)
def _tree(arch):
    rng = np.random.default_rng(5)
    return lm.map_leaves(lambda _p, leaf: (rng.standard_normal(leaf.shape)
                                           * (leaf.scale or 0.1)).astype(np.float32),
                         lm.param_leaves(_cfg(arch)))


def _batch(cfg, rows=B):
    return markov_batch(TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=T, global_batch=rows,
                                        seed=3), 0)


def _analog(noise, backend):
    return getattr(AnalogConfig, noise)(backend=backend)


def _run(arch, noise, backend, mesh):
    """``STEPS`` calibrate steps: ([(loss, nll)], log-energy leaves)."""
    cfg = _cfg(arch)
    step = steps.make_calibrate_step(cfg, mesh, analog_cfg=_analog(noise, backend), seq_len=T,
                                     target_e_per_mac=1.0, lam=20.0, lr=LR)
    params = bridge.params_from_numpy(_tree(arch), cfg, "cpu")
    log_e = uniform_log_energies(step.macs, E0)
    opt = adam.adam_init(log_e, adam.AdamConfig(lr=LR))
    metrics = []
    for i in range(STEPS):
        log_e, opt, m = step(log_e, opt, params, _batch(cfg), prng.fold_in(prng.PRNGKey(0), i))
        metrics.append((float(m["loss"]), float(m["nll"])))
    return metrics, leaves(log_e)


@functools.lru_cache(maxsize=None)
def _local(arch, noise, backend):
    return _run(arch, noise, backend, make_mesh_for_devices(1, data=DP))


@functools.lru_cache(maxsize=None)
def _one_device(arch, noise, backend):
    return _run(arch, noise, backend, None)


def _equal(a, b):
    return a[0] == b[0] and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), rtol=rtol)
    for x, y in zip(got[1], want[1]):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=rtol)


# ---------------------------------------------------------------------------
# the distributed form: two gloo ranks on the CPU, spawned once
# ---------------------------------------------------------------------------


def _worker(rank, store, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=DP, rank=rank)
    try:
        mesh = make_mesh_for_devices(1, group=dist.group.WORLD, data=DP)
        res = {case: _run(*case, mesh) for case in CASES}
        res.update({("thermal",) + c: _run(c[0], "thermal", c[1], mesh) for c in THERMAL})
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp

    out = str(tmp_path_factory.mktemp("cal_dp"))
    mp.start_processes(_worker, args=(os.path.join(out, "rendezvous"), out), nprocs=DP,
                       start_method="spawn", join=True)
    return [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(DP)]


@pytest.mark.parametrize("arch,noise,backend", CASES)
def test_local_form_equals_ranks_and_matches_one_device(ranks, arch, noise, backend):
    local = _local(arch, noise, backend)
    for res in ranks:
        assert _equal(res[arch, noise, backend], local)
    _close(local, _one_device(arch, noise, backend), ONE_DEVICE_RTOL)


@pytest.mark.parametrize("arch,backend", THERMAL)
def test_thermal_noise_on_ranks(ranks, arch, backend):
    a, b = (res["thermal", arch, backend] for res in ranks)
    assert _equal(a, b)
    _close(a, _one_device(arch, "thermal", backend), THERMAL_RTOL)
    with pytest.raises(ThermalRangeAcrossShards):
        _run(arch, "thermal", backend, make_mesh_for_devices(1, data=DP))


# ---------------------------------------------------------------------------
# against the reference's one-device step
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's one-device ``make_calibrate_step`` ("tile", shot),
    ``STEPS`` steps: ([(loss, nll)], log-energy leaves as numpy)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jsmoke
    from repro.core import AnalogConfig as JAnalogConfig
    from repro.core.energy import uniform_log_energies as juniform
    from repro.launch.mesh import make_local_mesh
    from repro.launch.steps import make_calibrate_step as jmake_calibrate_step
    from repro.optim import adam as jadam

    jcfg = dataclasses.replace(jsmoke(arch), dtype="float32", remat=False)
    batch = _batch(_cfg(arch))
    _, jit_for, aux = jmake_calibrate_step(jcfg, make_local_mesh(),
                                           analog_cfg=JAnalogConfig.shot(backend="tile"),
                                           seq_len=T, target_e_per_mac=1.0, lam=20.0, lr=LR)
    jstep = jit_for({k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()})
    jlog_e = juniform(aux["macs"], E0)
    jopt = jadam.adam_init(jlog_e, jadam.AdamConfig(lr=LR))
    jparams = jax.tree.map(jnp.asarray, _tree(arch))
    want = []
    for i in range(STEPS):
        jlog_e, jopt, jm = jstep(jlog_e, jopt, jparams, batch,
                                 jax.random.fold_in(jax.random.PRNGKey(0), i))
        want.append((float(jm["loss"]), float(jm["nll"])))
    return want, [np.asarray(b) for b in jax.tree.leaves(jlog_e)]


def _matches_reference(got, arch):
    want, want_log_e = _reference(arch)
    metrics, log_e = got
    np.testing.assert_allclose(np.asarray(metrics), np.asarray(want), rtol=LOSS_RTOL)
    for a, b in zip(log_e, want_log_e):
        np.testing.assert_allclose(a.numpy(), b, rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ["granite-3-8b", "xlstm-1.3b"])
def test_data_mesh_matches_reference_step(arch):
    _matches_reference(_local(arch, "shot", "tile"), arch)


def test_data_x_tp_mesh_matches_reference_step():
    """The local form on data 2 x tp 2 (granite's Megatron shards, the
    row-cut sites' noise drawn after the sum) against the same one-device
    reference step, at the same rule."""
    _matches_reference(_run("granite-3-8b", "shot", "tile", make_mesh_for_devices(2, data=DP)),
                       "granite-3-8b")


# ---------------------------------------------------------------------------
# each shard's site noise: the one-device noise's rows
# ---------------------------------------------------------------------------


def _site_noise(arch, noise, backend, shard, monkeypatch):
    """The gaussians every analog site draws in one analog train loss (a
    shard's rows of the batch under ``shard``), each as (rows, N)."""
    drawn = []
    if backend == "tile":
        real = prng.repeat_averaged_gaussian_tile

        def spy(*args, **kw):
            out = real(*args, **kw)
            drawn.append(out.reshape(-1, out.shape[-1]))
            return out

        monkeypatch.setattr(prng, "repeat_averaged_gaussian_tile", spy)
    else:
        real_normal, real_randn = noise_lib.standard_normal, torch.randn

        def spy(*args, **kw):
            out = real_normal(*args, **kw)
            drawn.append(out.reshape(-1, out.shape[-1]))
            return out

        def spy_randn(*args, **kw):  # weight noise: the whole weight's draw
            out = real_randn(*args, **kw)
            drawn.append(out.reshape(-1, out.shape[-1]))
            return out

        monkeypatch.setattr(noise_lib, "standard_normal", spy)
        if noise == "weight":
            monkeypatch.setattr(noise_lib.torch, "randn", spy_randn)
    cfg = _cfg(arch)
    batch = steps.batch_tensors(_batch(cfg), "cpu")
    if shard is not None:
        per = B // shard.data
        batch = {k: v[shard.r * per:(shard.r + 1) * per] for k, v in batch.items()}
    params = bridge.params_from_numpy(_tree(arch), cfg, "cpu")
    spec = lm.AnalogSpec(cfg=_analog(noise, backend), energies=lm.init_energy_tree(cfg, E0, "cpu"),
                         key=prng.PRNGKey(0))
    with torch.no_grad(), use_data_shard(shard):
        lm.train_loss(params, batch, cfg, analog=spec)
    monkeypatch.undo()
    return drawn


@pytest.mark.parametrize("arch,noise,backend", CASES)
def test_shard_noise_is_one_device_rows(arch, noise, backend, monkeypatch):
    whole = _site_noise(arch, noise, backend, None, monkeypatch)
    assert whole
    for r in range(DP):
        part = _site_noise(arch, noise, backend, DataShard(r, DP), monkeypatch)
        assert len(part) == len(whole)
        for p, w in zip(part, whole):
            if noise == "weight":  # drawn on the replicated weight
                assert torch.equal(p, w)
            else:
                m = p.shape[0]
                assert w.shape[0] == DP * m
                assert torch.equal(p, w[r * m:(r + 1) * m])


def test_moe_shard_splitting_a_group_raises():
    cfg = dataclasses.replace(_cfg("grok-1-314b"), moe_group_size=3 * T)
    step = steps.make_calibrate_step(cfg, make_mesh_for_devices(1, data=DP),
                                     analog_cfg=_analog("shot", "tile"), seq_len=T,
                                     target_e_per_mac=1.0, lam=20.0, lr=LR)
    log_e = uniform_log_energies(step.macs, E0)
    with pytest.raises(steps.MoEGroupsAcrossShards):
        step(log_e, adam.adam_init(log_e, adam.AdamConfig(lr=LR)),
             bridge.params_from_numpy(_tree("grok-1-314b"), cfg, "cpu"), _batch(cfg),
             prng.PRNGKey(0))
