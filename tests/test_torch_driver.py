"""The port's fault-tolerant training driver (``runtime/driver.py``), the
cases of tests/test_runtime.py:30-91 on granite3-smoke: a run with two
simulated failures ends in the clean run's parameters bit for bit, the
loss falls, too many restarts raise, the straggler monitor flags and
persists, int8 gradient compression trains; the training entry point
runs on the CPU. On a data mesh (tests/test_runtime.py:92): a resize
then ``run()`` ends in the uninterrupted run's state bit for bit, a
checkpoint written on 2 data shards restores bit for bit with no mesh,
and the resize logs its event with both meshes' fingerprints. And the step it runs against the reference's
(``make_train_step``, one step at float32, microbatches 1 and 4, int8_ef
off and on): loss and grad norm to 1e-5 relative, 99.9 % of the
parameters within 1e-6 (1 + |p|) of the reference's and every one within
Adam's first step, 2 lr + 1e-6; the port's microbatches 4 against 1
(the reference test's rule). Each reference step is jitted once."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.launch.steps import TrainConfig as JTrainConfig  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import TokenTaskConfig  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.checkpoint.store import latest_step  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for_devices  # noqa: E402
from repro_torch.launch.steps import TrainConfig  # noqa: E402
from repro_torch.runtime import train_lm  # noqa: E402
from repro_torch.runtime.driver import (  # noqa: E402
    DriverConfig,
    SimulatedFailure,
    StragglerMonitor,
    TrainDriver,
)
from repro_torch.tree import leaves  # noqa: E402
from test_torch_train import (  # noqa: E402
    LR,
    PARAM_SHARE,
    _batch,
    _cfgs,
    _jparams,
    _np,
    _params,
    _weights,
)

LOSS_RTOL = 1e-5
T = 32


def _driver(tmp, hook=None, max_steps=24, mesh=None, **tkw):
    model = get_smoke_config("granite-3-8b")
    data = TokenTaskConfig(vocab_size=model.vocab_size, seq_len=T, global_batch=8, seed=3)
    return TrainDriver(
        model, data, mesh, ckpt_dir=str(tmp),
        driver_cfg=DriverConfig(max_steps=max_steps, ckpt_every=8, ckpt_async=False),
        train_cfg=TrainConfig(lr=1e-3, opt_state_dtype="float32", **tkw),
        failure_hook=hook, device="cpu",
    )


def test_failure_recovery_bitexact(tmp_path):
    clean = _driver(tmp_path / "clean").run()
    fails = {5: True, 17: True}

    def hook(step):
        if fails.pop(step, None):
            raise SimulatedFailure(f"crash@{step}")

    drv = _driver(tmp_path / "faulty", hook=hook)
    faulty = drv.run()
    assert drv.restarts == 2 and faulty["step"] == 24
    for a, b in zip(leaves(clean["state"]["params"]), leaves(faulty["state"]["params"])):
        assert torch.equal(a, b)
    for a, b in zip(leaves(clean["state"]["opt"].mu), leaves(faulty["state"]["opt"].mu)):
        assert torch.equal(a, b)


def test_loss_decreases(tmp_path):
    out = _driver(tmp_path, max_steps=40).run()
    losses = [m["loss"] for m in out["metrics"]]
    assert losses[-1] < losses[0]


def test_too_many_restarts_raises(tmp_path):
    def hook(step):
        raise SimulatedFailure("always")

    drv = _driver(tmp_path, hook=hook)
    with pytest.raises(SimulatedFailure):
        drv.run()
    assert drv.restarts == drv.cfg.max_restarts + 1


def test_straggler_monitor_flags_and_persists():
    mon = StragglerMonitor(alpha=0.5, threshold=2.0, patience=3)
    for i in range(10):
        mon.observe(i, 0.1)
    assert not mon.persistent
    assert mon.observe(10, 0.5)  # 5x EWMA -> flagged
    mon.observe(11, 0.5)
    mon.observe(12, 0.5)
    assert mon.persistent
    # outliers must not drag the baseline up
    assert mon.ewma == pytest.approx(0.1, rel=0.05)
    mon.observe(13, 0.1)
    assert not mon.persistent


def test_grad_compression_trains(tmp_path):
    drv = _driver(tmp_path, max_steps=30, grad_compression="int8_ef")
    drv.cfg.ckpt_every = 30
    out = drv.run()
    losses = [m["loss"] for m in out["metrics"]]
    assert losses[-1] < losses[0]


def _state_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(
        leaves(a["params"]) + leaves(a["opt"].mu) + leaves(a["opt"].nu),
        leaves(b["params"]) + leaves(b["opt"].mu) + leaves(b["opt"].nu)))


def test_resize_then_run_resumes_bitexact(tmp_path):
    """tests/test_runtime.py:92 on a data mesh of 2 shards: a resize to a
    fresh mesh of the same shape mid-run, then ``run()``, ends in the
    uninterrupted run's state bit for bit."""
    clean = _driver(tmp_path / "clean", max_steps=16, mesh=make_mesh_for_devices(1, data=2)).run()
    _driver(tmp_path / "resized", max_steps=8, mesh=make_mesh_for_devices(1, data=2)).run()
    drv = _driver(tmp_path / "resized", max_steps=16, mesh=make_mesh_for_devices(1, data=2))
    drv.resize(make_mesh_for_devices(1, data=2))
    out = drv.run()
    assert out["step"] == 16
    assert _state_equal(clean["state"], out["state"])


def test_data_mesh_checkpoint_restores_on_one_device(tmp_path):
    """A checkpoint written on a data mesh of 2 shards holds the whole state:
    a driver with no mesh restores it bit for bit."""
    out = _driver(tmp_path, max_steps=8, mesh=make_mesh_for_devices(1, data=2)).run()
    step, state = _driver(tmp_path, max_steps=8)._restore_or_init()
    assert step == 8 and _state_equal(out["state"], state)


def test_resize_event_fields(tmp_path):
    _driver(tmp_path, max_steps=8).run()
    drv = _driver(tmp_path, max_steps=16)
    drv.resize(make_mesh_for_devices(1, data=2))
    assert drv.metrics_log == [{"step": 8, "event": "resize", "mesh_from": (),
                                "mesh_to": (("data", "tp"), (2, 1), ("local:0", "local:1"))}]
    assert drv.mesh.data == 2 and latest_step(str(tmp_path)) == 8


def test_train_lm_entry_point_runs_on_the_cpu(tmp_path, capsys):
    train_lm.main(["--steps", "2", "--seq-len", "16", "--batch", "2", "--device", "cpu",
                   "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "demo-10m" in out and "checkpoints in" in out
    assert sorted(n for n in tmp_path.iterdir() if n.name.startswith("step_"))


# ---------------------------------------------------------------------------
# the train step against the reference's
# ---------------------------------------------------------------------------

_JSTEPS = {}


def _jstep(jcfg, m, compression):
    """The reference's jitted train step, once per variant."""
    key = (m, compression)
    if key not in _JSTEPS:
        tcfg = JTrainConfig(lr=LR, opt_state_dtype="float32", microbatches=m,
                            grad_compression=compression)
        _, jit_for, _ = jmake_train_step(jcfg, make_local_mesh(), tcfg)
        specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in _batch(jcfg).items()}
        _JSTEPS[key] = (jit_for(specs), tcfg)
    return _JSTEPS[key]


@pytest.mark.parametrize("m,compression", [(1, None), (4, None), (1, "int8_ef"),
                                           (4, "int8_ef")])
def test_train_step_matches_reference(m, compression):
    cfg, jcfg = _cfgs()
    tree, batch = _weights(cfg, seed=2), _batch(cfg)
    tcfg = steps.TrainConfig(lr=LR, opt_state_dtype="float32", microbatches=m,
                             grad_compression=compression)
    params = _params(tree, cfg)
    step = steps.make_train_step(cfg, None, tcfg)
    params, opt, metrics = step(params, steps.make_opt_init(cfg, None, tcfg)(params), batch)
    jstep, jtcfg = _jstep(jcfg, m, compression)
    jp0 = _jparams(tree, jcfg)
    jparams, jopt, jmetrics = jstep(jp0, jadam.adam_init(jp0, jtcfg.adam()), batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=LOSS_RTOL)
    assert int(opt.step) == int(jopt.step) == 1
    close = total = 0
    for p, jp in zip(leaves(params), jax.tree.leaves(jparams)):
        diff = np.abs(_np(p) - np.asarray(jp))
        assert diff.max() <= 2 * LR + 1e-6  # Adam's first step moves lr * sign(g)
        close += int((diff <= 1e-6 * (1 + np.abs(np.asarray(jp)))).sum())
        total += diff.size
    assert close >= PARAM_SHARE * total, (close, total)


def test_microbatched_step_matches_full_batch():
    """Gradient accumulation in the port equals the full batch (the
    reference's tests/test_runtime.py rule)."""
    cfg, _ = _cfgs()
    tree, batch = _weights(cfg, seed=3), _batch(cfg, rows=8)
    outs = {}
    for m in (1, 4):
        tcfg = steps.TrainConfig(lr=LR, opt_state_dtype="float32", microbatches=m)
        params = _params(tree, cfg)
        step = steps.make_train_step(cfg, None, tcfg)
        p2, _, metrics = step(params, steps.make_opt_init(cfg, None, tcfg)(params), batch)
        outs[m] = (p2, float(metrics["loss"]))
    assert outs[1][1] == pytest.approx(outs[4][1], rel=1e-4)
    assert max(float((a - b).abs().max())
               for a, b in zip(leaves(outs[1][0]), leaves(outs[4][0]))) < 1e-4
