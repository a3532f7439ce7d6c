"""Data-parallel training with ZeRO-1 moments (``launch/steps.py`` on a
data mesh, ``launch/collectives.py``, ``optim/compress.py``
``compressed_psum``, ``TrainDriver``'s ZeRO-1 checkpoints).

Local form (the data shards one after another in one process):

* at data = 2 and 4, two steps equal the one-device step at
  ``microbatches = data`` bit for bit (loss, gradient norm, parameters,
  moments) on the dense and moe smoke configs (moe: the expert views),
  and on xlstm's at data = 2 (its "dp" profile);
* one step against the reference's ``make_train_step`` on the whole batch
  (``make_local_mesh()``) at float32, the bounds of the step test in
  ``tests/test_torch_driver.py``: loss and gradient norm to 1e-5
  relative, every parameter within Adam's first step (2 lr + 1e-6) and
  99.9 % within 1e-6 (1 + |p|).

Distributed form: one module fixture spawns two gloo ranks on the CPU
once; in them

* two steps at data = 2 equal the local form's bit for bit on both ranks
  (the moments gathered from the ranks' regions), each rank holding about
  half the moments;
* ``compressed_psum`` of per-rank inputs equals the reference's run under
  ``jax.vmap(..., axis_name=...)`` on the same inputs bit for bit;
* a ``TrainDriver`` on the distributed mesh checkpoints the whole state
  (rank 0 writes), equal bit for bit to the local form's run, and every
  rank restores its regions of it.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

# the reference is imported inside the tests that call it: the spawned
# ranks import this module, and need only the port
from repro_torch.checkpoint.store import restore_checkpoint  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import TokenTaskConfig, markov_batch  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for_devices  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim.compress import compressed_psum  # noqa: E402
from repro_torch.runtime.driver import DriverConfig, TrainDriver  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

T, ROWS, LR = 32, 4, 1e-3
LOSS_RTOL, PARAM_SHARE = 1e-5, 0.999
STEP_ARCHS = ("granite-3-8b", "grok-1-314b")
PSUM_SHAPES = [(64,), (7, 33)]


def _data(cfg, rows=ROWS):
    return TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=T, global_batch=rows, seed=3)


def _run(cfg, mesh, m, n_steps=2, tcfg=None):
    """``n_steps`` train steps from ``init_params(cfg, 0)`` on the CPU:
    (params, opt, [(loss, grad_norm), ...])."""
    tcfg = tcfg or steps.TrainConfig(lr=LR, microbatches=m)
    params = lm.init_params(cfg, 0, device="cpu")
    opt = steps.make_opt_init(cfg, mesh, tcfg)(params)
    step = steps.make_train_step(cfg, mesh, tcfg)
    metrics = []
    for i in range(n_steps):
        params, opt, met = step(params, opt, markov_batch(_data(cfg), i))
        metrics.append((float(met["loss"]), float(met["grad_norm"])))
    return params, opt, metrics


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _driver(cfg, mesh, ckpt_dir):
    return TrainDriver(cfg, _data(cfg), mesh, ckpt_dir=ckpt_dir,
                       driver_cfg=DriverConfig(max_steps=4, ckpt_every=2, ckpt_async=False),
                       train_cfg=steps.TrainConfig(lr=LR), device="cpu")


# ---------------------------------------------------------------------------
# local form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,dp", [(a, dp) for a in STEP_ARCHS for dp in (2, 4)]
                         + [("xlstm-1.3b", 2)])
def test_local_data_mesh_equals_one_device_microbatches(arch, dp):
    cfg = get_smoke_config(arch)
    p1, o1, m1 = _run(cfg, None, dp)
    p2, o2, m2 = _run(cfg, make_mesh_for_devices(1, data=dp), 1)
    assert m1 == m2
    assert _equal(leaves(p1), leaves(p2))
    assert _equal(leaves(o1.mu) + leaves(o1.nu), leaves(o2.mu) + leaves(o2.nu))


def test_local_data_mesh_matches_reference_step():
    import jax

    from repro.launch.mesh import make_local_mesh
    from repro.launch.steps import TrainConfig as JTrainConfig
    from repro.launch.steps import make_train_step as jmake_train_step
    from repro.optim import adam as jadam
    from test_torch_train import _batch, _cfgs, _jparams, _np, _params, _weights

    cfg, jcfg = _cfgs()
    tree, batch = _weights(cfg, seed=2), _batch(cfg)
    tcfg = steps.TrainConfig(lr=LR, opt_state_dtype="float32")
    mesh = make_mesh_for_devices(1, data=2)
    params = _params(tree, cfg)
    params, _, metrics = steps.make_train_step(cfg, mesh, tcfg)(
        params, steps.make_opt_init(cfg, mesh, tcfg)(params), batch)
    jtcfg = JTrainConfig(lr=LR, opt_state_dtype="float32")
    _, jit_for, _ = jmake_train_step(jcfg, make_local_mesh(), jtcfg)
    jstep = jit_for({k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()})
    jp0 = _jparams(tree, jcfg)
    jparams, _, jmetrics = jstep(jp0, jadam.adam_init(jp0, jtcfg.adam()), batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=LOSS_RTOL)
    close = total = 0
    for p, jp in zip(leaves(params), jax.tree.leaves(jparams)):
        diff = np.abs(_np(p) - np.asarray(jp))
        assert diff.max() <= 2 * LR + 1e-6
        close += int((diff <= 1e-6 * (1 + np.abs(np.asarray(jp)))).sum())
        total += diff.size
    assert close >= PARAM_SHARE * total, (close, total)


# ---------------------------------------------------------------------------
# distributed form: two gloo ranks on the CPU, spawned once
# ---------------------------------------------------------------------------


def _psum_input(rank, shape):
    return np.random.default_rng(10 + rank).standard_normal(shape).astype(np.float32) * (1 + rank)


def _worker(rank, store, out_dir):
    """One gloo rank: every distributed case, its results saved for the
    parent. The ranks meet at the file ``store`` (a ``file://`` rendezvous:
    no port is chosen ahead of its bind)."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2, rank=rank)
    try:
        mesh = make_mesh_for_devices(1, group=dist.group.WORLD, data=2)
        res = {}
        for arch in STEP_ARCHS:
            cfg = get_smoke_config(arch)
            params, opt, metrics = _run(cfg, mesh, 1)
            whole = steps.gather_opt_state(opt, cfg, mesh)
            res[arch] = dict(params=leaves(params), mu=leaves(whole.mu), nu=leaves(whole.nu),
                             metrics=metrics,
                             moment_elems=sum(t.numel() for t in leaves(opt.mu)),
                             whole_elems=sum(t.numel() for t in leaves(whole.mu)))
        res["psum"] = [compressed_psum(torch.from_numpy(_psum_input(rank, s)), dist.group.WORLD)
                       for s in PSUM_SHAPES]
        cfg = get_smoke_config("granite-3-8b")
        ckpt = os.path.join(out_dir, "ckpt")
        out = _driver(cfg, mesh, ckpt).run()
        _, back = _driver(cfg, mesh, ckpt)._restore_or_init()
        live = out["state"]
        res["restored_equal"] = (
            _equal(leaves(back["params"]), leaves(live["params"]))
            and _equal(leaves(back["opt"].mu) + leaves(back["opt"].nu),
                       leaves(live["opt"].mu) + leaves(live["opt"].nu)))
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp

    out = str(tmp_path_factory.mktemp("dp2"))
    store = os.path.join(out, "rendezvous")
    mp.start_processes(_worker, args=(store, out), nprocs=2, start_method="spawn", join=True)
    return out, [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(2)]


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_distributed_step_equals_local(ranks, arch):
    cfg = get_smoke_config(arch)
    params, opt, metrics = _run(cfg, make_mesh_for_devices(1, data=2), 1)
    for res in ranks[1]:
        got = res[arch]
        assert got["metrics"] == metrics
        assert _equal(got["params"], leaves(params))
        assert _equal(got["mu"] + got["nu"], leaves(opt.mu) + leaves(opt.nu))
        assert got["moment_elems"] < 0.6 * got["whole_elems"]


def test_compressed_psum_equals_reference(ranks):
    import jax
    import jax.numpy as jnp

    from repro.optim import compress as jcompress

    for i, shape in enumerate(PSUM_SHAPES):
        stacked = jnp.asarray(np.stack([_psum_input(r, shape) for r in range(2)]))
        want = np.asarray(jax.vmap(lambda v: jcompress.compressed_psum(v, "d"),
                                   axis_name="d")(stacked))
        for r, res in enumerate(ranks[1]):
            np.testing.assert_array_equal(res["psum"][i].numpy(), want[r])


def test_zero1_checkpoint_saves_whole_and_restores_regions(ranks, tmp_path):
    out, results = ranks
    assert all(res["restored_equal"] for res in results)
    cfg = get_smoke_config("granite-3-8b")
    local = _driver(cfg, make_mesh_for_devices(1, data=2), str(tmp_path)).run()["state"]
    step, saved = restore_checkpoint(os.path.join(out, "ckpt"), template=local)
    assert step == 4
    assert _equal(leaves(saved["params"]), leaves(local["params"]))
    assert _equal(leaves(saved["opt"].mu) + leaves(saved["opt"].nu),
                  leaves(local["opt"].mu) + leaves(local["opt"].nu))
    assert int(saved["opt"].step) == 4
