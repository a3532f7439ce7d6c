"""Tensor-parallel training, the distributed form: gloo ranks on the CPU
(``launch/mesh.py`` with both axes distributed, its tp and data
subgroups; ``launch/collectives.py``' *f* and *g* over the tp group;
``launch/steps.py`` ``shard_params`` / ``gather_params``;
``TrainDriver``'s checkpoints of tensor shards).

One module fixture spawns 2 ranks (a 1 x 2 mesh) and then 4 ranks (2 x
2), each rank given 120 s a collective (a rank that waits on a
collective its peers never run, as a remat recompute out of order would,
fails there). In them:

* two steps on float32 smoke configs (granite3-smoke, rgemma-smoke with
  tied embeddings, grok1-smoke, musicgen-smoke at 1 x 2; granite3-smoke
  and rgemma-smoke at 2 x 2): every rank's loss and gradient norm, and
  the whole parameters gathered from the ranks, equal the local form's
  on the same mesh bit for bit, and a rank holds about 1/tp of the cut
  parameters;
* a ``TrainDriver`` at 2 x 2 with a failure at step 3: the run restarts
  from its step-2 checkpoint and ends bit for bit where the local form's
  run without a failure ends, and its last checkpoint (written by rank 0,
  the tensor shards and the moments' regions gathered) is that state.
"""
import dataclasses
import datetime
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

# the spawned ranks import this module: the port only
from repro_torch.checkpoint.store import restore_checkpoint  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import TokenTaskConfig, markov_batch  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for_devices  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.runtime.driver import DriverConfig, SimulatedFailure, TrainDriver  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

T, ROWS, LR, STEPS = 32, 4, 1e-3, 2
MESHES = {2: (1, 2), 4: (2, 2)}  # ranks -> (data, tp)
ARCHS = {2: ("granite-3-8b", "recurrentgemma-2b", "grok-1-314b", "musicgen-large"),
         4: ("granite-3-8b", "recurrentgemma-2b")}
DRIVER_STEPS, FAIL_AT = 4, 3


def _weights(cfg, seed=0):
    """Float32 weights at ``lm.param_leaves``' shapes from ``seed``."""
    rng = np.random.default_rng(seed)
    return lm.map_leaves(lambda _p, leaf: (rng.standard_normal(leaf.shape)
                                           * (leaf.scale or 0.1)).astype(np.float32),
                         lm.param_leaves(cfg))


def _batch(cfg, step):
    """Step ``step``'s batch (numpy): a Markov token task, or under
    ``frames`` seeded frame embeddings and codebook labels."""
    if cfg.frontend == "frames":
        rng = np.random.default_rng(100 + step)
        return {"embeds": rng.standard_normal((ROWS, T, cfg.d_model)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (ROWS, T, cfg.n_codebooks),
                                       dtype=np.int32)}
    data = TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=T, global_batch=ROWS, seed=3)
    return markov_batch(data, step)


def _cfg(arch):
    kw = {"tie_embeddings": True} if arch == "recurrentgemma-2b" else {}
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)


def _run(cfg, mesh):
    """``STEPS`` steps from ``_weights(cfg)`` (this process's tensor shard
    of them): (params, [(loss, grad_norm)])."""
    from repro_torch import bridge

    tcfg = steps.TrainConfig(lr=LR, opt_state_dtype="float32")
    params = steps.shard_params(bridge.params_from_numpy(_weights(cfg), cfg, "cpu"), cfg, mesh)
    opt = steps.make_opt_init(cfg, mesh, tcfg)(params)
    step = steps.make_train_step(cfg, mesh, tcfg)
    metrics = []
    for i in range(STEPS):
        params, opt, met = step(params, opt, _batch(cfg, i))
        metrics.append((float(met["loss"]), float(met["grad_norm"])))
    return params, metrics


def _driver(cfg, mesh, ckpt, hook=None):
    data = TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=T, global_batch=ROWS, seed=3)
    return TrainDriver(cfg, data, mesh, ckpt_dir=ckpt, failure_hook=hook,
                       driver_cfg=DriverConfig(max_steps=DRIVER_STEPS, ckpt_every=2,
                                               ckpt_async=False),
                       train_cfg=steps.TrainConfig(lr=LR), device="cpu")


def _fail_once():
    state = {"failed": False}

    def hook(step):
        if step == FAIL_AT and not state["failed"]:
            state["failed"] = True
            raise SimulatedFailure(f"step {step}")

    return hook


def _worker(rank, world, store, out_dir):
    """One gloo rank of the ``MESHES[world]`` mesh: its results saved for
    the parent. The ranks meet at the file ``store``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        data, tp = MESHES[world]
        mesh = make_mesh_for_devices(tp, group=dist.group.WORLD, data=data)
        res = {}
        for arch in ARCHS[world]:
            cfg = _cfg(arch)
            params, metrics = _run(cfg, mesh)
            res[arch] = dict(metrics=metrics, params=leaves(steps.gather_params(params, cfg, mesh)),
                             elems=sum(t.numel() for t in leaves(params)))
        if world == 4:
            cfg = _cfg("granite-3-8b")
            driver = _driver(cfg, mesh, os.path.join(out_dir, "ckpt"), _fail_once())
            state = driver.run()["state"]
            res["driver"] = dict(restarts=driver.restarts,
                                 params=leaves(steps.gather_params(state["params"], cfg, mesh)))
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp

    out = {}
    for world in MESHES:
        d = str(tmp_path_factory.mktemp(f"tp{world}"))
        mp.start_processes(_worker, args=(world, os.path.join(d, "rendezvous"), d), nprocs=world,
                           start_method="spawn", join=True)
        out[world] = d, [torch.load(os.path.join(d, f"rank{r}.pt")) for r in range(world)]
    return out


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("world,arch", [(w, a) for w in MESHES for a in ARCHS[w]])
def test_ranks_equal_the_local_form(ranks, world, arch):
    data, tp = MESHES[world]
    cfg = _cfg(arch)
    params, metrics = _run(cfg, make_mesh_for_devices(tp, data=data))
    whole = sum(leaf.numel() for leaf in leaves(params))
    for res in ranks[world][1]:
        got = res[arch]
        assert got["metrics"] == metrics
        assert _equal(got["params"], leaves(params))
        assert got["elems"] < (1 / tp + 0.1) * whole


def test_driver_restart_on_both_axes(ranks, tmp_path):
    out, results = ranks[4]
    cfg = _cfg("granite-3-8b")
    local = _driver(cfg, make_mesh_for_devices(2, data=2), str(tmp_path)).run()["state"]
    for res in results:
        assert res["driver"]["restarts"] == 1
        assert _equal(res["driver"]["params"], leaves(local["params"]))
    step, saved = restore_checkpoint(os.path.join(out, "ckpt"), template=local)
    assert step == DRIVER_STEPS
    assert _equal(leaves(saved["params"]), leaves(local["params"]))
    assert _equal(leaves(saved["opt"].mu) + leaves(saved["opt"].nu),
                  leaves(local["opt"].mu) + leaves(local["opt"].nu))
    assert leaves(saved["params"])[0].shape == leaves(lm.param_leaves(cfg))[0].shape
