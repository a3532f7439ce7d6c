"""The LM calibration on a mesh of data x tensor shards, the distributed
form: gloo ranks on the CPU (``launch/steps.py`` ``make_calibrate_step``
with each rank's tensor shard of the weights, ``shard_params``; the
row-cut sites' sums and the summed energy gradients over the tp group,
the data shards' over the data group, ``launch/collectives.py``).

One module fixture spawns 2 ranks (a 1 x 2 mesh) and then 4 ranks (2 x
2), each given 120 s a collective. In them, the cases of
``tests/test_torch_calibrate_tp.py`` (2 steps on float32 smoke configs):
every rank's losses, NLLs and log energies equal the local form's on the
same mesh bit for bit. Thermal noise on a data axis runs only here (its
input range reduced over the data group as over the tp group): at 2 x 2
the ranks agree bit for bit and hold the one-device step within
``THERMAL_LOG_E``. The ranks meet at a ``file://`` store under the
test's temporary directory.
"""
import datetime
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

# the spawned ranks import this module and the local form's: the port only
from repro_torch.launch.mesh import make_mesh_for_devices  # noqa: E402
from test_torch_calibrate_tp import (  # noqa: E402
    MESHES,
    REL,
    THERMAL_LOG_E,
    _distance,
    _local,
    _one_device,
    _run,
)

WORLDS = {2: "tp2", 4: "data2_tp2"}  # ranks -> mesh
CASES = {
    2: [("granite3", "shot", "torch"), ("granite3", "shot", "tile"), ("rgemma", "shot", "torch"),
        ("grok1", "shot", "torch"), ("xlstm_dp", "shot", "torch"),
        ("granite3", "weight", "torch"), ("granite3", "thermal", "torch"),
        ("rgemma", "thermal", "tile")],
    4: [("granite3", "shot", "torch"), ("rgemma", "shot", "torch"), ("grok1", "shot", "torch"),
        ("xlstm_dp", "shot", "torch"), ("rgemma", "weight", "torch")],
}
#: thermal noise on both axes, in the ranks alone
THERMAL_BOTH = [("granite3", "torch"), ("rgemma", "tile")]


def _worker(rank, world, store, out_dir):
    """One gloo rank of the ``WORLDS[world]`` mesh: its results saved for
    the parent. The ranks meet at the file ``store``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        data, tp = MESHES[WORLDS[world]]
        mesh = make_mesh_for_devices(tp, group=dist.group.WORLD, data=data)
        res = {case: _run(*case, mesh) for case in CASES[world]}
        if world == 4:
            res.update({("thermal",) + c: _run(c[0], "thermal", c[1], mesh) for c in THERMAL_BOTH})
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp

    out = {}
    for world in WORLDS:
        d = str(tmp_path_factory.mktemp(f"cal_tp{world}"))
        mp.start_processes(_worker, args=(world, os.path.join(d, "rendezvous"), d), nprocs=world,
                           start_method="spawn", join=True)
        out[world] = [torch.load(os.path.join(d, f"rank{r}.pt")) for r in range(world)]
    return out


def _equal(a, b):
    return a[0] == b[0] and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


@pytest.mark.parametrize("world,name,noise,backend",
                         [(w,) + c for w in WORLDS for c in CASES[w]])
def test_ranks_equal_the_local_form(ranks, world, name, noise, backend):
    local = _local(name, WORLDS[world], noise, backend)
    for res in ranks[world]:
        assert _equal(res[name, noise, backend], local)


@pytest.mark.parametrize("name,backend", THERMAL_BOTH)
def test_thermal_noise_on_both_axes(ranks, name, backend):
    got = [res["thermal", name, backend] for res in ranks[4]]
    assert all(_equal(g, got[0]) for g in got[1:])
    rel, log_e = _distance(got[0], _one_device(name, "thermal", backend))
    print(f"{name} data2_tp2 thermal {backend}: rel {rel:.3g}, log E {log_e:.3g}")
    assert rel <= REL and log_e <= THERMAL_LOG_E
