"""A checkpointed region's recompute runs under the places its forward ran
under (``models/sharding.py`` ``remat``), whichever thread runs it.

On the card the recompute of a ``torch.utils.checkpoint`` region runs on
the autograd device thread, which sees none of the caller's thread-local
state; on the CPU it runs on the thread that calls ``backward``. So here
data shard 1 of 2 computes its analog calibration loss (``lm.train_loss``
under ``use_data_shard``) on this thread and runs ``.backward()`` in a
fresh ``threading.Thread``, whose thread-local state is empty as the
card's autograd thread's is. Its energy gradients must equal, bit for
bit, those of the same backward on this thread: every checkpointed
region on the path (the layer groups under ``cfg.remat``, griffin's
sublayers, the mLSTM blocks, and every lm_head chunk of
``chunked_xent``, which is checkpointed whenever grad is on) draws its
recomputed noise at the shard's rows. Smoke configs at float32, numpy
weights, 4 x 64 tokens (two loss chunks), shot noise on ``"torch"`` (a
shard's rows of the whole draw) and ``"tile"`` (row0 offsets).
"""
import dataclasses
import functools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.core.energy import to_energy  # noqa: E402
from repro_torch.data.pipeline import TokenTaskConfig, markov_batch  # noqa: E402
from repro_torch.kernels import prng  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.sharding import DataShard, use_data_shard  # noqa: E402
from repro_torch.tree import leaves, map_leaves  # noqa: E402

B, T, DP, E0 = 4, 64, 2, 8.0
CASES = [("granite-3-8b", True, "torch"), ("granite-3-8b", False, "torch"),
         ("granite-3-8b", True, "tile"), ("granite-3-8b", False, "tile"),
         ("recurrentgemma-2b", True, "torch"), ("xlstm-1.3b", True, "torch")]


def _cfg(arch, remat):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", remat=remat)


@functools.lru_cache(maxsize=None)
def _tree(arch):
    rng = np.random.default_rng(5)
    return lm.map_leaves(lambda _p, leaf: (rng.standard_normal(leaf.shape)
                                           * (leaf.scale or 0.1)).astype(np.float32),
                         lm.param_leaves(_cfg(arch, True)))


def _energy_grads(arch, remat, backend, in_thread):
    """Data shard 1's energy gradients: its loss on this thread, the
    backward on this thread (under the shard's place, as the calibrate
    step runs it) or on a fresh one."""
    cfg = _cfg(arch, remat)
    params = bridge.params_from_numpy(_tree(arch), cfg, "cpu")
    batch = steps.batch_tensors(markov_batch(TokenTaskConfig(
        vocab_size=cfg.vocab_size, seq_len=T, global_batch=B, seed=3), 0), "cpu")
    per = B // DP
    part = {k: v[per:2 * per] for k, v in batch.items()}
    log_e = map_leaves(lambda _p, t: torch.log(t).requires_grad_(),
                       lm.init_energy_tree(cfg, E0, "cpu"))
    spec = lm.AnalogSpec(cfg=AnalogConfig.shot(backend=backend), energies=to_energy(log_e),
                         key=prng.PRNGKey(0))
    with use_data_shard(DataShard(1, DP)):
        loss = lm.train_loss(params, part, cfg, analog=spec)
        if not in_thread:  # the caller's thread, inside the shard's place
            loss.backward()
    if in_thread:
        failed = []

        def run():
            try:
                loss.backward()
            except BaseException as e:  # noqa: BLE001 - re-raised on this thread
                failed.append(e)

        worker = threading.Thread(target=run)
        worker.start()
        worker.join()
        if failed:
            raise failed[0]
    return [t.grad for t in leaves(log_e)]


@pytest.mark.parametrize("arch,remat,backend", CASES)
def test_recompute_on_another_thread_keeps_the_data_shard(arch, remat, backend):
    here = _energy_grads(arch, remat, backend, in_thread=False)
    there = _energy_grads(arch, remat, backend, in_thread=True)
    assert all(g is not None for g in here)
    assert all(torch.equal(a, b) for a, b in zip(there, here))
