"""Port vs reference: the serving step functions (``launch/steps.py``
``make_prefill_step``, ``make_decode_step``) on granite-3-8b's smoke
config at float32, numpy weights handed to both: a prefill of 4 x 16
then 3 decode steps, digital and analog (shot noise on ``"tile"`` on both
sides, one key), the logits within ``1e-4·max|logit|`` of the reference's
steps on its local mesh (``make_local_mesh``), on the port's one device,
its local mesh of 2 data shards (each shard's noise at its global rows)
and of 2 tensor shards (the analog sites' columns). The decode step
updates the cache in place; an int8 tree serves through ``param_tree``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.core import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.launch.steps import make_decode_step as jdecode  # noqa: E402
from repro.launch.steps import make_prefill_step as jprefill  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.kernels import prng  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for_devices  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.quant.weights import quantize_params  # noqa: E402

ARCH, B, T, GEN, E0 = "granite-3-8b", 4, 16, 3, 20.0
LOGIT_REL = 1e-4
MESHES = {"one": None, "data2": lambda: make_mesh_for_devices(1, data=2),
          "tp2": lambda: make_mesh_for_devices(2)}


def _cfgs():
    return (dataclasses.replace(get_smoke_config(ARCH), dtype="float32"),
            dataclasses.replace(jsmoke(ARCH), dtype="float32"))


@functools.lru_cache(maxsize=None)
def _tree():
    cfg, _ = _cfgs()
    rng = np.random.default_rng(7)
    return lm.map_leaves(lambda _p, leaf: (rng.standard_normal(leaf.shape)
                                           * (leaf.scale or 0.1)).astype(np.float32),
                         lm.param_leaves(cfg))


def _tokens():
    cfg, _ = _cfgs()
    return np.random.default_rng(3).integers(0, cfg.vocab_size, (B, T + GEN), dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _reference(analog: bool):
    """The reference's logits: [prefill, decode 1, ...], each (B, V)."""
    _, jcfg = _cfgs()
    mesh = make_local_mesh()
    acfg = JAnalogConfig.shot(backend="tile") if analog else None
    energies = jlm.init_energy_tree(jcfg, E0) if analog else None
    key = jax.random.PRNGKey(1) if analog else None
    params = jax.tree.map(jnp.asarray, _tree())
    toks = _tokens()
    batch = {"tokens": jnp.asarray(toks[:, :T])}
    _, jit_for, _ = jprefill(jcfg, mesh, cache_len=T + GEN, analog_cfg=acfg)
    spec = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()}
    cache, logits = jit_for(spec)(params, batch, energies, key)
    out = [np.asarray(logits)[:, 0, 0]]
    _, jit_for, _ = jdecode(jcfg, mesh, analog_cfg=acfg)
    step_batch = {"tokens": jnp.asarray(toks[:, T:T + 1])}
    dstep = jit_for({k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in step_batch.items()},
                    T + GEN)
    for i in range(GEN):
        step_batch = {"tokens": jnp.asarray(toks[:, T + i:T + i + 1])}
        logits, cache = dstep(params, cache, step_batch, T + i, energies, key)
        out.append(np.asarray(logits)[:, 0, 0])
    return out


def _port(mesh, analog: bool, int8: bool = False):
    cfg, _ = _cfgs()
    acfg = AnalogConfig.shot(backend="tile") if analog else None
    energies = lm.init_energy_tree(cfg, E0, "cpu") if analog else None
    key = prng.PRNGKey(1) if analog else None
    params = bridge.params_from_numpy(_tree(), cfg, "cpu")
    if int8:
        params = quantize_params(params)
    toks = torch.from_numpy(_tokens())
    prefill = steps.make_prefill_step(cfg, mesh, cache_len=T + GEN, analog_cfg=acfg,
                                      param_tree=params if int8 else None)
    decode = steps.make_decode_step(cfg, mesh, analog_cfg=acfg,
                                    param_tree=params if int8 else None)
    with torch.no_grad():
        cache, logits = prefill(params, {"tokens": toks[:, :T]}, energies, key)
        out = [logits[:, 0, 0].numpy()]
        for i in range(GEN):
            logits, new = decode(params, cache, {"tokens": toks[:, T + i:T + i + 1]}, T + i,
                                 energies, key)
            assert new is cache  # updated in place
            out.append(logits[:, 0, 0].numpy())
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("analog", [False, True], ids=["digital", "tile"])
def test_serving_steps_match_reference(mesh, analog):
    make = MESHES[mesh]
    got = _port(make() if make else None, analog)
    want = _reference(analog)
    assert len(got) == len(want) == GEN + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = float(np.abs(g - w).max())
        assert err <= LOGIT_REL * float(np.abs(w).max()), (mesh, analog, err)


def test_param_tree_serves_int8():
    cfg, _ = _cfgs()
    got = _port(None, False, int8=True)
    assert all(np.isfinite(g).all() for g in got)
    step = steps.make_prefill_step(cfg, None, cache_len=T, param_tree=quantize_params(
        bridge.params_from_numpy(_tree(), cfg, "cpu")))
    with pytest.raises(TypeError):
        step(bridge.params_from_numpy(_tree(), cfg, "cpu"),
             {"tokens": torch.from_numpy(_tokens()[:, :T])}, None, None)
