"""Port vs reference: the Eq.-14 calibration at LM scale
(``launch/steps.py`` ``make_calibrate_step``) on granite3-smoke at
float32 without remat (the reference's tests/test_analog_lm.py setting),
numpy weights handed to both: 3 steps on the "tile" backend (the same
counter-based noise in both packages) with keys ``fold_in(key, i)``, from
a uniform start at 8 aJ/MAC: loss, NLL and log energies to 1e-5
relative; the weights stay frozen."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.core import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.core.energy import uniform_log_energies as juniform  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.launch.steps import make_calibrate_step as jmake_calibrate_step  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.core.energy import uniform_log_energies  # noqa: E402
from repro_torch.data.pipeline import TokenTaskConfig, markov_batch  # noqa: E402
from repro_torch.kernels import prng  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

LOSS_RTOL = 1e-5
T = 32


def test_calibrate_step_matches_reference():
    cfg = dataclasses.replace(get_smoke_config("granite-3-8b"), dtype="float32", remat=False)
    jcfg = dataclasses.replace(jsmoke("granite-3-8b"), dtype="float32", remat=False)
    rng = np.random.default_rng(5)
    tree = lm.map_leaves(lambda _p, leaf: (rng.standard_normal(leaf.shape)
                                           * (leaf.scale or 0.1)).astype(np.float32),
                         lm.param_leaves(cfg))
    batch = markov_batch(TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=T, global_batch=4,
                                         seed=3), 0)
    kw = dict(seq_len=T, target_e_per_mac=1.0, lam=20.0, lr=0.1)
    step = steps.make_calibrate_step(cfg, analog_cfg=AnalogConfig.shot(backend="tile"), **kw)
    _, jit_for, aux = jmake_calibrate_step(jcfg, make_local_mesh(),
                                           analog_cfg=JAnalogConfig.shot(backend="tile"), **kw)
    jstep = jit_for({k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()})
    log_e, jlog_e = uniform_log_energies(step.macs, 8.0), juniform(aux["macs"], 8.0)
    opt = adam.adam_init(log_e, adam.AdamConfig(lr=0.1))
    jopt = jadam.adam_init(jlog_e, jadam.AdamConfig(lr=0.1))
    params = bridge.params_from_numpy(tree, cfg, "cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    key, jkey = prng.PRNGKey(0), jax.random.PRNGKey(0)
    for i in range(3):
        log_e, opt, m = step(log_e, opt, params, batch, prng.fold_in(key, i))
        jlog_e, jopt, jm = jstep(jlog_e, jopt, jparams, batch, jax.random.fold_in(jkey, i))
        for k in ("loss", "nll"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_RTOL)
        for a, b in zip(leaves(log_e), jax.tree.leaves(jlog_e)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=LOSS_RTOL)
    assert all(not p.requires_grad for p in leaves(params))  # the weights stay frozen
