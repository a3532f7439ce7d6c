"""Port vs reference: the Eq.-14 calibration of the griffin, xlstm and moe
families — the energy gradients of the analog ``lm.train_loss`` and
``launch/steps.py`` ``make_calibrate_step`` — on the reference's smoke
configs of recurrentgemma-2b, xlstm-1.3b and grok-1-314b at float32
without remat (``tests/test_torch_calibrate_lm.py``'s setting), numpy
weights handed to both, shot noise on the "tile" backend on both sides
(the same counter-based noise).

* The loss within 1e-5 relative and every energy leaf's gradient within
  ``1e-4 * max|g_ref|``, from 50 aJ/MAC at every site (the reference's
  tests/test_analog_lm.py setting).
* ``make_calibrate_step`` on xlstm-1.3b's (its steps are the family's
  loss under the Eq.-14 penalty and Adam over the log energies, as the
  dense family's in ``tests/test_torch_calibrate_lm.py``), 3 steps with
  keys ``fold_in(key, i)`` from a uniform start at 8 aJ/MAC: loss, NLL
  and log energies within 1e-5 relative; the weights stay frozen.

MoE: an expert's capacity buffer holds all-zero rows (slots no token
took). Their shot-noise row norm is 0, and ``jnp.linalg.norm``'s
gradient there is NaN (sqrt's derivative at 0 times 0), which then
reaches every earlier site's energy gradient (the reference's
``make_calibrate_step`` on grok-1's smoke config gives NaN log energies
from its second step); ``torch.linalg.vector_norm`` gives those rows a
zero gradient. The rows' outputs are never read (the combine takes no
weight from them), so 0 is their gradient, and for the moe case the
reference runs here with a norm whose gradient is 0 at a zero row
(``_zero_safe_norm``: the same forward bits, sqrt of the sum of
squares).
"""
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
from repro.models import lm as jlm  # noqa: E402
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
from repro_torch.tree import leaves, map_leaves  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
T, B = 32, 4
E0 = 50.0
ARCHS = ["recurrentgemma-2b", "xlstm-1.3b", "grok-1-314b"]


@jax.custom_jvp
def _sqrt0(s):
    return jnp.sqrt(s)


@_sqrt0.defjvp
def _sqrt0_jvp(primals, tangents):
    (s,), (ds,) = primals, tangents
    r = jnp.sqrt(s)
    return r, jnp.where(s > 0, ds / (2 * jnp.where(s > 0, r, 1.0)), 0.0)


def _zero_safe_norm(x, ord=None, axis=None, keepdims=False):
    """``jnp.linalg.norm``'s 2-norm (sqrt of the sum of x * x), with a zero
    gradient at a zero vector."""
    assert ord is None
    return _sqrt0(jnp.sum(x * x, axis=axis, keepdims=keepdims))


@pytest.fixture
def reference_norm(monkeypatch):
    """Installs ``_zero_safe_norm`` for a moe case (see the docstring)."""
    def use(cfg):
        if cfg.family == "moe":
            monkeypatch.setattr(jnp.linalg, "norm", _zero_safe_norm)
    return use


def _setup(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", remat=False)
    jcfg = dataclasses.replace(jsmoke(arch), dtype="float32", remat=False)
    rng = np.random.default_rng(5)
    tree = lm.map_leaves(lambda _p, leaf: (rng.standard_normal(leaf.shape)
                                           * (leaf.scale or 0.1)).astype(np.float32),
                         lm.param_leaves(cfg))
    batch = markov_batch(TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=T, global_batch=B,
                                         seed=3), 0)
    return cfg, jcfg, tree, batch


@pytest.mark.parametrize("arch", ARCHS)
def test_energy_grads_match_reference(arch, reference_norm):
    cfg, jcfg, tree, batch = _setup(arch)
    reference_norm(cfg)
    params = bridge.params_from_numpy(tree, cfg, "cpu")
    energies = map_leaves(lambda _p, e: e.requires_grad_(), lm.init_energy_tree(cfg, E0, "cpu"))
    loss = lm.train_loss(params, steps.batch_tensors(batch, "cpu"), cfg, analog=lm.AnalogSpec(
        cfg=AnalogConfig.shot(backend="tile"), energies=energies, key=prng.PRNGKey(0)))
    loss.backward()
    jparams = jax.tree.map(jnp.asarray, tree)

    def jloss_of(e_tree):
        spec = jlm.AnalogSpec(cfg=JAnalogConfig.shot(backend="tile"), energies=e_tree,
                              key=jax.random.PRNGKey(0))
        return jlm.train_loss(jparams, batch, jcfg, analog=spec)

    jloss, jgrads = jax.jit(jax.value_and_grad(jloss_of))(jlm.init_energy_tree(jcfg, E0))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    paths = leaves(map_leaves(lambda p, _e: "/".join(p), energies))
    got = leaves(map_leaves(lambda _p, e: e.grad, energies))
    assert len(got) == len(jax.tree.leaves(jgrads))
    for path, g, jg in zip(paths, got, jax.tree.leaves(jgrads)):
        jg = np.asarray(jg)
        assert np.isfinite(jg).all() and float(np.abs(jg).max()) > 0, path
        err = float(np.abs(g.numpy() - jg).max())
        assert err <= GRAD_REL * float(np.abs(jg).max()), (arch, path, err)


def test_calibrate_step_matches_reference():
    cfg, jcfg, tree, batch = _setup("xlstm-1.3b")
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
