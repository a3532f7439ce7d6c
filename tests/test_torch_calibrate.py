"""Port vs reference: Eq.-14 calibration (``core/calibrate.py``) and the
language model's probe apply function, on the ``"tile"`` backend (the same
counter-based noise in both packages).

The 3-layer MLP of ``tests/test_calibrate.py`` ([32, 64, 64, 8], shot
noise) with numpy weights and data, labels the clean model's argmax:

* the step-0 Eq.-14 gradient within ``1e-4 * max|g|``;
* ``learn_energies``, 20 steps: ``log_e`` within 1e-3, the NLL trace
  within 1e-4 relative (float order of the matmuls and of the gradient);
* ``eval_accuracy`` (1, 5 and 9 noise samples) and ``eval_profile_accuracy``
  equal to the reference's, and the port's stacked samples equal to its
  own loop over samples exactly; ``noise_rms`` within 1e-5 relative.

bert-smoke (2 layers, float32, numpy weights) through
``ServingEngine.probe_apply`` against the reference's ``forward_hidden``
(``mode="train"``), accuracy the greedy agreement with the digital model
at every position: ``learn_energies`` for 5 steps gives the same
log-energies (1e-3), ``repeat_profile_search`` the same repeats and
accuracies, and the searched profile's JSON loads in the reference.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs as several processes on the cores (pytest-xdist): torch's
# intra-op threads in each would oversubscribe them (20x slower when six run)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.core import calibrate as jcal  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import profile as jprofile  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.core.analog import analog_dot as janalog_dot  # noqa: E402
from repro.core.analog import site_key as jsite_key  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.core import calibrate as cal  # noqa: E402
from repro_torch.core import energy  # noqa: E402
from repro_torch.core import search  # noqa: E402
from repro_torch.core.analog import AnalogConfig, analog_dot, fold_key, key_seed, site_key  # noqa: E402
from repro_torch.core.profile import PrecisionProfile  # noqa: E402
from repro_torch.kernels.prng import PRNGKey, fold_in  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.tree import leaves, map_leaves  # noqa: E402

GRAD_REL = 1e-4
LOG_E_ATOL = 1e-3
NLL_RTOL = 1e-4
RMS_RTOL = 1e-5
DIMS = [32, 64, 64, 8]
TARGET = 0.1  # aJ/MAC: where the MLP's shot noise costs accuracy
CALIB = dict(lam=20.0, lr=0.05, init_mult=4.0)
KEY = 0


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _tree_np(tree):
    return {k: _tree_np(v) if isinstance(v, dict) else _np(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def mlp():
    rng = np.random.default_rng(0)
    ws = [(rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(DIMS[:-1], DIMS[1:])]
    x = rng.standard_normal((512, DIMS[0])).astype(np.float32)
    h = x
    for i, w in enumerate(ws):
        h = h @ w if i == len(ws) - 1 else np.maximum(h @ w, 0)
    y = np.argmax(h, -1).astype(np.int32)
    jcfg, cfg = JAnalogConfig.shot(backend="tile"), AnalogConfig.shot(backend="tile")
    jws, tws = [jnp.asarray(w) for w in ws], [torch.from_numpy(w) for w in ws]

    def japply(e, xb, key):
        h = xb
        for i, w in enumerate(jws):
            h = janalog_dot(h, w, cfg=jcfg, energy=e[f"l{i}"],
                            key=jsite_key(jax.random.fold_in(key, i), f"l{i}"))
            h = jax.nn.relu(h) if i < len(jws) - 1 else h
        return h

    def apply(e, xb, key):
        """A stacked (S, 2) key with xb (S, B, d): one request a sample."""
        h = xb
        for i, w in enumerate(tws):
            seed = key_seed(site_key(fold_key(key, i), f"l{i}"), "cpu")
            h = analog_dot(h, w, cfg=cfg, energy=e[f"l{i}"], seed=seed)
            h = torch.relu(h) if i < len(tws) - 1 else h
        return h

    def macs(mod):
        return {f"l{i}": mod.dense_site_macs(1, a, b, per_channel=False)
                for i, (a, b) in enumerate(zip(DIMS[:-1], DIMS[1:]))}

    batches = [(x[i:i + 128], y[i:i + 128]) for i in range(0, 384, 128)]
    return dict(
        japply=japply, apply=apply, jmacs=macs(jenergy), macs=macs(energy),
        jbatches=[(jnp.asarray(a), jnp.asarray(b)) for a, b in batches],
        batches=[(torch.from_numpy(a), torch.from_numpy(b)) for a, b in batches],
        jtest=[(jnp.asarray(x[384:]), jnp.asarray(y[384:]))],
        test=[(torch.from_numpy(x[384:]), torch.from_numpy(y[384:]))],
    )


def _energies(m, e_per_mac):
    return (jenergy.to_energy(jenergy.uniform_log_energies(m["jmacs"], e_per_mac)),
            energy.to_energy(energy.uniform_log_energies(m["macs"], e_per_mac)))


def test_step0_gradient_matches_reference(mlp):
    x, y = mlp["batches"][0]
    jx, jy = mlp["jbatches"][0]
    jlog = jenergy.uniform_log_energies(mlp["jmacs"], CALIB["init_mult"] * TARGET)

    def jobj(le):
        e = jenergy.to_energy(le)
        nll = jcal.softmax_xent(mlp["japply"](e, jx, jax.random.fold_in(jax.random.PRNGKey(KEY), 0)),
                                jy)
        return nll + jenergy.log_energy_penalty(e, mlp["jmacs"], TARGET, CALIB["lam"])

    jg = jax.grad(jobj)(jlog)
    log_e = map_leaves(lambda _p, t: t.requires_grad_(True),
                       energy.uniform_log_energies(mlp["macs"], CALIB["init_mult"] * TARGET))
    e = energy.to_energy(log_e)
    nll = cal.softmax_xent(mlp["apply"](e, x, fold_in(PRNGKey(KEY), 0)), y)
    (nll + energy.log_energy_penalty(e, mlp["macs"], TARGET, CALIB["lam"])).backward()
    g = {k: float(v.grad) for k, v in log_e.items()}
    scale = max(abs(float(v)) for v in jg.values())
    for k in g:
        assert abs(g[k] - float(jg[k])) <= GRAD_REL * scale, (k, g[k], float(jg[k]))


def test_learn_energies_20_steps_matches_reference(mlp):
    jcfg, cfg = jcal.CalibConfig(steps=20, **CALIB), cal.CalibConfig(steps=20, **CALIB)
    _, jd = jcal.learn_energies(mlp["japply"], mlp["jmacs"], mlp["jbatches"],
                                key=jax.random.PRNGKey(KEY), target_e_per_mac=TARGET, cfg=jcfg)
    e, d = cal.learn_energies(mlp["apply"], mlp["macs"], mlp["batches"], key=PRNGKey(KEY),
                              target_e_per_mac=TARGET, cfg=cfg)
    for k in d["log_e"]:
        np.testing.assert_allclose(_np(d["log_e"][k]), np.asarray(jd["log_e"][k]),
                                   atol=LOG_E_ATOL, rtol=0)
    np.testing.assert_allclose(d["nll_trace"], jd["nll_trace"], rtol=NLL_RTOL)
    np.testing.assert_allclose(d["avg_e_per_mac"], jd["avg_e_per_mac"], rtol=1e-3)
    assert not any(v.requires_grad for v in leaves(e))


@pytest.mark.parametrize("n", [1, 5, 9])
def test_eval_accuracy_matches_reference_and_own_loop(mlp, n):
    je, e = _energies(mlp, 0.2)
    acc = cal.eval_accuracy(mlp["apply"], e, mlp["test"], key=PRNGKey(KEY), n_noise_samples=n)
    jacc = jcal.eval_accuracy(mlp["japply"], je, mlp["jtest"], key=jax.random.PRNGKey(KEY),
                              n_noise_samples=n)
    assert acc == jacc
    # the loop the stacked samples stand for
    x, y = mlp["test"][0]
    bk = fold_in(PRNGKey(KEY), 0)
    loop = sum(int((torch.argmax(mlp["apply"](e, x, fold_in(bk, s)), -1) == y).sum())
               for s in range(n))
    assert acc == loop / (y.numel() * n)


def test_eval_profile_accuracy_matches_reference(mlp):
    je, e = _energies(mlp, 0.05)
    reps = {"l0": 4, "l1": 1, "l2": 2}
    acc = cal.eval_profile_accuracy(mlp["apply"], e, reps, mlp["test"], key=PRNGKey(1),
                                    n_noise_samples=3)
    jacc = jcal.eval_profile_accuracy(mlp["japply"], je, reps, mlp["jtest"],
                                      key=jax.random.PRNGKey(1), n_noise_samples=3)
    assert acc == jacc


@pytest.mark.parametrize("n", [4, 10])
def test_noise_rms_matches_reference(mlp, n):
    je, e = _energies(mlp, 0.2)
    x = mlp["test"][0][0]
    ref = mlp["apply"]({k: torch.tensor(1e12) for k in e}, x, PRNGKey(0))
    got = cal.noise_rms(mlp["apply"], e, x, ref, key=PRNGKey(2), n_noise_samples=n)
    want = jcal.noise_rms(mlp["japply"], je, jnp.asarray(_np(x)), jnp.asarray(_np(ref)),
                          key=jax.random.PRNGKey(2), n_noise_samples=n)
    np.testing.assert_allclose(got, want, rtol=RMS_RTOL)


# ---------------------------------------------------------------------------
# the reduced LM: bert-smoke through the probe apply function
# ---------------------------------------------------------------------------

LM_T, LM_B = 16, 4
LM_E0 = 60.0  # aJ/MAC: uniform K=1 misses the floor of uniform K=4


@pytest.fixture(scope="module")
def bert():
    cfg = dataclasses.replace(configs.get_smoke_config("bert-base"), dtype="float32")
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("bert-base"), dtype="float32")
    rng = np.random.default_rng(0)
    tree = lm.map_leaves(
        lambda _p, leaf: (rng.standard_normal(leaf.shape) * (leaf.scale or 0.1)).astype(np.float32),
        lm.param_leaves(cfg))
    jparams = jax.tree.map(jnp.asarray, tree)
    params = bridge.params_from_numpy(tree, cfg, "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (LM_B, LM_T)).astype(np.int32)
    jshot, shot = JAnalogConfig.shot(backend="tile"), AnalogConfig.shot(backend="tile")
    jhead = jparams["embed"].T if jcfg.tie_embeddings else jparams["lm_head"]

    def japply(e, x, key):
        spec = jlm.AnalogSpec(cfg=jshot, energies=e, key=key)
        h, _ = jlm.forward_hidden(jparams, {"tokens": x}, jcfg, mode="train", analog=spec)
        return h @ jhead

    energies = lm.init_energy_tree(cfg, LM_E0, device="cpu")
    engine = ServingEngine(params, cfg, analog_cfg=shot, energies=energies, device="cpu")
    probe = engine.probe_apply()
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    apply = lambda e, x, key: probe(e, x, key) @ head  # noqa: E731
    labels = torch.argmax(engine.probe_reference(toks) @ head, -1)
    h, _ = jlm.forward_hidden(jparams, {"tokens": jnp.asarray(toks)}, jcfg, mode="train")
    jlabels = jnp.argmax(h @ jhead, -1)
    assert np.array_equal(_np(labels), np.asarray(jlabels))
    return dict(cfg=cfg, jcfg=jcfg, japply=japply, apply=apply, energies=energies,
                engine=engine, jparams=jparams,
                jenergies=jlm.init_energy_tree(jcfg, LM_E0), macs=lm.energy_macs(cfg, LM_T),
                jmacs=jlm.energy_macs(jcfg, LM_T), batch=[(torch.from_numpy(toks), labels)],
                jbatch=[(jnp.asarray(toks), jlabels)], probe=probe)


def test_lm_probe_stacked_equals_loop(bert):
    e, (x, _) = bert["energies"], bert["batch"][0]
    keys = fold_in(PRNGKey(5), np.arange(3))
    stacked = bert["apply"](e, x.unsqueeze(0).expand(3, *x.shape), keys)
    for s in range(3):
        assert torch.equal(stacked[s], bert["apply"](e, x, keys[s]))


def test_lm_learn_energies_matches_reference(bert):
    kw = dict(steps=5, lr=0.05, init_mult=4.0)
    _, jd = jcal.learn_energies(bert["japply"], bert["jmacs"], bert["jbatch"],
                                key=jax.random.PRNGKey(7), target_e_per_mac=100.0,
                                cfg=jcal.CalibConfig(**kw))
    _, d = cal.learn_energies(bert["apply"], bert["macs"], bert["batch"], key=PRNGKey(7),
                              target_e_per_mac=100.0, cfg=cal.CalibConfig(**kw))
    got, want = _tree_np(d["log_e"]), jax.tree.map(np.asarray, jd["log_e"])
    for sub in ("groups",):
        for s in got[sub]:
            np.testing.assert_allclose(got[sub][s], want[sub][s], atol=LOG_E_ATOL, rtol=0)
    np.testing.assert_allclose(got["lm_head"], want["lm_head"], atol=LOG_E_ATOL, rtol=0)
    np.testing.assert_allclose(d["nll_trace"], jd["nll_trace"], rtol=NLL_RTOL)


def test_lm_repeat_profile_search_matches_reference(bert, tmp_path):
    cfg, jcfg, n = bert["cfg"], bert["jcfg"], bert["cfg"].n_layers

    def search_in(mod, cal_mod, lm_mod, apply, energies, batch, key):
        def acc(reps):
            p = PrecisionProfile(tuple(reps), name="cand") if mod is search else \
                jprofile.PrecisionProfile(tuple(reps), name="cand")
            rep_tree = lm_mod.profile_repeat_tree(cfg if mod is search else jcfg, p)
            return cal_mod.eval_profile_accuracy(apply, energies, rep_tree, batch, key=key,
                                                 n_noise_samples=2)

        float_acc = acc((4,) * n)
        return mod.repeat_profile_search(acc, n_layers=n, float_acc=float_acc,
                                         k_levels=(1, 2, 4)), float_acc

    res, fa = search_in(search, cal, lm, bert["apply"], bert["energies"], bert["batch"],
                        PRNGKey(3))
    jres, jfa = search_in(jsearch, jcal, jlm, bert["japply"], bert["jenergies"], bert["jbatch"],
                          jax.random.PRNGKey(3))
    assert fa == jfa
    assert res.repeats == jres.repeats and res.trace == jres.trace
    # the search lowered a layer, and not every layer to K=1
    assert res.feasible and res.repeats != (4,) * n and res.repeats != (1,) * n
    p = PrecisionProfile(res.repeats, name="learned", accuracy=res.accuracy)
    p.save(str(tmp_path / "learned.json"))
    j = jprofile.PrecisionProfile.load(str(tmp_path / "learned.json"))
    assert j.repeats == p.repeats and j.accuracy == p.accuracy


def test_lm_probe_matches_reference_engine(bert):
    """The engine's probe functions against the reference engine's: hidden
    states at float32 within 1e-4 of max|h|, ``noise_rms`` within 1e-5."""
    from repro.serving.engine import ServingEngine as JServingEngine

    cfg, jcfg = bert["cfg"], bert["jcfg"]
    jparams = bert["jparams"]
    jengine = JServingEngine(jparams, jcfg, analog_cfg=JAnalogConfig.shot(backend="tile"),
                             energies=bert["jenergies"])
    x = bert["batch"][0][0]
    jx = bert["jbatch"][0][0]
    ref, jref = bert["engine"].probe_reference(x), jengine.probe_reference(jx)
    scale = float(np.abs(np.asarray(jref)).max())
    np.testing.assert_allclose(_np(ref), np.asarray(jref), atol=1e-4 * scale, rtol=0)
    h = bert["probe"](bert["energies"], x, PRNGKey(4))
    jh = jengine.probe_apply()(bert["jenergies"], jx, jax.random.PRNGKey(4))
    np.testing.assert_allclose(_np(h), np.asarray(jh), atol=1e-4 * scale, rtol=0)
    got = cal.noise_rms(bert["probe"], bert["energies"], x, ref, key=PRNGKey(5))
    want = jcal.noise_rms(jengine.probe_apply(), bert["jenergies"], jx, jref,
                          key=jax.random.PRNGKey(5))
    np.testing.assert_allclose(got, float(want), rtol=RMS_RTOL)
    assert cfg.n_layers == jcfg.n_layers
