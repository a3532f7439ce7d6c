"""Port vs reference: the dense LM (prefill, per-row decode, caches) and
the weight bridge.

Both packages compute from the same numpy weights (``lm.param_leaves``
shapes; not the reference ``init_params``, whose ``jax.random.split``
depends on the jax version) at float32. Tolerance: max|dlogit| within
``1e-4 * max|logit|`` — float32 sums in another order through 4 layers.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs as several processes on the cores (pytest-xdist): torch's
# intra-op threads in each would oversubscribe them (20x slower when six run)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.granite_3_8b import smoke_config as jsmoke_config  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.granite_3_8b import smoke_config  # noqa: E402
from repro_torch.core.analog import AnalogConfig, fold_key  # noqa: E402
from repro_torch.models import lm  # noqa: E402

REL_TOL = 1e-4
CFG = dataclasses.replace(smoke_config(), dtype="float32")
JCFG = dataclasses.replace(jsmoke_config(), dtype="float32")


def numpy_params(cfg, seed=0):
    """Weights at the reference shapes and scales; norm scales random too,
    so rms_norm's (1 + scale) is exercised."""
    rng = np.random.default_rng(seed)
    return lm.map_leaves(
        lambda _p, leaf: (rng.standard_normal(leaf.shape) * (leaf.scale or 0.1)).astype(np.float32),
        lm.param_leaves(cfg),
    )


def _close(got, want, rel=REL_TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


@pytest.fixture(scope="module")
def weights():
    tree = numpy_params(CFG)
    jenergies = jlm.init_energy_tree(JCFG, 20.0)
    return dict(
        tree=tree,
        jparams=jax.tree.map(jnp.asarray, tree),
        params=bridge.params_from_numpy(tree, CFG, "cpu"),
        jenergies=jenergies,
        energies=bridge.energies_from_numpy(jax.tree.map(np.asarray, jenergies), CFG, "cpu"),
    )


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.asarray([5, 16, 9, 0], np.int32)  # the last row is batch padding
    toks = np.zeros((4, 16), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(0, CFG.vocab_size, n)
    return toks, lengths


def _keys():
    return jnp.stack([jax.random.fold_in(jax.random.PRNGKey(5), u) for u in range(3)]
                     + [jax.random.PRNGKey(0)])


def _specs(weights, n_repeats, keys):
    jspec = jlm.AnalogSpec(cfg=JAnalogConfig.shot(backend="tile"), energies=weights["jenergies"],
                           key=keys, n_repeats=n_repeats)
    spec = lm.AnalogSpec(cfg=AnalogConfig.shot(), energies=weights["energies"],
                         key=np.asarray(keys), n_repeats=n_repeats)
    return jspec, spec


@functools.partial(jax.jit, static_argnames=("k",))
def _jdecode(params, cache, tok, pos, lengths, energies, key, *, k):
    """The reference's decode step (digital for ``k`` None), compiled once a
    K: a test's decode steps share one executable."""
    spec = None if k is None else jlm.AnalogSpec(
        cfg=JAnalogConfig.shot(backend="tile"), energies=energies, key=key, n_repeats=k)
    return jlm.decode_step(params, cache, {"tokens": tok}, pos, JCFG, analog=spec, lengths=lengths)


@pytest.mark.parametrize("mode", ["digital", "analog-K1", "analog-K4"])
def test_prefill_and_per_row_decode_match_reference(weights, mode):
    toks, lengths = _batch()
    cache_len = 20
    keys = _keys()
    n_rep = 4 if mode.endswith("K4") else 1
    jspec, spec = _specs(weights, n_rep, keys) if mode != "digital" else (None, None)
    jcache, jh = jlm.prefill(weights["jparams"], {"tokens": jnp.asarray(toks)}, JCFG, analog=jspec,
                             cache_len=cache_len, lengths=jnp.asarray(lengths))
    jlogits = jlm.logits_last(weights["jparams"], jh, JCFG)
    cache, h = lm.prefill(weights["params"], torch.from_numpy(toks), CFG, analog=spec,
                          cache_len=cache_len, lengths=torch.from_numpy(lengths))
    logits = lm.logits_last(weights["params"], h, CFG)
    _close(logits[:3], jlogits[:3])
    for name in ("k", "v"):
        _close(cache["groups"][name][:, :, :3], jcache["groups"][name][:, :, :3])

    tok = np.asarray(jnp.argmax(jlogits[:, 0, 0], axis=-1)).astype(np.int32)
    for step in range(2):
        pos = lengths + step
        step_spec = spec and dataclasses.replace(spec, key=fold_key(np.asarray(keys), pos))
        jlogits, jcache = _jdecode(weights["jparams"], jcache, jnp.asarray(tok)[:, None],
                                   jnp.asarray(pos), jnp.asarray(lengths), weights["jenergies"],
                                   jax.vmap(jax.random.fold_in)(keys, jnp.asarray(pos)),
                                   k=None if mode == "digital" else n_rep)
        logits, cache = lm.decode_step(weights["params"], cache, torch.from_numpy(tok)[:, None],
                                       torch.from_numpy(pos), CFG, analog=step_spec)
        _close(logits[:3], jlogits[:3])
        for name in ("k", "v"):
            _close(cache["groups"][name][:, :, :3], jcache["groups"][name][:, :, :3])
        tok = np.asarray(jnp.argmax(jlogits[:, 0, 0], axis=-1)).astype(np.int32)


def test_padded_batch_rows_equal_solo_rows(weights):
    """Inside the port: a request's prefill logits in a padded bucket batch
    equal its solo run bit for bit (stacked per-request keys)."""
    toks, lengths = _batch(1)
    keys = np.asarray(_keys())
    _, spec = _specs(weights, 4, jnp.asarray(keys))
    _, h = lm.prefill(weights["params"], torch.from_numpy(toks), CFG, analog=spec, cache_len=20,
                      lengths=torch.from_numpy(lengths))
    for r in range(3):
        solo_spec = dataclasses.replace(spec, key=keys[r:r + 1])
        _, hs = lm.prefill(weights["params"], torch.from_numpy(toks[r:r + 1]), CFG, analog=solo_spec,
                           cache_len=20, lengths=torch.from_numpy(lengths[r:r + 1]))
        torch.testing.assert_close(h[r:r + 1], hs, rtol=0, atol=0)


def test_bridge_round_trip(weights):
    for path_tree in (weights["params"],):
        lm.map_leaves(
            lambda p, leaf, t, a: np.testing.assert_array_equal(t.numpy(), a) or
            (tuple(t.shape) == leaf.shape) or pytest.fail("/".join(p)),
            lm.param_leaves(CFG), path_tree, weights["tree"],
        )
    np.testing.assert_array_equal(weights["energies"]["groups"]["mlp0_up"].numpy(),
                                  np.asarray(weights["jenergies"]["groups"]["mlp0_up"]))


def test_bridge_keeps_bfloat16_bits():
    bf16 = jnp.asarray(np.linspace(-3, 3, 7, dtype=np.float32)).astype(jnp.bfloat16)
    t = bridge._to_torch(np.asarray(bf16), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(bf16.astype(jnp.float32)))


def test_bridge_rejects_wrong_shapes(weights):
    bad = dict(weights["tree"], final_ln=np.zeros((3,), np.float32))
    with pytest.raises(ValueError):
        bridge.params_from_numpy(bad, CFG, "cpu")


def test_init_params_shapes_scales_and_seed():
    a = lm.init_params(CFG, seed=3, device="cpu")
    b = lm.init_params(CFG, seed=3, device="cpu")
    c = lm.init_params(CFG, seed=4, device="cpu")
    lm.map_leaves(lambda p, leaf, x: tuple(x.shape) == leaf.shape or pytest.fail("/".join(p)),
                  lm.param_leaves(CFG), a)
    torch.testing.assert_close(a["blocks"]["attn0"]["wq"], b["blocks"]["attn0"]["wq"], rtol=0, atol=0)
    assert not torch.equal(a["blocks"]["attn0"]["wq"], c["blocks"]["attn0"]["wq"])
    assert float(a["final_ln"].abs().max()) == 0.0  # scale-0 leaves start at zero
    std = float(a["blocks"]["mlp0"]["w_down"].std())
    assert std == pytest.approx(CFG.d_ff**-0.5, rel=0.1)
    assert a["embed"].dtype == torch.float32
    assert lm.init_params(smoke_config(), device="cpu")["embed"].dtype == torch.bfloat16


def test_param_count_matches_leaves():
    n = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(
        lm.param_leaves(CFG), is_leaf=lambda x: isinstance(x, lm.Leaf)))
    pad = (CFG.padded_vocab - CFG.vocab_size) * CFG.d_model * 2
    final_ln = CFG.d_model  # the reference's count leaves out the final norm
    assert CFG.param_count() == n - pad - final_ln
