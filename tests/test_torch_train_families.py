"""Port vs reference: training of the griffin, xlstm and moe families
(``lm.train_loss`` and ``launch/steps.py`` ``make_train_step``) on the
reference's smoke configs of recurrentgemma-2b, xlstm-1.3b, grok-1-314b
and llama4-maverick at float32.

Weights are numpy at ``lm.param_leaves``' shapes, handed to both packages
(``repro_torch.bridge``); the reference's jitted ``value_and_grad`` runs
once a (config, T) for the module. Held here:

* the loss within 1e-5 relative and every gradient leaf within
  ``1e-4 * max|g_ref|`` (``tests/test_torch_train.py``'s bounds), remat
  on (the configs' default: group remat, and per-sublayer remat in
  griffin and xlstm); the gradients come through ``steps._grad_leaves``,
  whose per-layer, per-block and per-expert views accumulate in place;
* xlstm: on random weights its recurrences amplify float order (the
  sLSTM's and mLSTM's state carries), so its leaf bound adds the
  reference's own distance between two mLSTM chunk sizes (32 and 16: the
  same recurrence summed in another order), measured here;
* griffin's local attention past its window (T = 2 * window, aligned:
  the query-chunk einsum branch under autograd) against the reference;
* remat on equals remat off, bit for bit, loss and every leaf;
* the virtual-expert split (``moe_ff_split`` = 2 with the weights split
  to match) gives the unsplit loss within 1e-4, as
  ``tests/test_moe.py``'s does in the reference;
* two ``make_train_step`` steps from the same weights and a fresh
  optimizer, run twice, are bit-equal, and the loss and the parameters
  move;
* Adam and the global norm cut a layer of experts (a row of a 3-D or
  4-D leaf above ``SLICE_ELEMS``) along its next axes, the update bit
  for bit the whole leaf's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs as several processes on the cores (pytest-xdist): torch's
# intra-op threads in each would oversubscribe them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adam, clip  # noqa: E402
from repro_torch.tree import leaves, map_leaves  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
SPLIT_ATOL = 1e-4  # tests/test_moe.py's virtual-expert bound
T, B = 32, 4
ARCHS = ["recurrentgemma-2b", "xlstm-1.3b", "grok-1-314b", "llama4-maverick-400b-a17b"]
#: the families whose groups checkpoint per sublayer (griffin, xlstm) or hold
#: a MoE block under the group's checkpoint
REMAT_ARCHS = ["recurrentgemma-2b", "xlstm-1.3b", "grok-1-314b"]


def _np(t):
    return t.detach().float().cpu().numpy()


def _cfgs(arch, **kw):
    return (dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw),
            dataclasses.replace(jsmoke(arch), dtype="float32", **kw))


def _weights(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return lm.map_leaves(lambda _p, leaf: (rng.standard_normal(leaf.shape)
                                           * (leaf.scale or 0.1)).astype(np.float32),
                         lm.param_leaves(cfg))


def _batch(cfg, t=T, step=0):
    data = pipeline.TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=t, global_batch=B, seed=3)
    return pipeline.markov_batch(data, step)


def _port_grads(tree, batch, cfg):
    params = bridge.params_from_numpy(tree, cfg, "cpu")
    grads = map_leaves(lambda _p, p: torch.zeros_like(p), params)
    loss = lm.train_loss(steps._grad_leaves(params, grads), steps.batch_tensors(batch, "cpu"),
                         cfg)
    loss.backward()
    return loss.detach(), grads


_REF = {}


def _ref_grads(arch, t=T, **kw):
    """The reference's jitted (loss, gradient leaves) on ``_weights`` and
    ``_batch(cfg, t)``, once per (arch, t, config changes)."""
    key = (arch, t, tuple(sorted(kw.items())))
    if key not in _REF:
        cfg, jcfg = _cfgs(arch, **kw)
        tree, batch = _weights(cfg), _batch(cfg, t)
        fn = jax.jit(jax.value_and_grad(lambda p: jlm.train_loss(p, batch, jcfg)))
        loss, grads = fn(jax.tree.map(jnp.asarray, tree))
        _REF[key] = float(loss), [np.asarray(g, np.float32) for g in jax.tree.leaves(grads)]
    return _REF[key]


def _check(arch, loss, grads, ref, spread=None):
    jloss, jgrads = ref
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    cfg, _ = _cfgs(arch)
    paths = leaves(lm.map_leaves(lambda p, _l: "/".join(p), lm.param_leaves(cfg)))
    assert len(paths) == len(jgrads) == len(leaves(grads))
    for i, (path, g, jg) in enumerate(zip(paths, leaves(grads), jgrads)):
        bound = GRAD_REL * np.abs(jg).max() + (0.0 if spread is None else spread[i])
        err = np.abs(_np(g) - jg).max()
        assert err <= bound, (arch, path, err, bound)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch):
    cfg, _ = _cfgs(arch)
    assert cfg.remat
    loss, grads = _port_grads(_weights(cfg), _batch(cfg), cfg)
    spread = None
    if cfg.family == "xlstm":  # the reference's own float-order distance
        half = _ref_grads(arch, attn_kv_chunk=cfg.attn_kv_chunk // 2)[1]
        spread = [np.abs(a - b).max() for a, b in zip(_ref_grads(arch)[1], half)]
        assert max(s / np.abs(g).max() for s, g in zip(spread, half)) < GRAD_REL
    _check(arch, loss, grads, _ref_grads(arch), spread)


def test_griffin_local_attention_past_the_window():
    """T = 2 * local_window: each query chunk of ``window`` rows attends to
    its (previous, current) key chunks by plain einsums, under autograd."""
    arch = "recurrentgemma-2b"
    cfg, _ = _cfgs(arch)
    t = 2 * cfg.local_window
    assert t % cfg.local_window == 0 and t > cfg.local_window
    loss, grads = _port_grads(_weights(cfg), _batch(cfg, t), cfg)
    _check(arch, loss, grads, _ref_grads(arch, t))


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_on_equals_off_bit_for_bit(arch):
    runs = []
    for remat in (True, False):
        cfg, _ = _cfgs(arch, remat=remat)
        runs.append(_port_grads(_weights(cfg), _batch(cfg), cfg))
    (l_on, g_on), (l_off, g_off) = runs
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(a, b) for a, b in zip(leaves(g_on), leaves(g_off)))


def test_virtual_expert_split_keeps_the_loss():
    """grok's smoke config at ``moe_ff_split`` 1 and 2: expert e's d_ff
    halves become virtual experts 2e and 2e + 1 (gate/up split by columns,
    down by rows), and the loss stays within 1e-4 of the unsplit one."""
    cfg1, _ = _cfgs("grok-1-314b", moe_ff_split=1)
    cfg2 = dataclasses.replace(cfg1, moe_ff_split=2)
    tree1 = _weights(cfg1)
    moe1 = tree1["blocks"]["moe"]

    def split_ff(w):  # (G, E, d, ff) -> (G, 2E, d, ff/2)
        g, e, d, ff = w.shape
        return np.moveaxis(w.reshape(g, e, d, 2, ff // 2), 3, 2).reshape(g, 2 * e, d, ff // 2)

    def split_in(w):  # (G, E, ff, d) -> (G, 2E, ff/2, d)
        g, e, ff, d = w.shape
        return w.reshape(g, 2 * e, ff // 2, d)

    tree2 = dict(tree1, blocks=dict(tree1["blocks"], moe={
        "router": moe1["router"], "w_gate": split_ff(moe1["w_gate"]),
        "w_up": split_ff(moe1["w_up"]), "w_down": split_in(moe1["w_down"])}))
    batch = steps.batch_tensors(_batch(cfg1), "cpu")
    l1 = lm.train_loss(bridge.params_from_numpy(tree1, cfg1, "cpu"), batch, cfg1)
    l2 = lm.train_loss(bridge.params_from_numpy(tree2, cfg2, "cpu"), batch, cfg2)
    assert abs(float(l1) - float(l2)) < SPLIT_ATOL


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_two_train_steps_repeat_bit_for_bit(arch):
    cfg, _ = _cfgs(arch)
    tcfg = steps.TrainConfig(lr=1e-2)
    step = steps.make_train_step(cfg, None, tcfg)
    batches = [_batch(cfg, step=i) for i in range(2)]
    runs = []
    for _ in range(2):
        params = bridge.params_from_numpy(_weights(cfg), cfg, "cpu")
        opt = steps.make_opt_init(cfg, None, tcfg)(params)
        losses = []
        for b in batches:
            params, opt, metrics = step(params, opt, b)
            losses.append(metrics["loss"])
        runs.append((losses, leaves(params) + leaves(opt.mu) + leaves(opt.nu)))
    (l1, s1), (l2, s2) = runs
    assert all(torch.equal(a, b) for a, b in zip(l1, l2))
    assert all(torch.equal(a, b) for a, b in zip(s1, s2))
    assert all(torch.isfinite(x) for x in l1)
    start = bridge.params_from_numpy(_weights(cfg), cfg, "cpu")
    assert any(not torch.equal(a, b) for a, b in zip(leaves(start), s1))


def test_adam_and_global_norm_slice_an_expert_layer(monkeypatch):
    """A row of a leaf of three or more axes above ``SLICE_ELEMS`` (one
    layer of experts, (E, d, f)) is cut along its next axes: every element
    in exactly one slice of at most ``SLICE_ELEMS``, the update in slices
    equal to the whole leaf's bit for bit, the norm the whole leaf's to
    float32 rounding. A 2-D leaf keeps whole rows."""
    gen = torch.Generator().manual_seed(0)
    p, g = (torch.randn((2, 3, 4, 5), generator=gen) for _ in range(2))
    cfg = adam.AdamConfig(lr=1e-2, weight_decay=0.1)
    whole_p, _ = adam.adam_update({"w": g}, adam.adam_init({"w": p}, cfg), {"w": p}, cfg)
    whole_norm = float(clip.global_norm({"w": g}))
    monkeypatch.setattr(adam, "SLICE_ELEMS", 8)
    sl = adam.leading_slices(p)
    cover = torch.zeros_like(p)
    for s in sl:
        assert p[s].numel() <= 8
        cover[s] += 1
    assert bool((cover == 1).all()) and len(sl) == 2 * 3 * 4  # rows of 5
    assert len(adam.leading_slices(torch.zeros((6, 9)))) == 6
    state = adam.adam_init({"w": p}, cfg)
    q = p.clone()
    adam.adam_update_({"w": g}, state, {"w": q}, cfg)
    assert torch.equal(q, whole_p["w"])
    np.testing.assert_allclose(float(clip.global_norm({"w": g})), whole_norm, rtol=1e-6)
