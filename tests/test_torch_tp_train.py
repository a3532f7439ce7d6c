"""Tensor-parallel training, the local form (``launch/steps.py`` on a mesh
of tensor shards, which the local form runs in turn inside each sharded
block; ``models/sharding.py`` ``tensor_plan``; the Megatron blocks of
``models/lm.py``, ``layers.py``, ``griffin.py``, ``moe.py``;
``launch/collectives.py``' *f* and *g*).

Two steps on float32 smoke configs from the same numpy weights and
batches: the local form at tp against the port's one-device step and the
reference's (``make_train_step`` on ``make_local_mesh()``), each within
the bounds below (loss and gradient norm relative; every parameter within
``PARAM_MAX`` and ``PARAM_SHARE`` of them within ``PARAM_CLOSE * (1 +
|p|)``, as Adam's first steps move a weight by about lr whatever its
gradient's size: where a gradient is near 0, float order can flip its
sign). The cases: granite3-smoke at tp 2, and at tp 4 where its 2 kv
heads stay whole; qwen14-smoke (``qkv_bias``); rgemma-smoke (rnn, MQA,
and tied embeddings as recurrentgemma-2b's, which its smoke config
leaves out); grok1-smoke (experts); musicgen-smoke (4 codebooks,
``frames``) at tp 2, and at tp 8 where each shard holds half a codebook;
granite3-smoke with 6 heads at tp 4, whose attention stays whole.

The bounds come from the distances measured on these cases (largest over
them: loss and gradient norm 2.25e-6 relative against the port's step,
6.9e-7 against the reference's; a parameter 2.3e-4 away at most, and at
least 99.857 % of them within 1e-6 (1 + |p|), both at rgemma; the port's
own one-device step is 2.9e-6 and 99.855 % from the reference's), with
room of about 4x (2x on the share's misses), and each planted fault
lands outside them: one shard's partial dropped from *g* (0.35
relative) and every whole leaf's gradient summed over tp (1.6e-3
relative in the gradient norm; Adam's update is blind to a leaf's
scale, so the parameters stay inside).

Also: xlstm-smoke under its ``"dp"`` profile on a 1 x 2 mesh equals the
one-device step at ``microbatches = 2`` bit for bit; the vocab-parallel
loss with a shard across a codebook boundary (3 codebooks, tp 2) against
the whole head; ``tensor_plan``'s exceptions.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.launch.steps import TrainConfig as JTrainConfig  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import collectives, steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for_devices  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.sharding import Shards, TensorShard, TPLeaf, tensor_plan  # noqa: E402
from repro_torch.tree import leaves, map_leaves  # noqa: E402
from test_torch_tp_train_dist import LR, STEPS, _batch, _weights  # noqa: E402

REL = 1e-5  # loss and gradient norm, against either one-device step
PARAM_MAX, PARAM_CLOSE, PARAM_SHARE = 1e-3, 1e-6, 0.997
CASES = {
    "granite3": ("granite-3-8b", 2, {}),
    "granite3_tp4_kv_whole": ("granite-3-8b", 4, {}),
    "qwen14": ("qwen2.5-14b", 2, {}),
    "rgemma": ("recurrentgemma-2b", 2, {"tie_embeddings": True}),
    "grok1": ("grok-1-314b", 2, {}),
    "musicgen": ("musicgen-large", 2, {}),
    "musicgen_tp8": ("musicgen-large", 8, {}),
    "granite3_6_heads_whole_attention": ("granite-3-8b", 4, {"n_heads": 6}),
}


def _cfg(arch, **kw):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)


def _run(cfg, mesh, m=1, tree=None):
    """``STEPS`` port steps from ``tree``: (params, [(loss, grad_norm)])."""
    tcfg = steps.TrainConfig(lr=LR, microbatches=m, opt_state_dtype="float32")
    params = bridge.params_from_numpy(_weights(cfg) if tree is None else tree, cfg, "cpu")
    opt = steps.make_opt_init(cfg, mesh, tcfg)(params)
    step = steps.make_train_step(cfg, mesh, tcfg)
    metrics = []
    for i in range(STEPS):
        params, opt, met = step(params, opt, _batch(cfg, i))
        metrics.append((float(met["loss"]), float(met["grad_norm"])))
    return params, metrics


_REF = {}


def _reference(arch, kw):
    """The reference's ``STEPS`` one-device steps on the same weights and
    batches, once per config: (parameter leaves, [(loss, grad_norm)])."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _REF:
        cfg = _cfg(arch, **kw)
        jcfg = dataclasses.replace(jsmoke(arch), dtype="float32", **kw)
        jtcfg = JTrainConfig(lr=LR, opt_state_dtype="float32")
        _, jit_for, _ = jmake_train_step(jcfg, make_local_mesh(), jtcfg)
        batch0 = _batch(cfg, 0)
        jstep = jit_for({k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch0.items()})
        params = jax.tree.map(jnp.asarray, _weights(cfg))
        opt = jadam.adam_init(params, jtcfg.adam())
        metrics = []
        for i in range(STEPS):
            params, opt, met = jstep(params, opt, _batch(cfg, i))
            metrics.append((float(met["loss"]), float(met["grad_norm"])))
        _REF[key] = [np.asarray(p, np.float32) for p in jax.tree.leaves(params)], metrics
    return _REF[key]


def _distance(params, metrics, want_params, want_metrics):
    """(largest relative distance of loss and gradient norm, largest
    parameter distance, share of parameters within PARAM_CLOSE (1 + |p|))."""
    rel = max(abs(a - b) / abs(b) for m, w in zip(metrics, want_metrics) for a, b in zip(m, w))
    worst = close = total = 0
    for p, w in zip(leaves(params), want_params):
        p = p.detach().float().numpy() if torch.is_tensor(p) else p
        w = w.detach().float().numpy() if torch.is_tensor(w) else w
        diff = np.abs(p - w)
        worst = max(worst, float(diff.max()))
        close += int((diff <= PARAM_CLOSE * (1 + np.abs(w))).sum())
        total += diff.size
    return rel, worst, close / total


def _within(rel, worst, share) -> bool:
    print(f"rel {rel:.3g}, parameters {worst:.3g} at most, {share:.6f} close")
    return rel <= REL and worst <= PARAM_MAX and share >= PARAM_SHARE


@pytest.mark.parametrize("case", list(CASES))
def test_local_tp_step_matches_one_device(case):
    arch, tp, kw = CASES[case]
    cfg = _cfg(arch, **kw)
    one, one_metrics = _run(cfg, None)
    got, metrics = _run(cfg, make_mesh_for_devices(tp))
    assert _within(*_distance(got, metrics, leaves(one), one_metrics))
    assert _within(*_distance(got, metrics, *_reference(arch, kw)))


def test_dp_profile_on_both_axes_equals_one_device_microbatches():
    cfg = _cfg("xlstm-1.3b", sharding_profile="dp")
    one, one_metrics = _run(cfg, None, m=2)
    got, metrics = _run(cfg, make_mesh_for_devices(2))
    assert metrics == one_metrics
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(one)))


def _drop_last_partial(monkeypatch):
    orig = collectives.reduce_from_tp
    monkeypatch.setattr(collectives, "reduce_from_tp",
                        lambda parts, shards: orig(parts[:-1] + [parts[-1] * 0], shards))


def _sum_whole_leaves(monkeypatch):
    """Every whole leaf's gradient summed over tp, as a rank that summed
    it would (the local form holds it on shard 0: each shard gets a copy
    first)."""
    orig = steps._per_leaf

    def faulty(grads, plan):
        out = []
        for place, gs in orig(grads, plan):
            if not place.per_shard:
                for g in gs[1:]:
                    g.copy_(gs[0])
                place = TPLeaf(summed=True)
            out.append((place, gs))
        return out

    monkeypatch.setattr(steps, "_per_leaf", faulty)


@pytest.mark.parametrize("fault", [_drop_last_partial, _sum_whole_leaves])
def test_planted_faults_fall_outside_the_bounds(fault, monkeypatch):
    cfg = _cfg("granite-3-8b")
    one, one_metrics = _run(cfg, None)
    fault(monkeypatch)
    got, metrics = _run(cfg, make_mesh_for_devices(2))
    assert not _within(*_distance(got, metrics, leaves(one), one_metrics))


def test_vocab_parallel_loss_across_a_codebook_boundary():
    """3 codebooks of 16 padded columns (13 real) at tp 2: shard 0 holds
    codebook 0 and half of 1. Loss and gradients against the whole head."""
    rng = np.random.default_rng(5)
    b, t, d, n_cb, vp, vocab = 2, 8, 12, 3, 16, 13
    h = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32))
    head = torch.from_numpy(rng.standard_normal((d, n_cb * vp)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(-1, vocab, (b, t, n_cb)).astype(np.int64))

    def loss_and_grads(split):
        hh = h.clone().requires_grad_()
        if split:
            parts = [head[:, :24].clone().requires_grad_(), head[:, 24:].clone().requires_grad_()]
            w = Shards(parts, [TensorShard(r, 2) for r in range(2)])
        else:
            w = parts = head.clone().requires_grad_()
        loss = layers.chunked_xent(hh, w, labels, chunk=4, vocab=vocab, n_codebooks=n_cb)
        loss.backward()
        gw = torch.cat([p.grad for p in parts], dim=1) if split else parts.grad
        return loss, hh.grad, gw

    want, got = loss_and_grads(False), loss_and_grads(True)
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=0)
    for g, w in zip(got[1:], want[1:]):
        assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max())


def test_tensor_plan_exceptions():
    dims = lambda plan: {"/".join(p): (v.dim, v.summed) for p, v in zip(  # noqa: E731
        leaves(map_leaves(lambda path, _l: path, plan)), leaves(plan))}
    g4 = dims(tensor_plan(_cfg("granite-3-8b"), 4))  # 4 heads, 2 kv heads
    assert g4["blocks/attn0/wq"] == (2, False) and g4["blocks/attn0/wo"] == (1, False)
    assert g4["blocks/attn0/wk"] == (None, True) and g4["blocks/ln1_0"] == (None, False)
    assert g4["embed"] == (0, False) and g4["lm_head"] == (1, False)
    g2 = dims(tensor_plan(_cfg("granite-3-8b"), 2))
    assert g2["blocks/attn0/wk"] == (2, False)
    six = dims(tensor_plan(_cfg("granite-3-8b", n_heads=6), 4))
    assert six["blocks/attn0/wq"] == (None, False) and six["blocks/mlp0/w_down"] == (1, False)
    rg = dims(tensor_plan(_cfg("recurrentgemma-2b", tie_embeddings=True), 2))
    assert rg["blocks/rec0/w_a"] == (1, False) and rg["blocks/rec0/b_a"] == (None, True)
    assert rg["tail/rec/lambda"] == (None, True) and "lm_head" not in rg
    grok = dims(tensor_plan(_cfg("grok-1-314b"), 2))
    assert grok["blocks/moe/w_gate"] == (3, False) and grok["blocks/moe/router"] == (None, False)
    with pytest.raises(NotImplementedError, match="dp"):
        tensor_plan(_cfg("xlstm-1.3b"), 2)
    assert all(v == (None, False) for v in
               dims(tensor_plan(_cfg("xlstm-1.3b", sharding_profile="dp"), 2)).values())


def test_shards_round_trip_and_layout():
    """``bridge.tensor_shard_tree`` cuts a numpy tree into contiguous
    shards that ``gather_tensor_shards`` joins back bit for bit."""
    cfg = _cfg("recurrentgemma-2b")
    tree = _weights(cfg)
    shards = [bridge.tensor_shard_tree(tree, cfg, 2, t) for t in range(2)]
    assert shards[1]["embed"].shape == (cfg.padded_vocab // 2, cfg.d_model)
    assert shards[0]["blocks"]["rec0"]["w_x"].flags["C_CONTIGUOUS"]
    back = bridge.gather_tensor_shards(shards, cfg, 2)
    assert all(np.array_equal(a, b) for a, b in zip(leaves(back), leaves(tree)))
