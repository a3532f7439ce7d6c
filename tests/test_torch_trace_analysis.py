"""The dry run's reckoning (``launch/trace_analysis.py``): one device's
step run on the meta device under the FLOP counter, the contraction and
analog tallies, the live-bytes tracker and a dry mesh's collective
recorder.

* The reckoned dot FLOPs (matmul plus contraction) of a smoke config's
  prefill and decode steps are within 2 % of the reference's
  ``hlo_analysis.analyze(...).dot_flops`` for the same step compiled on
  one CPU device (dense, griffin, xlstm; measured: equal).
* The train step's ratio to the reference's is ``TRAIN_RATIO`` ± 1 %:
  the port recomputes each layer group's forward in the backward
  (remat) and its flash attention backward recomputes the block scores,
  where XLA's compiled step keeps some of them.
* The tracker's peak (and the bytes alive before the step) on meta equal
  its peak on real CPU tensors of the same step; the train step's differ
  by at most the host tensors of Adam's step counter, which live on the
  CPU on every device.
* On a dry 2 x 4 mesh (data x tp) an analog prefill records one
  all-gather of 4 shards per analog site, the site's (rows, N) float32
  output, by count and bytes, and reckons no site whole.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import ShapeSpec, get_smoke_config, input_specs  # noqa: E402
from repro_torch.core import analog as analog_lib  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.launch import collectives, steps  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.trace_analysis import meta_params, reckon  # noqa: E402
from repro_torch.models import hooks, lm  # noqa: E402

T, B = 32, 2
FLOP_REL = 0.02
#: the port's train-step dot FLOPs over the reference's compiled step's,
#: granite-3-8b's smoke config at 2 x 32 (measured 1.0610)
TRAIN_RATIO, TRAIN_REL = 1.0610, 0.01
#: host bytes of the train step that live on the CPU on every device
#: (Adam's int32 step counter, before and after the step)
HOST_BYTES = 8
FLOP_ARCHS = ("granite-3-8b", "recurrentgemma-2b", "xlstm-1.3b")


def _meta_like(tree):
    return lm.map_leaves(lambda _p, t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def _port_flops(cfg, kind):
    params = meta_params(cfg)
    batch = input_specs(cfg, ShapeSpec("s", T, B, kind))
    if kind == "prefill":
        step = steps.make_prefill_step(cfg, None, cache_len=T)
        fn, hold = (lambda: step(params, batch, None, None)), (params, batch)
    elif kind == "decode":
        cache = lm.init_cache(cfg, B, T, device="meta")
        step = steps.make_decode_step(cfg, None)
        fn, hold = (lambda: step(params, cache, batch, T - 1, None, None)), (params, cache)
    else:
        tcfg = steps.TrainConfig()
        opt = steps.make_opt_init(cfg, None, tcfg)(params)
        step = steps.make_train_step(cfg, None, tcfg)
        fn, hold = (lambda: step(params, opt, batch)), (params, opt, batch)
    return reckon(fn, hold=hold)[1]


def _reference_flops(arch, kind):
    import jax

    from repro.configs import get_smoke_config as jsmoke
    from repro.configs.shapes import ShapeSpec as JShapeSpec
    from repro.configs.shapes import input_specs as jinput_specs
    from repro.launch import hlo_analysis
    from repro.launch.mesh import make_local_mesh
    from repro.launch.steps import TrainConfig, make_decode_step, make_prefill_step, make_train_step
    from repro.models import lm as jlm
    from repro.optim.adam import adam_init

    jcfg, mesh = jsmoke(arch), make_local_mesh()
    jb = jinput_specs(jcfg, JShapeSpec("s", T, B, kind))
    p = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0), jcfg))
    if kind == "prefill":
        _, jit_for, _ = make_prefill_step(jcfg, mesh, cache_len=T)
        lowered = jit_for(jb).lower(p, jb, None, None)
    elif kind == "decode":
        _, jit_for, _ = make_decode_step(jcfg, mesh)
        c = jax.eval_shape(lambda: jlm.init_cache(jcfg, B, T))
        lowered = jit_for(jb, T).lower(p, c, jb, T - 1, None, None)
    else:
        tcfg = TrainConfig()
        _, jit_for, _ = make_train_step(jcfg, mesh, tcfg)
        o = jax.eval_shape(lambda q: adam_init(q, tcfg.adam()), p)
        lowered = jit_for(jb).lower(p, o, jb)
    return hlo_analysis.analyze(lowered.compile().as_text(), 1).dot_flops


@pytest.mark.parametrize("arch", FLOP_ARCHS)
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_step_flops_match_reference(arch, kind):
    st = _port_flops(get_smoke_config(arch), kind)
    want = _reference_flops(arch, kind)
    assert st.analog_flops == 0
    assert abs(st.matmul_flops + st.contraction_flops - want) <= FLOP_REL * want, (st, want)
    if kind == "decode":  # decode attention's contractions are elementwise products
        assert st.contraction_flops > 0


def test_train_step_flops_ratio():
    st = _port_flops(get_smoke_config("granite-3-8b"), "train")
    ratio = st.dot_flops / _reference_flops("granite-3-8b", "train")
    assert abs(ratio - TRAIN_RATIO) <= TRAIN_REL * TRAIN_RATIO, ratio


def _program(cfg, kind, dev):
    params = lm.init_params(cfg, 0, device="cpu")
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in input_specs(cfg, ShapeSpec("s", T, B, kind)).items()}
    energies = lm.init_energy_tree(cfg, 10.0, device="cpu")
    if dev == "meta":
        params, batch, energies = _meta_like(params), _meta_like(batch), _meta_like(energies)
    if kind == "prefill":
        step = steps.make_prefill_step(cfg, None, cache_len=T,
                                       analog_cfg=AnalogConfig.shot(backend="tile"))
        key = np.asarray([0, 1], np.uint32)
        return (lambda: step(params, batch, energies, key)), (params, batch, energies)
    if kind == "decode":
        cache = lm.init_cache(cfg, B, T, device=dev)
        step = steps.make_decode_step(cfg, None)
        return (lambda: step(params, cache, batch, T - 1, None, None)), (params, batch, cache)
    tcfg = steps.TrainConfig()
    opt = steps.make_opt_init(cfg, None, tcfg)(params)
    step = steps.make_train_step(cfg, None, tcfg)
    return (lambda: step(params, opt, batch)), (params, opt, batch)


@pytest.mark.parametrize("arch", ["granite-3-8b", "grok-1-314b"])
@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_meta_peak_equals_real_tensors(arch, kind):
    cfg = get_smoke_config(arch)
    got = {}
    for dev in ("meta", "cpu"):
        fn, hold = _program(cfg, kind, dev)
        got[dev] = reckon(fn, device=dev, hold=hold)[1]
    m, c = got["meta"], got["cpu"]
    assert m.dot_flops == c.dot_flops > 0
    slack = HOST_BYTES if kind == "train" else 0
    assert 0 <= c.base_bytes - m.base_bytes <= slack
    assert 0 <= c.peak_bytes - m.peak_bytes <= slack
    assert m.peak_bytes > m.base_bytes


def test_dry_mesh_records_the_column_shard_gathers(monkeypatch):
    cfg = dataclasses.replace(get_smoke_config("granite-3-8b"), dtype="float32")
    data, tp, rows = 2, 4, 2  # rows a device
    params = meta_params(cfg)
    energies = lm.init_energy_tree(cfg, 10.0, device="meta")
    acfg, key = AnalogConfig.shot(backend="tile"), np.zeros(2, np.uint32)

    # every analog site's (rows, N) on one device's rows, run whole
    sites = []
    real_dot = hooks.analog_dot

    def spy(x, w, **kw):
        sites.append((x.numel() // x.shape[-1], w.shape[1]))
        return real_dot(x, w, **kw)

    monkeypatch.setattr(hooks, "analog_dot", spy)
    step = steps.make_prefill_step(cfg, None, cache_len=T, analog_cfg=acfg)
    batch = input_specs(cfg, ShapeSpec("s", T, rows, "prefill"))
    reckon(lambda: step(params, batch, energies, key), hold=(params,))
    monkeypatch.setattr(hooks, "analog_dot", real_dot)
    assert sites

    # shard (0, 0) of the dry mesh on the global batch
    whole = []
    real_tile = analog_lib.tile_dot
    monkeypatch.setattr(analog_lib, "tile_dot", lambda *a, **kw: whole.append(1)
                        or real_tile(*a, **kw))
    rec = collectives.Recorder()
    mesh = Mesh(tp=tp, group=collectives.DryGroup(data * tp, rec), data=data)
    step = steps.make_prefill_step(cfg, mesh, cache_len=T, analog_cfg=acfg)
    batch = input_specs(cfg, ShapeSpec("s", T, rows * data, "prefill"))
    _, st = reckon(lambda: step(params, batch, energies, key), hold=(params,), recorder=rec)
    want = [("all-gather", m * n * 4, tp) for m, n in sites]  # (rows, N) float32, 4 shards
    assert sorted(rec.calls) == sorted(want)
    assert st.collective_counts == {"all-gather": len(sites)}
    assert st.collective_bytes == {"all-gather": sum(b for _k, b, _g in want)}
    assert not whole  # no site ran whole
