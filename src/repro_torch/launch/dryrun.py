"""The dry run: every (arch x shape) cell reckoned for one device of a
mesh, on the CPU, without a card; port of ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell with XLA for its production
meshes (16 x 16 and 2 x 16 x 16 TPU v5e chips) and records XLA's memory
and cost analyses. The port runs the cell's step (``launch/steps.py``) on
the meta device under ``launch/trace_analysis.reckon`` for one device of
the mesh: its FLOPs, peak bytes, largest tensors and collectives, and
``roofline.terms`` at the H100's spec rates. Meshes:

  * ``single``: 16 data x 16 tp; ``multi``: 32 data x 16 tp (the
    reference's two pods folded into data, ``mesh.make_production_mesh``).
    Dry meshes: shard (0, 0) is reckoned, its collectives recorded.
  * ``local``: one device (``mesh.make_local_mesh``): the whole global
    batch on one H100, a train cell at ``--microbatch`` microbatches.

The port's program is reckoned as it is: a train cell runs the
tensor-parallel step (``steps.make_train_step`` on the mesh: shard (0, 0)
holds its Megatron shards of the weights, ``steps.shard_params``, and its
data shard's rows); a serving cell under tp shards only the analog sites'
columns, and weights, caches and every digital site stay whole on every
device. What the port keeps whole where the reference shards it is in the
artifact's ``replicates``; the program is not made to look like the
reference's. An MoE cell whose data shard would split an expert group is
``not_ported`` (``steps.MoEGroupsAcrossShards``, ROADMAP A.4). A train cell traces one
microbatch and scales its FLOPs by their count; a cell whose trace would
take hours of host time (``_trace_points``) is traced at two smaller
row or position counts and extrapolated linearly (the artifact says so).
Artifacts go to ``--out`` (default ``dryrun_out/`` at the repository's
root).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k --mesh local
  python -m repro_torch.launch.dryrun --all [--mesh both|local] [--jobs 2] [--skip-existing]
  python -m repro_torch.launch.dryrun --summarize   # print the cell table
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
OUT_DIR = os.path.join(ROOT, "dryrun_out")
MESHES = ("single", "multi", "local")
#: rows a device traced at most where a loop runs a request at a time
#: (prefill's attention over its blocks: 528 a layer at 32,768 positions,
#: ~100 s of host time a request on the meta device; the xlstm family's
#: chunk scan), and positions at most in the xlstm family (its sLSTM steps
#: one position at a time: ~47 ms a position of one row); beyond them a
#: cell is traced at two smaller points and extrapolated
TRACE_ROWS = 2
TRACE_POSITIONS = 1024
#: the ROADMAP item a ``not_ported`` cell waits for
MOE_GROUPS_ITEM = "ROADMAP A.4 (MoE expert groups across data shards)"

CELL_ANALOG_EXTRAS = [
    # (arch, shape) cells additionally reckoned with analog shot-noise serving
    ("granite-3-8b", "decode_32k"),
    ("llama4-maverick-400b-a17b", "decode_32k"),
]


def _artifact_path(out, arch, shape, mesh_name, variant=""):
    os.makedirs(out, exist_ok=True)
    sfx = f"__{variant}" if variant else ""
    return os.path.join(out, f"{arch}__{shape}__{mesh_name}{sfx}.json")


def _mesh(name: str):
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh

    if name == "local":
        return make_local_mesh()
    return make_production_mesh(multi_pod=name == "multi")


def _nbytes(tree) -> int:
    from repro_torch.launch.trace_analysis import _tensors

    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _replicates(cfg, mesh, analog: str, batch_note, train: bool) -> list:
    """What the port keeps whole on every device of ``mesh`` where the
    reference shards it (``batch_note``: how the batch is placed where it
    is not one block of rows a data shard)."""
    out = []
    if mesh.size == 1:
        return out
    if train and mesh.tp > 1 and cfg.sharding_profile == "tp":
        if cfg.n_heads % mesh.tp:
            out.append(f"attention: whole on every device ({cfg.n_heads} heads in {mesh.tp} "
                       "shards; the reference's sequence-parallel attention is ROADMAP A.7)")
        elif cfg.n_kv_heads % mesh.tp:
            out.append(f"wk, wv: whole on every device ({cfg.n_kv_heads} kv heads in "
                       f"{mesh.tp} shards)")
        out.append("activations: whole over tp between the blocks (the reference keeps the "
                   "residual stream sequence-sharded, act_seq; ROADMAP A.7)")
        if cfg.family == "moe":
            out.append("experts: whole across data shards (the reference's expert parallelism "
                       "over data, ROADMAP A.4, A.5)")
    elif mesh.tp > 1 and not train:
        out.append("weights: whole on every device (the reference shards heads, MLP, vocabulary "
                   "and experts over tp)")
        out.append("digital sites and everything outside analog_dot: whole on every device"
                   + ("" if analog != "none" else " (this cell has no analog site)"))
        out.append("caches: whole heads on every device (the reference shards KV heads over tp)")
    if batch_note:
        out.append(batch_note)
    return out


def run_cell(arch: str, shape_name: str, mesh_name: str, analog: str = "none",
             microbatch: int = 1, causal_skip: bool = False, kv_dtype: str = None,
             profile: str = None, capacity_factor: float = None,
             int8_weights: bool = False) -> dict:
    """One cell's artifact (a dict): status ``ok``, ``skipped`` (the
    reference's ``shape_applicable`` reason) or ``not_ported`` (the
    ROADMAP item named)."""
    import numpy as np
    import torch

    from repro_torch.configs import SHAPES, get_config, input_specs, shape_applicable
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.launch import steps
    from repro_torch.launch.trace_analysis import meta_params
    from repro_torch.models import lm

    cfg = get_config(arch)
    if causal_skip:
        cfg = dataclasses.replace(cfg, causal_skip=True)
    if profile:
        cfg = dataclasses.replace(cfg, sharding_profile=profile)
    if capacity_factor:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    shape = SHAPES[shape_name]
    head = dict(arch=arch, shape=shape_name, mesh=mesh_name, analog=analog,
                microbatch=microbatch, causal_skip=causal_skip, kv_dtype=kv_dtype,
                profile=profile, capacity_factor=capacity_factor, int8_weights=int8_weights)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {**head, "status": "skipped", "reason": why}
    mesh = _mesh(mesh_name)
    if shape.kind == "train" and (analog != "none" or int8_weights or kv_dtype):
        raise ValueError("a train cell takes no --analog, --int8-weights or --kv-dtype")
    if shape.kind == "train" and shape.global_batch % microbatch:
        raise ValueError(f"--microbatch {microbatch} does not divide {shape.global_batch} rows")

    meta = "meta"
    params = meta_params(cfg)
    params_bytes = None
    if int8_weights:
        from repro_torch.quant.weights import quantize_params

        params = quantize_params(params)
        params_bytes = _nbytes(params)
    if shape.kind == "train":  # the batch's blocks among the data shards, one a device
        dp = steps.train_layout(cfg, mesh).dp
        blocks = steps.row_blocks(cfg, mesh, shape.global_batch)
        batch_note = None if blocks == dp else (
            f"the batch: {blocks} blocks of rows, each on {dp // blocks} data shards (the "
            "reference's placement of the rows degrades the same way)")
        own, per_own = shape.global_batch // blocks // microbatch, blocks
        if cfg.family == "moe" and dp > 1 and (own * shape.seq_len) % cfg.moe_group_size:
            return {**head, "status": "not_ported", "reason": (
                f"a data shard of {own} x {shape.seq_len} tokens is not whole expert groups of "
                f"{cfg.moe_group_size}: {MOE_GROUPS_ITEM}")}
    else:
        dp = mesh.data
        rows_cut = shape.global_batch % dp == 0
        own = shape.global_batch // dp if rows_cut else shape.global_batch
        per_own = dp if rows_cut else 1  # global rows a device row
        batch_note = None if rows_cut or dp == 1 else (
            "the batch: whole on every data shard (data does not divide its rows; the reference "
            "replicates it too)")
    analog_cfg = AnalogConfig.shot(backend="cuda") if analog == "shot" else None
    energies = lm.init_energy_tree(cfg, 1.0, device=meta) if analog_cfg else None
    key = np.zeros(2, np.uint32) if analog_cfg else None
    kv = getattr(torch, kv_dtype) if kv_dtype else None
    cache_bytes = None
    if shape.kind == "decode":
        cache_bytes = _nbytes(lm.init_cache(cfg, shape.global_batch, shape.seq_len, device=meta,
                                            dtype=kv))
    tree = params if int8_weights else None
    if shape.kind == "train":  # one microbatch of the device's rows
        tcfg = steps.TrainConfig()
        params = steps.shard_params(params, cfg, mesh)
        opt = steps.make_opt_init(cfg, mesh, tcfg)(params)
        step = steps.make_train_step(cfg, mesh, tcfg)
    elif shape.kind == "prefill":
        step = steps.make_prefill_step(cfg, mesh, cache_len=shape.seq_len, analog_cfg=analog_cfg,
                                       param_tree=tree)
    else:
        step = steps.make_decode_step(cfg, mesh, analog_cfg=analog_cfg, param_tree=tree)

    def program(rows: int, positions: int):
        """(fn, hold) of the device's step at ``rows`` rows a device and
        ``positions`` positions."""
        spec = dataclasses.replace(shape, seq_len=positions, global_batch=rows * per_own)
        batch = input_specs(cfg, spec)
        if shape.kind == "train":
            return (lambda: step(params, opt, batch)), (params, opt, batch)
        if shape.kind == "prefill":
            return (lambda: step(params, batch, energies, key)), (params, batch, energies)
        cache = lm.init_cache(cfg, rows, positions, device=meta, dtype=kv)
        return ((lambda: step(params, cache, batch, positions - 1, energies, key)),
                (params, batch, cache, energies))

    row_points, pos_points = _trace_points(cfg, shape.kind, own, shape.seq_len)
    traced, seconds = {}, 0.0
    for r in row_points:
        for t in pos_points:
            fn, hold = program(r, t)
            got = _trace(fn, hold, mesh, head)
            if isinstance(got, dict):
                return got
            traced[r, t], seconds = got[0], seconds + got[1]
    st = _extrapolate(traced, row_points, pos_points, own, shape.seq_len)
    notes = []
    if shape.kind == "train" and microbatch > 1:
        notes.append(f"one microbatch of {own} rows traced, its FLOPs x {microbatch}; the peak "
                     "is one microbatch's beside the state")
    if len(row_points) > 1 or len(pos_points) > 1:
        notes.append(f"traced at rows {list(row_points)} x positions {list(pos_points)}; FLOPs, "
                     f"bytes and collectives extrapolated to {own} x {shape.seq_len}, linear in "
                     "each (the program's work and state are linear in its rows and, in the "
                     "xlstm family, in its positions); largest tensors of the last trace")
    return _artifact(head, cfg, shape, mesh, st, seconds, float(microbatch) if
                     shape.kind == "train" else 1.0, "; ".join(notes) or None, analog, batch_note,
                     cache_bytes, params_bytes)


def _trace_points(cfg, kind: str, rows: int, positions: int) -> tuple:
    """The rows and positions a cell is traced at: the cell's own, or two
    smaller ones to extrapolate from where a trace at the cell's own would
    take hours of host time (per-request loops over rows; the xlstm
    family's time loop over positions)."""
    per_request = kind == "prefill" or cfg.family == "xlstm"
    row_points = (1, 2) if per_request and rows > TRACE_ROWS else (rows,)
    pos_points = ((TRACE_POSITIONS // 2, TRACE_POSITIONS)
                  if cfg.family == "xlstm" and kind != "decode" and positions > TRACE_POSITIONS
                  else (positions,))
    return row_points, pos_points



def _trace(fn, hold, mesh, head):
    """(``TraceStats``, seconds) of ``fn`` on the meta device, or the
    ``not_ported`` artifact of an MoE cell whose shard splits a group."""
    from repro_torch.launch import steps
    from repro_torch.launch.trace_analysis import reckon

    t0 = time.time()
    try:
        _, st = reckon(fn, hold=hold, recorder=mesh.recorder)
    except steps.MoEGroupsAcrossShards as e:
        return {**head, "status": "not_ported", "reason": f"{e}: {MOE_GROUPS_ITEM}"}
    return st, time.time() - t0


def _extrapolate(traced: dict, row_points, pos_points, rows: int, positions: int):
    """``TraceStats`` at (``rows``, ``positions``) from the traces at the
    grid ``row_points`` x ``pos_points`` (one or two points an axis):
    each count interpolated linearly in each axis (Lagrange's form)."""
    from repro_torch.launch.trace_analysis import TraceStats

    def basis(points, x):
        if len(points) == 1:
            return [1.0]
        a, b = points
        return [(b - x) / (b - a), (x - a) / (b - a)]

    weights = [(wr * wt, traced[r, t]) for r, wr in zip(row_points, basis(row_points, rows))
               for t, wt in zip(pos_points, basis(pos_points, positions))]
    last = traced[row_points[-1], pos_points[-1]]

    def lin(get):
        return sum(w * get(st) for w, st in weights)

    def by_kind(name):
        kinds = set().union(*(getattr(st, name) for _w, st in weights))
        return {k: lin(lambda st: getattr(st, name).get(k, 0)) for k in kinds}

    return TraceStats(
        matmul_flops=lin(lambda st: st.matmul_flops),
        contraction_flops=lin(lambda st: st.contraction_flops),
        analog_flops=lin(lambda st: st.analog_flops),
        analog_sites=last.analog_sites,
        base_bytes=int(lin(lambda st: st.base_bytes)),
        peak_bytes=int(lin(lambda st: st.peak_bytes)),
        largest=last.largest,
        collective_counts=last.collective_counts,
        collective_bytes=by_kind("collective_bytes"),
        collective_link_bytes=by_kind("collective_link_bytes"),
        collective_calls=last.collective_calls,
    )


def _artifact(head, cfg, shape, mesh, st, trace_s, scale, note, analog, batch_note, cache_bytes,
              params_bytes) -> dict:
    from repro_torch.launch import roofline
    from repro_torch.launch.roofline import H100

    dot = st.dot_flops * scale
    rt = roofline.terms(cfg, shape, mesh.size, dot_flops=dot,
                        collective_link_bytes=st.total_collective_link_bytes * scale,
                        cache_bytes_global=cache_bytes, param_bytes_global=params_bytes)
    return {
        **head,
        "status": "ok",
        "n_devices": mesh.size,
        "mesh_shape": {"data": mesh.data, "tp": mesh.tp},
        "step_kind": shape.kind,
        "trace_s": round(trace_s, 2),
        "reckoned": "on the meta device from the H100 SXM spec, not measured",
        "note": note,
        "per_device": {
            "matmul_flops": st.matmul_flops * scale,
            "contraction_flops": st.contraction_flops * scale,
            "analog_flops": st.analog_flops * scale,
            "analog_sites": st.analog_sites,
            "dot_flops": dot,
            "base_bytes": st.base_bytes,
            "peak_bytes": st.peak_bytes,
            "largest": st.as_dict()["largest"],
        },
        "fits_card": bool(st.peak_bytes < H100["hbm_bytes"]),
        "collectives": {"counts": st.collective_counts, "bytes": st.collective_bytes,
                        "link_bytes": st.collective_link_bytes,
                        "calls": [dict(kind=k, bytes=b, group=g, calls=n)
                                  for k, b, g, n in st.collective_calls]},
        "replicates": _replicates(cfg, mesh, analog, batch_note, shape.kind == "train"),
        "roofline": rt.as_dict(),
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
    }


def all_cells(meshes):
    from repro_torch.configs import ARCHS, SHAPES

    cells = []
    for arch in ARCHS:
        for shape in SHAPES:
            for m in meshes:
                cells.append((arch, shape, m, "none"))
    for arch, shape in CELL_ANALOG_EXTRAS:
        for m in meshes:
            cells.append((arch, shape, m, "shot"))
    return cells


def _line(r: dict) -> str:
    if r["status"] != "ok":
        return (f"{r['arch']} {r['shape']} {r['mesh']} {r.get('analog', 'none')} "
                f"{r['status']} ({r['reason'][:60]})")
    rf, pd = r["roofline"], r["per_device"]
    return (f"{r['arch']} {r['shape']} {r['mesh']} {r.get('analog', 'none')} ok "
            f"{r['trace_s']} {pd['peak_bytes'] / 1e9:.2f} {r['fits_card']} "
            f"{pd['dot_flops']:.4g} {rf['compute_s']:.4g} {rf['memory_s']:.4g} "
            f"{rf['collective_s']:.4g} {rf['dominant']} {rf['useful_ratio']:.3f}")


def summarize(out: str = OUT_DIR) -> None:
    rows = [json.load(open(os.path.join(out, n))) for n in sorted(os.listdir(out))
            if n.endswith(".json")]
    print("arch shape mesh analog status trace_s peak_GB fits dot_flops compute_s memory_s "
          "collective_s dominant useful  (reckoned on the meta device from the H100 SXM spec, "
          "not measured)")
    for r in rows:
        print(_line(r))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=list(MESHES) + ["both"])
    ap.add_argument("--analog", default="none", choices=["none", "shot"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--causal-skip", action="store_true")
    ap.add_argument("--kv-dtype", default=None)
    ap.add_argument("--profile", default=None)
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--int8-weights", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--summarize", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    if args.summarize:
        summarize(args.out)
        return 0

    if args.all:
        meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
        cells = all_cells(meshes)
        if args.skip_existing:
            cells = [c for c in cells if not os.path.exists(
                _artifact_path(args.out, c[0], c[1], c[2], c[3] if c[3] != "none" else ""))]
        print(f"running {len(cells)} cells with {args.jobs} workers", flush=True)

        def run_sub(cell):
            arch, shape, mesh_name, analog = cell
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                   shape, "--mesh", mesh_name, "--analog", analog, "--out", args.out,
                   "--microbatch", str(args.microbatch)]
            t0 = time.time()
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=7200)
            status = "OK" if r.returncode == 0 else "FAIL"
            print(f"[{status}] {arch} {shape} {mesh_name} {analog} ({time.time() - t0:.0f}s)",
                  flush=True)
            if r.returncode != 0:
                print(r.stderr[-2000:], flush=True)
            return r.returncode

        with ThreadPoolExecutor(max_workers=args.jobs) as ex:
            codes = list(ex.map(run_sub, cells))
        print(f"done: {codes.count(0)}/{len(codes)} ok")
        return 0 if all(c == 0 for c in codes) else 1

    if args.mesh == "both":
        ap.error("--mesh both takes --all")
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all, or --summarize)")
    art = run_cell(args.arch, args.shape, args.mesh, args.analog, microbatch=args.microbatch,
                   causal_skip=args.causal_skip, kv_dtype=args.kv_dtype, profile=args.profile,
                   capacity_factor=args.capacity_factor, int8_weights=args.int8_weights)
    variant = args.analog if args.analog != "none" else ""
    if args.tag:
        variant = (variant + "_" if variant else "") + args.tag
    path = _artifact_path(args.out, args.arch, args.shape, args.mesh, variant)
    with open(path, "w") as f:
        json.dump(art, f, indent=2)
    print(_line(art))
    return 0


if __name__ == "__main__":
    sys.exit(main())
