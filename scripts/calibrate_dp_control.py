#!/usr/bin/env python3
"""A control for the bounds of ``chip_smoke.py``'s ``calibrate_dp`` check.

    python3 scripts/calibrate_dp_control.py [--seeds 3]

On one CUDA card, on granite-3-8b at full width and ``TRAIN_DP_LAYERS``
layers, it runs ``chip_smoke._cal_dp_run`` (``CAL_DP_STEPS`` LM
calibration steps, shot noise on the "torch" backend) at each seed on one
device, on the local data mesh of ``TRAIN_DP`` shards, and on that mesh
with a planted fault: every shard keeps rows 0.. of the whole call's
noise (the shard's row offset dropped from ``noise.standard_normal``), so
shard 1 adds shard 0's noise. One JSON line a seed: the largest relative
loss/NLL difference and the largest log-energy difference of each mesh
run against the one-device run, beside ``CAL_DP_REL`` and
``CAL_DP_LOG_E``; then the card's name and power limit. Exits 1 unless
every right run lies inside both bounds and every faulty run outside at
least one.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke  # noqa: E402


def _row_offset_dropped(gen, shape, dtype=None, rows=None):
    """``noise.standard_normal`` with the fault: shard r takes shard 0's rows."""
    import math

    import torch

    shape = tuple(shape)
    dtype = torch.float32 if dtype is None else dtype
    if rows is None:
        return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)
    m = math.prod(shape[:-1])
    whole = torch.randn((rows[1] * m, shape[-1]), generator=gen, device=gen.device, dtype=dtype)
    return whole[:m].reshape(shape)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("calibrate_dp_control: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import noise
    from repro_torch.launch.mesh import make_mesh_for_devices

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = chip_smoke._dp_cfg(chip_smoke.TRAIN_DP_LAYERS)
    mesh = make_mesh_for_devices(1, data=chip_smoke.TRAIN_DP)
    bounds = (chip_smoke.CAL_DP_REL, chip_smoke.CAL_DP_LOG_E)
    ok = True
    right_draw = noise.standard_normal
    for seed in range(args.seeds):
        one = chip_smoke._cal_dp_run(cfg, None, seed)
        local = chip_smoke._cal_dp_run(cfg, mesh, seed)
        noise.standard_normal = _row_offset_dropped
        try:
            faulty = chip_smoke._cal_dp_run(cfg, mesh, seed)
        finally:
            noise.standard_normal = right_draw
        right = chip_smoke.cal_dp_diffs(local, one)
        wrong = chip_smoke.cal_dp_diffs(faulty, one)
        inside = right[0] <= bounds[0] and right[1] <= bounds[1]
        caught = wrong[0] > bounds[0] or wrong[1] > bounds[1]
        ok = ok and inside and caught
        print(json.dumps(dict(
            phase="calibrate_dp_control", config=cfg.name, layers=cfg.n_layers, seed=seed,
            bounds=dict(rel=bounds[0], log_e_abs=bounds[1]),
            right=dict(rel=right[0], log_e_abs=right[1], inside=inside),
            row_offset_dropped=dict(rel=wrong[0], log_e_abs=wrong[1], caught=caught),
            nlls=dict(one_device=one["nlls"], local=local["nlls"], faulty=faulty["nlls"]))),
            flush=True)
    print(chip_smoke.card())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
