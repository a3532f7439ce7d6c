"""One cell's two diagnostic lists: the top collectives and the largest
tensors; port of ``repro/launch/diagnose.py``.

The reference lowers the cell and walks its HLO. The port runs the
cell's step on the meta device (``launch/dryrun.py`` ``run_cell``,
``launch/trace_analysis.py``): the collectives its dry mesh recorded,
grouped by (kind, result bytes, group size) with their count and ring
link bytes, and the largest tensors the step made. Reckoned from the
program, not measured.

Usage:
  python -m repro_torch.launch.diagnose --arch granite-3-8b --shape decode_32k [--mesh single]
      [--analog shot] [--top 12]
"""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "local"])
    ap.add_argument("--analog", default="none", choices=["none", "shot"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    from repro_torch.launch.collectives import _link_bytes
    from repro_torch.launch.dryrun import run_cell

    art = run_cell(args.arch, args.shape, args.mesh, args.analog, microbatch=args.microbatch)
    tag = f"{args.arch} {args.shape} {args.mesh} {args.analog}"
    if art["status"] != "ok":
        print(f"{tag}: {art['status']} ({art['reason']})")
        return 0
    print(f"== top collectives ({tag}; reckoned on the meta device, not measured) ==")
    calls = art["collectives"]["calls"]
    for c in calls[: args.top]:
        link = c["calls"] * _link_bytes(c["kind"], c["bytes"], c["group"])
        print(f"{c['kind']:14s} {c['bytes'] / 1e6:9.2f}MB x{c['calls']:6d} = {link / 1e9:8.3f}GB "
              f"link g={c['group']:3d}")
    if not calls:
        print("(none)")
    print("== largest tensors ==")
    for t in art["per_device"]["largest"][: args.top]:
        print(f"{t['bytes'] / 1e9:8.3f}GB {t['op']:24s} {t['dtype']:9s} {t['shape']}")
    pd = art["per_device"]
    print(f"peak {pd['peak_bytes'] / 1e9:.2f} GB a device (state {pd['base_bytes'] / 1e9:.2f} GB),"
          f" fits an H100: {art['fits_card']}" + (f"; {art['note']}" if art["note"] else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
