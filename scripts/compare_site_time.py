#!/usr/bin/env python3
"""Compare two ``chip_smoke.py`` logs' ``site_time`` and ``sweep`` phases.

    PYTHONPATH=src python3 scripts/compare_site_time.py parent=<log> change=<log> ...

Each log holds the JSON lines of ``python3 chip_smoke.py --only
build,site_time,sweep`` on one tree: the parent's or the change's, timed in
one call on one card, in turns (parent, change, change, parent); runs of
one tree are averaged. For the decode and tc sites (shot noise, K = 1, 4
requests), each tree's ms by (model, stage, site) and the change over the
parent; per (model, stage) and route, ``chip_smoke.site_summary`` over each
tree's rows: Σ (launches of a forward x ms) against Σ (launches x bound);
each run's sweep line; the card's name and power limit the logs name. One
JSON line each.
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke  # noqa: E402


def _rows(path):
    """The site_time and sweep lines of one log, and its card."""
    sites, sweep, card = [], [], None
    with open(path) as f:
        for line in f:
            if not line.startswith("{"):
                continue
            d = json.loads(line)
            if d.get("phase") == "site_time":
                sites.append(d)
                card = d.get("card", card)
            elif d.get("phase") == "sweep":
                sweep.append(d)
    return sites, sweep, card


def _mean(values):
    return sum(values) / len(values)


def main(argv):
    runs = {"parent": [], "change": []}
    for arg in argv:
        name, _, path = arg.partition("=")
        runs[name].append(_rows(path))
    keyed = {}
    for tree, logs in runs.items():
        for sites, _, _ in logs:
            for r in sites:
                if r["noise"] != "output" or r["route"] not in ("decode", "tc"):
                    continue
                key = (r.get("model"), r["stage"], r["site"])
                keyed.setdefault(key, {}).setdefault(tree, []).append(r)
    for (model, stage, site), by in keyed.items():
        out = dict(model=model, stage=stage, site=site)
        for tree, rs in by.items():
            out[tree] = dict(route=rs[0]["route"], ms=_mean([r["ms"] for r in rs]),
                             runs_ms=[r["ms"] for r in rs], bound_ms=rs[0]["bound_ms"],
                             share_of_bound=rs[0]["bound_ms"] / _mean([r["ms"] for r in rs]),
                             no_noise_ms=rs[0].get("no_noise_ms"),
                             matmul_only_ms=_mean([r["matmul_only_ms"] for r in rs]))
        if "parent" in out and "change" in out:
            out["change_over_parent"] = out["change"]["ms"] / out["parent"]["ms"]
        print(json.dumps(out))
    summaries = {}
    for tree, logs in runs.items():
        for sites, sweep, card in logs:
            for line in chip_smoke.site_summary(sites):
                summaries.setdefault((line["model"], line["stage"]), {}).setdefault(
                    tree, []).append(line)
            for s in sweep:
                print(json.dumps(dict(tree=tree, sweep=s["shape"], decode_ms=s["decode_ms"],
                                      tc_ms=s["tc_ms"], faster=s["faster"], card=card)))
    for (model, stage), by in summaries.items():
        out = dict(summary=model, stage=stage)
        for tree, lines in by.items():
            routes = {}
            for route in lines[0]["routes"]:
                ms = _mean([ln["routes"][route]["ms"] for ln in lines])
                bound = lines[0]["routes"][route]["bound_ms"]
                routes[route] = dict(launches=lines[0]["routes"][route]["launches"], ms=ms,
                                     bound_ms=bound, share_of_bound=bound / ms)
            out[tree] = dict(routes=routes, missing=lines[0]["missing"])
        print(json.dumps(out))
    print(json.dumps({"cards": sorted({c for logs in runs.values() for _, _, c in logs if c})}))


if __name__ == "__main__":
    main(sys.argv[1:])
