#!/usr/bin/env python3
"""Time granite-3-8b's shot-noise serve on one tree's port, for A/B runs.

    python3 scripts/ab_serve.py <src dir> <label>

imports ``repro_torch`` from ``<src dir>`` (this tree's ``src``, or the
``src`` of another commit unpacked with ``git archive``), builds its
kernels, serves the eight requests of ``chip_smoke.py``'s serve (prompts
from ``default_rng(0)`` in [8, 60], 16 new tokens, 4 at K=1 and 4 at
K=4) three times, each drain in one window (ms a forward), then times 15
decode steps of the first batch three times (ms a step), and prints one
JSON line with the card's name and power limit. Compare two trees only
inside one call on one card, in turns: parent, change, change, parent.
"""
import json
import subprocess
import sys
import time

sys.path.insert(0, sys.argv[1])

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.granite_3_8b import CONFIG  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.kernels import analog_matmul as am  # noqa: E402
from repro_torch.kernels.prng import PRNGKey, fold_in  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.bucketing import pad_to_bucket  # noqa: E402
from repro_torch.serving.engine import ServingEngine, batch_keys  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("ab_serve: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    am.build(force=True)
    params = lm.init_params(CONFIG, seed=0, device="cuda")
    energies = lm.init_energy_tree(CONFIG, 20.0, device="cuda")
    rng = np.random.default_rng(0)
    lengths = rng.integers(8, 61, size=8)
    prompts = [rng.integers(0, CONFIG.vocab_size, int(n)).astype(np.int32) for n in lengths]
    out = {"label": sys.argv[2], "src": sys.argv[1], "ms_per_forward": [], "decode_step_ms": []}
    for _ in range(3):
        eng = ServingEngine(params, CONFIG, analog_cfg=AnalogConfig.shot(), energies=energies,
                            device="cuda", max_gen=16, batch_buckets=(1, 2, 4),
                            seq_buckets=(32, 64))
        for p, k in zip(prompts, [1] * 4 + [4] * 4):
            eng.submit(p, n_repeats=k, max_new_tokens=16)
        torch.cuda.synchronize()
        t = time.perf_counter()
        results = eng.flush()
        torch.cuda.synchronize()
        forwards = eng.stats["batches"] + eng.stats["decode_steps"]
        out["ms_per_forward"].append((time.perf_counter() - t) * 1e3 / forwards)
    out["tokens"] = {int(u): r.tolist() for u, r in results.items()}
    first = [0, 1, 2]
    tok, lens = pad_to_bucket([prompts[i] for i in first], (4, 64))
    table = batch_keys([fold_in(PRNGKey(0), i) for i in first], 4)
    tier = eng.tiers.get(1)
    for _ in range(3):
        cache, logits = tier.prefill(torch.from_numpy(tok).cuda(), torch.from_numpy(lens).cuda(),
                                     table, 80)
        nxt = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(15):
            logits, cache = tier.decode(cache, nxt, lens + i, table)
            nxt = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        out["decode_step_ms"].append((time.perf_counter() - t) * 1e3 / 15)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
