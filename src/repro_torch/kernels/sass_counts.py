"""SASS instructions of a route's kernels, by opcode (``cuobjdump -sass``):
what a kernel's loop compiled to, read when its rate is explained.

Builds the route's library if needed, so it runs where ``nvcc`` is:

    PYTHONPATH=src python -m repro_torch.kernels.sass_counts weight

prints one JSON object: for each kernel of the library, its instruction
count and the most common opcodes.
"""
import collections
import json
import os
import re
import subprocess
import sys

from repro_torch.kernels import analog_matmul as am


def sass_counts(route: str) -> dict:
    lib = am.build()[route]
    tool = os.path.join(os.path.dirname(am.find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts[fn] = collections.Counter()
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if fn and ins:
            counts[fn][ins.group(1)] += 1
    return {f: dict(total=sum(c.values()), top=c.most_common(14)) for f, c in counts.items()}


if __name__ == "__main__":
    print(json.dumps(sass_counts(sys.argv[1] if len(sys.argv) > 1 else "weight")))
