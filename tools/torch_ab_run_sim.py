#!/usr/bin/env python3
"""The SC circuit's rate in two trees of the port, in turns, on one GPU.

    python3 tools/torch_ab_run_sim.py --parent <dir of another checkout> [--scans 430]

Compares `xchu_slam_tpu_torch.cli.run_sim` (the `run-sim` circuit: SC loops,
no sensors, no export) of this tree with that of another checkout of the
repository, e.g. the parent commit unpacked by `git archive` into a
directory that git ignores. Order: parent, this tree, this tree, parent,
each in a fresh process that runs the circuit twice (the first run holds
the cold start: CUDA context, lazy kernel loading, the nvcc build; the
second is warm). Prints one JSON line per process and, last, one with the
means per tree. The result (keyframes, loops, ATE) must be the same in all.
The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CODE = """
import json, sys
from xchu_slam_tpu_torch.cli import run_sim
out = []
for _ in range(2):
    _pipe, s = run_sim({scans}, 55.0, 0, "cuda")
    out.append({{k: s[k] for k in ("keyframes", "loops", "ate_rmse_m", "scans_per_sec")}})
print("AB " + json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--scans", type=int, default=430)
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    trees = {"parent": os.path.abspath(args.parent), "change": here}
    runs = {"parent": [], "change": []}
    for name in ("parent", "change", "change", "parent"):
        env = dict(os.environ, PYTHONPATH=trees[name])
        res = subprocess.run([sys.executable, "-c", CODE.format(scans=args.scans)],
                             cwd=trees[name], env=env, capture_output=True,
                             text=True, check=True)
        line = next(ln for ln in res.stdout.splitlines() if ln.startswith("AB "))
        cold, warm = json.loads(line[3:])
        runs[name].append((cold, warm))
        print(json.dumps({"tree": name, "cold": cold, "warm": warm}))
    results = {json.dumps({k: r[k] for k in ("keyframes", "loops", "ate_rmse_m")})
               for pair in runs.values() for both in pair for r in both}
    if len(results) != 1:
        raise AssertionError(f"the trees' results differ: {sorted(results)}")
    print(json.dumps({name: {
        "cold_scans_per_sec": [c["scans_per_sec"] for c, _ in pairs],
        "warm_scans_per_sec": [w["scans_per_sec"] for _, w in pairs]}
        for name, pairs in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
