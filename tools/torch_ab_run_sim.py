#!/usr/bin/env python3
"""The SC circuit's rate in two trees of the port, or through its two
engines, in turns, on one GPU.

    python3 tools/torch_ab_run_sim.py --parent <dir of another checkout> [--scans 430]
    python3 tools/torch_ab_run_sim.py --engine host,device [--scans 430]

Compares `xchu_slam_tpu_torch.cli.run_sim` (the `run-sim` circuit: SC loops,
no sensors, no export). With `--parent`: this tree against another checkout
of the repository, e.g. the parent commit unpacked by `git archive` into a
directory that git ignores, both with the engine `--engine` names (one
engine; default host). Order: parent, this tree, this tree, parent. With
two engines in `--engine` and no `--parent`: this tree's two engines, in the
order first, second, second, first. Each turn is a fresh process that runs
the circuit twice (the first run holds the cold start: CUDA context, lazy
kernel loading, the nvcc build; the second is warm). Prints one JSON line per
process, one with the rates per side and, last, whether the two sides'
results are bit-identical (`chip_smoke.py`'s pose hash, of the odometry and
both keyframe trajectories, beside keyframes, loops and ATE) and made the
same kernel launches (each wrapper's count, set to 0 before a run). Every
side must agree with itself in all its turns (keyframes, loops, ATE): two
trees may align with another arithmetic, and the two engines see scans with
different noise (the device engine renders each from a generator of its
own). The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CODE = """
import hashlib, json, sys
from xchu_slam_tpu_torch.cli import run_sim
from xchu_slam_tpu_torch.ops.cuda import icp_kernel, ndt_kernel, nn_kernel, pgo_kernel
KERNELS = {{"nn": nn_kernel, "ndt": ndt_kernel, "pgo": pgo_kernel, "icp_step": icp_kernel}}
out = []
for _ in range(2):
    for mod in KERNELS.values():
        mod.launches = 0
    pipe, s = run_sim({scans}, 55.0, 0, "cuda"{engine})
    row = {{k: s[k] for k in ("keyframes", "loops", "ate_rmse_m", "scans_per_sec",
                              "stage_seconds") if k in s}}
    row["launches"] = {{k: mod.launches for k, mod in KERNELS.items()}}
    # the poses themselves, bit for bit: the odometry and both keyframe trajectories
    _st, kf_odo, kf_opt = pipe.keyframe_trajectory()
    row["pose_hash"] = hashlib.sha256(pipe.odometry_trajectory().tobytes() + kf_odo.tobytes()
                                      + kf_opt.tobytes()).hexdigest()[:16]
    out.append(row)
print("AB " + json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--scans", type=int, default=430)
    ap.add_argument("--engine", default="host",
                    help="host, device, or two of them separated by a comma")
    args = ap.parse_args()
    engines = args.engine.split(",")
    if any(e not in ("host", "device") for e in engines) or len(engines) > 2 \
            or (len(engines) == 2) == (args.parent is not None):
        ap.error("give --parent with one engine, or two engines without --parent")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    if args.parent is not None:
        # a parent from before the device engine takes no `engine` argument
        arg = "" if engines[0] == "host" else ', engine="device"'
        sides = {"parent": (os.path.abspath(args.parent), arg), "change": (here, arg)}
        order = ("parent", "change", "change", "parent")
    else:
        sides = {e: (here, f', engine="{e}"') for e in engines}
        order = (engines[0], engines[1], engines[1], engines[0])
    runs = {name: [] for name in sides}
    for name in order:
        tree, arg = sides[name]
        env = dict(os.environ, PYTHONPATH=tree)
        res = subprocess.run(
            [sys.executable, "-c", CODE.format(scans=args.scans, engine=arg)],
            cwd=tree, env=env, capture_output=True, text=True, check=True)
        line = next(ln for ln in res.stdout.splitlines() if ln.startswith("AB "))
        cold, warm = json.loads(line[3:])
        runs[name].append((cold, warm))
        print(json.dumps({"side": name, "cold": cold, "warm": warm}))

    def results(names):
        return {json.dumps({k: r[k] for k in ("keyframes", "loops", "ate_rmse_m",
                                              "pose_hash", "launches")})
                for name in names for both in runs[name] for r in both}

    for names in ([name] for name in sides):
        if len(results(names)) != 1:
            raise AssertionError(f"the results of {names} differ: {sorted(results(names))}")
    print(json.dumps({name: {
        "cold_scans_per_sec": [c["scans_per_sec"] for c, _ in pairs],
        "warm_scans_per_sec": [w["scans_per_sec"] for _, w in pairs]}
        for name, pairs in runs.items()}))
    print(json.dumps({"poses_and_launches_identical_across_sides":
                      len(results(list(sides))) == 1}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
