#!/usr/bin/env python3
"""ICP loop verification on one GPU: the CUDA-graph route (NN kernel +
`icp_step`, nothing read back) against the plain version `align_ref` (a
readback and the Kabsch step on the host every iteration).

    python3 tools/torch_icp_probe.py [--scans 430] [--reps 10]

Runs the port's `run-sim` circuit once (430 scans, radius 55, seed 0) and
keeps the arguments of every `icp.align` call the loop closure makes. Then
replays those calls, `--reps` times each, in turns: plain, graph, graph,
plain; every replay is timed on the host clock between two device syncs.
Prints, per turn, ms per verification and ICP iterations, the share of
verifications whose iteration count the two routes agree on, the largest
rotation difference and the largest translation difference over the source
cloud's lever arm. Then one replay of each under torch.profiler gives the
device time per verification. Last, one JSON line with the means. The
card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from xchu_slam_tpu_torch.cli import run_sim  # noqa: E402
from xchu_slam_tpu_torch.ops import icp  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=430)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())

    calls = []
    align = icp.align

    def recording_align(src, src_mask, tgt, tgt_mask, init_T, spec, live=None):
        calls.append((src.clone(), src_mask.clone(), tgt.clone(), tgt_mask.clone(),
                      init_T.clone(), spec))
        return align(src, src_mask, tgt, tgt_mask, init_T, spec, live)

    icp.align = recording_align
    try:
        _pipe, summary = run_sim(args.scans, 55.0, 0, "cuda")
    finally:
        icp.align = align
    print("circuit: " + json.dumps(summary))
    if not calls:
        raise SystemExit("the circuit closed no loop: nothing to replay")

    routes = {"plain": icp.align_ref, "graph": icp.align}

    def replay(route: str, reps: int = args.reps):
        """(ms per verification, results) over all calls × reps."""
        fn = routes[route]
        results = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            for c in calls:
                results.append(fn(*c))
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / (reps * len(calls)), results

    replay("plain", 1), replay("graph", 1)   # warm both
    turns = []
    for route in ("plain", "graph", "graph", "plain"):
        ms, results = replay(route)
        iters = sum(int(r.iterations) for r in results) / args.reps / len(calls)
        turns.append((route, ms, results))
        print(f"{route:5s}: {ms:.3f} ms per verification, {iters:.2f} ICP iterations a "
              "verification")
    plain = turns[0][2][:len(calls)]
    graph = turns[1][2][:len(calls)]
    same, err_r, err_t = 0, 0.0, 0.0
    for c, a, b in zip(calls, plain, graph):
        if int(a.iterations) != int(b.iterations):
            continue
        same += 1
        lever = max(1.0, float(torch.linalg.norm(c[0][c[1]], dim=1).max()))
        err_r = max(err_r, float((a.T[:3, :3] - b.T[:3, :3]).abs().max()))
        err_t = max(err_t, float((a.T[:3, 3] - b.T[:3, 3]).abs().max()) / lever)

    def device_ms(route: str) -> float:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            replay(route, reps=1)
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        return 1e-3 * total / len(calls)

    dev_plain, dev_graph = device_ms("plain"), device_ms("graph")
    print(f"device time per verification: plain {dev_plain:.3f} ms, graph {dev_graph:.3f} ms")
    out = {"verifications": len(calls),
           "ms_per_verification": float(np.mean([t[1] for t in turns if t[0] == "graph"])),
           "ms_per_verification_plain": float(np.mean([t[1] for t in turns
                                                        if t[0] == "plain"])),
           "device_ms_per_verification": dev_graph,
           "device_ms_per_verification_plain": dev_plain,
           "same_iterations": same, "max_abs_err_R": err_r, "max_err_t_over_lever": err_t}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
