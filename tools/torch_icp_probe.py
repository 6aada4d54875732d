#!/usr/bin/env python3
"""ICP loop verification on one GPU, with the nearest-neighbour kernel and
with its first version in its place.

    python3 tools/torch_icp_probe.py [--scans 430] [--reps 10]

Runs the port's `run-sim` circuit once (430 scans, radius 55, seed 0) and
keeps the arguments of every `icp.align` call the loop closure makes. Then
replays those calls, `--reps` times each, in turns: first version, kernel,
kernel, first version; every replay is timed on the host clock between two
device syncs. Prints, per turn, ms per verification, ICP iterations and
kernel launches. The results of the two kernels must be identical (same
transforms, fitness and iteration counts). Then one replay of each under
torch.profiler gives the device time of all kernels and of the
nearest-neighbour kernels per verification: the share of the wall time in
which the card is busy says whether the kernel's time can show end to end.
Last, one JSON line with the means. The card's name and power limit come
first.
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
from xchu_slam_tpu_torch.ops.cuda import nn_kernel  # noqa: E402


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

    def recording_align(src, src_mask, tgt, tgt_mask, init_T, spec):
        calls.append((src.clone(), src_mask.clone(), tgt.clone(), tgt_mask.clone(),
                      init_T.clone(), spec))
        return align(src, src_mask, tgt, tgt_mask, init_T, spec)

    icp.align = recording_align
    try:
        _pipe, summary = run_sim(args.scans, 55.0, 0, "cuda")
    finally:
        icp.align = align
    print("circuit: " + json.dumps(summary))
    if not calls:
        raise SystemExit("the circuit closed no loop: nothing to replay")
    shapes = sorted({(c[0].shape[0], c[2].shape[0]) for c in calls})
    print(f"{len(calls)} verifications, shapes (N, M): {shapes}")

    kernel = nn_kernel.nearest_neighbor

    def replay(simple: bool, reps: int = args.reps):
        """(ms per verification, results, launches) over all calls × reps."""
        nn_kernel.nearest_neighbor = (nn_kernel._nearest_neighbor_simple
                                      if simple else kernel)
        nn_kernel.launches = 0
        try:
            results = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                for c in calls:
                    results.append(align(*c))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / (reps * len(calls))
        finally:
            nn_kernel.nearest_neighbor = kernel
        return ms, results, nn_kernel.launches

    replay(False), replay(True)  # warm both
    turns = []
    for simple in (True, False, False, True):
        ms, results, launches = replay(simple)
        iters = sum(r.iterations for r in results) / args.reps
        turns.append((simple, ms, results, launches))
        print(f"{'first version' if simple else 'kernel':13s}: {ms:.3f} ms per "
              f"verification, {iters:.0f} ICP iterations over {len(calls)} "
              f"verifications, {launches} counted launches")
    base = turns[0][2]
    for _simple, _ms, results, _launches in turns[1:]:
        for a, b in zip(base, results):
            if not (torch.equal(a.T, b.T) and a.fitness == b.fitness
                    and a.iterations == b.iterations and a.converged == b.converged):
                raise AssertionError("the two kernels give different ICP results")

    def device_ms(simple: bool):
        """(device ms of all kernels, of the NN kernels) per verification,
        from one profiled replay."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            replay(simple, reps=1)
        total = nn = 0.0
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            total += e.self_device_time_total
            if "nn_kernel" in e.key or "nn_merge_kernel" in e.key:
                nn += e.self_device_time_total
        return 1e-3 * total / len(calls), 1e-3 * nn / len(calls)

    dev_old, nn_old = device_ms(True)
    dev_new, nn_new = device_ms(False)
    print(f"device time per verification: first version {dev_old:.3f} ms "
          f"(NN kernel {nn_old:.3f} ms), kernel {dev_new:.3f} ms "
          f"(NN kernels {nn_new:.3f} ms)")
    new_ms = float(np.mean([t[1] for t in turns if not t[0]]))
    old_ms = float(np.mean([t[1] for t in turns if t[0]]))
    iters = sum(r.iterations for r in base) / args.reps / len(calls)
    print(json.dumps({"verifications": len(calls), "iterations_per_verification": iters,
                      "ms_per_verification": new_ms,
                      "ms_per_verification_first_version": old_ms,
                      "saved_ms": old_ms - new_ms,
                      "device_ms_per_verification": dev_new,
                      "device_ms_per_verification_first_version": dev_old,
                      "nn_device_ms_per_verification": nn_new,
                      "nn_device_ms_per_verification_first_version": nn_old,
                      "results_identical": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
