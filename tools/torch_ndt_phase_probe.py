#!/usr/bin/env python3
"""Where one NDT align spends its time inside the kernel, on one GPU.

    python3 tools/torch_ndt_phase_probe.py [--scans 6] [--reps 5]

Builds `csrc/ndt_kernel.cu` with `-DNDT_TICKS` (the first thread of block 0
then leaves the SM's cycle counter at every phase), drives the host engine's
odometry over the first `--scans` scans of the `run-sim` circuit at full
width, and aligns the next scan `--reps` times from that state. For each rep
it prints the cycles of the last pass of each kind (Hessian, line-search
trial, fitness where one ran):

  loop     the pass over the (point, neighbour) pairs: gather and arithmetic
  reduce   the warp butterfly, the block's partial, its store
  barrier  `grid.sync()`, the wait for the slowest block included
  total    every block's read and sum of all partials
  control  after a Hessian pass: the Newton step (6×6 solves), then the rest
           (the trial pose, its rotation products, the block's barrier)

and, last, the align's time from CUDA-graph replays with its trip counts.
Cycles are block 0's view: its own warps and the barriers it waits in. The
card's name, power limit and SM clock come first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from xchu_slam_tpu_torch import cli  # noqa: E402
from xchu_slam_tpu_torch.models import odometry  # noqa: E402
from xchu_slam_tpu_torch.ops import ndt  # noqa: E402
from xchu_slam_tpu_torch.ops.cuda import ndt_kernel  # noqa: E402
from xchu_slam_tpu_torch.ops.filter import filter_scan  # noqa: E402
from xchu_slam_tpu_torch.types import make_cloud  # noqa: E402
from xchu_slam_tpu_torch.utils import sim  # noqa: E402

KINDS = ("hessian", "trial", "fitness")
PHASES = ("loop", "reduce", "barrier", "total")


def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """ms per call of `fn()` on the card alone: `calls` calls in one CUDA
    graph, `replays` replays between one pair of CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (calls * replays)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=6)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probe times a CUDA kernel")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    # the instrumented build is a library of its own (the flags are part of its key)
    ndt_kernel.NVCC_FLAGS = (*ndt_kernel.NVCC_FLAGS, "-DNDT_TICKS")
    lib = ndt_kernel._library()
    lib.ndt_ticks.argtypes = [ctypes.c_void_p]
    lib.ndt_ticks.restype = ctypes.c_int

    dev = torch.device("cuda")
    cfg = cli.sim_config()
    _stamps, gt, world = cli._sim_world_and_traj(430, 55.0, 0)
    rng = np.random.default_rng(0)
    ospec = odometry.spec_from_config(cfg)
    g, nspec = ospec.gspec, ospec.nspec
    d1, d2 = ndt.gauss_constants(nspec.outlier_ratio, nspec.resolution)

    def filtered(i):
        xyz, inten = sim.render_scan(world, gt[i], rng, n_points=24_000)
        return filter_scan(make_cloud(xyz, inten, capacity=cfg.filter.max_raw_points,
                                      device=dev), cfg.filter)

    f0 = filtered(0)
    state = odometry.init_state(ospec, torch.zeros(6, device=dev), f0.xyz, f0.mask)
    for i in range(1, args.scans):
        f = filtered(i)
        state, _out = odometry.step(state, f.xyz, f.mask, ospec)
    filt = filtered(args.scans)
    call = (state.grid_a.fin, state.grid_a.origin, filt.xyz, filt.mask,
            odometry._guess(state), g, nspec, d1, d2)
    slot = ndt_kernel.RECORD
    rows = []
    for _ in range(args.reps):
        rec = ndt_kernel.align_record(*call)
        torch.cuda.synchronize()
        ticks = np.zeros(32, np.int64)
        if lib.ndt_ticks(ticks.ctypes.data) != 0:
            raise RuntimeError("reading the kernel's cycle counts failed")
        passes = int(rec[slot["passes"]])
        ran = int(rec[slot["iterations"]]) + int(rec[slot["trials"]])
        row = {"iterations": int(rec[slot["iterations"]]), "trials": int(rec[slot["trials"]]),
               "passes": passes}
        for k, kind in enumerate(KINDS):
            if kind == "fitness" and passes == ran:
                continue       # the accepted trial gave the fitness sums
            t = ticks[8 * k:8 * k + 5]
            row[kind] = {name: int(t[j + 1] - t[j]) for j, name in enumerate(PHASES)}
        row["control"] = {"newton_step": int(ticks[24] - ticks[4]),
                          "rest": int(ticks[25] - ticks[24])}
        rows.append(row)
        print(json.dumps(row))
    ms = graph_ms(lambda: ndt_kernel.align_record(*call))
    print(json.dumps({"align_ms": ms, "instrumented_build": True, **{
        k: rows[-1][k] for k in ("iterations", "trials", "passes")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
