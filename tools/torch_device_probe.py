#!/usr/bin/env python3
"""Device time of the pieces of the device engine's Part A on one GPU.

    python3 tools/torch_device_probe.py [--scans 48] [--device cuda]

Runs the port's device engine (`models/device_pipeline.DeviceSlamPipeline`)
over the first `--scans` scans of the `run-sim` circuit at full width, so
that the localmaps are populated, then times each piece of Part A on the
state that run left and on the next scan, alone on the card: the piece is
captured `CALLS` times into one CUDA graph and the graph replayed `REPLAYS`
times between one pair of CUDA events (the host enqueues nothing inside the
window), and torch.profiler counts the kernels of one call.

  filter            `ops/filter.filter_scan` of one staged scan
  ndt_align         `ops/ndt.align` on CUDA tensors: the hand-written kernel
  insert            `voxel_map.insert_points_pair` under a device flag
  finalize          `voxel_map.finalize` under a device flag (once a scan)
  swap              `voxel_map.swap` under a device flag (a second finalize)
  recentre          `voxel_map.recentre` of both grids under a device flag
  odometry_step     `models/odometry.step(on_device=True)`: the five above
                    but the filter, with the guess and the flags
  part_a            the engine's whole every-scan half, state update and log
                    row included

Prints one line per piece and, last, one JSON line with every number. The
card's name and power limit come first. `--device cpu` rehearses the script
at a small `--scans` on the host's clock, eagerly.
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
from xchu_slam_tpu_torch import cli  # noqa: E402
from xchu_slam_tpu_torch.io.prefetch import ChunkStager  # noqa: E402
from xchu_slam_tpu_torch.models import odometry  # noqa: E402
from xchu_slam_tpu_torch.models.device_pipeline import DeviceSlamPipeline  # noqa: E402
from xchu_slam_tpu_torch.ops import ndt, voxel_map as vm  # noqa: E402
from xchu_slam_tpu_torch.ops.filter import filter_scan  # noqa: E402
from xchu_slam_tpu_torch.types import Cloud  # noqa: E402
from xchu_slam_tpu_torch.utils import se3, sim  # noqa: E402

CALLS, REPLAYS, CHUNK = 5, 10, 16


def _device_ms(fn, on_card: bool) -> float:
    """ms per call of `fn()`: from CUDA-graph replays on the card, on the
    host's clock elsewhere."""
    fn()
    if not on_card:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        return 1e3 * (time.perf_counter() - t0) / CALLS
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPLAYS):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (CALLS * REPLAYS)


def _kernels(fn, on_card: bool) -> int | None:
    """Kernels and copies the card runs for one eager call of `fn()`."""
    if not on_card:
        return None
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=48)
    ap.add_argument("--radius", type=float, default=55.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[], metavar="key=value")
    args = ap.parse_args()
    cli._check_device(args.device)
    on_card = args.device.startswith("cuda")
    if on_card:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip())

    cfg = cli.sim_config(args.set)
    gt_stamps, gt, world = cli._sim_world_and_traj(args.scans + CHUNK, args.radius,
                                                   args.seed)
    lazy = sim.RenderedScans(world, gt, seed=args.seed, n_points=24_000)
    stager = ChunkStager(cfg.filter.max_raw_points, CHUNK, device=args.device)
    pipe = DeviceSlamPipeline(cfg, log_capacity=8192, device=args.device)
    for lo in range(0, args.scans, CHUNK):
        hi = min(lo + CHUNK, args.scans)
        clouds, n_real = stager.stage([lazy[i] for i in range(lo, hi)])
        pipe.process_chunk(clouds, np.resize(gt_stamps[lo:hi], CHUNK), n_real)

    # the next scan, and the state it meets
    clouds, _n = stager.stage([lazy[args.scans]])
    cloud = Cloud(*(t[0].clone() for t in clouds))
    stamp = torch.tensor(float(gt_stamps[args.scans]), device=args.device)
    st, spec = pipe.state.odom, pipe.spec.ospec
    g = spec.gspec
    filt = filter_scan(cloud, cfg.filter)
    guess = odometry._guess(st)
    pose = ndt.align(st.grid_a, filt.xyz, filt.mask, guess, g, spec.nspec).pose
    pts_map = se3.rotate_translate(pose, filt.xyz)
    yes = torch.ones((), dtype=torch.bool, device=args.device)
    no = torch.zeros((), dtype=torch.bool, device=args.device)

    pieces = {
        "filter": lambda: filter_scan(cloud, cfg.filter),
        "ndt_align": lambda: ndt.align(st.grid_a, filt.xyz, filt.mask, guess, g,
                                       spec.nspec),
        "insert": lambda: vm.insert_points_pair(st.grid_a, st.grid_b, pts_map,
                                                filt.mask, g, flag=yes),
        "finalize": lambda: vm.finalize(st.grid_a, g, flag=yes),
        "swap": lambda: vm.swap(st.grid_a, st.grid_b, g, flag=no),
        "recentre": lambda: (vm.recentre(st.grid_a, pose[:3], g, flag=no),
                             vm.recentre(st.grid_b, pose[:3], g, flag=no)),
        "odometry_step": lambda: odometry.step(st, filt.xyz, filt.mask, spec,
                                               on_device=True),
        "part_a": lambda: pipe._part_a(cloud, stamp),
    }
    out = {"scans": args.scans, "device": args.device,
           "points_after_filter": int(filt.mask.sum())}
    for name, fn in pieces.items():
        kernels = _kernels(fn, on_card)
        ms = _device_ms(fn, on_card)
        out[name] = {"ms": round(ms, 4), "kernels": kernels}
        print(f"{name:14s} {ms:8.4f} ms  {kernels} kernels")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
