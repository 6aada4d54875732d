#!/usr/bin/env python3
"""The host engine's cost per scan in this tree and, in turns, in another
checkout of the repository, on one GPU.

    python3 tools/torch_host_engine_probe.py [--parent <dir of another checkout>]
    python3 tools/torch_host_engine_probe.py --device cpu --scans 12 --window 4 \
        --radius 20 --set filter.max_points=4096 --set pgo.max_keyframes=64   # rehearsal

Each turn is a fresh process in one tree (order: parent, this tree, this
tree, parent; without `--parent` this tree twice). It prints one JSON line
with:

  main_cold / main_warm   `run-sim` on the 430-scan circuit through the host
                          engine, twice: scans/s, the `slam` and `render`
                          stage means (ms a scan, device syncs around each),
                          keyframes, loops, aligned ATE
  session_warm            the same circuit with `--loop-method isc --imu
                          --wheel --gps` (no files): scans/s, `slam` mean
  device_warm             `run-sim --engine device --chunk 16`: scans/s
  step                    over the circuit's scans 1..`--window`: ms per
                          `odometry.step` (the host-branch form; host clock,
                          a device sync before and after), mean Newton
                          iterations
  profile                 the same scans through `SlamPipeline.process_scan`
                          under torch.profiler: launch calls, synchronise
                          calls (one per readback) and device-to-host copies
                          the host made per scan, kernels and device ms per
                          scan, the card's busy share

and, last, one line with every turn by side. The card's name and power limit
come first. Two trees may differ in their results (an align of another
arithmetic): each side must agree with itself.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CODE = r"""
import json, time
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from xchu_slam_tpu_torch import cli
from xchu_slam_tpu_torch.models import odometry
from xchu_slam_tpu_torch.models.pipeline import SlamPipeline
from xchu_slam_tpu_torch.ops.filter import filter_scan
from xchu_slam_tpu_torch.types import make_cloud
from xchu_slam_tpu_torch.utils import sim
from xchu_slam_tpu_torch.utils.profiling import StageTimers

SCANS, WINDOW, DEV, SETS = {scans}, {window}, "{device}", {sets!r}
LAUNCH = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
          "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync", "cuLaunchKernel",
          "cuLaunchKernelEx")
SYNC = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def sync():
    if DEV == "cuda":
        torch.cuda.synchronize()


def run(**kw):
    timers = StageTimers(DEV)
    _pipe, s = cli.run_sim(SCANS, {radius}, 0, DEV, overrides=SETS, timers=timers, **kw)
    out = {{k: s[k] for k in ("keyframes", "loops", "ate_rmse_m", "scans_per_sec")}}
    out.update(slam_ms=round(timers.mean_ms("slam"), 3),
               render_ms=round(timers.mean_ms("render"), 3))
    return out


res = {{"main_cold": run(), "main_warm": run(),
       "session_warm": run(loop_method="isc", imu=True, wheel=True, gps=True),
       "device_warm": run(engine="device", chunk=16)}}

cfg = cli.sim_config(SETS)
_stamps, gt, world = cli._sim_world_and_traj(SCANS, {radius}, 0)
rng = np.random.default_rng(0)
scans = [sim.render_scan(world, gt[i], rng, n_points=24_000) for i in range(WINDOW + 1)]
ospec = odometry.spec_from_config(cfg)


def filtered(i):
    return filter_scan(make_cloud(*scans[i], capacity=cfg.filter.max_raw_points,
                                  device=DEV), cfg.filter)


f0 = filtered(0)
state = odometry.init_state(ospec, torch.zeros(6, device=DEV), f0.xyz, f0.mask)
times, iters = [], []
for i in range(1, WINDOW + 1):
    f = filtered(i)
    sync()
    t0 = time.perf_counter()
    state, out = odometry.step(state, f.xyz, f.mask, ospec)
    sync()
    times.append(time.perf_counter() - t0)
    iters.append(int(out.iterations))
res["step"] = {{"scans": WINDOW, "ms_mean": round(1e3 * float(np.mean(times)), 4),
               "ms_median": round(1e3 * float(np.median(times)), 4),
               "mean_newton_iterations": round(float(np.mean(iters)), 3)}}

pipe = SlamPipeline(cfg, kf_points=4096, device=DEV)
pipe.process_scan(*scans[0], stamp=0.0)
sync()
t0 = time.perf_counter()
acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if DEV == "cuda" else [])
with profile(activities=acts) as prof:
    for i in range(1, WINDOW + 1):
        pipe.process_scan(*scans[i], stamp=0.1 * i)
    sync()
    wall = time.perf_counter() - t0
launches = syncs = kernels = d2h = 0
device_us = 0.0
for e in prof.key_averages():
    if e.device_type == torch.autograd.DeviceType.CUDA:
        device_us += e.self_device_time_total
        kernels += e.count
        if "DtoH" in e.key:
            d2h += e.count
    elif e.key in LAUNCH:
        launches += e.count
    elif e.key in SYNC:
        syncs += e.count
res["profile"] = {{"scans": WINDOW, "wall_ms_per_scan": round(1e3 * wall / WINDOW, 3),
                  "host_launch_calls_per_scan": round(launches / WINDOW, 2),
                  "host_sync_calls_per_scan": round((syncs - 1) / WINDOW, 3),
                  "device_to_host_copies_per_scan": round(d2h / WINDOW, 3),
                  "device_kernels_per_scan": round(kernels / WINDOW, 1),
                  "device_ms_per_scan": round(1e-3 * device_us / WINDOW, 4),
                  "device_busy_share": round(1e-6 * device_us / wall, 4)}}
print("PROBE " + json.dumps(res))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--scans", type=int, default=430)
    ap.add_argument("--window", type=int, default=60)
    ap.add_argument("--radius", type=float, default=55.0)
    ap.add_argument("--device", default="cuda", help="cpu rehearses the script at a small size")
    ap.add_argument("--set", action="append", default=[], dest="sets", metavar="KEY=VALUE")
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip())
    sides = {"change": here}
    order = ("change", "change")
    if args.parent is not None:
        sides["parent"] = os.path.abspath(args.parent)
        order = ("parent", "change", "change", "parent")
    runs = {name: [] for name in sides}
    for name in order:
        tree = sides[name]
        proc = subprocess.run(
            [sys.executable, "-c", CODE.format(
                scans=args.scans, window=args.window, radius=args.radius,
                device=args.device, sets=tuple(args.sets))],
            cwd=tree, env=dict(os.environ, PYTHONPATH=tree), capture_output=True,
            text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"the {name} turn failed:\n{proc.stderr[-4000:]}")
        line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("PROBE "))
        runs[name].append(json.loads(line[6:]))
        print(json.dumps({"side": name, **runs[name][-1]}))
    for name, turns in runs.items():
        results = {json.dumps({k: t[run][k] for k in ("keyframes", "loops", "ate_rmse_m")})
                   for t in turns for run in ("main_cold", "main_warm")}
        if len(results) != 1:
            raise AssertionError(f"the {name} side disagrees with itself: {sorted(results)}")
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
