#!/usr/bin/env python3
"""Per-stage times of the sensor-aided mapping session on one GPU.

    python3 tools/torch_session_probe.py [--scans 430] [--reps 20] [--device cuda]

Runs the port's session once through the CLI's `run_sim` (ISC loops, IMU +
wheel + GPS inputs, a checkpoint every 200 scans, export files into a
temporary directory) and prints its summary and stage timers. Then, on the
state that run left, times the pieces the session adds to the SC circuit,
each `--reps` times on the host clock between two device syncs (median ms);
the summary also gives the mean Newton iterations per scan under the IMU +
wheel guess:

  isc_descriptor     `ops/isc.make_descriptor` of one filtered scan
  isc_detect         `ops/isc.detect_loop` for the newest keyframe, over the
                     run's live keyframes, and over a full store (every row
                     live: the run's rows tiled to the capacity)
  sc_detect          `ops/scancontext.detect_loop` on the same store, for scale
  imu / wheel        `ops/imu.integrate_imu` / `integrate_wheel_odom` of one
                     16-sample window (host arithmetic)
  assemble_map       the batched transform, readback and voxel dedup
  save_run           all export files
  save_checkpoint / load_checkpoint   the .npz at this store size
  localize           `SessionLocalizer.localize` per query (12 fresh scans),
                     with its NN kernel launches

Last, one JSON line with every number. The card's name and power limit come
first. `--device cpu` rehearses the script at a small `--scans`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from xchu_slam_tpu_torch import cli  # noqa: E402
from xchu_slam_tpu_torch.io.export import save_run  # noqa: E402
from xchu_slam_tpu_torch.models.relocalize import SessionLocalizer  # noqa: E402
from xchu_slam_tpu_torch.ops import imu as imu_ops, isc, scancontext as sc  # noqa: E402
from xchu_slam_tpu_torch.ops.cuda import nn_kernel  # noqa: E402
from xchu_slam_tpu_torch.ops.filter import filter_scan  # noqa: E402
from xchu_slam_tpu_torch.types import make_cloud  # noqa: E402
from xchu_slam_tpu_torch.utils import checkpoint, sim  # noqa: E402
from xchu_slam_tpu_torch.utils.profiling import StageTimers  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=430)
    ap.add_argument("--radius", type=float, default=55.0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[], metavar="key=value")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip())

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def ms(fn, reps=args.reps):
        fn()
        times = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(times))

    last = {}

    def on_scan(i, res, scan):
        last.update(scan)

    out = {}
    with tempfile.TemporaryDirectory(prefix="xchu_probe_") as tmp:
        timers = StageTimers(dev)
        pipe, summary = cli.run_sim(
            args.scans, args.radius, 0, args.device, args.set, on_scan=on_scan,
            loop_method="isc", imu=True, wheel=True, gps=True, out=tmp,
            checkpoint_every=200, timers=timers)
        summary.pop("artifacts")
        summary["newton_iterations_per_scan"] = round(float(np.mean(
            [r["iterations"] for r in pipe.odom_log])), 3)
        summary["icp_verifications"] = pipe.icp_verifications
        print("session: " + json.dumps(summary))
        print(timers.report())
        out["session"] = summary
        out["stage_mean_ms"] = {k: timers.mean_ms(k) for k in timers.total}
        out["stage_total_s"] = dict(timers.total)

        cfg, db, n = pipe.cfg, pipe.db, pipe.kf_count
        filt = filter_scan(make_cloud(last["xyz"], last["intensity"],
                                      capacity=cfg.filter.max_raw_points, device=dev),
                           cfg.filter)
        out["isc_descriptor_ms"] = ms(lambda: isc.make_descriptor(
            filt.xyz, filt.intensity, filt.mask, pipe.iscspec))

        def isc_detect(store, count, travel):
            return isc.detect_loop(store.isc_db[count - 1], store.isc_db, count,
                                   store.poses[:, :3], travel, pipe.iscspec)

        out["isc_detect_live_ms"] = ms(lambda: isc_detect(db, n, db.travel))
        K = db.poses.shape[0]
        tile = torch.arange(K, device=dev) % n
        full = db._replace(isc_db=db.isc_db[tile], sc_db=db.sc_db[tile],
                           poses=db.poses[tile], count=K)
        travel = torch.arange(K, device=dev, dtype=torch.float32) * 2.0
        out["isc_detect_full_ms"] = ms(lambda: isc_detect(full, K, travel))
        out["sc_detect_live_ms"] = ms(lambda: sc.detect_loop(
            db.sc_db[n - 1], db.sc_db, n, pipe.scspec))
        out["sc_detect_full_ms"] = ms(lambda: sc.detect_loop(
            full.sc_db[K - 1], full.sc_db, K, pipe.scspec))
        out["live_keyframes"], out["store_capacity"] = n, K

        pose0 = pipe._last_odom_pose
        state = imu_ops.ImuState(velocity=torch.zeros(3))
        out["imu_ms"] = ms(lambda: imu_ops.integrate_imu(last["imu"], pose0, state))
        out["wheel_ms"] = ms(lambda: imu_ops.integrate_wheel_odom(last["wheel"], pose0))

        out["assemble_map_ms"] = ms(lambda: pipe.assemble_map(voxel=0.5), reps=3)
        out["save_run_ms"] = ms(lambda: save_run(
            pipe, os.path.join(tmp, "again"), cam_T=sim.camera_frame_transform()), reps=3)
        ckpt = os.path.join(tmp, "probe.npz")
        out["save_checkpoint_ms"] = ms(lambda: checkpoint.save_checkpoint(pipe, ckpt), reps=3)
        out["checkpoint_mb"] = os.path.getsize(ckpt) / 1e6
        out["load_checkpoint_ms"] = ms(
            lambda: checkpoint.load_checkpoint(ckpt, device=dev), reps=3)

        loc = SessionLocalizer(db, cfg.override({"loop.icp_fitness_thresh": 1.5}))
        _stamps, gt, world = cli._sim_world_and_traj(args.scans, args.radius, 0)
        rng = np.random.default_rng(99)
        queries = [sim.render_scan(world, gt[i], rng, n_points=24_000)
                   for i in np.linspace(0, len(gt) - 1, 12).round().astype(int)]
        loc.localize(*queries[0])
        nn_kernel.launches = 0
        times, found = [], 0
        for xyz, inten in queries:
            sync()
            t0 = time.perf_counter()
            found += loc.localize(xyz, inten).found
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
        out["localize_ms"] = float(np.median(times))
        out["localize_max_ms"] = float(np.max(times))
        out["localize_found"] = found
        out["localize_nn_launches_per_query"] = nn_kernel.launches / len(queries)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
