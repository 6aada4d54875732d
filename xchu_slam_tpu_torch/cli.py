"""Command-line interface of the port.

  python -m xchu_slam_tpu_torch.cli run-sim --scans 430 --radius 55 --device cuda

`run-sim` runs the host engine (`models/pipeline.SlamPipeline`) on the
synthetic squircle circuit with the same config overrides and world /
trajectory setup as `xchu_slam_tpu.cli run-sim`, and prints one JSON line of
summary metrics. It writes no export files yet.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _apply_overrides(cfg, pairs):
    overrides = {}
    for kv in pairs:
        key, val = kv.split("=", 1)
        try:
            val = json.loads(val)
        except json.JSONDecodeError:
            pass
        overrides[key] = val
    return cfg.override(overrides) if overrides else cfg


def sim_config(overrides=()):
    """The `run-sim` config: the defaults plus the reference CLI's sim
    overrides (denser-filter and looser-gate settings for sparse simulated
    scans; see `xchu_slam_tpu/cli.py:51-71`)."""
    from xchu_slam_tpu_torch.config import default_config

    cfg = default_config().override({
        "filter.max_points": 8192,
        "filter.max_raw_points": 32768,
        "filter.outlier_method": "statistical",
        "loop.method": "sc",
        "pgo.odom_noise_trans": 1e-3,
        "pgo.odom_noise_rot": 1e-3,
        "loop.icp_fitness_thresh": 1.0,
        "sc.dist_thresh": 0.35,
    })
    return _apply_overrides(cfg, overrides)


def run_sim(scans: int = 400, radius: float = 55.0, seed: int = 0,
            device: str = "cuda", overrides=(), on_scan=None):
    """Run the host engine over the circuit. Returns (pipeline, summary
    dict); `on_scan(i, result)` is called after each scan."""
    from xchu_slam_tpu_torch.models.pipeline import SlamPipeline
    from xchu_slam_tpu_torch.utils import metrics, se3, sim

    cfg = sim_config(overrides)
    world = sim.make_world(seed, extent=radius * 2.5)
    gt = sim.loop_trajectory(n_scans=scans, radius=radius, speed=1.0)
    gt_stamps = 0.1 * np.arange(scans)
    rng = np.random.default_rng(seed)

    pipe = SlamPipeline(cfg, kf_points=4096, device=device)
    t0 = time.perf_counter()
    for i, p in enumerate(gt):
        xyz, inten = sim.render_scan(world, p, rng, n_points=24_000)
        res = pipe.process_scan(xyz, inten, stamp=float(gt_stamps[i]))
        if on_scan is not None:
            on_scan(i, res)
    pipe.finalize()
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)
    wall = time.perf_counter() - t0

    gtT = se3.pose_to_matrix(torch.from_numpy(gt)).numpy()
    gt_rel = np.einsum("ab,nbc->nac", np.linalg.inv(gtT[0]), gtT)
    stamps, _kf_odo, kf_opt = pipe.keyframe_trajectory()
    ei, idx = metrics.associate(stamps, gt_stamps, max_diff=0.05)
    kf_opt = kf_opt[ei]
    ate = metrics.ape_rmse(kf_opt[:, :3], gt_rel[idx, :3, 3], align=True)
    ate_raw = metrics.ape_rmse(kf_opt[:, :3], gt_rel[idx, :3, 3], align=False)
    summary = {
        "scans": scans,
        "keyframes": pipe.kf_count,
        "loops": pipe.loop_count,
        "ate_rmse_m": round(float(ate), 4),
        "ate_unaligned_m": round(float(ate_raw), 4),
        "scans_per_sec": round(scans / wall, 2),
    }
    return pipe, summary


def cmd_run_sim(args):
    device = args.device
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    _pipe, summary = run_sim(args.scans or 400, args.radius, args.seed, device,
                             args.set)
    print(json.dumps(summary))


def main(argv=None):
    p = argparse.ArgumentParser(prog="xchu_slam_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("run-sim", help="run SLAM on the synthetic circuit")
    ps.add_argument("--scans", type=int, default=0, help="scans (default 400)")
    ps.add_argument("--radius", type=float, default=55.0)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--device", default="cuda", help="torch device (cuda, cpu)")
    ps.add_argument("--set", action="append", default=[], metavar="key=value",
                    help="config override, e.g. --set ndt.resolution=1.0")
    ps.set_defaults(fn=cmd_run_sim)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
