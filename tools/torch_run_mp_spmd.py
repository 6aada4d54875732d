"""The mesh device engine of the port as one session over groups of
processes, held to the single-device engine (the port's counterpart of
`tools/run_mp_spmd.py` + `tools/mp_spmd_worker.py`).

    python tools/torch_run_mp_spmd.py [--scans 48] [--radius 12] [--device cpu|cuda]
                                      [--worlds 2,4] [--out result.json]

The scenario is the reference worker's: its config (`CONFIG`), its world
(`make_world(21)`, 70 m), a `--radius` circle of `--scans` scans of 8000
points to 50 m drawn in order from one generator seeded 5, fed scan by scan
(`process_scan`). Every rank of a group renders the whole sequence itself
and runs the session with its `Mesh` (`DeviceSlamPipeline(mesh=)`); a group
of each size in `--worlds` is started by `parallel/distributed.launch`
(gloo on the CPU; on a card NCCL where the cards suffice, else gloo on card
0), and the single-device engine runs the same sequence in one more
process.

The reference asserts the multi-process run bit-identical to its
single-process run of the same mesh program. That does not carry over: in
the port every rank is a process and the rank-ordered sums change with the
group's size. So the ranks of a group are compared bit for bit
(`procs_agree`), and each group with the single-device engine within the
stated tolerance (`within_tolerance_of_single`: keyframes and loops within
±1, per-scan odometry within ODOM_TOL_M). `launch()` returns the
comparison, which `tests/test_torch_mesh_engine.py` holds.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))

# the reference worker's config (tools/mp_spmd_worker.py)
CONFIG = {
    "filter.max_raw_points": 16384,
    "filter.max_points": 8192,
    "filter.outlier_method": "none",
    "ndt.grid_x": 72, "ndt.grid_y": 72, "ndt.grid_z": 16,
    "pgo.max_keyframes": 256, "pgo.max_loops": 32,
    "loop.submap_half_width": 6, "loop.submap_points": 8192,
    "loop.icp_fitness_thresh": 1.0,
    "sc.dist_thresh": 0.35,
}
KF_POINTS = 4096
LOG_CAPACITY = 256
ODOM_TOL_M = 0.15        # the reference's mesh-engine test bound on an odometry chain


def _hash(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def run(mesh, scans: int, radius: float, use_mesh: bool = True) -> dict:
    """One process's session (a rank body of `launch`; with `use_mesh`
    false the mesh is ignored and the single-device engine runs on its
    device): render the sequence, feed it scan by scan, finalize."""
    import torch

    from xchu_slam_tpu_torch.config import default_config
    from xchu_slam_tpu_torch.models.device_pipeline import DeviceSlamPipeline
    from xchu_slam_tpu_torch.parallel import distributed
    from xchu_slam_tpu_torch.types import make_cloud
    from xchu_slam_tpu_torch.utils import sim

    cfg = default_config().override(CONFIG)
    world = sim.make_world(21, extent=70.0, ground_pts=80_000)
    gt = sim.loop_trajectory(n_scans=scans, radius=radius, speed=1.0)
    rng = np.random.default_rng(5)
    t0 = time.perf_counter()
    pipe = DeviceSlamPipeline(cfg, kf_points=KF_POINTS, log_capacity=LOG_CAPACITY,
                              device=mesh.device, mesh=mesh if use_mesh else None)
    for i, p in enumerate(gt):
        xyz, inten = sim.render_scan(world, p, rng, n_points=8000, max_range=50.0)
        pipe.process_scan(make_cloud(xyz, inten, capacity=cfg.filter.max_raw_points,
                                     device=mesh.device), stamp=float(i))
    pipe.finalize()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    n = pipe.kf_count
    _stamps, odo, opt = pipe.keyframe_trajectory()
    log = pipe.odometry_trajectory()
    return {"topology": distributed.topology() if use_mesh else
            {"process_index": 0, "process_count": 1},
            "scans": scans, "kf_count": n, "loop_count": pipe.loop_count,
            "scan_count": pipe.scan_count, "seconds": time.perf_counter() - t0,
            "odometry": log, "opt_hash": _hash(opt), "odom_hash": _hash(odo),
            "log_hash": _hash(log)}


def launch(scans: int = 48, radius: float = 12.0, device: str = "cpu",
           worlds: tuple = (2, 4)) -> dict:
    """The single-device engine and a group of each size in `worlds` on the
    scenario; returns the comparison (topologies, `procs_agree`, counts,
    hashes, `within_tolerance_of_single`, seconds)."""
    from xchu_slam_tpu_torch.cli import _mesh_transport, mesh_timeout
    from xchu_slam_tpu_torch.parallel import distributed

    timeout = mesh_timeout(scans)
    backend, dev = _mesh_transport(1, device)
    t0 = time.perf_counter()
    single = distributed.launch(1, "torch_run_mp_spmd:run", (scans, radius, False),
                                backend=backend, device=dev, timeout_s=timeout,
                                path=(_HERE,))[0]
    out = {"scans": scans, "radius": radius, "device": device,
           "single": {k: single[k] for k in ("kf_count", "loop_count", "opt_hash",
                                              "odom_hash", "log_hash")},
           "single_seconds": round(time.perf_counter() - t0, 1), "groups": {}}
    agree, close = True, True
    for world in worlds:
        backend, dev = _mesh_transport(world, device)
        t0 = time.perf_counter()
        ranks = distributed.launch(world, "torch_run_mp_spmd:run", (scans, radius),
                                   backend=backend, device=dev, timeout_s=timeout,
                                   path=(_HERE,))
        r0 = ranks[0]
        same = all(r[k] == r0[k] for r in ranks for k in ("opt_hash", "odom_hash",
                                                            "log_hash"))
        odom_err = float(np.linalg.norm(r0["odometry"][:, :3] - single["odometry"][:, :3],
                                        axis=1).max())
        within = (r0["scan_count"] == single["scan_count"]
                  and abs(r0["kf_count"] - single["kf_count"]) <= 1
                  and abs(r0["loop_count"] - single["loop_count"]) <= 1
                  and odom_err < ODOM_TOL_M)
        agree, close = agree and same, close and within
        out["groups"][world] = {
            "backend": backend, "topology": [r["topology"] for r in ranks],
            "procs_agree": same, "kf_count": r0["kf_count"], "loop_count": r0["loop_count"],
            "opt_hash": r0["opt_hash"], "odom_hash": r0["odom_hash"],
            "log_hash": r0["log_hash"], "max_odom_err_m": odom_err,
            "within_tolerance_of_single": within,
            "seconds": round(time.perf_counter() - t0, 1)}
    first = out["groups"][worlds[0]]
    out.update(procs_agree=agree, within_tolerance_of_single=close,
               kf_count=first["kf_count"], loop_count=first["loop_count"],
               mp_topology=first["topology"])
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=48)
    ap.add_argument("--radius", type=float, default=12.0)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--worlds", default="2,4")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cmp = launch(args.scans, args.radius, args.device,
                 tuple(int(w) for w in args.worlds.split(",")))
    js = json.dumps(cmp, indent=2)
    print(js)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(js + "\n")
    if not (cmp["procs_agree"] and cmp["within_tolerance_of_single"]):
        sys.exit(1)


if __name__ == "__main__":
    main()
