"""Command-line interface of the port.

  python -m xchu_slam_tpu_torch.cli run-sim  --scans 430 --radius 55 --out out/sim
  python -m xchu_slam_tpu_torch.cli run-sim  --loop-method isc --imu --wheel --gps \\
                                             --checkpoint-every 200 --out out/sim
  python -m xchu_slam_tpu_torch.cli eval     --est out/sim/odom_tum.txt --gt gt_tum.txt
  python -m xchu_slam_tpu_torch.cli localize --session out/sim/checkpoint.npz \\
                                             --scans 430 --radius 55
  python -m xchu_slam_tpu_torch.cli run-sim  --engine device --imu --wheel --gps \\
                                             --checkpoint-every 200 --out out/dev
  python -m xchu_slam_tpu_torch.cli run-sim  --engine device \\
                                             --continue-session out/dev/checkpoint.npz
  python -m xchu_slam_tpu_torch.cli run-sim  --engine device --realism --render-procs 5 \\
                                             --prefetch-threads 3 --prefetch-depth 6
  python -m xchu_slam_tpu_torch.cli run-sim  --trajectory gt_tum.txt --engine device \\
                                             --render-procs 3 --out out/traj
  python -m xchu_slam_tpu_torch.cli run-kitti --velodyne-dir .../velodyne --gt 00.txt \\
                                             --out out/kitti00
  python -m xchu_slam_tpu_torch.cli run-sim  --engine device --trace-chunks 8:11 \
                                             --out out/trace
  python -m xchu_slam_tpu_torch.cli run-sim  --engine device --mesh 2 --out out/mesh
  torchrun --nproc-per-node 4 -m xchu_slam_tpu_torch.cli run-sim --engine device --mesh 4
  python -m xchu_slam_tpu_torch.cli info

`run-sim` runs the synthetic squircle circuit (or, with `--trajectory`, a
TUM trajectory file in a corridor world built along it) with the config
overrides and the world / trajectory / sensor-feed setup of
`xchu_slam_tpu.cli run-sim`,
writes the run's export files (`io/export.save_run`) and prints a JSON
summary. `--engine host` (default) is `models/pipeline.SlamPipeline`, fed
scan by scan; one random generator is consumed in a fixed order (IMU
windows, wheel windows, GPS altimeter noise and dropouts, then every scan),
so that a run sees the scans and sensor feeds the reference CLI makes for the
same arguments. `--engine device` is `models/device_pipeline.
DeviceSlamPipeline`, fed chunks of `--chunk` scans that the staging threads
of `io/prefetch.DeviceChunkPrefetcher` render lazily (each scan from a
generator of its own, as the reference's device path does) and copy to the
card; with `--render-procs N` the scans are rendered by N forked worker
processes instead (`io/procsource.ProcessScanSource`, forked before the
run's first CUDA call); its summary adds the streaming rate and the
per-chunk wait / dispatch attribution and Part B's stage totals;
`--trace-chunks A:B` traces chunks A to B - 1 with
`utils/profiling.device_trace` into `<out>/trace.json` (the card's kernels
and the program's spans, a track a host thread) and adds the trace's idle
time split among the feeding thread's spans (`idle_by_span`) to the
summary (the profiler and the trace's writing slow the run's rate).
`--realism` renders through the
beam-level sensor model with moving traffic on either engine. Its sensor
windows are sliced per chunk from the same draws as
the host engine's, it writes `checkpoint.npz` at chunk boundaries, and
`--continue-session` continues a saved device-engine session: the
checkpoint's config governs the run, scan 0 seeds the continuation, and the
summary covers the continued keyframes.
`run-kitti` runs a directory of velodyne `.bin` scans at the default config
(read by `io/native_loader.py`; the summary names the reader) through
either engine, writes the camera-frame export and, with `--gt`, the ATE;
the host engine pipelines one scan (`defer_sync`) unless `--no-defer-sync`.
`eval` compares two trajectory files, `localize` places fresh scans in a
saved session's map, `info` prints versions, devices and the default config.

`--mesh N` (`run-sim`, `run-kitti`; N of 0 or 1 is the single-device
engine) runs the device engine as one session over N ranks
(`DeviceSlamPipeline(mesh=)`: the state replicated, the hot ops sharded).
The CLI starts N ranks through `parallel/distributed.launch`, each a fresh
interpreter that renders (or reads) its own scans and runs the whole session
with its `Mesh`: NCCL, a card a rank, where `--device cuda` sees N cards;
else gloo, every rank on card 0 with each collective staged through pinned
host memory; gloo on `--device cpu`. Under `torchrun` (its variables set)
the CLI joins that group instead, and N must equal its world size. With
`--render-procs W` each rank forks its own W render workers before it forms
its group (a process may not fork once CUDA is initialized), each rendering
the whole stream, since every rank holds the whole state. Rank 0 alone
writes `--out`, the export and the checkpoints; the summary is rank 0's,
with `"mesh"`, `"backend"` and `"ranks_agree"` (a hash of every pose, equal
on every rank, or the run fails), and with workers each rank's
`"inline_renders"`, the render processes of the group and `os.cpu_count()`.

Every subcommand that computes takes `--device` (default `cuda`, an error
without a card; `cpu` runs the kernels' plain versions). Refused by name:
`--sync-every` (not ported), `--mesh` with `--engine host`;
`--continue-session` and `--render-procs` need `--engine device`.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
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


def sim_config(overrides=(), loop_method: str = "sc", imu: bool = False,
               wheel: bool = False, gps: bool = False):
    """The `run-sim` config: the defaults plus the reference CLI's sim
    overrides (denser-filter and looser-gate settings for sparse simulated
    scans; see `xchu_slam_tpu/cli.py:51-71`), the sensor switches, then the
    caller's `key=value` overrides."""
    from xchu_slam_tpu_torch.config import default_config

    cfg = default_config().override({
        "filter.max_points": 8192,
        "filter.max_raw_points": 32768,
        "filter.outlier_method": "statistical",
        "loop.method": loop_method,
        "pgo.odom_noise_trans": 1e-3,
        "pgo.odom_noise_rot": 1e-3,
        "loop.icp_fitness_thresh": 1.0,
        "sc.dist_thresh": 0.35,
        "odom.use_imu": imu,
        "odom.use_odom": wheel,
        "pgo.use_gps": gps,
    })
    return _apply_overrides(cfg, overrides)


def _check_device(device: str) -> None:
    if str(device).startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")


def _sim_world_and_traj(scans: int, radius: float, seed: int,
                        trajectory: str | None = None):
    """(stamps, poses, world), shared by run-sim and localize: `localize` is
    right only if its world is the mapping run's (a pure function of the
    trajectory or the radius, and the seed). With a TUM `trajectory` file
    the poses and stamps are the file's (its first `scans` rows; all where
    `scans` is 0) and the world is a corridor along them; else the circuit
    of `radius` with `scans` poses (0: 400)."""
    from xchu_slam_tpu_torch.utils import sim

    if trajectory:
        stamps, gt = sim.tum_trajectory_poses(trajectory, max_scans=scans)
        return stamps, gt, sim.make_world_along(gt[:, :3], seed)
    n_scans = scans or 400
    world = sim.make_world(seed, extent=radius * 2.5)
    gt = sim.loop_trajectory(n_scans=n_scans, radius=radius, speed=1.0)
    return 0.1 * np.arange(n_scans), gt, world


def _world_index(world, trajectory: str | None):
    """The renders' `WorldIndex` of a world along a trajectory file (millions
    of points), None for the circuit's world, as in the reference."""
    from xchu_slam_tpu_torch.utils import sim

    return sim.WorldIndex(world) if trajectory else None


def _gt_in_map_frame(gt: np.ndarray) -> np.ndarray:
    """Ground-truth poses [N,4,4] relative to the first (the map frame)."""
    from xchu_slam_tpu_torch.utils import se3

    gtT = se3.pose_to_matrix(torch.from_numpy(gt)).numpy()
    return np.einsum("ab,nbc->nac", np.linalg.inv(gtT[0]), gtT)


def _sim_sensor_windows(cfg, gt, gt_stamps, rng) -> dict:
    """Per-scan IMU / wheel-odometry windows along the sim trajectory, with
    measurement noise (IMU first: the order the generator is consumed in)."""
    from xchu_slam_tpu_torch.utils import sim

    out = {}
    M = cfg.odom.imu_samples
    if cfg.odom.use_imu:
        out["imu"] = sim.imu_windows(gt, gt_stamps, samples=M, rng=rng,
                                     gyro_noise=0.002, accel_noise=0.05)
    if cfg.odom.use_odom:
        out["wheel"] = sim.wheel_windows(gt, gt_stamps, samples=M, rng=rng,
                                         vel_noise=0.03, gyro_noise=0.002)
    return out


def _sim_feeds(cfg, gt, gt_stamps, rng):
    """(sensor windows, GPS altitudes or None) of a run, drawn from `rng` in
    the CLI's order: IMU windows, wheel windows, then a synthetic altimeter
    along the trajectory (noisy, with 20 % dropouts as NaN)."""
    sensor_windows = _sim_sensor_windows(cfg, gt, gt_stamps, rng)
    gps_alts = None
    if cfg.pgo.use_gps:
        n = len(gt)
        gps_alts = gt[:, 2] + rng.normal(0.0, 0.5, n)
        gps_alts[rng.random(n) < 0.2] = np.nan
    return sensor_windows, gps_alts


def _scan_windows(sensor_windows: dict, i: int):
    """(ImuWindow, OdomWindow) for scan i (None when the mode is off)."""
    from xchu_slam_tpu_torch.ops.imu import ImuWindow, OdomWindow

    imu_w = wheel_w = None
    if "imu" in sensor_windows:
        imu_w = ImuWindow(*(torch.from_numpy(a[i]) for a in sensor_windows["imu"]))
    if "wheel" in sensor_windows:
        wheel_w = OdomWindow(*(torch.from_numpy(a[i]) for a in sensor_windows["wheel"]))
    return imu_w, wheel_w


def _slice_windows(sensor_windows: dict, idx: np.ndarray):
    """GuessWindows (numpy arrays, a leading axis over `idx`) of a chunk's
    slots, `idx` the slots' scans clamped at the last one; None when no
    guess mode is on."""
    from xchu_slam_tpu_torch.models.device_pipeline import GuessWindows
    from xchu_slam_tpu_torch.ops.imu import ImuWindow, OdomWindow

    if not sensor_windows:
        return None
    imu_w = wheel_w = None
    if "imu" in sensor_windows:
        imu_w = ImuWindow(*(a[idx] for a in sensor_windows["imu"]))
    if "wheel" in sensor_windows:
        wheel_w = OdomWindow(*(a[idx] for a in sensor_windows["wheel"]))
    return GuessWindows(imu=imu_w, wheel=wheel_w)


class _TailView:
    """scans[start:] as an indexable sequence (a continuation's scan 0 went
    into its seed)."""

    def __init__(self, scans, start: int):
        self.scans, self.start = scans, start

    def __len__(self) -> int:
        return len(self.scans) - self.start

    def __getitem__(self, k: int):
        return self.scans[k + self.start]


def _run_host_engine(pipe, world, gt, gt_stamps, gps_alts, sensor_windows, rng,
                     timers, on_scan, verbose: bool, checkpoint_every: int,
                     out: str | None, index=None, sensor=None, dynamics=None) -> None:
    """Render and feed the scans one by one to the host engine (scan i at
    time 0.1·i for the moving objects of `--realism`)."""
    from xchu_slam_tpu_torch.utils import sim
    from xchu_slam_tpu_torch.utils.checkpoint import save_checkpoint

    for i, p in enumerate(gt):
        with timers.time("render"):
            xyz, inten = sim.render_scan(world, p, rng, n_points=24_000, index=index,
                                         sensor=sensor, dynamics=dynamics, t=0.1 * i)
        imu_w, wheel_w = _scan_windows(sensor_windows, i)
        galt = None
        if gps_alts is not None and np.isfinite(gps_alts[i]):
            galt = float(gps_alts[i])
        scan = dict(xyz=xyz, intensity=inten, stamp=float(gt_stamps[i]),
                    gps_alt=galt, imu=imu_w, wheel=wheel_w)
        with timers.time("slam"):
            res = pipe.process_scan(**scan)
        if on_scan is not None:
            on_scan(i, res, scan)
        if verbose and i % 25 == 0:
            print(f"scan {i}: kf={pipe.kf_count} loops={pipe.loop_count}",
                  file=sys.stderr)
        if checkpoint_every and i and i % checkpoint_every == 0:
            with timers.time("checkpoint"):
                save_checkpoint(pipe, os.path.join(out, "checkpoint.npz"))


def _run_device_engine(pipe, scans, gt_stamps, gps_alts, cfg, chunk: int,
                       prefetch_depth: int, prefetch_threads: int, device: str,
                       timers, verbose: bool, sensor_windows: dict | None = None,
                       checkpoint_every: int = 0, out: str | None = None,
                       start: int = 0, trace_chunks: tuple | None = None) -> dict:
    """Stream `scans[start:]` through the device engine in chunks, with the
    sensor windows of each chunk's slots; `checkpoint.npz` is written at the
    chunk boundaries of the reference's cadence; chunks [A, B) of
    `trace_chunks` run inside `device_trace(out)`. Returns the per-chunk
    times: host wait on the prefetcher (render + stage + copy behind) and
    time inside `process_chunk` (Part A's enqueue, the chunk's readback,
    Part B), with each chunk's scan span, and the trace's summary."""
    from xchu_slam_tpu_torch.io.prefetch import DeviceChunkPrefetcher
    from xchu_slam_tpu_torch.utils.checkpoint import save_checkpoint
    from xchu_slam_tpu_torch.utils.profiling import device_trace

    n_scans = len(scans)
    wait_s, dispatch_s, span, ts = [], [], [], [time.perf_counter()]
    base = start
    feed = scans if start == 0 else _TailView(scans, start)
    trace = None
    with contextlib.ExitStack() as tracing, \
            DeviceChunkPrefetcher(feed, capacity=cfg.filter.max_raw_points,
                                  chunk=chunk, depth=prefetch_depth,
                                  threads=prefetch_threads, device=device) as pf, \
            timers.time("slam"):
        it = iter(pf)
        while True:
            if trace_chunks and len(span) == trace_chunks[0]:
                trace = tracing.enter_context(device_trace(out, device))
            tw = time.perf_counter()
            try:
                clouds, n_real = next(it)
            except StopIteration:
                break
            wait_s.append(time.perf_counter() - tw)
            idx = np.minimum(base + np.arange(clouds.xyz.shape[0]), n_scans - 1)
            td = time.perf_counter()
            pipe.process_chunk(clouds, gt_stamps[idx], n_real,
                               gps_alts=None if gps_alts is None else gps_alts[idx],
                               wins=_slice_windows(sensor_windows, idx))
            dispatch_s.append(time.perf_counter() - td)
            span.append((base, base + n_real))
            base += n_real
            ts.append(time.perf_counter())
            if checkpoint_every and base and \
                    (base // 16) % max(checkpoint_every // 16, 1) == 0:
                with timers.time("checkpoint"):
                    save_checkpoint(pipe, os.path.join(out, "checkpoint.npz"))
            if verbose:
                print(f"scan {base}: kf={pipe.state.db.count} "
                      f"loops={int(pipe.state.loop_count)}", file=sys.stderr)
            if trace is not None and len(span) == trace_chunks[1]:
                tracing.close()
    res = {"wait_s": wait_s, "dispatch_s": dispatch_s, "span": span, "ts": ts}
    if trace is not None:
        res["trace"] = {"chunks": [trace_chunks[0], min(trace_chunks[1], len(span))],
                        "path": trace.path, "spans": len(trace.spans),
                        "dropped": trace.dropped, "idle_s": round(trace.idle_s, 6),
                        "idle_by_span": {k: round(v, 6) for k, v in sorted(
                            trace.idle_by_span.items(), key=lambda kv: -kv[1])}}
    return res


PART_B_STAGES = ("part_b.store", "part_b.retrieve", "part_b.verify", "part_b.solve")


def _chunk_attribution(chunks: dict, pipe, n_scans: int) -> dict:
    """The streaming rate, where the chunks' time went, Part B's stages
    (host ms in all, self ms, count) and the trace of `--trace-chunks`."""
    ts = chunks["ts"]
    out = {}
    if len(ts) > 2:
        out["stream_scans_per_sec"] = round(n_scans / (ts[-1] - ts[0]), 2)
    wait = 1e3 * np.asarray(chunks["wait_s"])
    disp = 1e3 * np.asarray(chunks["dispatch_s"])
    total = wait + disp

    def mean(x):
        return round(float(np.mean(x)), 1) if len(x) else None

    out["chunk_attribution"] = {
        "chunks": len(total),
        "p50_ms": round(float(np.median(total)), 1),
        "mean_wait_ms": mean(wait),
        "mean_dispatch_ms": mean(disp),
    }
    stage = pipe.stage_seconds
    out["stage_seconds"] = {k: round(v, 3) for k, v in stage.items()}
    out["part_b_stages"] = {
        name: {"ms": round(1e3 * stage[name], 1), "self_ms": round(1e3 * stage[f"self.{name}"], 1),
               "count": pipe.spans.counts[name]}
        for name in PART_B_STAGES if name in stage}
    if "trace" in chunks:
        out["trace"] = chunks["trace"]
    return out


def run_sim(scans: int = 400, radius: float = 55.0, seed: int = 0,
            device: str = "cuda", overrides=(), on_scan=None,
            loop_method: str = "sc", imu: bool = False, wheel: bool = False,
            gps: bool = False, out: str | None = None,
            checkpoint_every: int = 0, verbose: bool = False, timers=None,
            engine: str = "host", chunk: int = 16, prefetch_depth: int = 2,
            prefetch_threads: int = 2, continue_from: str | None = None,
            realism: bool = False, trajectory: str | None = None,
            render_procs: int = 0, mesh=None, source=None,
            trace_chunks: tuple | None = None):
    """Run the circuit, or the TUM `trajectory`, through the host or the
    device engine. Returns (pipeline, summary dict). With `out`, the run's
    artifacts are written there. `timers` (a `StageTimers` for `device`)
    collects the stage times. `realism` renders through the beam-level
    sensor model with moving traffic.

    Host engine: `on_scan(i, result, scan)` is called after each scan with
    the keyword arguments `process_scan` was given; `checkpoint.npz` is
    written every `checkpoint_every` scans. Device engine: the scans are
    rendered lazily inside the staging threads, or by `render_procs` forked
    worker processes, and fed in chunks of `chunk` with their sensor
    windows; `checkpoint.npz` is written at the chunk boundaries where
    `(scans fed // 16) % max(checkpoint_every // 16, 1) == 0`; `on_scan` is
    not ported to it. `continue_from` (device engine only) continues the
    device-engine session saved in that checkpoint: its config governs the
    run (the config arguments are then ignored), scan 0 seeds the
    continuation, and the summary covers the continued keyframes.
    `trace_chunks` (A, B) traces chunks A to B - 1 of the device engine into
    `<out>/trace.json` (`utils/profiling.device_trace`).

    The render workers are forked before anything here touches CUDA, and
    closed when the run ends, however it ends. `source` is a scan source
    that `mesh_rank_setup` made earlier for the same arguments (its workers
    forked before the process touched CUDA); it is closed here too.

    With `mesh` (this rank's `parallel.distributed.Mesh`; every rank of the
    group calls this with the same arguments) the device engine runs the
    session over the mesh on the mesh's device (`device` is then ignored),
    each rank rendering its own scans; rank 0 alone writes `out`. A rank
    forms its group before it gets here, so with `render_procs` it must
    pass the `source` it made before (`mesh_rank_setup`)."""
    from xchu_slam_tpu_torch.io.export import save_run
    from xchu_slam_tpu_torch.models.pipeline import SlamPipeline
    from xchu_slam_tpu_torch.utils import metrics, se3, sim
    from xchu_slam_tpu_torch.utils.profiling import StageTimers

    if engine not in ("host", "device"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "device" and on_scan:
        raise ValueError("the device engine takes no per-scan callback")
    if continue_from and engine != "device":
        raise ValueError("continue_from requires the device engine")
    if render_procs and engine != "device":
        raise ValueError("render_procs requires the device engine: the host engine "
                         "draws every scan from one shared generator")
    _check_trace_chunks(trace_chunks, engine, mesh, out)
    if mesh is not None:
        if engine != "device":
            raise ValueError("a mesh runs the device engine only")
        if render_procs and source is None:
            raise ValueError("render_procs with a mesh: fork the render workers before the "
                             "rank forms its group and pass them as `source` "
                             "(cli.mesh_rank_setup)")
        device = str(mesh.device)
    writer = mesh is None or mesh.rank == 0
    gt_stamps, gt, world, index, sensor, dynamics, lazy = _sim_inputs(
        scans, radius, seed, trajectory, realism)
    if engine == "device" and render_procs and source is None:
        # forked before the first CUDA call of the run (the device check
        # included)
        source = _fork_renders(lazy, render_procs, chunk, prefetch_depth, prefetch_threads)
    try:
        _check_device(device)
        cfg = sim_config(overrides, loop_method, imu, wheel, gps)
        n_scans = len(gt)
        rng = np.random.default_rng(seed)
        timers = timers if timers is not None else StageTimers(device)
        cont = None
        if continue_from:
            # loaded first: the checkpoint's config governs the run, and the
            # sensor feeds below must be drawn for that config
            from xchu_slam_tpu_torch.models.continue_session import continue_session

            xyz0, inten0 = lazy[0]   # the raw source: the workers' scan 0 goes unread
            with timers.time("continue"):
                cont = continue_session(continue_from, xyz0, inten0, stamp=float(gt_stamps[0]),
                                        log_capacity=max(n_scans, 8192), device=device,
                                        mesh=mesh)
            if overrides or imu or wheel or gps or loop_method != "sc":
                print("warning: --continue-session runs under the checkpoint's config; "
                      "the CLI's config flags (--set/--imu/--wheel/--gps/--loop-method) "
                      "are ignored", file=sys.stderr)
            cfg = cont.cfg
            print(f"continued session: relocalized to kf {cont.continuation['matched_kf']} "
                  f"(icp_fitness={cont.continuation['icp_fitness']:.3f}, "
                  f"{cont.continuation['old_keyframes']} saved keyframes)", file=sys.stderr)
        sensor_windows, gps_alts = _sim_feeds(cfg, gt, gt_stamps, rng)
        if out:
            if writer:
                os.makedirs(out, exist_ok=True)
        elif checkpoint_every:
            raise ValueError("checkpoint_every needs an output directory")

        chunks = None
        if engine == "device":
            from xchu_slam_tpu_torch.models.device_pipeline import DeviceSlamPipeline

            pipe = cont if cont is not None else DeviceSlamPipeline(
                cfg, kf_points=4096, log_capacity=max(n_scans, 8192), device=device,
                mesh=mesh)
            t0 = time.perf_counter()
            chunks = _run_device_engine(pipe, lazy if source is None else source, gt_stamps,
                                        gps_alts, cfg, chunk, prefetch_depth, prefetch_threads,
                                        device, timers, verbose, sensor_windows,
                                        checkpoint_every, out, start=0 if cont is None else 1,
                                        trace_chunks=trace_chunks)
        else:
            pipe = SlamPipeline(cfg, kf_points=4096, device=device)
            t0 = time.perf_counter()
            _run_host_engine(pipe, world, gt, gt_stamps, gps_alts, sensor_windows, rng,
                             timers, on_scan, verbose, checkpoint_every, out, index, sensor,
                             dynamics)
        with timers.time("finalize"):
            pipe.finalize()
        wall = time.perf_counter() - t0

        paths = None
        if out and writer:
            with timers.time("save"):
                # camera-frame TUM export, so that `eval --est odom_tum.txt
                # --gt <camera-frame GT file>` compares directly
                paths = save_run(pipe, out, cam_T=sim.camera_frame_transform())

        gt_rel = _gt_in_map_frame(gt)
        stamps, _kf_odo, kf_opt = pipe.keyframe_trajectory()
        kf_base = 0 if cont is None else cont.continuation["old_keyframes"]
        # a continuation is evaluated on its own keyframes only: the saved
        # session's stamps belong to its own run
        stamps, kf_opt = stamps[kf_base:], kf_opt[kf_base:]
        n_streamed = n_scans - (0 if cont is None else 1)   # scan 0 went into the seed
        ei, idx = metrics.associate(stamps, gt_stamps, max_diff=0.05)
        kf_opt = kf_opt[ei]
        estT = se3.pose_to_matrix(torch.from_numpy(kf_opt)).numpy()
        gt_xyz = gt_rel[idx, :3, 3]
        # SE(3)-aligned APE (the evo_ape -a convention); unaligned alongside
        ate = metrics.ape_rmse(kf_opt[:, :3], gt_xyz, align=True)
        ate_raw = metrics.ape_rmse(kf_opt[:, :3], gt_xyz, align=False)
        drift, length = metrics.end_drift(kf_opt[:, :3], gt_xyz)
        summary = {
            "scans": n_scans,
            "keyframes": pipe.kf_count,
            "loops": pipe.loop_count,
            "ate_rmse_m": round(float(ate), 4),
            "ate_unaligned_m": round(float(ate_raw), 4),
            "rpe_rmse_m": round(metrics.rpe_rmse(estT, gt_rel[idx]), 4),
            "end_drift_m": round(drift, 3),
            "length_m": round(length, 1),
            "drift_pct": round(100.0 * drift / max(length, 1e-9), 3),
            "scans_per_sec": round(n_streamed / wall, 2),
        }
        if cont is not None:
            summary["continuation"] = {
                **{k: v for k, v in cont.continuation.items() if k != "reloc_pose"},
                "new_keyframes": pipe.kf_count - kf_base}
        if chunks is not None:
            summary["engine"] = "device"
            summary.update(_chunk_attribution(chunks, pipe, n_streamed))
        if paths is not None:
            summary["artifacts"] = paths
    finally:
        if source is not None:
            source.close()
    if source is not None:
        summary["render_procs"] = render_procs
        summary["inline_renders"] = source.inline_renders
    return pipe, summary


def _check_trace_chunks(trace_chunks, engine: str, mesh, out) -> None:
    """`trace_chunks` is a range (A, B), 0 <= A < B, of a single-device
    device engine's chunks that writes its trace into `out`."""
    if trace_chunks is None:
        return
    a, b = trace_chunks
    if not 0 <= a < b:
        raise ValueError(f"trace_chunks {a}:{b}: needs 0 <= A < B")
    if engine != "device" or mesh is not None:
        raise ValueError("trace_chunks traces the single-device device engine")
    if not out:
        raise ValueError("trace_chunks needs an output directory")


def _sim_inputs(scans: int, radius: float, seed: int, trajectory: str | None,
                realism: bool):
    """A `run_sim` run's stamps, poses, world and its index, sensor model and
    moving objects (None without `realism`), and its scans as the device
    engine renders them: lazily, each from a generator of its own."""
    from xchu_slam_tpu_torch.utils import sim

    gt_stamps, gt, world = _sim_world_and_traj(scans, radius, seed, trajectory)
    index = _world_index(world, trajectory)
    sensor = dynamics = None
    if realism:
        sensor, dynamics = sim.SensorModel(), sim.DynamicObjects(gt[:, :3], seed=seed)
    lazy = sim.RenderedScans(world, gt, seed=seed, n_points=24_000, index=index,
                             sensor=sensor, dynamics=dynamics)
    return gt_stamps, gt, world, index, sensor, dynamics, lazy


def _fork_renders(lazy, render_procs: int, chunk: int, prefetch_depth: int,
                  prefetch_threads: int):
    """`render_procs` forked render workers over `lazy`, reading ahead what
    the staging threads can hold (the reference's readahead)."""
    from xchu_slam_tpu_torch.io.procsource import ProcessScanSource

    return ProcessScanSource(lazy, workers=render_procs,
                             readahead=(prefetch_depth + prefetch_threads + 2) * chunk)


def mesh_rank_setup(command: str, kwargs: dict):
    """What a rank of `command` must make before it forms its group: with
    `render_procs`, run-sim's render workers (`ProcessScanSource`, forked
    before the process touches CUDA) over the same scans `run_sim` renders
    for `kwargs`; else None. Passed to `mesh_rank` as its `source`."""
    if command != "run-sim" or not kwargs.get("render_procs"):
        return None
    import inspect

    a = inspect.signature(run_sim).bind_partial(**kwargs)
    a.apply_defaults()
    a = a.arguments
    lazy = _sim_inputs(a["scans"], a["radius"], a["seed"], a["trajectory"], a["realism"])[-1]
    return _fork_renders(lazy, a["render_procs"], a["chunk"], a["prefetch_depth"],
                         a["prefetch_threads"])


def cmd_run_sim(args):
    from xchu_slam_tpu_torch.utils.profiling import StageTimers

    kwargs = dict(scans=args.scans, radius=args.radius, seed=args.seed, device=args.device,
                  overrides=args.set, loop_method=args.loop_method, imu=args.imu,
                  wheel=args.wheel, gps=args.gps, out=args.out,
                  checkpoint_every=args.checkpoint_every, verbose=args.verbose,
                  engine=args.engine, chunk=args.chunk, prefetch_depth=args.prefetch_depth,
                  prefetch_threads=args.prefetch_threads,
                  continue_from=args.continue_session, realism=args.realism,
                  trajectory=args.trajectory, render_procs=args.render_procs)
    if args.mesh > 1:
        _cmd_on_mesh("run-sim", kwargs, args.mesh)
        return
    kwargs["trace_chunks"] = args.trace_chunks
    timers = StageTimers(args.device)
    _pipe, summary = run_sim(**kwargs, timers=timers)
    print(json.dumps(summary, indent=2))
    print(timers.report(), file=sys.stderr)


def run_kitti(velodyne_dir: str, gt: str | None = None, out: str = "out/kitti",
              max_scans: int = 0, engine: str = "host", defer_sync: bool = True,
              verbose: bool = False, overrides=(), device: str = "cuda", timers=None,
              mesh=None, trace_chunks: tuple | None = None):
    """Run the velodyne `.bin` scans of a directory (in name order, the
    first `max_scans` where it is not 0; scan i stamped 0.1·i) at the
    default config with `overrides`, through the host engine (scans staged
    by `DeviceScanPrefetcher`, `defer_sync` on unless asked off) or the
    device engine (chunks of 16 staged by `DeviceChunkPrefetcher`). Scans
    are read by `io/native_loader.py` at `filter.max_raw_points`. Writes the
    camera-frame export to `out`; with a KITTI pose file `gt` (one row a
    scan, camera frame) the summary adds the keyframes' ATE. Returns
    (pipeline, summary); the summary names the reader that ran. With `mesh`
    (this rank's `parallel.distributed.Mesh`, every rank calling this with
    the same arguments) the device engine runs over the mesh on the mesh's
    device, each rank reading the scans itself; rank 0 alone writes `out`
    (and so alone reports the ATE). `trace_chunks` (A, B) traces the device
    engine's chunks A to B - 1 into `<out>/trace.json`."""
    from xchu_slam_tpu_torch.config import default_config
    from xchu_slam_tpu_torch.io import kitti, native_loader
    from xchu_slam_tpu_torch.io.export import save_run
    from xchu_slam_tpu_torch.io.prefetch import DeviceScanPrefetcher, LazyScans
    from xchu_slam_tpu_torch.models.pipeline import SlamPipeline
    from xchu_slam_tpu_torch.utils import metrics
    from xchu_slam_tpu_torch.utils.profiling import StageTimers

    if mesh is not None:
        if engine != "device":
            raise ValueError("a mesh runs the device engine only")
        device = str(mesh.device)
    writer = mesh is None or mesh.rank == 0
    _check_device(device)
    if engine not in ("host", "device"):
        raise ValueError(f"unknown engine {engine!r}")
    _check_trace_chunks(trace_chunks, engine, mesh, out)
    cfg = _apply_overrides(default_config(), overrides)
    files = kitti.list_velodyne_dir(velodyne_dir)
    if max_scans:
        files = files[:max_scans]
    if not files:
        raise ValueError(f"no velodyne .bin scans in {velodyne_dir}")
    capacity = cfg.filter.max_raw_points
    reader = native_loader.reader()   # built here, before the timed region

    def read(path):
        xyz, inten, n = native_loader.read_velodyne(path, capacity=capacity)
        return xyz[:n], inten[:n]

    scans = LazyScans(files, read)
    stamps = 0.1 * np.arange(len(files))
    timers = timers if timers is not None else StageTimers(device)
    chunks = None
    if engine == "device":
        from xchu_slam_tpu_torch.models.device_pipeline import DeviceSlamPipeline

        pipe = DeviceSlamPipeline(cfg, kf_points=4096, log_capacity=max(len(files), 8192),
                                  device=device, mesh=mesh)
        t0 = time.perf_counter()
        chunks = _run_device_engine(pipe, scans, stamps, None, cfg, 16, 2, 2, device,
                                    timers, verbose, out=out, trace_chunks=trace_chunks)
    else:
        pipe = SlamPipeline(cfg, kf_points=4096, device=device)
        pipe.defer_sync = defer_sync
        t0 = time.perf_counter()
        with DeviceScanPrefetcher(scans, capacity=capacity, depth=6, threads=3,
                                  device=device) as pf, timers.time("slam"):
            for i, cloud in enumerate(pf):
                pipe.process_scan(cloud, None, stamp=float(stamps[i]))
                if verbose and i % 100 == 0:
                    print(f"scan {i}/{len(files)}: kf={pipe.kf_count} "
                          f"loops={pipe.loop_count}", file=sys.stderr)
    with timers.time("finalize"):
        pipe.finalize()
    wall = time.perf_counter() - t0
    paths = None
    if writer:
        with timers.time("save"):
            paths = save_run(pipe, out, to_camera_frame=True)
    summary = {
        "scans": len(files),
        "keyframes": pipe.kf_count,
        "loops": pipe.loop_count,
        "scans_per_sec": round(len(files) / wall, 2),
        "engine": engine,
        "reader": reader,
    }
    if engine == "host":
        summary["defer_sync"] = defer_sync
    if gt and paths is not None:
        gt_poses = kitti.read_kitti_poses(gt)
        st, poses = kitti.read_tum(paths["odom_tum"])
        # a keyframe row carries its scan's stamp: index the per-scan rows
        idx = np.clip(np.round(np.asarray(st) * 10.0).astype(int), 0, len(gt_poses) - 1)
        summary["ate_rmse_m"] = round(metrics.ape_rmse(poses[:, :3, 3],
                                                       gt_poses[idx][:, :3, 3]), 4)
    if chunks is not None:
        summary.update(_chunk_attribution(chunks, pipe, len(files)))
    if paths is not None:
        summary["artifacts"] = paths
    return pipe, summary


def cmd_run_kitti(args):
    from xchu_slam_tpu_torch.utils.profiling import StageTimers

    kwargs = dict(velodyne_dir=args.velodyne_dir, gt=args.gt, out=args.out,
                  max_scans=args.max_scans, engine=args.engine,
                  defer_sync=not args.no_defer_sync, verbose=args.verbose,
                  overrides=args.set, device=args.device)
    if args.mesh > 1:
        _cmd_on_mesh("run-kitti", kwargs, args.mesh)
        return
    kwargs["trace_chunks"] = args.trace_chunks
    timers = StageTimers(args.device)
    _pipe, summary = run_kitti(**kwargs, timers=timers)
    print(json.dumps(summary, indent=2))
    print(timers.report(), file=sys.stderr)


# ------------------------------------------------------------------ meshes -- #
# a launched group's bound: start-up, then per scan (two gloo ranks sharing
# one card run ~14 scans/s at run-sim's width; a CPU rank far slower)
MESH_TIMEOUT_S = 120.0
MESH_TIMEOUT_PER_SCAN_S = 3.0


def mesh_timeout(n_scans: int) -> float:
    """The bound of a launched group that feeds `n_scans` scans."""
    return MESH_TIMEOUT_S + MESH_TIMEOUT_PER_SCAN_S * n_scans


def _mesh_transport(world: int, device: str) -> tuple[str, str]:
    """(backend, device) of a group of `world` ranks: NCCL, a card a rank,
    where a CUDA device sees `world` cards; else gloo, on card 0 for a CUDA
    device (each collective staged through pinned host memory) or on the
    CPU."""
    if str(device).startswith("cuda"):
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is available")
        return ("nccl" if world <= torch.cuda.device_count() else "gloo"), "cuda"
    return "gloo", str(device)


def _mesh_scans(command: str, kwargs: dict) -> int:
    """How many scans a run of `command` feeds (for its group's bound)."""
    if command == "run-kitti":
        from xchu_slam_tpu_torch.io import kitti

        n = len(kitti.list_velodyne_dir(kwargs["velodyne_dir"]))
        return min(n, kwargs["max_scans"]) if kwargs.get("max_scans") else n
    if kwargs.get("trajectory"):
        from xchu_slam_tpu_torch.utils import sim

        return len(sim.tum_trajectory_poses(kwargs["trajectory"], kwargs.get("scans") or 0)[0])
    return kwargs.get("scans") or 400


def pose_hash(pipe) -> str:
    """A hash of every pose a finished pipeline holds: the per-scan odometry
    rows and the keyframes' odometric and optimized poses."""
    _stamps, kf_odo, kf_opt = pipe.keyframe_trajectory()
    return hashlib.sha256(pipe.odometry_trajectory().tobytes() + kf_odo.tobytes()
                          + kf_opt.tobytes()).hexdigest()[:16]


def rank_counters(pipe) -> dict:
    """This process's kernel launches (each wrapper's count), live ICP trips
    on the card (`icp.live_trip_count`), collectives and host-staged
    collectives, and the device engine `pipe`'s chunk readbacks and ICP
    verifications."""
    from xchu_slam_tpu_torch.ops import icp
    from xchu_slam_tpu_torch.ops.cuda import (guess_kernel, icp_kernel, ndt_kernel, nn_kernel,
                                             pgo_kernel)
    from xchu_slam_tpu_torch.utils import collectives

    return {"nn": nn_kernel.launches, "ndt": ndt_kernel.launches,
            "ndt_pass": ndt_kernel.pass_launches, "icp_step": icp_kernel.launches,
            "icp_partial": icp_kernel.partial_launches,
            "icp_solve": icp_kernel.solve_launches, "pgo": pgo_kernel.launches,
            "guess": guess_kernel.launches, "icp_live_trips": icp.live_trip_count(),
            "collectives": collectives.collectives,
            "host_staged": collectives.host_staged,
            "chunk_readbacks": pipe.chunk_readbacks,
            "icp_verifications": pipe.icp_verifications}


def mesh_rank(mesh, command: str, kwargs: dict, source=None) -> dict:
    """One rank of `command` ("run-sim" or "run-kitti") over `mesh`: the
    whole run with this rank's mesh, and its scans from `source` where
    `mesh_rank_setup` made one. Returns its summary, its pose hash and
    per-scan odometry, a continuation's record, its counters
    (`rank_counters`, and on a CUDA device the host synchronisations
    PyTorch made, `count_host_syncs`) and its stage timers' report."""
    from xchu_slam_tpu_torch.utils.profiling import StageTimers, count_host_syncs

    fn = {"run-sim": run_sim, "run-kitti": run_kitti}[command]
    timers = StageTimers(mesh.device)
    extra = {} if source is None else {"source": source}
    with count_host_syncs(mesh.device.type == "cuda") as syncs:
        pipe, summary = fn(**kwargs, **extra, timers=timers, mesh=mesh)
    return {"rank": mesh.rank, "summary": summary, "pose_hash": pose_hash(pipe),
            "odometry": pipe.odometry_trajectory(),
            "continuation": getattr(pipe, "continuation", None),
            "counters": {**rank_counters(pipe), "host_syncs": syncs["syncs"]},
            "timers": timers.report()}


def _mesh_summary(summary: dict, hashes: list, backend: str,
                  inline_renders: list | None = None) -> dict:
    """Rank 0's `summary` with the group's size, backend and whether every
    rank ended with rank 0's poses (`hashes`, rank 0's first); a rank that
    did not is an error. Where the ranks rendered with workers, each rank's
    `inline_renders`, the group's render processes and `os.cpu_count()`."""
    bad = [r for r, h in enumerate(hashes) if h != hashes[0]]
    if bad:
        raise RuntimeError(f"mesh of {len(hashes)}: ranks {bad} ended with other poses than "
                           f"rank 0 (pose hashes {hashes})")
    out = {**summary, "mesh": len(hashes), "backend": backend, "ranks_agree": True,
           "pose_hash": hashes[0]}
    if "render_procs" in summary:
        out.update(inline_renders=list(inline_renders),
                   render_processes=len(hashes) * summary["render_procs"],
                   cpu_count=os.cpu_count())
    return out


def run_on_mesh(command: str, kwargs: dict, world: int):
    """Run `command` ("run-sim" or "run-kitti", with the keyword arguments
    of `run_sim` / `run_kitti`; `kwargs["device"]` picks the transport, see
    `_mesh_transport`) on a group of `world` ranks started by
    `parallel/distributed.launch`, bounded by `mesh_timeout`. Returns (the summary, every rank's
    result as `mesh_rank` returns it)."""
    from xchu_slam_tpu_torch.parallel import distributed

    backend, device = _mesh_transport(world, kwargs.get("device", "cuda"))
    timeout = mesh_timeout(_mesh_scans(command, kwargs))
    ranks = distributed.launch(world, "xchu_slam_tpu_torch.cli:mesh_rank", (command, kwargs),
                               backend=backend, device=device, timeout_s=timeout,
                               setup="xchu_slam_tpu_torch.cli:mesh_rank_setup")
    inline = [r["summary"].get("inline_renders") for r in ranks]
    return _mesh_summary(ranks[0]["summary"], [r["pose_hash"] for r in ranks], backend,
                         inline), ranks


def _join_torchrun(command: str, kwargs: dict, world: int) -> None:
    """This process's rank of a group that torchrun started: join it, run
    the whole session over it, compare every rank's pose hash in one
    collective; rank 0 prints the summary."""
    from xchu_slam_tpu_torch.parallel import distributed
    from xchu_slam_tpu_torch.utils import collectives

    backend, device = _mesh_transport(world, kwargs.get("device", "cuda"))
    size = int(os.environ["WORLD_SIZE"])
    if size != world:
        raise SystemExit(f"--mesh {world}: torchrun started {size} ranks")
    if device == "cuda":
        device = None if backend == "nccl" else "cuda:0"
    # forked before the group touches CUDA, closed however the rank ends
    source = mesh_rank_setup(command, kwargs)
    try:
        mesh = distributed.initialize(backend, device=device,
                                      timeout_s=distributed.GROUP_TIMEOUT_S)
        try:
            mine = mesh_rank(mesh, command, kwargs, source)
            # the pose hash (2 int32) and the inline renders, of every rank
            row = np.append(np.frombuffer(bytes.fromhex(mine["pose_hash"]), np.int32),
                            np.int32(mine["summary"].get("inline_renders", 0)))
            every = collectives.shard_allgather(torch.from_numpy(row)[None].to(mesh.device),
                                                mesh).cpu().numpy()
            summary = _mesh_summary(mine["summary"], [r[:2].tobytes().hex() for r in every],
                                    backend, [int(r[2]) for r in every])
        finally:
            torch.distributed.destroy_process_group()
    finally:
        if source is not None:
            source.close()
    if mesh.rank == 0:
        print(json.dumps(summary, indent=2))
        print(mine["timers"], file=sys.stderr)


def _cmd_on_mesh(command: str, kwargs: dict, world: int) -> None:
    """`--mesh N` with N > 1: join torchrun's group where its variables are
    set, else launch N ranks; print rank 0's summary and timers."""
    if os.environ.get("WORLD_SIZE"):
        _join_torchrun(command, kwargs, world)
        return
    summary, ranks = run_on_mesh(command, kwargs, world)
    print(json.dumps(summary, indent=2))
    print(ranks[0]["timers"], file=sys.stderr)


def localize_sim(session: str, queries: int = 12, scans: int = 0,
                 radius: float = 55.0, seed: int = 0, query_seed: int = 99,
                 fitness_thresh: float | None = None, device: str = "cuda",
                 trajectory: str | None = None) -> dict:
    """Localize `queries` fresh scans, rendered along the mapping run's
    trajectory in its world (pass that run's scans / radius / seed, or its
    TUM `trajectory` file / scans / seed) with independent noise, against
    the session saved in checkpoint `session`."""
    from xchu_slam_tpu_torch.models.relocalize import localizer_from_checkpoint
    from xchu_slam_tpu_torch.utils import sim

    _check_device(device)
    loc = localizer_from_checkpoint(session, device=device)
    if fitness_thresh is not None:
        # ICP fitness is density-dependent; single-scan-vs-submap refinement
        # may need a looser gate than the session's in-run loop gate
        loc.cfg = loc.cfg.override({"loop.icp_fitness_thresh": fitness_thresh})
    _stamps, gt, world = _sim_world_and_traj(scans, radius, seed, trajectory)
    index = _world_index(world, trajectory)
    gt_rel = _gt_in_map_frame(gt)   # the session's odometry starts at gt[0]

    qi = np.linspace(0, len(gt) - 1, queries).round().astype(int)
    rng = np.random.default_rng(query_seed)
    rows, errs = [], []
    for i in qi:
        xyz, inten = sim.render_scan(world, gt[i], rng, n_points=24_000, index=index)
        r = loc.localize(xyz, inten)
        row = {"query_pose_idx": int(i), "found": r.found, "kf_idx": r.kf_idx,
               "sc_dist": round(r.sc_dist, 4) if np.isfinite(r.sc_dist) else None,
               "icp_fitness": round(r.icp_fitness, 4)
               if np.isfinite(r.icp_fitness) else None}
        if r.found:
            err = float(np.linalg.norm(r.pose[:3] - gt_rel[i, :3, 3]))
            row["pos_err_m"] = round(err, 3)
            errs.append(err)
        rows.append(row)
    found = sum(r["found"] for r in rows)
    return {
        "session": session,
        "queries": len(rows),
        "localized": found,
        "success_rate": round(found / max(len(rows), 1), 3),
        "mean_err_m": round(float(np.mean(errs)), 3) if errs else None,
        "median_err_m": round(float(np.median(errs)), 3) if errs else None,
        "results": rows,
    }


def cmd_localize(args):
    print(json.dumps(localize_sim(args.session, args.queries, args.scans,
                                  args.radius, args.seed, args.query_seed,
                                  args.fitness_thresh, args.device, args.trajectory),
                     indent=2))


def evaluate(est: str, gt: str, gt_format: str = "tum", t_max_diff: float = 0.05,
             scan_dt: float = 0.1) -> dict:
    """APE / RPE / drift between a TUM trajectory file `est` and a ground
    truth file `gt` (TUM, or KITTI 12-float rows, one per scan),
    timestamp-associated."""
    from xchu_slam_tpu_torch.io import kitti
    from xchu_slam_tpu_torch.utils import metrics

    s1, est_T = kitti.read_tum(est)
    if gt.endswith(".txt") and gt_format == "kitti":
        gt_T = kitti.read_kitti_poses(gt)
        s2 = np.arange(len(gt_T), dtype=np.float64)
        s1 = np.round(np.asarray(s1) / scan_dt)  # stamp → scan index
    else:
        s2, gt_T = kitti.read_tum(gt)
    ei, gi = metrics.associate(s1, s2, max_diff=t_max_diff)
    if len(ei) < 2:  # stamps not comparable → positional fallback
        ei = gi = np.arange(min(len(est_T), len(gt_T)))
    est_T, gt_T = est_T[ei], gt_T[gi]
    drift, length = metrics.end_drift(est_T[:, :3, 3], gt_T[:, :3, 3])
    return {
        "pairs": int(len(ei)),
        "ape_rmse_m": round(metrics.ape_rmse(est_T[:, :3, 3], gt_T[:, :3, 3]), 4),
        "rpe_rmse_m": round(metrics.rpe_rmse(est_T, gt_T), 4),
        "end_drift_m": round(drift, 3),
        "length_m": round(length, 1),
        "drift_pct": round(100.0 * drift / max(length, 1e-9), 3),
    }


def cmd_eval(args):
    print(json.dumps(evaluate(args.est, args.gt, args.gt_format,
                              args.t_max_diff, args.scan_dt), indent=2))


def cmd_info(args):
    from xchu_slam_tpu_torch import __version__
    from xchu_slam_tpu_torch.config import default_config

    print(json.dumps({
        "version": __version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "devices": [torch.cuda.get_device_name(i)
                    for i in range(torch.cuda.device_count())],
        "default_config": json.loads(default_config().to_json()),
    }, indent=2))


def _add_device(parser):
    parser.add_argument("--device", default="cuda", help="torch device (cuda, cpu)")


def _chunk_range(text: str) -> tuple:
    """"A:B" → (A, B)."""
    try:
        a, b = (int(x) for x in text.split(":"))
    except ValueError:
        raise argparse.ArgumentTypeError(f"{text!r} is not A:B") from None
    return a, b


def _add_trace_chunks(parser):
    parser.add_argument("--trace-chunks", type=_chunk_range, default=None, metavar="A:B",
                        help="trace chunks A to B - 1 of the device engine into "
                        "<out>/trace.json: kernels and the program's spans")


def main(argv=None):
    p = argparse.ArgumentParser(prog="xchu_slam_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("run-sim", help="run SLAM on the synthetic circuit, or along "
                        "a TUM trajectory (--trajectory)")
    ps.add_argument("--scans", type=int, default=0,
                    help="scans (0 = 400 on the circuit, the whole file with --trajectory)")
    ps.add_argument("--radius", type=float, default=55.0)
    ps.add_argument("--trajectory", default=None, metavar="TUM_FILE",
                    help="TUM camera-frame trajectory file: simulate the scans along it "
                    "in a corridor world")
    ps.add_argument("--realism", action="store_true",
                    help="beam-level sensor model (64 beams, per-ray occlusion, dropout, "
                    "radial noise, attenuated intensity) and moving traffic")
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--loop-method", default="sc",
                    choices=["sc", "isc", "radius", "none"])
    ps.add_argument("--out", default="out/sim")
    ps.add_argument("--gps", action="store_true",
                    help="altitude GPS factors from a synthetic noisy "
                    "altimeter with dropouts")
    ps.add_argument("--imu", action="store_true",
                    help="IMU-integrated NDT guess from simulated gyro/accel")
    ps.add_argument("--wheel", action="store_true",
                    help="wheel-odometry NDT guess from simulated twist")
    ps.add_argument("--checkpoint-every", type=int, default=0,
                    help="write <out>/checkpoint.npz every N scans (the device "
                    "engine: at chunk boundaries, every max(N // 16, 1) × 16 scans)")
    ps.add_argument("--continue-session", default=None, metavar="CHECKPOINT",
                    help="continue a saved device-engine session (needs --engine "
                    "device; the checkpoint's config governs the run)")
    ps.add_argument("--verbose", action="store_true")
    ps.add_argument("--engine", default="host", choices=["host", "device"],
                    help="host: per-scan host-orchestrated engine; device: the "
                    "every-scan half on the card with no readback, chunked ingest")
    ps.add_argument("--chunk", type=int, default=16,
                    help="scans per staged chunk for --engine device")
    ps.add_argument("--prefetch-depth", type=int, default=2,
                    help="staged chunks in flight ahead of the engine "
                    "(--engine device)")
    ps.add_argument("--prefetch-threads", type=int, default=2,
                    help="staging threads; they also render the scans unless "
                    "--render-procs (--engine device)")
    ps.add_argument("--render-procs", type=int, default=0,
                    help="render the scans in N forked worker processes, started "
                    "before the run's first CUDA call (--engine device; 0 = in the "
                    "staging threads; with --mesh, N for each rank)")
    ps.add_argument("--mesh", type=int, default=0,
                    help="run the device engine as one session over N ranks: state "
                    "replicated, NDT points / SC and ISC database / ICP correspondences "
                    "/ pose-graph factors sharded (0 or 1 = single device)")
    # a flag of the reference's run-sim that is named, so that it is refused
    # by name
    ps.add_argument("--sync-every", default=None, help=argparse.SUPPRESS)
    _add_trace_chunks(ps)
    _add_device(ps)
    ps.add_argument("--set", action="append", default=[], metavar="key=value",
                    help="config override, e.g. --set ndt.resolution=1.0")
    ps.set_defaults(fn=cmd_run_sim)

    pk = sub.add_parser("run-kitti", help="run SLAM on KITTI velodyne scans")
    pk.add_argument("--velodyne-dir", required=True)
    pk.add_argument("--gt", default=None, help="KITTI pose file (camera frame, a row "
                    "a scan) for the ATE")
    pk.add_argument("--out", default="out/kitti")
    pk.add_argument("--max-scans", type=int, default=0)
    pk.add_argument("--engine", default="host", choices=["host", "device"])
    pk.add_argument("--no-defer-sync", action="store_true",
                    help="the host engine waits for each scan's results before "
                    "the next scan")
    pk.add_argument("--verbose", action="store_true")
    pk.add_argument("--mesh", type=int, default=0,
                    help="run the device engine as one session over N ranks (0 or 1 = "
                    "single device; needs --engine device)")
    _add_trace_chunks(pk)
    _add_device(pk)
    pk.add_argument("--set", action="append", default=[], metavar="key=value",
                    help="config override, e.g. --set ndt.resolution=1.0")
    pk.set_defaults(fn=cmd_run_kitti)

    pe = sub.add_parser("eval", help="APE/RPE between trajectories "
                        "(timestamp-associated, like evo)")
    pe.add_argument("--est", required=True)
    pe.add_argument("--gt", required=True)
    pe.add_argument("--gt-format", default="tum", choices=["tum", "kitti"])
    pe.add_argument("--t-max-diff", type=float, default=0.05,
                    help="max timestamp difference for association (s)")
    pe.add_argument("--scan-dt", type=float, default=0.1,
                    help="scan period for KITTI-format GT (maps est stamps "
                    "to scan indices)")
    pe.set_defaults(fn=cmd_eval)

    pl = sub.add_parser("localize", help="multi-session place recognition: "
                        "localize fresh scans against a saved session's map "
                        "(checkpoint.npz from run-sim --checkpoint-every)")
    pl.add_argument("--session", required=True,
                    help="checkpoint .npz of the mapped session")
    pl.add_argument("--queries", type=int, default=12,
                    help="number of query poses sampled along the trajectory")
    pl.add_argument("--scans", type=int, default=0,
                    help="trajectory length (match the mapping run)")
    pl.add_argument("--radius", type=float, default=55.0,
                    help="circuit radius (match the mapping run)")
    pl.add_argument("--trajectory", default=None, metavar="TUM_FILE",
                    help="TUM trajectory file (match the mapping run)")
    pl.add_argument("--seed", type=int, default=0,
                    help="world seed (must match the mapping run)")
    pl.add_argument("--query-seed", type=int, default=99,
                    help="sensor-noise seed for the query scans")
    pl.add_argument("--fitness-thresh", type=float, default=None,
                    help="override the ICP verification gate (fitness is "
                    "density-dependent; sim clouds need ~1.2-1.5)")
    _add_device(pl)
    pl.set_defaults(fn=cmd_localize)

    pi = sub.add_parser("info", help="version / devices / config")
    pi.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    if args.cmd in ("run-sim", "run-kitti"):
        if args.mesh < 0:
            p.error("--mesh must be >= 0")
        if args.mesh > 1 and args.engine != "device":
            p.error("--mesh needs --engine device: the host engine runs on one device")
        if getattr(args, "sync_every", None):
            p.error("--sync-every is not ported yet")
        if args.trace_chunks is not None:
            a, b = args.trace_chunks
            if not 0 <= a < b:
                p.error("--trace-chunks A:B needs 0 <= A < B")
            if args.engine != "device" or args.mesh > 1:
                p.error("--trace-chunks traces the device engine on one device")
    if args.cmd == "run-sim":
        if args.continue_session and args.engine != "device":
            p.error("--continue-session requires --engine device")
        if args.render_procs and args.engine != "device":
            p.error("--render-procs requires --engine device: the host engine draws "
                    "every scan from one shared generator")
        if args.render_procs < 0:
            p.error("--render-procs must be >= 0")
    if args.cmd == "run-sim" and args.engine == "device":
        if args.chunk < 1 or args.prefetch_depth < 1 or args.prefetch_threads < 1:
            p.error("--chunk, --prefetch-depth and --prefetch-threads must be >= 1")
    args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
