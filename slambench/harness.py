"""The benchmark of xchu_slam_tpu_torch's device engine: one cell a run.

A cell (`BENCHMARK.json`'s `workloads`) names a configuration
(`configs/<config>.json`: the program's settings, world, route, sensor and
the K or N of each mix), a traffic mix (`traffic/<mix>.json`) and, through
`BENCHMARK.json`, its metrics (`metrics/<metric>.py`, one reader each). A
cell's limits of correctness are `limits/<cell>.json`. Nothing here names a
cell, a configuration, a mix or a metric: adding one is adding its files and
its entries.

A run: set-up (the lap rendered by spawned workers while the card starts,
the sensor feeds that the configuration turns on drawn along the session
(`gen/feeds.py`), the window's scans drawn from the lap, one short warm
session of the cell's own shapes), then the measured window (whole sessions
back to back, every one handed the same drawn scans and feeds, each a new
`DeviceSlamPipeline` fed by a
`DeviceChunkPrefetcher` in a closed loop, a `finalize` and the optimized
keyframe trajectory read back at its end), then, with the window closed,
the peak memory read, the program's state freed and session 0 judged
against the plain reference (`reference/check.py`). With `trace` the
profiler records a fixed slice of session 0's chunks.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

SB = Path(__file__).resolve().parent
ROOT = SB.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "xchu_slam_tpu")
WARM_CHUNKS = 8          # the warm session: every graph of Part A and Part B is captured
WARM_SESSION = 2 ** 32 - 1   # its noise stream, apart from the window's
DRAW_THREADS = 6         # set-up's threads drawing the window's scans


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list
    limits: dict


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def metric_module(name: str, root: Path = ROOT):
    """The reader of metric `name`: `slambench/metrics/<name>.py` under
    `root`, dots and dashes as underscores."""
    mod = name.replace(".", "_").replace("-", "_")
    path = root / "slambench" / "metrics" / f"{mod}.py"
    key = f"slambench.metrics.{mod}"
    if root == ROOT:
        return importlib.import_module(key)
    spec = importlib.util.spec_from_file_location(f"{key}@{root}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell `name` of `BENCHMARK.json`, its files found by name."""
    bench = load_benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "slambench" / "traffic" / f"{w['traffic']}.json").read_text())
    mix.update(config["mixes"][w["traffic"]])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}

    def applies(m):
        return name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names

    per_layer = [m for m in bench["per_layer"] if applies(m)]
    limits = json.loads((root / "slambench" / "limits" / f"{name}.json").read_text())
    return Cell(name=name, chips=w["chips"], config=config, mix=mix, end_to_end=e2e,
                per_layer=per_layer, limits=limits)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not load,
    each compared whole (`xchu_slam_tpu_torch` is not `xchu_slam_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def program_config(config: dict, extra: dict | None = None):
    """The port's SlamConfig: its defaults with every key of the
    configuration's `program` entry (and `extra`) set."""
    from xchu_slam_tpu_torch.config import default_config

    keys = dict(config["program"])
    keys.update(extra or {})
    cfg = default_config()
    known = dataclasses.asdict(cfg)
    for k in keys:
        sec, _, field = k.partition(".")
        if sec not in known or field not in known[sec]:
            raise ValueError(f"the program has no setting {k!r}")
    return cfg.override(keys)


# ---------------------------------------------------------------- sessions --
@dataclasses.dataclass
class Session:
    index: int
    n_scans: int
    chunks: list = dataclasses.field(default_factory=list)   # dicts, in order
    finalize_s: float | None = None
    complete: bool = False
    pipe: object = None
    record: dict | None = None
    stage_seconds: dict | None = None
    counts: dict | None = None
    start_s: float | None = None

    def summary(self) -> str:
        lat = [1e3 * c["latency_s"] for c in self.chunks]
        med = float(np.median(lat)) if lat else float("nan")
        first = lat[0] if lat else float("nan")
        fin = "-" if self.finalize_s is None else f"{1e3 * self.finalize_s:.1f} ms"
        return (f"session {self.index}: {sum(c['n'] for c in self.chunks)} of {self.n_scans} "
                f"scans, {len(self.chunks)} chunks, start {1e3 * (self.start_s or 0):.1f} ms, "
                f"first chunk {first:.1f} ms, median "
                f"{med:.1f} ms, finalize {fin}, {self.counts}")


class Driver:
    """Sessions of the cell's traffic through the program, in a closed loop."""

    def __init__(self, cell: Cell, seed: int, lap: list, device: str, prog_overrides=None):
        from slambench.gen import drive, feeds

        self.cell, self.seed, self.lap, self.device = cell, seed, lap, device
        self.cfg = program_config(cell.config, prog_overrides)
        self.engine = cell.config["engine"]
        self.lap_index = drive.session_lap_index(cell.mix, len(lap))
        self.period = cell.config["route"]["scan_period_s"]
        self.chunk = self.engine["chunk"]
        # the sensor feeds of every session (each hands in the same scans),
        # None where the configuration turns no mode on
        self.feeds = feeds.session_feeds(
            cell.config, dict(cell.config["program"], **(prog_overrides or {})),
            drive.lap_poses(cell.config["route"])[self.lap_index], seed)

    def feed_args(self, idx: np.ndarray) -> dict:
        """`process_chunk`'s keyword arguments for the chunk's slots `idx`:
        the altitudes and the windows of each mode that is on, none where
        every mode is off."""
        f = self.feeds
        if f is None:
            return {}
        from xchu_slam_tpu_torch.models.device_pipeline import GuessWindows
        from xchu_slam_tpu_torch.ops.imu import ImuWindow, OdomWindow

        out = {}
        if f.gps_alts is not None:
            out["gps_alts"] = f.gps_alts[idx]
        if f.imu is not None or f.wheel is not None:
            out["wins"] = GuessWindows(
                imu=None if f.imu is None else ImuWindow(*(a[idx] for a in f.imu)),
                wheel=None if f.wheel is None else OdomWindow(*(a[idx] for a in f.wheel)))
        return out

    def scans(self, session: int):
        from slambench.gen import drive

        return drive.SessionScans(self.lap, self.lap_index, self.cell.mix["range_noise_m"],
                                  self.seed, session)

    def run_session(self, s: Session, deadline: float | None, source, on_chunk=None,
                    max_chunks: int | None = None) -> None:
        """Feed session `s` chunk by chunk until it ends, or until a chunk
        returns after `deadline` (then it is not counted and the session
        stops there). Finalizes a session whose every chunk came back by the
        deadline, and reads its optimized keyframe trajectory back."""
        from xchu_slam_tpu_torch.io.prefetch import DeviceChunkPrefetcher
        from xchu_slam_tpu_torch.models.device_pipeline import DeviceSlamPipeline

        t_start = time.perf_counter()
        n = s.n_scans
        stamps = self.period * np.arange(n)
        s.pipe = pipe = DeviceSlamPipeline(self.cfg, kf_points=self.engine["kf_points"],
                                           log_capacity=max(n, 8192), device=self.device)
        n_chunks = -(-n // self.chunk) if max_chunks is None else max_chunks
        with DeviceChunkPrefetcher(source, capacity=self.cfg.filter.max_raw_points,
                                   chunk=self.chunk, depth=self.engine["prefetch_depth"],
                                   threads=self.engine["prefetch_threads"],
                                   device=self.device) as pf:
            it = iter(pf)
            base = 0
            s.start_s = time.perf_counter() - t_start
            for ci in range(n_chunks):
                if on_chunk is not None:
                    on_chunk(s, ci, "before")
                tw = time.perf_counter()
                clouds, n_real = next(it)
                td = time.perf_counter()
                idx = np.minimum(base + np.arange(clouds.xyz.shape[0]), n - 1)
                pipe.process_chunk(clouds, stamps[idx], n_real, **self.feed_args(idx))
                tr = time.perf_counter()
                late = deadline is not None and tr > deadline
                s.chunks.append({"first": base, "n": n_real, "wait_s": td - tw,
                                 "latency_s": tr - td, "returned": tr, "late": late})
                base += n_real
                if on_chunk is not None:
                    on_chunk(s, ci, "after")
                if late:
                    s.stage_seconds = dict(pipe.stage_seconds)
                    return
        tf = time.perf_counter()
        pipe.finalize()
        pipe.keyframe_trajectory()
        s.finalize_s = time.perf_counter() - tf
        s.stage_seconds = dict(pipe.stage_seconds)
        s.counts = {"keyframes": pipe.kf_count, "loops": pipe.loop_count,
                    "verifications": pipe.icp_verifications}
        s.complete = True


def _session_record(s: Session, samples_kf: list | None = None) -> dict:
    """What the check reads of session `s`'s finalized pipeline, on the host:
    the odometry log, the keyframe store's poses, the loop table, the
    counters, each keyframe's GPS fix and the keyframe clouds the check
    samples."""
    pipe = s.pipe
    rows = np.array([[*r["pose"], r["iterations"], r["fitness"], r["matched_frac"],
                      float(r["keyframe"]), r["stamp"], r["loop_cand"], float(r["loop_found"]),
                      r["loop_icp_fitness"], r["loop_icp_correction"],
                      float(r["loop_verify_ran"])] for r in pipe.odom_log], np.float64)
    stamps, kf_odo, kf_opt = pipe.keyframe_trajectory()
    L = pipe.loop_count
    g = pipe.graph
    rec = {"scans_fed": sum(c["n"] for c in s.chunks), "rows": rows,
           "kf_stamps": np.asarray(stamps, np.float64), "kf_poses": np.asarray(kf_odo),
           "kf_opt": np.asarray(kf_opt), "loop_count": L,
           "loop_i": g.loop_i[:L].cpu().numpy(), "loop_j": g.loop_j[:L].cpu().numpy(),
           "loop_T": g.loop_T[:L].cpu().numpy(), "loop_info": g.loop_info[:L].cpu().numpy(),
           "gps_alt": g.gps_alt[:pipe.kf_count].cpu().numpy(),
           "gps_mask": g.gps_mask[:pipe.kf_count].cpu().numpy(),
           "kf_count": pipe.kf_count, "scan_count": pipe.scan_count,
           "icp_verifications": pipe.icp_verifications, "kf_clouds": {}}
    for k in samples_kf or []:
        if k < pipe.kf_count:
            rec["kf_clouds"][k] = (pipe.db.clouds[k].cpu().numpy().copy(),
                                   pipe.db.cloud_mask[k].cpu().numpy().copy())
    return rec


# ------------------------------------------------------------------- trace --
class TraceSlice:
    """torch.profiler over chunks [first, first + count) of session 0, with
    the program's counters read at both ends (a readback each: this run's
    end-to-end numbers are not reported)."""

    def __init__(self, first: int, count: int, device: str):
        self.first, self.last = first, first + count
        self.device = device
        self.prof = None
        self.t = [None, None]
        self.counters = [None, None]
        self.scans = [None, None]
        self.done = False

    def __call__(self, s: Session, ci: int, when: str) -> None:
        if s.index != 0 or self.done:
            return
        if when == "before" and ci == self.first:
            self._mark(0, s)
            import torch

            self.prof = torch.profiler.profile(activities=self._activities())
            self.prof.__enter__()
            self.t[0] = time.perf_counter()
        elif when == "after" and ci == self.last - 1 and self.prof is not None:
            import torch

            if self.device != "cpu":
                torch.cuda.synchronize()
            self.t[1] = time.perf_counter()
            self.prof.__exit__(None, None, None)
            self._mark(1, s)
            self.done = True

    def _activities(self):
        return _activities(self.device)

    def _mark(self, i: int, s: Session) -> None:
        import torch

        if self.device != "cpu":
            torch.cuda.synchronize()
        self.counters[i] = program_counters()
        self.scans[i] = sum(c["n"] for c in s.chunks)

    def summary(self) -> dict | None:
        """Kernel time by name, busy time (the union of kernel intervals),
        the slice's wall time, the longest idle gaps labelled by the host
        call in progress, and the counters' differences."""
        if not self.done:
            return None
        from slambench import tracing

        out = tracing.reduce(self.prof, self.t[1] - self.t[0])
        out["counters"] = {k: self.counters[1][k] - self.counters[0][k]
                           for k in self.counters[0]}
        out["scans"] = (self.scans[0], self.scans[1])
        return out


def _activities(device: str):
    """On the card the device's activity alone (kernels, copies and the CUDA
    runtime's calls, which label the idle gaps): recording every host
    operator as well slowed the traced slice by ~40 %. On the CPU (the
    tests) the host's."""
    import torch

    act = torch.profiler.ProfilerActivity
    return [act.CPU] if device == "cpu" else [act.CUDA]


def warm_profiler(device: str) -> None:
    """Start and stop the profiler once in set-up, so that its own start-up
    (CUPTI's) is not in the traced slice."""
    import torch

    with torch.profiler.profile(activities=_activities(device)):
        x = torch.ones(16, device=device)
        (x + 1).sum().item()


def program_counters() -> dict:
    """The program's own counters: kernel launches by wrapper and live ICP
    trips (one readback)."""
    from xchu_slam_tpu_torch.ops import icp
    from xchu_slam_tpu_torch.ops.cuda import (guess_kernel, icp_kernel, ndt_kernel, nn_kernel,
                                              pgo_kernel)

    return {"nn": nn_kernel.launches, "ndt": ndt_kernel.launches,
            "icp_step": icp_kernel.launches, "pgo": pgo_kernel.launches,
            "guess": guess_kernel.launches, "icp_live_trips": icp.live_trip_count()}


# --------------------------------------------------------------------- run --
def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", prog_overrides: dict | None = None, lap: list | None = None,
        check_mode: str = "program", log=print) -> dict:
    """One run of `cell`; returns the result's fields and the check's
    numbers. `lap` (the tests') replaces the rendered lap; `check_mode`
    "control" judges the reference's lower-precision control in the
    program's place as well."""
    from slambench.gen import drive
    from slambench.reference import check

    seed = int(seed) % (1 << 63)
    render = None
    if lap is None:
        render = drive.LapRender(cell.config, seed)
    import torch

    import xchu_slam_tpu_torch  # noqa: F401  (its TF32 switches)

    if device != "cpu":
        torch.cuda.set_device(0)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    if trace:
        warm_profiler(device)
    if render is not None:
        lap = render.result()
        log(f"set-up: lap of {len(lap)} scans rendered in {render.seconds:.2f} s")
    drv = Driver(cell, seed, lap, device, prog_overrides)
    n = len(drv.lap_index)
    td = time.perf_counter()
    window_scans = drv.scans(0).drawn(DRAW_THREADS)
    log(f"set-up: the window's {n} scans drawn in {time.perf_counter() - td:.2f} s")

    # the warm session: the cell's own shapes, every graph captured once
    warm = Session(-1, n)
    tw = time.perf_counter()
    drv.run_session(warm, None, drv.scans(WARM_SESSION), max_chunks=min(WARM_CHUNKS,
                                                                        -(-n // drv.chunk)))
    warm.pipe.finalize()
    warm.pipe = None
    if device != "cpu":
        torch.cuda.synchronize()
    log(f"set-up: warm session of {sum(c['n'] for c in warm.chunks)} scans "
        f"{time.perf_counter() - tw:.2f} s")
    gc.collect()
    counters0 = program_counters()
    tracer = None
    if trace:
        tr = cell.mix["trace"]
        first = int(tr["start_share"] * n) // drv.chunk
        tracer = TraceSlice(first, tr["chunks"], device)

    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    deadline = t0 + seconds
    sessions = []
    while time.perf_counter() < deadline:
        s = Session(len(sessions), n)
        sessions.append(s)
        drv.run_session(s, deadline, window_scans, on_chunk=tracer)
        if s.index > 0:
            s.pipe = None        # only session 0 is judged
    if tracer is not None and tracer.prof is not None and not tracer.done:
        tracer.prof.__exit__(None, None, None)       # the window ended inside the slice
        log("trace: the window ended before the traced slice did")

    # the window has closed: its counters, the peak memory
    if device != "cpu":
        torch.cuda.synchronize()
    counters1 = program_counters()
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    s0 = sessions[0]
    if not s0.complete:
        # cut by the window: finalized now, outside it, for the check
        tf = time.perf_counter()
        s0.pipe.finalize()
        s0.finalize_s = time.perf_counter() - tf
    plan = check.plan(cell, seed, s0.pipe.kf_count)
    s0.record = _session_record(s0, plan["keyframes"])
    s0.record["prog_overrides"] = dict(prog_overrides or {})
    s0.pipe = None
    del window_scans
    gc.collect()
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    ctx = {"cell": cell, "seconds": seconds, "setup_s": setup_s, "sessions": sessions,
           "counters": (counters0, counters1),
           "trace": tracer.summary() if tracer is not None else None,
           "config": cell.config, "device": device}

    # judged against the plain reference, the program's state freed
    tc = time.perf_counter()
    scans0 = drv.scans(0)
    verdict = check.judge(cell, seed, s0.record, scans0, drv.lap_index, lap_poses(cell),
                          plan, device, mode=check_mode, feeds=drv.feeds)
    verdict["seconds"] = time.perf_counter() - tc

    ctx["verdict"] = verdict
    for s in sessions:
        log(s.summary())
    window = [c for s in sessions for c in s.chunks if not c["late"]]
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = metric_module(m["name"]).read(ctx)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": verdict["correct"], "attempted": sum(c["n"] for c in window),
           "failed": 0, "metrics": metrics, "device": dev}
    if trace and ctx["trace"] is not None:
        dev["busy_s"] = ctx["trace"]["busy_s"]
        dev["window_s"] = ctx["trace"]["window_s"]
        out["breakdown"] = {"device_ops": ctx["trace"]["device_ops"][:10],
                            "idle_gaps": ctx["trace"]["idle_gaps"][:10]}
    out["check"] = verdict["numbers"]
    return {"result": out, "verdict": verdict, "ctx": ctx}


def lap_poses(cell: Cell) -> np.ndarray:
    from slambench.gen import drive

    return drive.lap_poses(cell.config["route"])
