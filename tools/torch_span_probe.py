#!/usr/bin/env python3
"""What the device engine's spans cost on one GPU, and one traced slice of
the run-sim circuit.

    python3 tools/torch_span_probe.py [--scans 386] [--pairs 3] \
        [--out out/span_probe] [--device cuda]

1. event nodes: Part A's CUDA graph captured twice on one engine (the
   circuit's first two chunks fed), with its four phase events and without
   (`DeviceSlamPipeline._capture(phase_events=False)`), both over the same
   inputs, replayed in turns (with, without, without, with), `REPLAYS`
   replays between one pair of CUDA events, `ROUNDS` rounds: device µs a
   replay each, and their difference.
2. recording: whole sessions of the circuit's first `--scans` scans
   (rendered once, up front), a new engine a session fed by
   `DeviceChunkPrefetcher`, `finalize` and the keyframe trajectory read
   back, `--pairs` rounds in turns without `profiling.recording()`, inside
   it, and inside it with Part B's stages left without timing events:
   scans/s each.
3. trace: `cli.run_sim` of `TRACE_SCANS` scans with `trace_chunks` =
   `TRACE_CHUNKS` into `--out`: the trace file's kernel and program-span
   events, and `idle_by_span`'s sum against the trace's idle time. The
   trace is kept gzipped where it is under `KEEP_BYTES`.

Prints a line a phase and, last, one JSON line with every number, the
card's name and power limit first. `--device cpu` rehearses the script at
a small `--scans` (phase 1 needs a card and is left out there).
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from xchu_slam_tpu_torch import cli  # noqa: E402
from xchu_slam_tpu_torch.io.prefetch import ChunkStager, DeviceChunkPrefetcher  # noqa: E402
from xchu_slam_tpu_torch.models import device_pipeline as tdp  # noqa: E402
from xchu_slam_tpu_torch.types import Cloud  # noqa: E402
from xchu_slam_tpu_torch.utils import profiling, sim  # noqa: E402

CHUNK, REPLAYS, ROUNDS = 16, 50, 8
TRACE_SCANS, TRACE_CHUNKS = 464, (24, 27)     # the first lap's end: loops close there
KEEP_BYTES = 20 << 20


def _card() -> dict:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        out = f"nvidia-smi: {exc}"
    return {"card": out, "torch": torch.__version__, "cuda": torch.version.cuda}


def _scans(n: int) -> tuple[list, np.ndarray]:
    stamps, gt, world = cli._sim_world_and_traj(n, 55.0, 0)
    lazy = sim.RenderedScans(world, gt, seed=0, n_points=24_000)
    return [lazy[i] for i in range(n)], stamps


def event_nodes(scans: list, device: str) -> dict:
    """Device µs a replay of Part A's graph with its phase events and
    without, on one engine and the same inputs."""
    cfg = cli.sim_config()
    pipe = tdp.DeviceSlamPipeline(cfg, log_capacity=8192, device=device)
    stager = ChunkStager(cfg.filter.max_raw_points, CHUNK, n_buffers=2, device=device)
    for c in range(2):
        clouds, n_real = stager.stage(scans[c * CHUNK:(c + 1) * CHUNK])
        pipe.process_chunk(clouds, 0.1 * (c * CHUNK + np.arange(CHUNK)), n_real)
    torch.cuda.synchronize()
    # the first graph's event nodes name its events: they live as long as it
    with_ev, inputs, keep = pipe._graph, pipe._in, (pipe._out, pipe._phase_events)
    pipe._capture(Cloud(*(t[0] for t in clouds)), None, phase_events=False)
    without = pipe._graph
    tdp._assign(pipe._in, inputs)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def us(graph) -> float:
        start.record()
        for _ in range(REPLAYS):
            graph.replay()
        end.record()
        end.synchronize()
        return 1e3 * start.elapsed_time(end) / REPLAYS

    us(with_ev), us(without)
    got = {"with": [], "without": []}
    for _ in range(ROUNDS):
        got["with"].append(us(with_ev))
        got["without"].append(us(without))
        got["without"].append(us(without))
        got["with"].append(us(with_ev))
    torch.cuda.synchronize()
    del with_ev, without
    del keep
    med = {k: float(np.median(v)) for k, v in got.items()}
    return {"replays_a_reading": REPLAYS, "readings": {k: [round(x, 3) for x in v]
                                                      for k, v in got.items()},
            "with_us": round(med["with"], 3), "without_us": round(med["without"], 3),
            "nodes_us_a_replay": round(med["with"] - med["without"], 3)}


def _session(scans: list, stamps: np.ndarray, device: str) -> float:
    cfg = cli.sim_config()
    t0 = time.perf_counter()
    pipe = tdp.DeviceSlamPipeline(cfg, log_capacity=8192, device=device)
    base = 0
    with DeviceChunkPrefetcher(scans, capacity=cfg.filter.max_raw_points, chunk=CHUNK,
                               depth=2, threads=2, device=device) as pf:
        for clouds, n_real in pf:
            idx = np.minimum(base + np.arange(CHUNK), len(scans) - 1)
            pipe.process_chunk(clouds, stamps[idx], n_real)
            base += n_real
    pipe.finalize()
    pipe.keyframe_trajectory()
    return len(scans) / (time.perf_counter() - t0)


def _host_spans_only(spans, name: str):
    """`device_pipeline._span` without Part B's timing events."""
    return tdp.contextlib.nullcontext() if spans is None else spans.span(name)


def recording(scans: list, stamps: np.ndarray, pairs: int, device: str) -> dict:
    """Whole sessions in turns without `profiling.recording()` ("off"),
    inside it ("on") and inside it with Part B's stages left without timing
    events ("on_host")."""
    _session(scans[:2 * CHUNK], stamps, device)        # warm: every graph captured once
    modes = ("off", "on", "on_host")
    got = {m: [] for m in modes}
    span = tdp._span
    for i in range(pairs):
        for mode in modes[i % 3:] + modes[:i % 3]:
            if mode == "off":
                got[mode].append(_session(scans, stamps, device))
                continue
            tdp._span = span if mode == "on" else _host_spans_only
            try:
                with profiling.recording() as rec:
                    got[mode].append(_session(scans, stamps, device))
            finally:
                tdp._span = span
            records, dropped = len(rec.records), rec.dropped
    med = {k: float(np.median(v)) for k, v in got.items()}
    return {"scans": len(scans), "scans_per_s": {k: [round(x, 2) for x in v]
                                                 for k, v in got.items()},
            **{f"{k}_median": round(v, 2) for k, v in med.items()},
            "on_over_off": round(med["on"] / med["off"], 4),
            "on_host_over_off": round(med["on_host"] / med["off"], 4),
            "records_a_session": records, "dropped": dropped}


def trace(out: str, scans: int, chunks: tuple, device: str) -> dict:
    """A traced slice of run-sim's device engine, and what its file holds."""
    _pipe, summary = cli.run_sim(scans, 55.0, 0, device, engine="device", chunk=CHUNK,
                                 out=out, trace_chunks=chunks)
    tr = summary["trace"]
    with open(tr["path"]) as f:
        events = json.load(f)["traceEvents"]
    kinds = {}
    for e in events:
        kinds[e.get("cat", "")] = kinds.get(e.get("cat", ""), 0) + 1
    split = sum(tr["idle_by_span"].values())
    size = os.path.getsize(tr["path"])
    kept = None
    if size <= 4 * KEEP_BYTES:
        with open(tr["path"], "rb") as src, gzip.open(tr["path"] + ".gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        if os.path.getsize(tr["path"] + ".gz") <= KEEP_BYTES:
            kept = tr["path"] + ".gz"
        else:
            os.remove(tr["path"] + ".gz")
    for name in os.listdir(out):              # the run's export: not what is measured
        if os.path.join(out, name) != kept:
            os.remove(os.path.join(out, name))
    return {"trace": tr, "events_by_category": kinds, "bytes": size, "kept": kept,
            "kernel_events": kinds.get("kernel", 0),
            "program_span_events": kinds.get("program_span", 0),
            "idle_split_over_idle": round(split / tr["idle_s"], 6) if tr["idle_s"] else None,
            "part_b_stages": summary["part_b_stages"],
            "scans_per_sec": summary["scans_per_sec"], "loops": summary["loops"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scans", type=int, default=386)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--out", default="out/span_probe")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    on_card = args.device != "cpu"
    rec = _card() if on_card else {"card": "cpu"}
    print(json.dumps(rec), flush=True)
    scans, stamps = _scans(args.scans)
    if on_card:
        rec["event_nodes"] = event_nodes(scans, args.device)
        print("event nodes " + json.dumps(rec["event_nodes"]), flush=True)
    rec["recording"] = recording(scans, stamps, args.pairs, args.device)
    print("recording " + json.dumps(rec["recording"]), flush=True)
    n, chunks = (TRACE_SCANS, TRACE_CHUNKS) if on_card else (args.scans, (1, 2))
    rec["trace"] = trace(args.out, n, chunks, args.device)
    print("trace " + json.dumps(rec["trace"]), flush=True)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
