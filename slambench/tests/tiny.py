"""A cell of the benchmark cut to a size the CPU tests can run: a small
world and lap, short sessions, small capacities. Only the tests use it; the
benchmark's cells run at their configurations' sizes."""

from __future__ import annotations

import copy
import time

import pytest

from slambench import harness
from slambench.fusion_run import fusion_config
from slambench.gen import drive

PROGRAM = {"filter.max_points": 1024, "filter.max_raw_points": 4096,
           "pgo.max_keyframes": 128, "loop.submap_points": 1024, "sc.num_exclude_recent": 10}


def cell(name: str = "sim_circuit_sc.segments", fusion: bool = False) -> harness.Cell:
    """`name` at the tests' size; with `fusion` its configuration turns on
    every sensor mode, and the stored fixes are compared exactly."""
    c = harness.load_cell(name)
    cfg = copy.deepcopy(c.config)
    if fusion:
        cfg = fusion_config(cfg)            # ISC loops, the IMU and wheel guess, GPS
        c.limits = copy.deepcopy(c.limits)
        c.limits["numbers"]["gps_mismatch"] = {"limit": 0.0}
    cfg["route"]["radius_m"] = 12.0
    cfg["world"].update(extent_m=30.0, ground_points=20000, wall_points_per_face=800,
                        buildings=10, index=False)
    cfg["sensor"].update(points=3000, max_range_m=30.0)
    cfg["engine"]["kf_points"] = 512
    c.config = cfg
    c.mix["trace"] = {"start_share": 0.0, "chunks": 1}
    if c.mix["kind"] == "laps":
        c.mix["laps_per_session"] = 2
    else:
        c.mix["scans_per_session"] = 32
    return c


def run(c: harness.Cell, seed: int = 20261018, seconds: float = 3.0, trace: bool = False,
        mode: str = "program", lap=None, whole: bool = False) -> dict:
    """One run of `c` on the CPU, skipping the look for a card. With `whole`
    session 0 runs to its end whatever the window, which then closes with
    it: the check judges the same scans however fast the CPU is."""
    lap = drive.render_lap_inline(c.config, seed) if lap is None else lap
    with pytest.MonkeyPatch.context() as mp:
        if whole:
            real = harness.Driver.run_session

            def first_whole(self, s, deadline, *a, **k):
                return real(self, s, None if s.index == 0 else deadline, *a, **k)

            mp.setattr(harness.Driver, "run_session", first_whole)
        return harness.run(c, seed, seconds, trace, time.perf_counter(), device="cpu",
                           prog_overrides=PROGRAM, lap=lap, check_mode=mode,
                           log=lambda m: None)
