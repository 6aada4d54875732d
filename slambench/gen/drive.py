"""The drive generator: one closed lap rendered in set-up, then sessions of
scans drawn from it with fresh range noise.

A configuration's file names its world, its route and its sensor; a traffic
mix's file names the kind of session (`laps`: K laps of the closed lap;
`segments`: the lap's first N scans) and the range noise, with K or N taken
from the configuration's `mixes` entry for that mix. Everything is a pure
function of the seed:

- the world comes from the configuration's own world seed (every run maps the
  same streets, so every seed does the same amount of work);
- scan k of the lap is rendered with a generator seeded from (seed, k);
- scan i of session s is lap scan `lap_index[i]` with every point moved along
  its beam by a draw of N(0, range_noise_m), from a generator seeded from
  (seed, s, i): no two laps hand the program identical scans, and the ground
  truth stays the lap's poses;
- the window's sessions all hand in session 0's scans, drawn in set-up
  (`SessionScans.drawn`), so the window's staging threads only copy arrays
  and every session does the same work.

The lap is rendered by worker processes started with `spawn` (they import
numpy and this package only), each building the world once.
"""

from __future__ import annotations

import concurrent.futures as cf
import multiprocessing
import os
import time

import numpy as np

from slambench.gen import sim

_RENDER, _NOISE = 1, 2          # generator domains: the lap's render, a session's noise
_WORKER: dict = {}


def lap_poses(route: dict) -> np.ndarray:
    """The closed lap of the route: `scan_spacing_m` apart on the squircle of
    `radius_m`, as [L,6] poses; the last scan sits one step before the
    first."""
    per = sim.perimeter(route["radius_m"])
    n = int(round(per / route["scan_spacing_m"]))
    return sim.closed_lap_trajectory(n, radius=route["radius_m"])


def make_world(world: dict):
    """(World, WorldIndex or None) of a configuration's `world` entry."""
    w = sim.make_world(world["seed"], extent=world["extent_m"],
                       n_buildings=world["buildings"], n_pillars=world["pillars"],
                       ground_pts=world["ground_points"],
                       wall_pts_per_face=world["wall_points_per_face"])
    return w, (sim.WorldIndex(w) if world.get("index") else None)


def _init_worker(world: dict, sensor: dict) -> None:
    _WORKER["world"], _WORKER["index"] = make_world(world)
    _WORKER["sensor"] = sensor


def _render_some(seed: int, ks: list, poses: np.ndarray):
    w, index, sensor = _WORKER["world"], _WORKER["index"], _WORKER["sensor"]
    out = []
    for k, pose in zip(ks, poses):
        rng = np.random.default_rng([_RENDER, seed, k])
        out.append(sim.render_scan(w, pose, rng, max_range=sensor["max_range_m"],
                                   min_range=sensor["min_range_m"],
                                   n_points=sensor["points"], noise=sensor["point_noise_m"],
                                   index=index))
    return ks, out


class LapRender:
    """The lap's scans rendered by `workers` spawned processes; `result()`
    waits for them. Started before anything else in set-up, so that the
    render overlaps the card's initialisation."""

    def __init__(self, cfg: dict, seed: int, workers: int | None = None, batch: int = 8):
        self.poses = lap_poses(cfg["route"])
        self.t0 = time.perf_counter()
        workers = workers or max(1, min(6, (os.cpu_count() or 2) - 2))
        ctx = multiprocessing.get_context("spawn")
        self._pool = cf.ProcessPoolExecutor(workers, mp_context=ctx, initializer=_init_worker,
                                            initargs=(cfg["world"], cfg["sensor"]))
        L = len(self.poses)
        self._futs = [self._pool.submit(_render_some, seed, list(range(lo, min(lo + batch, L))),
                                        self.poses[lo:lo + batch])
                      for lo in range(0, L, batch)]
        self.seconds = None

    def result(self) -> list:
        """The lap's scans [(xyz, intensity)] in lap order; shuts the pool."""
        scans = [None] * len(self.poses)
        try:
            for f in self._futs:
                ks, out = f.result()
                for k, s in zip(ks, out):
                    scans[k] = s
        finally:
            self._pool.shutdown(wait=True, cancel_futures=True)
        self.seconds = time.perf_counter() - self.t0
        return scans


def render_lap_inline(cfg: dict, seed: int) -> list:
    """The lap rendered in this process (the tests' small laps)."""
    world, index = make_world(cfg["world"])
    _WORKER.update(world=world, index=index, sensor=cfg["sensor"])
    poses = lap_poses(cfg["route"])
    return _render_some(seed, list(range(len(poses))), poses)[1]


def session_lap_index(mix: dict, n_lap: int) -> np.ndarray:
    """Lap scan of each scan of one session: `laps` runs `laps_per_session`
    whole laps, `segments` the lap's first `scans_per_session` scans."""
    if mix["kind"] == "laps":
        return np.arange(mix["laps_per_session"] * n_lap) % n_lap
    if mix["kind"] == "segments":
        n = mix["scans_per_session"]
        if n > n_lap:
            raise ValueError(f"a segment of {n} scans is longer than the lap ({n_lap})")
        return np.arange(n)
    raise ValueError(f"unknown traffic kind {mix['kind']!r}")


def add_range_noise(xyz: np.ndarray, sigma: float, rng: np.random.Generator) -> np.ndarray:
    """Every point moved along its beam by N(0, sigma)."""
    r = np.linalg.norm(xyz, axis=1)
    e = rng.standard_normal(len(xyz), dtype=np.float32) * np.float32(sigma)
    return (xyz * (1.0 + e / np.maximum(r, 1e-3))[:, None]).astype(np.float32)


class SessionScans:
    """Session `session`'s scans as an indexable sequence: scan i is drawn on
    access (the warm session's and the check's), or all at once by
    `drawn`."""

    def __init__(self, lap: list, lap_index: np.ndarray, sigma: float, seed: int,
                 session: int):
        self.lap, self.lap_index = lap, lap_index
        self.sigma, self.seed, self.session = sigma, seed, session

    def __len__(self) -> int:
        return len(self.lap_index)

    def __getitem__(self, i: int):
        xyz, inten = self.lap[self.lap_index[i]]
        rng = np.random.default_rng([_NOISE, self.seed, self.session, int(i)])
        return add_range_noise(xyz, self.sigma, rng), inten

    def drawn(self, threads: int = 1) -> list:
        """Every scan of the session drawn now, in order, by `threads`
        threads (numpy's draws and array arithmetic release the GIL)."""
        with cf.ThreadPoolExecutor(max(1, threads)) as pool:
            return list(pool.map(self.__getitem__, range(len(self))))
