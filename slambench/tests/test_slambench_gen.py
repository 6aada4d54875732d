"""The generator is a pure function of the seed, its lap cycles seamlessly
and its range noise lies along each beam."""

from __future__ import annotations

import numpy as np
import pytest

from slambench.gen import drive, sim
from slambench.tests import tiny


@pytest.fixture(scope="module")
def small():
    return tiny.cell().config


def test_lap_render_is_a_function_of_the_seed(small):
    a = drive.render_lap_inline(small, 5)
    b = drive.render_lap_inline(small, 5)
    c = drive.render_lap_inline(small, 6)
    assert all(np.array_equal(x[0], y[0]) for x, y in zip(a, b))
    assert not np.array_equal(a[3][0], c[3][0])


def test_spawned_workers_render_the_same_lap(small):
    inline = drive.render_lap_inline(small, 9)
    spawned = drive.LapRender(small, 9, workers=2).result()
    assert len(inline) == len(spawned)
    assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
               for x, y in zip(inline, spawned))


@pytest.mark.parametrize("radius", [12.0, 45.0, 55.0])
def test_lap_cycles_seamlessly(radius):
    poses = drive.lap_poses({"radius_m": radius, "scan_spacing_m": 1.0})
    step = np.linalg.norm(np.diff(poses[:, :2], axis=0), axis=1)
    wrap = np.linalg.norm(poses[0, :2] - poses[-1, :2])
    assert abs(wrap - np.median(step)) < 0.05
    assert abs(len(poses) - sim.perimeter(radius)) < 1.0


def test_sessions_are_seeded_and_laps_differ(small):
    lap = drive.render_lap_inline(small, 1)
    mix = {"kind": "laps", "laps_per_session": 2}
    idx = drive.session_lap_index(mix, len(lap))
    s = drive.SessionScans(lap, idx, 0.02, 2 ** 31 + 12345, 0)
    t = drive.SessionScans(lap, idx, 0.02, 2 ** 31 + 12345, 0)
    u = drive.SessionScans(lap, idx, 0.02, 2 ** 31 + 12345, 1)
    L = len(lap)
    assert np.array_equal(s[7][0], t[7][0])
    assert not np.array_equal(s[7][0], s[7 + L][0]), "two laps hand in the same scan"
    assert not np.array_equal(s[7][0], u[7][0]), "two sessions hand in the same scan"
    # the noise moves each point along its own beam
    base = lap[7][0].astype(np.float64)
    moved = s[7][0].astype(np.float64)
    cross = np.linalg.norm(np.cross(base, moved), axis=1) / np.linalg.norm(base, axis=1) ** 2
    assert np.max(cross) < 1e-5
    dr = np.linalg.norm(moved, axis=1) - np.linalg.norm(base, axis=1)
    assert 0.015 < np.std(dr) < 0.025


def test_drawn_session_is_the_session_drawn_on_access(small):
    lap = drive.render_lap_inline(small, 1)
    idx = drive.session_lap_index({"kind": "laps", "laps_per_session": 2}, len(lap))
    s = drive.SessionScans(lap, idx, 0.02, 2 ** 33 + 7, 0)
    drawn = s.drawn(threads=3)
    assert len(drawn) == len(s)
    assert all(np.array_equal(d[0], s[i][0]) and np.array_equal(d[1], s[i][1])
               for i, d in enumerate(drawn))


def test_segments_stop_before_the_lap_ends():
    assert list(drive.session_lap_index({"kind": "segments", "scans_per_session": 5}, 40)) \
        == [0, 1, 2, 3, 4]
    with pytest.raises(ValueError):
        drive.session_lap_index({"kind": "segments", "scans_per_session": 50}, 40)
