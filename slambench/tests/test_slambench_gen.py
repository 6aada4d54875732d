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


# sha256 (first 16 hex digits) of session 0's scans 0-15 and its last, at the
# tests' size and seed 20261018, as the generator drew them before the
# sensor feeds existed
PARENT_SCANS = {"sim_circuit_sc.laps": "78c64284897cdec3",
                "kitti_hdl64_radius.laps": "776c4dfcd38faf4b",
                "sim_circuit_sc.segments": "5a83768d00936839"}


@pytest.mark.parametrize("name", sorted(PARENT_SCANS))
def test_modes_off_feed_nothing_and_draw_the_same_scans(name, monkeypatch):
    import hashlib

    from xchu_slam_tpu_torch.models.device_pipeline import DeviceSlamPipeline

    from slambench import harness

    seed = 20261018
    c = tiny.cell(name)
    lap = drive.render_lap_inline(c.config, seed)
    drv = harness.Driver(c, seed, lap, "cpu", tiny.PROGRAM)
    assert drv.feeds is None
    s = drv.scans(0)
    h = hashlib.sha256()
    for i in list(range(16)) + [len(s) - 1]:
        xyz, inten = s[i]
        h.update(xyz.tobytes())
        h.update(inten.tobytes())
    assert h.hexdigest()[:16] == PARENT_SCANS[name]
    calls = []
    real = DeviceSlamPipeline.process_chunk

    def kept(self, *args, **kw):
        calls.append((len(args), kw))
        return real(self, *args, **kw)

    monkeypatch.setattr(DeviceSlamPipeline, "process_chunk", kept)
    drv.run_session(harness.Session(0, len(s)), None, s, max_chunks=1)
    assert calls == [(3, {})], "with every mode off the driver hands in the scans alone"


def test_feeds_copy_the_ports_windows_across_the_seam():
    from xchu_slam_tpu_torch.utils import sim as port_sim

    from slambench.gen import feeds

    lap = drive.lap_poses({"radius_m": 12.0, "scan_spacing_m": 1.0})
    gt = np.concatenate([lap, lap])               # two laps: a window spans the seam
    stamps = 0.1 * np.arange(len(gt))
    tr = feeds._Trajectory(gt, stamps)
    rng = np.random.default_rng(0)
    mine = (feeds.imu_windows(tr, 16, rng, 0.0, 0.0), feeds.wheel_windows(tr, 16, rng, 0.0, 0.0))
    port = (port_sim.imu_windows(gt, stamps, samples=16),
            port_sim.wheel_windows(gt, stamps, samples=16))
    for a, b in zip(mine, port):
        assert np.array_equal(a[3], b[3]) and not a[3][0].any() and a[3][1:].all()
        np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-6)
        for x, y in zip(a[1:3], b[1:3]):
            np.testing.assert_allclose(x, y, rtol=0, atol=2e-4)
    L, gyro = len(lap), np.abs(mine[0][1])
    assert gyro[L - 1:L + 2].max() <= gyro[1:L].max() < 2.5, "a yaw rate spikes at the seam"


def test_session_feeds_follow_the_modes_and_the_seed():
    from slambench.gen import feeds

    c = tiny.cell("sim_circuit_sc.laps", fusion=True)
    prog = dict(c.config["program"], **tiny.PROGRAM)
    poses = drive.lap_poses(c.config["route"])
    poses = poses[drive.session_lap_index(c.mix, len(poses))]
    a = feeds.session_feeds(c.config, prog, poses, 2 ** 33 + 5)
    b = feeds.session_feeds(c.config, prog, poses, 2 ** 33 + 5)
    d = feeds.session_feeds(c.config, prog, poses, 2 ** 33 + 6)
    assert all(np.array_equal(x, y) for x, y in zip(a.imu + a.wheel, b.imu + b.wheel))
    assert not np.array_equal(a.imu[1], d.imu[1])
    assert a.imu[0].shape == (len(poses), prog["odom.imu_samples"])
    alts = a.gps_alts
    assert alts.dtype == np.float32 and 0.1 < np.mean(np.isnan(alts)) < 0.3
    assert 0.3 < np.nanstd(alts - poses[:, 2]) < 0.7
    assert feeds.session_feeds(c.config, dict(prog, **{"odom.use_imu": False,
                                                       "odom.use_odom": False}),
                               poses, 1).imu is None
    off = dict(prog, **{"odom.use_imu": False, "odom.use_odom": False, "pgo.use_gps": False})
    assert feeds.session_feeds(c.config, off, poses, 1) is None
    for feed in ("imu", "wheel", "gps"):      # a mode on states its noise
        cfg = dict(c.config, sensor={k: v for k, v in c.config["sensor"].items() if k != feed})
        with pytest.raises(ValueError, match=feed):
            feeds.session_feeds(cfg, prog, poses, 1)
