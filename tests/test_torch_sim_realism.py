"""The port's simulator realism and real-trajectory sources against the JAX
reference's `utils/sim.py`, bit for bit on the same seed: TUM trajectories
(`tum_trajectory_poses`), the corridor world (`make_world_along`), the
beam-level sensor model with moving traffic (`SensorModel`,
`DynamicObjects`, `render_scan`, `RenderedScans`) and `simulate_sequence`.
Then `run-sim --realism` and `run-sim --trajectory` on both engines, and
`localize --trajectory` against such a session, through the CLI on the CPU."""

import json

import numpy as np
import pytest
import torch

from xchu_slam_tpu.utils import sim as jsim
from xchu_slam_tpu_torch import cli
from xchu_slam_tpu_torch.io import kitti
from xchu_slam_tpu_torch.utils import se3, sim

torch.set_num_threads(2)

SMALL = ["--set", "filter.max_points=2048", "--set", "pgo.max_keyframes=32",
         "--set", "loop.submap_points=2048", "--set", "ndt.grid_x=48",
         "--set", "ndt.grid_y=48", "--set", "ndt.grid_z=16"]


def _write_tum(path, poses6, stamps):
    """A camera-frame TUM file of z-up poses (the frame of KITTI's files)."""
    cam = sim.camera_frame_transform()
    T = se3.pose_to_matrix(torch.from_numpy(np.asarray(poses6, np.float64))).numpy()
    kitti.write_tum(str(path), stamps, cam @ T @ np.linalg.inv(cam))


@pytest.fixture(scope="module")
def tum_file(tmp_path_factory):
    """A 64-pose closed lap of 10 m radius in the camera frame, with the
    file's own stamps (not 0.1·i)."""
    path = tmp_path_factory.mktemp("traj") / "lap_tum.txt"
    _write_tum(path, sim.closed_lap_trajectory(64, radius=10.0), 3.0 + 0.1 * np.arange(64))
    return str(path)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=True)


# ------------------------------------------------------ the copies ---- #

def test_tum_trajectory_poses_is_the_references(tum_file):
    for max_scans in (0, 20):
        ts, ps = sim.tum_trajectory_poses(tum_file, max_scans=max_scans)
        js, jp = jsim.tum_trajectory_poses(tum_file, max_scans=max_scans)
        _same(ts, js)
        _same(ps, jp)
    assert len(ts) == 20 and ts[0] == 3.0
    # the z-up poses come back from the camera frame, yaw wrapped
    want = sim.closed_lap_trajectory(64, radius=10.0)[:20]
    np.testing.assert_allclose(ps[:, :3], want[:, :3], atol=2e-5)
    np.testing.assert_allclose(np.cos(ps[:, 5] - want[:, 5]), 1.0, atol=1e-9)
    q = np.random.default_rng(0).normal(size=(9, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    _same(sim._quat_to_matrix(q), jsim._quat_to_matrix(q))
    _same(sim._decimate_by_arclen(want, 2.5), jsim._decimate_by_arclen(want, 2.5))


def test_make_world_along_is_the_references(tum_file):
    _ts, gt = sim.tum_trajectory_poses(tum_file)
    world = sim.make_world_along(gt[:, :3], seed=4)
    ref = jsim.make_world_along(gt[:, :3], seed=4)
    _same(world.xyz, ref.xyz)
    _same(world.intensity, ref.intensity)
    assert len(world.xyz) > 10_000
    index, jindex = sim.WorldIndex(world), jsim.WorldIndex(ref)
    _same(index.query(gt[10, :2], 60.0), jindex.query(gt[10, :2], 60.0))


def test_sensor_model_and_traffic_are_the_references():
    assert sim.SensorModel() == jsim.SensorModel()
    path = sim.loop_trajectory(40, radius=15.0, speed=1.0)[:, :3]
    dyn, jdyn = sim.DynamicObjects(path, seed=2), jsim.DynamicObjects(path, seed=2)
    for t in (0.0, 0.7, 13.3):
        for got, want in zip(dyn.points_at(t), jdyn.points_at(t)):
            _same(got, want)
    empty = sim.DynamicObjects(path, n_objects=0).points_at(1.0)
    assert empty[0].shape == (0, 3) and empty[1].shape == (0,)


@pytest.mark.parametrize("mode", ["sensor", "sensor+traffic", "traffic", "sensor+index"])
def test_render_scan_with_realism_is_the_references(mode):
    world = sim.make_world(5, extent=40.0, ground_pts=40_000)
    gt = sim.loop_trajectory(12, radius=12.0, speed=1.0)
    sensor = sim.SensorModel() if "sensor" in mode else None
    jsensor = jsim.SensorModel() if "sensor" in mode else None
    dyn = sim.DynamicObjects(gt[:, :3], seed=5) if "traffic" in mode else None
    jdyn = jsim.DynamicObjects(gt[:, :3], seed=5) if "traffic" in mode else None
    index = sim.WorldIndex(world, cell=16.0) if "index" in mode else None
    jindex = jsim.WorldIndex(world, cell=16.0) if "index" in mode else None
    rng, jrng = np.random.default_rng(8), np.random.default_rng(8)
    for i in (0, 5, 11):
        got = sim.render_scan(world, gt[i], rng, n_points=6000, index=index, sensor=sensor,
                              dynamics=dyn, t=0.1 * i)
        want = jsim.render_scan(world, gt[i], jrng, n_points=6000, index=jindex,
                                sensor=jsensor, dynamics=jdyn, t=0.1 * i)
        _same(got[0], want[0])
        _same(got[1], want[1])
        assert len(got[0]) > 500 and got[0].dtype == np.float32


def test_rendered_scans_with_realism_are_the_references():
    world = sim.make_world(6, extent=40.0, ground_pts=40_000)
    gt = sim.loop_trajectory(16, radius=12.0, speed=1.0)
    scans = sim.RenderedScans(world, gt, seed=3, n_points=5000, sensor=sim.SensorModel(),
                              dynamics=sim.DynamicObjects(gt[:, :3], seed=3))
    ref = jsim.RenderedScans(world, gt, seed=3, n_points=5000, sensor=jsim.SensorModel(),
                             dynamics=jsim.DynamicObjects(gt[:, :3], seed=3))
    assert len(scans) == len(ref) == 16
    for k in (15, 0, 7):     # any order: each scan has a generator of its own
        for got, want in zip(scans[k], ref[k]):
            _same(got, want)


def test_simulate_sequence_is_the_references():
    got = list(sim.simulate_sequence(seed=2, n_scans=4, n_points=3000, radius=10.0))
    want = list(jsim.simulate_sequence(seed=2, n_scans=4, n_points=3000, radius=10.0))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            _same(a, b)


# ------------------------------------------------------- the CLI ---- #

def _run(argv, capsys):
    cli.main(argv + ["--device", "cpu"])
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("engine", ["host", "device"])
def test_cli_realism_runs(engine, capsys):
    extra = ["--engine", "device", "--chunk", "4"] if engine == "device" else []
    s = _run(["run-sim", "--scans", "8", "--radius", "20", "--seed", "2", "--realism",
              "--out", "", *extra] + SMALL, capsys)
    assert s["scans"] == 8 and s["keyframes"] >= 2
    assert np.isfinite(s["ate_rmse_m"]) and s["ate_rmse_m"] < 0.5


def test_cli_realism_scans_are_the_references(monkeypatch):
    """The host engine with --realism renders what the reference CLI's host
    engine renders: the sensor model, the traffic at t = 0.1·i, one
    generator."""
    seen = []
    cli.run_sim(3, 20.0, 4, "cpu", ["filter.max_points=2048", "pgo.max_keyframes=16"],
                on_scan=lambda i, res, scan: seen.append(scan), realism=True)
    world = jsim.make_world(4, extent=50.0)
    gt = jsim.loop_trajectory(n_scans=3, radius=20.0, speed=1.0)
    sensor, dyn = jsim.SensorModel(), jsim.DynamicObjects(gt[:, :3], seed=4)
    rng = np.random.default_rng(4)
    for i, scan in enumerate(seen):
        xyz, inten = jsim.render_scan(world, gt[i], rng, n_points=24_000, sensor=sensor,
                                      dynamics=dyn, t=0.1 * i)
        _same(scan["xyz"], xyz)
        _same(scan["intensity"], inten)


@pytest.mark.parametrize("engine", ["host", "device"])
def test_cli_trajectory_runs_and_localizes(engine, tum_file, tmp_path, capsys):
    """run-sim along the TUM lap (the file's stamps, a corridor world), with
    a checkpoint; then localize --trajectory against it."""
    out = tmp_path / "traj"
    extra = ["--engine", "device", "--chunk", "8"] if engine == "device" else []
    s = _run(["run-sim", "--trajectory", tum_file, "--scans", "16", "--seed", "1",
              "--checkpoint-every", "8", "--out", str(out), *extra] + SMALL, capsys)
    assert s["scans"] == 16 and s["keyframes"] >= 4 and np.isfinite(s["ate_rmse_m"])
    stamps, _ = kitti.read_tum(s["artifacts"]["odom_tum"])
    assert stamps[0] == pytest.approx(3.0) and len(stamps) == s["keyframes"]
    loc = _run(["localize", "--session", str(out / "checkpoint.npz"), "--trajectory",
                tum_file, "--scans", "16", "--seed", "1", "--queries", "2",
                "--fitness-thresh", "1.5"], capsys)
    assert loc["queries"] == 2 and loc["localized"] >= 1
    assert loc["results"][0]["found"] and loc["results"][0]["pos_err_m"] < 1.0
