"""`run-kitti`'s inputs and the host engine's one-scan pipelining.

The port's velodyne readers (`io/native_loader.py`: the loader built from
`native/loader.cpp`, where a host compiler exists, and its numpy reader)
against each other, against a record-by-record oracle and against the
reference's `read_velodyne`: non-finite records dropped, the range crop as
r² in (min², max²), the cut at `capacity`. Then `ScanPrefetcher`,
`run-kitti --device cpu` end to end on both engines, and `defer_sync`:
poses bit-identical to the synchronous mode, with and without IMU / wheel
windows, the last scan drained by `finalize`."""

import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

from xchu_slam_tpu.io import native_loader as jnl
from xchu_slam_tpu_torch import cli
from xchu_slam_tpu_torch.io import kitti, native_loader as nl
from xchu_slam_tpu_torch.models.pipeline import SlamPipeline
from xchu_slam_tpu_torch.utils import se3, sim

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def records():
    """KITTI records with non-finite coordinates, and records on the
    crop's bounds."""
    pts = np.random.default_rng(3).normal(0, 20, (5000, 4)).astype(np.float32)
    pts[::50, 0] = np.nan
    pts[7::61, 2] = np.inf
    pts[11::97, 1] = -np.inf
    pts[3, :2], pts[4, :2], pts[5, :2] = (1.0, 0.0), (60.0, 0.0), (0.6, 0.8)
    return pts


@pytest.fixture(scope="module")
def bin_file(records, tmp_path_factory):
    path = tmp_path_factory.mktemp("velodyne") / "000000.bin"
    records.tofile(path)
    return str(path)


def _oracle(pts, capacity, lo, hi):
    """The reader's rules, one record at a time in float32."""
    keep = []
    lo2, hi2 = np.float32(lo) * np.float32(lo), np.float32(hi) * np.float32(hi)
    for rec in pts:
        x, y, z = rec[:3]
        if not (np.isfinite(x) and np.isfinite(y) and np.isfinite(z)):
            continue
        if lo > 0 or hi > 0:
            r2 = x * x + y * y
            if r2 <= lo2 or (hi > 0 and r2 >= hi2):
                continue
        keep.append(rec)
        if len(keep) == capacity:
            break
    xyz = np.zeros((capacity, 3), np.float32)
    inten = np.zeros((capacity,), np.float32)
    if keep:
        xyz[:len(keep)] = np.asarray(keep)[:, :3]
        inten[:len(keep)] = np.asarray(keep)[:, 3]
    return xyz, inten, len(keep)


def _same(got, want):
    assert got[2] == want[2]
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _native_expected() -> bool:
    """The native reader must be there wherever a host compiler is."""
    if shutil.which("g++") or shutil.which("c++"):
        assert nl.available(), nl.unavailable_reason()
        assert nl.reader() == "native"
        return True
    assert nl.reader() == "numpy"
    return False


@pytest.mark.parametrize("capacity,lo,hi", [(8192, 0.0, 0.0), (8192, 1.0, 60.0),
                                            (8192, 0.0, 30.0), (4096, 5.0, 0.0),
                                            (1000, 1.0, 60.0), (10, 0.0, 0.0)])
def test_readers_agree(records, bin_file, capacity, lo, hi):
    want = _oracle(records, capacity, lo, hi)
    assert 0 < want[2] <= capacity
    _same(nl.read_velodyne_numpy(bin_file, capacity, lo, hi), want)
    _same(jnl.read_velodyne(bin_file, capacity, lo, hi), want)
    if _native_expected():
        _same(nl.read_velodyne(bin_file, capacity, lo, hi), want)


def test_readers_keep_a_nan_intensity_and_cut_a_torn_record(tmp_path):
    """loader.cpp drops a record only for its coordinates, and reads whole
    records of a file cut short; the numpy reader does the same."""
    pts = np.random.default_rng(4).normal(0, 10, (300, 4)).astype(np.float32)
    pts[17, 3] = np.nan
    path = tmp_path / "000001.bin"
    path.write_bytes(pts.tobytes() + pts[0, :2].tobytes())
    want = _oracle(pts, 512, 0.0, 0.0)
    assert want[2] == 300 and np.isnan(want[1][17])
    _same(nl.read_velodyne_numpy(str(path), 512), want)
    if _native_expected():
        _same(nl.read_velodyne(str(path), 512), want)
        with pytest.raises(FileNotFoundError):
            nl.read_velodyne(str(tmp_path / "missing.bin"), 16)


def test_scan_prefetcher(records, tmp_path):
    files = []
    for i in range(5):
        path = tmp_path / f"{i:06d}.bin"
        records[i * 700:i * 700 + 2000].tofile(path)
        files.append(str(path))
    if not _native_expected():
        with pytest.raises(RuntimeError, match="native loader unavailable"):
            nl.ScanPrefetcher(files, 4096)
        return
    with nl.ScanPrefetcher(files, 4096, min_range=1.0, max_range=60.0) as pf:
        for i, f in enumerate(files):
            _same(pf.get(i), nl.read_velodyne_numpy(f, 4096, 1.0, 60.0))
        with pytest.raises(IndexError):
            pf.get(len(files))
    with pytest.raises(RuntimeError, match="closed"):
        pf.get(0)


# ------------------------------------------------------------ run-kitti -- #

@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    """18 velodyne scans of a small circuit and its KITTI-format poses (a
    row a scan, camera frame, as the exporter writes)."""
    root = tmp_path_factory.mktemp("kitti")
    world = sim.make_world(3, extent=70.0, ground_pts=40_000)
    gt = sim.loop_trajectory(n_scans=18, radius=12.0, speed=1.0)
    rng = np.random.default_rng(7)
    vdir = root / "velodyne"
    vdir.mkdir()
    for i, p in enumerate(gt):
        xyz, inten = sim.render_scan(world, p, rng, n_points=6000)
        np.c_[xyz, inten].astype(np.float32).tofile(vdir / f"{i:06d}.bin")
    gtT = kitti.velo_to_cam(se3.pose_to_matrix(torch.from_numpy(gt)).numpy())
    gt_file = root / "gt.txt"
    gt_file.write_text("".join(" ".join(f"{v:.9f}" for v in T[:3].reshape(-1)) + "\n"
                               for T in gtT))
    return str(vdir), str(gt_file)


KITTI_SMALL = ["--set", "filter.max_raw_points=8192", "--set", "filter.max_points=4096",
               "--set", "filter.outlier_method=none", "--set", "ndt.grid_x=48",
               "--set", "ndt.grid_y=48", "--set", "ndt.grid_z=16",
               "--set", "pgo.max_keyframes=64", "--set", "pgo.max_loops=8"]


@pytest.mark.parametrize("engine", ["host", "device"])
def test_run_kitti_end_to_end(kitti_dir, tmp_path, capsys, engine):
    """Reader → staged ingest → SLAM → camera-frame export → the ATE."""
    vdir, gt_file = kitti_dir
    cli.main(["run-kitti", "--velodyne-dir", vdir, "--gt", gt_file,
              "--out", str(tmp_path / engine), "--engine", engine, "--device", "cpu",
              *KITTI_SMALL])
    summary = json.loads(capsys.readouterr().out)
    assert summary["scans"] == 18 and summary["keyframes"] > 2
    assert summary["ate_rmse_m"] < 1.0
    assert summary["reader"] == nl.reader() and summary["engine"] == engine
    assert summary.get("defer_sync") is (True if engine == "host" else None)
    for name, path in summary["artifacts"].items():
        assert os.path.exists(path), name


# ----------------------------------------------------------- defer_sync -- #

@pytest.fixture(scope="module")
def circuit():
    """20 scans of a 10 m circuit, stamped 0.1·i, with noisy IMU and wheel
    windows along it."""
    world = sim.make_world(2, extent=40.0, ground_pts=30_000)
    gt = sim.loop_trajectory(n_scans=20, radius=10.0, speed=1.0)
    stamps = 0.1 * np.arange(len(gt))
    rng = np.random.default_rng(2)
    scans = [sim.render_scan(world, p, rng, n_points=4000) for p in gt]
    cfg = cli.sim_config(imu=True, wheel=True)
    return scans, stamps, cli._sim_sensor_windows(cfg, gt, stamps, rng)


DEFER_SMALL = ("filter.max_raw_points=4096", "filter.max_points=2048",
               "ndt.grid_x=40", "ndt.grid_y=40", "ndt.grid_z=12",
               "pgo.max_keyframes=32", "loop.submap_points=2048")


def _run(circuit, defer: bool, imu: bool, wheel: bool):
    scans, stamps, windows = circuit
    pipe = SlamPipeline(cli.sim_config(DEFER_SMALL, imu=imu, wheel=wheel), kf_points=1024,
                        device="cpu")
    pipe.defer_sync = defer
    results = []
    for i, (xyz, inten) in enumerate(scans):
        imu_w, wheel_w = cli._scan_windows(windows, i)
        results.append(pipe.process_scan(xyz, inten, stamp=float(stamps[i]),
                                         imu=imu_w if imu else None,
                                         wheel=wheel_w if wheel else None))
    return pipe, results


def _pose_hash(pipe) -> str:
    _stamps, kf_odo, kf_opt = pipe.keyframe_trajectory()
    return hashlib.sha256(pipe.odometry_trajectory().tobytes() + kf_odo.tobytes()
                          + kf_opt.tobytes()).hexdigest()


@pytest.mark.parametrize("imu,wheel", [(False, False), (True, False), (True, True)],
                         ids=["constant-velocity", "imu", "imu+wheel"])
def test_defer_sync_equals_the_synchronous_mode(circuit, imu, wheel):
    sync, sync_res = _run(circuit, False, imu, wheel)
    defer, defer_res = _run(circuit, True, imu, wheel)
    # each call returns the previous scan's result; the seed scan's at once
    assert defer_res[1] is None
    n = len(sync_res)
    assert defer.scan_count == n - 1 and len(defer.odom_log) == n - 2
    defer.finalize()
    sync.finalize()
    assert defer.scan_count == sync.scan_count == n and defer._pending is None
    assert [r["iterations"] for r in defer.odom_log] == \
        [r["iterations"] for r in sync.odom_log]
    assert defer.kf_count == sync.kf_count >= 3
    assert _pose_hash(defer) == _pose_hash(sync)
    for got, want in zip(defer_res[2:], sync_res[1:-1]):
        assert np.array_equal(got["pose"], want["pose"]) and got["keyframe"] == want["keyframe"]
