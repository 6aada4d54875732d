"""The device engine's external guess on the CPU (the guess kernel's plain
route): `ops/imu.ext_guess` against the reference's `_ext_guess`, the device
engine with IMU / wheel / both windows against the reference's device engine
on the zigzag scene of tests/test_imu_e2e.py (IMU alone on a circle), the
velocity reset under a biased accelerometer, chunked feeds against per-scan
feeds, and the command line's parsing of the flags this lifts. Inputs come
from numpy seeds; tolerances are stated per test."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xchu_slam_tpu import config as jconfig
from xchu_slam_tpu.models import device_pipeline as jdp
from xchu_slam_tpu.ops import imu as jimu
from xchu_slam_tpu.types import make_cloud as jmake_cloud
from xchu_slam_tpu_torch import cli, config as tconfig
from xchu_slam_tpu_torch.io import prefetch as tprefetch
from xchu_slam_tpu_torch.models import device_pipeline as tdp
from xchu_slam_tpu_torch.ops import imu as timu
from xchu_slam_tpu_torch.utils import sim

torch.set_num_threads(2)

M = 16
MODES = {"imu": (True, False), "wheel": (False, True), "both": (True, True)}


# ------------------------------------------------------- the plain guess -- #
@pytest.mark.parametrize("mode", list(MODES))
def test_ext_guess_matches_reference(mode):
    """50 windows of the simulator along a small circuit (window 0 fully
    masked), each integrated from the previous pose with the velocity of the
    pose delta before it (as the engine resets it every scan): delta and
    velocity within 1e-6 of the reference's `_ext_guess` (positions within
    ±8 m, where a float32 ulp is under 1e-6), `use_ext` equal, and false
    only for the masked window."""
    use_imu, use_odom = MODES[mode]
    gt = sim.loop_trajectory(50, radius=4.0, speed=1.0)
    stamps = 0.1 * np.arange(len(gt))
    rng = np.random.default_rng(11)
    imu = sim.imu_windows(gt, stamps, samples=M, rng=rng, gyro_noise=0.002, accel_noise=0.05)
    whl = sim.wheel_windows(gt, stamps, samples=M, rng=rng, vel_noise=0.03,
                            gyro_noise=0.002)
    spec = types.SimpleNamespace(use_imu=use_imu, use_odom=use_odom)
    for i in range(len(gt)):
        pose0 = gt[max(i - 1, 0)].astype(np.float32)
        vel0 = ((gt[max(i - 1, 0)] - gt[max(i - 2, 0)])[:3] / 0.1).astype(np.float32)
        vel_j, vel_t = jnp.asarray(vel0), torch.from_numpy(vel0)
        state = jdp.DevState(odom=types.SimpleNamespace(pose=jnp.asarray(pose0)), db=None,
                             graph=None, kf_accum=None, travel=None, last_kf_odom=None,
                             loop_count=None, scan_count=None, imu_vel=vel_j,
                             last_stamp=None, log=None, diag=None)
        win = jdp.GuessWindows(imu=jimu.ImuWindow(*(jnp.asarray(a[i]) for a in imu)),
                               wheel=jimu.OdomWindow(*(jnp.asarray(a[i]) for a in whl)))
        state, dj, uj = jdp._ext_guess(state, win, spec)
        dt, ut, vel_t = timu.ext_guess(
            torch.from_numpy(pose0), timu.ImuWindow(*(torch.from_numpy(a[i]) for a in imu)),
            timu.OdomWindow(*(torch.from_numpy(a[i]) for a in whl)), vel_t, use_imu, use_odom)
        vel_j = state.imu_vel
        assert dt.dtype == torch.float32 and ut.dtype == torch.bool and ut.shape == ()
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-6)
        np.testing.assert_allclose(vel_t.numpy(), np.asarray(vel_j), rtol=0, atol=1e-6)
        assert bool(ut) == bool(uj) == (i > 0)
        if not use_imu:
            assert np.array_equal(vel_t.numpy(), vel0)


def test_ext_guess_with_no_mode_is_no_guess():
    delta, use, vel = timu.ext_guess(torch.zeros(6), None, None, torch.ones(3), False, False)
    assert not delta.any() and not bool(use) and torch.equal(vel, torch.ones(3))


# ------------------------------------------------ the engine with windows -- #
def _cfg(mod, **over):
    """The zigzag scene's configuration (tests/test_imu_e2e.py::_cfg)."""
    return mod.default_config().override({
        "filter.max_raw_points": 4096, "filter.max_points": 2048,
        "filter.outlier_method": "none",
        "ndt.grid_x": 48, "ndt.grid_y": 48, "ndt.grid_z": 16,
        "pgo.max_keyframes": 64, "pgo.max_loops": 8, "loop.method": "none",
        "loop.submap_half_width": 4, "loop.submap_points": 2048, **over})


def _zigzag(n):
    """The aggressive-rotation path of tests/test_imu_e2e.py: heading
    oscillates ±0.8 rad scan to scan."""
    yaw = 0.8 * np.sin(np.arange(n) * 1.3)
    gt = np.zeros((n, 6), np.float32)
    for i in range(1, n):
        gt[i, 0] = gt[i - 1, 0] + np.cos(yaw[i])
        gt[i, 1] = gt[i - 1, 1] + np.sin(yaw[i])
    gt[:, 5] = yaw
    return gt


N_ZIG = 24
# the scene each mode is held to the reference on. IMU alone on the zigzag is
# chaotic at the last bit: its first align runs to the 30-iteration cap (the
# guess starts from zero velocity at 10 m/s), and the two packages, within
# 2e-6 for five scans, part from the sixth on. On the circle it converges.
SCENES = {"imu": "circle", "wheel": "zigzag", "both": "zigzag"}


def _scene(kind, bias=0.0):
    """24 scans of 3000 points along the zigzag or a 12 m circle, with the
    IMU windows (an accelerometer bias along x, if any) and wheel windows of
    the simulator, from seeds."""
    gt = _zigzag(N_ZIG) if kind == "zigzag" else sim.loop_trajectory(N_ZIG, radius=12.0,
                                                                      speed=1.0)
    world = sim.make_world(4, extent=50.0, ground_pts=30000)
    rng = np.random.default_rng(9)
    scans = [sim.render_scan(world, p, rng, n_points=3000) for p in gt]
    stamps = 0.1 * np.arange(N_ZIG)
    imu = sim.imu_windows(gt, stamps, samples=M, rng=np.random.default_rng(2),
                          gyro_noise=0.002, accel_noise=0.05)
    imu = imu[:2] + (imu[2] + np.float32([bias, 0.0, 0.0]),) + imu[3:]
    whl = sim.wheel_windows(gt, stamps, samples=M, rng=np.random.default_rng(3),
                            vel_noise=0.03, gyro_noise=0.002)
    return gt, scans, stamps, imu, whl


@pytest.fixture(scope="module")
def scenes():
    return {kind: _scene(kind) for kind in ("zigzag", "circle")}


def _over(mode):
    use_imu, use_odom = MODES[mode]
    return {"odom.use_imu": use_imu, "odom.use_odom": use_odom}


def _port(mode, scene, chunk=None):
    """The port's device engine on the CPU, per scan or in chunks of `chunk`
    staged by the prefetcher."""
    gt, scans, stamps, imu, whl = scene
    use_imu, use_odom = MODES[mode]
    pipe = tdp.DeviceSlamPipeline(_cfg(tconfig, **_over(mode)), kf_points=1024,
                                  log_capacity=64, device="cpu")
    if chunk is None:
        for i, (xyz, inten) in enumerate(scans):
            pipe.process_scan(
                xyz, inten, stamp=float(stamps[i]),
                imu=timu.ImuWindow(*(a[i] for a in imu)) if use_imu else None,
                wheel=timu.OdomWindow(*(a[i] for a in whl)) if use_odom else None)
    else:
        base = 0
        with tprefetch.DeviceChunkPrefetcher(scans, capacity=4096, chunk=chunk, depth=2,
                                             threads=2, device="cpu") as pf:
            for clouds, n_real in pf:
                idx = np.minimum(base + np.arange(chunk), N_ZIG - 1)
                wins = cli._slice_windows({"imu": imu, "wheel": whl}, idx)
                pipe.process_chunk(clouds, stamps[idx], n_real, wins=wins)
                base += n_real
    pipe.finalize()
    return pipe


@pytest.fixture(scope="module")
def runs(scenes):
    """Each mode through the port's engine and through the reference's
    device engine, per scan, on its scene."""
    out = {}
    for mode, (use_imu, use_odom) in MODES.items():
        _, scans, stamps, imu, whl = scene = scenes[SCENES[mode]]
        ref = jdp.DeviceSlamPipeline(_cfg(jconfig, **_over(mode)), kf_points=1024,
                                     log_capacity=64)
        for i, (xyz, inten) in enumerate(scans):
            ref.process_scan(
                jmake_cloud(xyz, inten, capacity=4096), stamp=float(stamps[i]),
                imu=jimu.ImuWindow(*(jnp.asarray(a[i]) for a in imu)) if use_imu else None,
                wheel=jimu.OdomWindow(*(jnp.asarray(a[i]) for a in whl)) if use_odom else None)
        ref.finalize()
        out[mode] = (_port(mode, scene), ref)
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_device_engine_with_sensors_matches_reference(runs, mode):
    """Per scan, the port's engine against the reference's: odometry poses
    within 1e-3, Newton iteration counts equal, the same keyframes, the
    carried IMU velocity's step within 1e-3."""
    port, ref = runs[mode]
    assert port.scan_count == ref.scan_count == N_ZIG
    np.testing.assert_allclose(port.odometry_trajectory(), ref.odometry_trajectory(),
                               atol=1e-3)
    assert [r["iterations"] for r in port.odom_log] == [r["iterations"] for r in ref.odom_log]
    assert port.kf_count == ref.kf_count
    np.testing.assert_allclose(port.keyframe_trajectory()[2], ref.keyframe_trajectory()[2],
                               atol=1e-3)
    # the velocity is the last pose step over 0.1 s: its step within the
    # poses' bound
    np.testing.assert_allclose(0.1 * port.state.imu_vel.numpy(),
                               0.1 * np.asarray(ref.state.imu_vel), atol=1e-3)


def test_imu_velocity_resets_from_slam_delta():
    """The reference's test of the same name on the port: on the zigzag
    with a constant accelerometer bias of 0.4 m/s², the carried IMU velocity
    is the last inter-scan SLAM delta over the scan interval (within 1e-3),
    not the biased feed's integral, and tracking holds (unaligned odometry
    error < 2.5 m, the reference's bound)."""
    scene = _scene("zigzag", bias=0.4)
    pipe = _port("imu", scene)
    traj = pipe.odometry_trajectory()
    want = (traj[-1, :3] - traj[-2, :3]) / 0.1
    np.testing.assert_allclose(pipe.state.imu_vel.numpy(), want, atol=1e-3)
    err = np.sqrt(np.mean(np.sum((traj[:, :3] - scene[0][:, :3]) ** 2, axis=1)))
    assert err < 2.5


def test_the_guess_is_used(runs, scenes):
    """The external guess changes the odometry: each mode's poses differ
    from the constant-velocity run's on its scene, and the wheel guess saves
    Newton iterations on the zigzag."""
    for mode in MODES:
        _, scans, stamps, _, _ = scenes[SCENES[mode]]
        cv = tdp.DeviceSlamPipeline(_cfg(tconfig), kf_points=1024, log_capacity=64,
                                    device="cpu")
        for i, (xyz, inten) in enumerate(scans[:8]):
            cv.process_scan(xyz, inten, stamp=float(stamps[i]))
        cv.finalize()
        port = runs[mode][0]
        assert not np.array_equal(port.odometry_trajectory()[:8], cv.odometry_trajectory())
        if mode == "wheel":
            assert np.mean([r["iterations"] for r in port.odom_log[1:8]]) < \
                np.mean([r["iterations"] for r in cv.odom_log[1:]])


def test_chunked_windows_match_per_scan(runs, scenes):
    """Chunks of 8 with their windows sliced per slot (the CLI's
    `_slice_windows`, a short final chunk included) reproduce the per-scan
    feed bit for bit, with one readback a chunk."""
    port, _ = runs["both"]
    chunked = _port("both", scenes["zigzag"], chunk=8)
    assert chunked.chunk_readbacks == 3
    np.testing.assert_array_equal(chunked.odometry_trajectory(), port.odometry_trajectory())
    assert torch.equal(chunked.state.imu_vel, port.state.imu_vel)
    assert [r["iterations"] for r in chunked.odom_log] == \
        [r["iterations"] for r in port.odom_log]


def test_feed_without_the_windows_of_a_mode_is_refused(scenes):
    """A mode that is on needs its windows (they are inputs of Part A's
    graph); the first scan, the seed, needs none."""
    _, scans, _, imu, _ = scenes["zigzag"]
    pipe = tdp.DeviceSlamPipeline(_cfg(tconfig, **_over("both")), kf_points=1024,
                                  log_capacity=64, device="cpu")
    pipe.process_scan(*scans[0], stamp=0.0)
    with pytest.raises(ValueError, match="wheel windows"):
        pipe.process_scan(*scans[1], stamp=0.1, imu=timu.ImuWindow(*(a[1] for a in imu)))


# ------------------------------------------------------------------- CLI -- #
@pytest.mark.parametrize("flags", [["--imu"], ["--wheel"], ["--checkpoint-every", "8"]])
def test_cli_takes_the_device_engine_flags(flags, monkeypatch):
    """`--imu`, `--wheel` and `--checkpoint-every` with `--engine device`
    reach `run_sim` (called here with a stub)."""
    seen = {}
    monkeypatch.setattr(cli, "run_sim", lambda *a, **kw: (seen.update(kw), (None, {}))[1])
    cli.main(["run-sim", "--scans", "4", "--device", "cpu", "--engine", "device", *flags])
    assert seen["engine"] == "device"
    assert seen["imu"] or seen["wheel"] or seen["checkpoint_every"] == 8


@pytest.mark.parametrize("argv,msg", [
    (["--continue-session", "x.npz"], "requires --engine device"),
    (["--engine", "device", "--sync-every", "2"], "not ported yet"),
])
def test_cli_refusals_after_the_port(argv, msg, capsys):
    """`--continue-session` with the host engine is an error, as in the
    reference; `--sync-every` is still refused (`--mesh` runs since the mesh
    engine was ported: tests/test_torch_mesh_engine.py)."""
    with pytest.raises(SystemExit) as err:
        cli.main(["run-sim", "--scans", "4", "--device", "cpu", *argv])
    assert err.value.code == 2 and msg in capsys.readouterr().err
