"""The port's IMU / wheel-odometry guess providers, the simulator's sensor
windows, and the odometry step with an external delta, against the JAX
reference. Inputs come from numpy seeds; tolerances are stated per test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xchu_slam_tpu import config as jconfig
from xchu_slam_tpu.models import odometry as jodom
from xchu_slam_tpu.ops import imu as jimu
from xchu_slam_tpu.ops.filter import filter_scan as jfilter_scan
from xchu_slam_tpu.types import make_cloud as jmake_cloud
from xchu_slam_tpu.utils import sim as jsim
from xchu_slam_tpu_torch import config as tconfig, convert
from xchu_slam_tpu_torch.models import odometry as todom
from xchu_slam_tpu_torch.ops import imu as timu
from xchu_slam_tpu_torch.utils import sim as tsim

torch.set_num_threads(2)

M = 16


def _windows(seed, masked="none"):
    """One seeded window of each kind: stamps over 0.1 s, rates and
    accelerations of a turning, accelerating vehicle."""
    rng = np.random.default_rng(seed)
    stamps = (3.0 + np.linspace(0.0, 0.1, M)).astype(np.float32)
    gyro = (rng.normal(size=(M, 3)) * [0.02, 0.02, 0.4]).astype(np.float32)
    accel = (rng.normal(size=(M, 3)) * 0.8 + [0, 0, jimu.GRAVITY]).astype(np.float32)
    lin = (rng.normal(size=(M, 3)) * 0.2 + [10.0, 0, 0]).astype(np.float32)
    mask = np.ones(M, bool)
    if masked == "all":
        mask[:] = False
    elif masked == "some":
        mask[[2, 3, 9]] = False
    pose0 = np.r_[rng.uniform(-8, 8, 3), rng.uniform(-0.05, 0.05, 2),
                  rng.uniform(-3, 3)].astype(np.float32)
    vel0 = rng.normal(size=3).astype(np.float32) * 5
    return stamps, gyro, accel, lin, mask, pose0, vel0


@pytest.mark.parametrize("masked", ["none", "some", "all"])
@pytest.mark.parametrize("seed", [0, 1])
def test_integrate_imu_and_wheel_match_reference(seed, masked):
    """Deltas and the carried velocity within 1e-6 of the reference (poses
    within ±8 m, where a float32 ulp is under 1e-6); a fully masked window
    gives a zero delta (to the 1e-7 that wrapping an angle through
    atan2(sin, cos) costs) and leaves the velocity as it was."""
    stamps, gyro, accel, lin, mask, pose0, vel0 = _windows(seed, masked)
    dj, sj = jimu.integrate_imu(
        jimu.ImuWindow(*map(jnp.asarray, (stamps, gyro, accel, mask))),
        jnp.asarray(pose0), jimu.ImuState(velocity=jnp.asarray(vel0)))
    dt, st = timu.integrate_imu(
        timu.ImuWindow(*map(torch.from_numpy, (stamps, gyro, accel, mask))),
        pose0, timu.ImuState(velocity=torch.from_numpy(vel0)))
    assert dt.dtype == torch.float32 and st.velocity.dtype == torch.float32
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(st.velocity.numpy(), np.asarray(sj.velocity), rtol=0, atol=1e-6)
    wj = jimu.integrate_wheel_odom(
        jimu.OdomWindow(*map(jnp.asarray, (stamps, lin, gyro, mask))), jnp.asarray(pose0))
    wt = timu.integrate_wheel_odom(
        timu.OdomWindow(*map(torch.from_numpy, (stamps, lin, gyro, mask))), pose0)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        timu.combine_imu_odom(dt, wt).numpy(),
        np.asarray(jimu.combine_imu_odom(jnp.asarray(dt.numpy()), jnp.asarray(wt.numpy()))))
    if masked == "all":
        assert np.abs(dt.numpy()).max() <= 1e-6 and np.abs(wt.numpy()).max() <= 1e-6
        assert np.array_equal(st.velocity.numpy(), vel0)
    else:
        assert np.abs(dt.numpy()[:3]).max() > 0.1 and np.abs(wt.numpy()[:3]).max() > 0.1


def test_sim_sensor_windows_match_reference():
    """All four arrays of the IMU and of the wheel windows within 1e-6 of
    the reference's for the same generator, or within one float32 ulp
    (1.2e-7 relative) where a value is too large for 1e-6 to be resolved
    (accelerations above 16 m/s²: the one float32 step, the rotation matrix,
    differs in the last bit between the packages). Both leave the generator
    in the same state, so what is rendered after them sees the same numbers."""
    gt = tsim.loop_trajectory(25, radius=15.0, speed=1.0)
    stamps = 0.1 * np.arange(len(gt))
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    ij = jsim.imu_windows(gt, stamps, samples=M, rng=rj, gyro_noise=0.002, accel_noise=0.05)
    it = tsim.imu_windows(gt, stamps, samples=M, rng=rt, gyro_noise=0.002, accel_noise=0.05)
    wj = jsim.wheel_windows(gt, stamps, samples=M, rng=rj, vel_noise=0.03, gyro_noise=0.002)
    wt = tsim.wheel_windows(gt, stamps, samples=M, rng=rt, vel_noise=0.03, gyro_noise=0.002)
    for a, b in zip(it + wt, ij + wj):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1.2e-7, atol=1e-6)
    assert rj.random() == rt.random()
    assert not it[3][0].any() and it[3][1:].all()       # window 0 is masked
    # noise-free windows integrate back to the trajectory's own step
    clean = tsim.wheel_windows(gt, stamps, samples=M)
    d = timu.integrate_wheel_odom(
        timu.OdomWindow(*(torch.from_numpy(a[10]) for a in clean)), gt[9])
    np.testing.assert_allclose(d.numpy()[:2], (gt[10] - gt[9])[:2], atol=2e-2)


def test_odometry_step_with_external_delta_matches_reference():
    """One odometry step whose NDT guess comes from an external delta, from
    the same (converted) state: pose within 1e-4 of the reference, the same
    Newton iteration count; with `use_ext=False` the delta is ignored."""
    jcfg = jconfig.tiny_config().override({"filter.outlier_method": "statistical"})
    tcfg = tconfig.tiny_config().override({"filter.outlier_method": "statistical"})
    sj, st = jodom.spec_from_config(jcfg), todom.spec_from_config(tcfg)
    world = tsim.make_world(6, extent=50.0, ground_pts=60_000)
    gt = tsim.loop_trajectory(3, radius=12.0, speed=1.0)
    rng = np.random.default_rng(6)
    clouds = []
    for p in gt[:2]:
        xyz, inten = tsim.render_scan(world, p, rng, n_points=4000)
        f = jfilter_scan(jmake_cloud(xyz, inten, capacity=4096), jcfg.filter)
        clouds.append((np.asarray(f.xyz), np.asarray(f.mask)))
    (x0, m0), (x1, m1) = clouds
    ext = np.array([0.9, 0.05, 0.0, 0.0, 0.0, 0.07], np.float32)

    def jstate():
        return jodom.init_state(sj, jnp.zeros(6, jnp.float32), jnp.asarray(x0), jnp.asarray(m0))

    def tstate():
        ref = jstate()
        leaves = type(ref)(*(type(v)(*map(np.asarray, v)) if hasattr(v, "_fields")
                             else np.asarray(v) for v in ref))
        return convert.odom_state_from_ref(leaves, st.gspec)

    gj = np.asarray(jodom._guess(jstate(), jnp.asarray(ext), jnp.asarray(True)))
    np.testing.assert_allclose(todom._guess(tstate(), torch.from_numpy(ext)).numpy(),
                               gj, atol=1e-7)
    np.testing.assert_allclose(gj[[0, 1, 5]], ext[[0, 1, 5]], atol=1e-7)
    assert not todom._guess(tstate()).numpy().any()      # constant velocity from rest
    x1t, m1t = torch.from_numpy(x1), torch.from_numpy(m1)
    _, oj = jodom.step(jstate(), jnp.asarray(x1), jnp.asarray(m1), sj, jnp.asarray(ext), True)
    _, ot = todom.step(tstate(), x1t, m1t, st, torch.from_numpy(ext), True)
    np.testing.assert_allclose(ot.pose.numpy(), np.asarray(oj.pose), atol=1e-4)
    assert ot.iterations == int(oj.iterations)
    _, off = todom.step(tstate(), x1t, m1t, st, torch.from_numpy(ext), False)
    _, none = todom.step(tstate(), x1t, m1t, st)
    assert torch.equal(off.pose, none.pose) and off.iterations == none.iterations
    assert not torch.equal(off.pose, ot.pose) or off.iterations != ot.iterations
