"""The sensor feeds of a session: IMU and wheel-odometry windows and GPS
altitudes along its ground truth, drawn from the seed in set-up.

Frozen numpy copies, so that a later change to the program cannot move the
yardstick: `xchu_slam_tpu_torch/utils/sim.py::imu_windows` and
`::wheel_windows` (per-scan windows of `samples` samples over (t_{i-1},
t_i], window 0 fully masked; gyro and wheel rates are Euler-angle rates,
accel the body-frame specific force with gravity, linear the body-frame
velocity), here computed for every window at once, and the altimeter of
`cli._sim_feeds` (the ground truth's z plus noise, a share dropped as NaN).
A configuration turns each on through its program (`odom.use_imu`,
`odom.use_odom`, `pgo.use_gps`) and states the noise of each mode it turns
on in its `sensor` entry (`imu`: gyro_noise, accel_noise; `wheel`:
vel_noise, gyro_noise; `gps`: alt_noise_m, dropout_share); no value is
assumed for it.

The trajectory is the session's: lap poses back to back at the harness's
stamps (`scan_period_s · arange(n)`), the yaw unwrapped across the lap's
seam, so a window that spans a lap boundary is as smooth as any other. The
noise comes from a random stream of its own, apart from the render's and the
range noise's, so the scans of a run are the same with the feeds on or off.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

_FEEDS = 3            # generator domain (drive.py: 1 the render, 2 the range noise)
GRAVITY = 9.80665
NOISE_KEYS = {"imu": ("gyro_noise", "accel_noise"), "wheel": ("vel_noise", "gyro_noise"),
              "gps": ("alt_noise_m", "dropout_share")}


class Feeds(NamedTuple):
    """Each None where its mode is off. `imu`: (stamps [n,M], gyro [n,M,3],
    accel [n,M,3], mask [n,M]); `wheel`: (stamps, linear, angular, mask);
    `gps_alts`: float32 [n], NaN where the fix dropped out."""

    imu: tuple | None
    wheel: tuple | None
    gps_alts: np.ndarray | None


def modes(prog: dict) -> tuple[bool, bool, bool]:
    """(IMU, wheel, GPS) on in a program's settings (`program` keys)."""
    return bool(prog["odom.use_imu"]), bool(prog["odom.use_odom"]), bool(prog["pgo.use_gps"])


def _noise(config: dict, feed: str) -> dict:
    """The configuration's `sensor.<feed>` noise, every key of it stated."""
    given = config["sensor"].get(feed, {})
    missing = [k for k in NOISE_KEYS[feed] if k not in given]
    if missing:
        raise ValueError(f"the configuration turns the {feed} feed on and its sensor "
                         f"entry does not state {missing}")
    return given


def _euler_to_matrix(rpy: np.ndarray) -> np.ndarray:
    """float32 R = Rz(y)·Ry(p)·Rx(r) [..., 3, 3] of rpy [..., 3]."""
    rpy = rpy.astype(np.float32)
    cr, sr = np.cos(rpy[..., 0]), np.sin(rpy[..., 0])
    cp, sp = np.cos(rpy[..., 1]), np.sin(rpy[..., 1])
    cy, sy = np.cos(rpy[..., 2]), np.sin(rpy[..., 2])
    return np.stack([np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
                     np.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
                     np.stack([-sp, cp * sr, cp * cr], -1)], -2)


class _Trajectory:
    """Linear interpolation of positions and unwrapped angles over the
    stamps; velocity and acceleration by central differences of it."""

    def __init__(self, gt: np.ndarray, stamps: np.ndarray):
        self.stamps = np.asarray(stamps, np.float64)
        self.pos = np.asarray(gt[:, :3], np.float64)
        self.rpy = np.unwrap(np.asarray(gt[:, 3:6], np.float64), axis=0)

    def _at(self, t, values):
        return np.stack([np.interp(t, self.stamps, values[:, k]) for k in range(3)], -1)

    def pos_t(self, t):
        return self._at(t, self.pos)

    def rpy_t(self, t):
        return self._at(t, self.rpy)

    def vel_t(self, t, h=1e-3):
        return (self.pos_t(t + h) - self.pos_t(t - h)) / (2 * h)

    def acc_t(self, t, h=2e-2):
        return (self.vel_t(t + h) - self.vel_t(t - h)) / (2 * h)


def _windows(tr: _Trajectory, samples: int):
    """(ts [n-1,M], mid [n-1,M], Euler rates at mid [n-1,M,3], body
    rotations at mid [n-1,M,3,3]) of windows 1..n-1: sample k integrates
    over (ts[k-1], ts[k]], so rates are read at the sub-interval midpoints
    (sample 0 has dt = 0)."""
    st = tr.stamps
    ts = np.linspace(st[:-1], st[1:], samples, axis=1)
    mid = np.concatenate([ts[:, :1], 0.5 * (ts[:, 1:] + ts[:, :-1])], axis=1)
    rates = np.gradient(tr.rpy_t(ts), axis=1) / ((st[1:] - st[:-1]) / (samples - 1))[:, None, None]
    rates = np.concatenate([rates[:, :1], 0.5 * (rates[:, 1:] + rates[:, :-1])], axis=1)
    R = _euler_to_matrix(tr.rpy_t(mid))
    return ts, mid, rates, R


def _clip(tr: _Trajectory, t):
    return np.clip(t, tr.stamps[0] + 0.05, tr.stamps[-1] - 0.05)


def _pack(ts, a, b, n: int, samples: int) -> tuple:
    out_stamps = np.zeros((n, samples), np.float32)
    out_a = np.zeros((n, samples, 3), np.float32)
    out_b = np.zeros((n, samples, 3), np.float32)
    mask = np.zeros((n, samples), bool)
    out_stamps[1:], out_a[1:], out_b[1:], mask[1:] = ts, a, b, True
    return out_stamps, out_a, out_b, mask


def imu_windows(tr: _Trajectory, samples: int, rng, gyro_noise: float, accel_noise: float):
    """(stamps, gyro, accel, mask) of every scan, as `ops.imu.ImuWindow`'s
    leaves with a leading scan axis."""
    ts, mid, gyro, R = _windows(tr, samples)
    aw = tr.acc_t(_clip(tr, mid)) + np.array([0.0, 0.0, GRAVITY])
    accel = np.einsum("nmba,nmb->nma", R, aw)
    gyro = gyro + rng.normal(0, gyro_noise, gyro.shape)
    accel = accel + rng.normal(0, accel_noise, accel.shape)
    return _pack(ts, gyro, accel, len(tr.stamps), samples)


def wheel_windows(tr: _Trajectory, samples: int, rng, vel_noise: float, gyro_noise: float):
    """(stamps, linear, angular, mask) of every scan, as
    `ops.imu.OdomWindow`'s leaves with a leading scan axis."""
    ts, mid, ang, R = _windows(tr, samples)
    lin = np.einsum("nmba,nmb->nma", R, tr.vel_t(_clip(tr, mid)))
    lin = lin + rng.normal(0, vel_noise, lin.shape)
    ang = ang + rng.normal(0, gyro_noise, ang.shape)
    return _pack(ts, lin, ang, len(tr.stamps), samples)


def session_feeds(config: dict, prog: dict, poses: np.ndarray, seed: int) -> Feeds | None:
    """The feeds of a session whose ground truth is `poses` [n,6] (lap poses
    back to back), for the modes `prog` turns on; None where none is. Drawn
    in the CLI's order: IMU, wheel, then GPS."""
    use_imu, use_odom, use_gps = modes(prog)
    if not (use_imu or use_odom or use_gps):
        return None
    n = len(poses)
    stamps = config["route"]["scan_period_s"] * np.arange(n)
    tr = _Trajectory(poses, stamps)
    rng = np.random.default_rng([_FEEDS, seed])
    M = int(prog["odom.imu_samples"])
    imu = wheel = alts = None
    if use_imu:
        s = _noise(config, "imu")
        imu = imu_windows(tr, M, rng, s["gyro_noise"], s["accel_noise"])
    if use_odom:
        s = _noise(config, "wheel")
        wheel = wheel_windows(tr, M, rng, s["vel_noise"], s["gyro_noise"])
    if use_gps:
        s = _noise(config, "gps")
        alts = tr.pos[:, 2] + rng.normal(0.0, s["alt_noise_m"], n)
        alts[rng.random(n) < s["dropout_share"]] = np.nan
        alts = alts.astype(np.float32)
    return Feeds(imu=imu, wheel=wheel, gps_alts=alts)
