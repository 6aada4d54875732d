"""The external NDT guess of the reference: a frozen copy of the port's plain
chain (`ops/imu.py::ext_guess_ref` with `integrate_imu`,
`integrate_wheel_odom` and `combine_imu_odom`), in the reference's order of
operations, and the velocity that the device engine carries into each
scan's IMU chain, worked out again from the session's start."""

from __future__ import annotations

import numpy as np
import torch

from slambench.reference import se3

GRAVITY = 9.80665


def _sample_dt(stamps: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-sample integration interval [M]: 0 for sample 0, for masked
    samples and for stamps that run backwards."""
    dt = torch.diff(stamps, prepend=stamps[:1])
    return torch.where(mask, torch.clamp(dt, min=0.0), 0.0)


def _attitude_chain(rpy0: torch.Tensor, rates: torch.Tensor, dt: torch.Tensor):
    """Euler-rate integration: (the attitude before each sample [M,3], the
    attitude after the last)."""
    before, rpy = [], rpy0
    for k in range(rates.shape[0]):
        before.append(rpy)
        rpy = se3.wrap_angle(rpy + rates[k] * dt[k])
    return torch.stack(before), rpy


def integrate_imu(window, pose0: torch.Tensor, velocity: torch.Tensor):
    """One IMU window (stamps, gyro, accel, mask) from world pose `pose0`:
    (delta6 in the world frame, the velocity after it)."""
    stamps, gyro, accel, mask = window
    dt = _sample_dt(stamps, mask)
    rpys, rpy = _attitude_chain(pose0[3:6], gyro, dt)
    R = se3.euler_to_matrix(rpys)
    gravity = torch.zeros(3, device=pose0.device)
    gravity[2] = GRAVITY
    a_world = torch.matmul(R, accel[:, :, None])[:, :, 0] - gravity
    pos, vel = pose0[:3], velocity
    for k in range(dt.shape[0]):
        pos = pos + vel * dt[k] + 0.5 * a_world[k] * dt[k] * dt[k]
        vel = vel + a_world[k] * dt[k]
    return torch.cat([pos - pose0[:3], se3.wrap_angle(rpy - pose0[3:6])]), vel


def integrate_wheel_odom(window, pose0: torch.Tensor) -> torch.Tensor:
    """One wheel-odometry window (stamps, linear, angular, mask) from world
    pose `pose0`: delta6 in the world frame."""
    stamps, linear, angular, mask = window
    dt = _sample_dt(stamps, mask)
    rpys, rpy = _attitude_chain(pose0[3:6], angular, dt)
    R = se3.euler_to_matrix(rpys)
    v_world = torch.matmul(R, linear[:, :, None])[:, :, 0]
    pos = pose0[:3]
    for k in range(dt.shape[0]):
        pos = pos + v_world[k] * dt[k]
    return torch.cat([pos - pose0[:3], se3.wrap_angle(rpy - pose0[3:6])])


def ext_guess(pose0: torch.Tensor, imu, wheel, velocity: torch.Tensor):
    """(delta float32[6], use_ext 0-d bool) of one scan: the IMU's delta,
    the wheel's, or the wheel's translation with the IMU's rotation where
    both are on (`imu` / `wheel` None where off). `use_ext` holds where
    every window in use has a sample."""
    have = torch.ones((), dtype=torch.bool, device=pose0.device)
    d_imu = d_wheel = None
    if imu is not None:
        d_imu, _vel = integrate_imu(imu, pose0, velocity)
        have = have & torch.any(imu[3])
    if wheel is not None:
        d_wheel = integrate_wheel_odom(wheel, pose0)
        have = have & torch.any(wheel[3])
    if d_imu is not None and d_wheel is not None:
        return torch.cat([d_wheel[:3], d_imu[3:6]]), have
    return (d_imu if d_imu is not None else d_wheel), have


def window(arrays: tuple | None, k: int, device):
    """Scan k's window of a feed's arrays, as tensors on `device`."""
    if arrays is None:
        return None
    return tuple(torch.as_tensor(a[k], device=device) for a in arrays)


def imu_velocity(rows: np.ndarray, k: int, imu_arrays: tuple, device) -> torch.Tensor:
    """The velocity the IMU chain starts scan k from: zero at the session's
    seed, then after each scan j the SLAM velocity (pose_j − pose_{j−1}) /
    (stamp_j − stamp_{j−1}) where that interval exceeds 1e-6 s, else the
    chain's own velocity after integrating window j. From the logged poses
    and stamps, in float32 on `device`."""
    f32 = np.float32
    st = rows[:, 10].astype(f32)
    vel = torch.zeros(3, device=device)
    start = 1
    for j in range(k - 1, 0, -1):          # the last scan before k that resets it
        if st[j] - st[j - 1] > f32(1e-6):
            p = torch.as_tensor(rows[j - 1:j + 1, :3].astype(f32), device=device)
            dt = torch.as_tensor(st[j] - st[j - 1], device=device)
            vel = (p[1] - p[0]) / torch.clamp(dt, min=1e-6)
            start = j + 1
            break
    for j in range(start, k):
        pose = torch.as_tensor(rows[j - 1, :6].astype(f32), device=device)
        _d, vel = integrate_imu(window(imu_arrays, j, device), pose, vel)
    return vel
