"""IMU / wheel-odometry integration for NDT initial guesses (port of
`xchu_slam_tpu.ops.imu`).

`integrate_imu` integrates gyro rates into a rotation delta and doubly
integrates gravity-free acceleration for translation; `integrate_wheel_odom`
integrates a wheel-odometry twist; `combine_imu_odom` takes IMU rotation with
wheel translation. The odometry step consumes the resulting delta through
its `ext_delta` input in place of the constant-velocity prediction.

These are chains of 16 dependent 3-vector updates per scan. The reference
runs them as `lax.scan`s inside its device program; here they run on the
host, on CPU float32 tensors in the reference's order of operations, from
the host copy of the pose the pipeline already holds, and only the 6-vector
delta goes to the device. As device ops they would be ~150 launches of a
few bytes each per scan.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from xchu_slam_tpu_torch.utils import se3

GRAVITY = 9.80665


class ImuWindow(NamedTuple):
    """Fixed-capacity IMU samples between two scans (CPU tensors).

    stamps: float32[M]; gyro: float32[M,3] (rad/s, body); accel: float32[M,3]
    (m/s², body, gravity included); mask: bool[M]."""

    stamps: torch.Tensor
    gyro: torch.Tensor
    accel: torch.Tensor
    mask: torch.Tensor


class ImuState(NamedTuple):
    """Velocity estimate carried between scans."""

    velocity: torch.Tensor  # float32[3], world frame, on the CPU


class OdomWindow(NamedTuple):
    """Wheel-odometry twist samples: linear [M,3] + angular [M,3] (body)."""

    stamps: torch.Tensor
    linear: torch.Tensor
    angular: torch.Tensor
    mask: torch.Tensor


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device="cpu")


def _sample_dt(stamps, mask) -> torch.Tensor:
    """Per-sample integration interval [M]: 0 for sample 0, for masked
    samples and for stamps that run backwards."""
    stamps = _f32(stamps)
    dt = torch.diff(stamps, prepend=stamps[:1])
    mask = torch.as_tensor(mask, dtype=torch.bool, device="cpu")
    return torch.where(mask, torch.clamp(dt, min=0.0), 0.0)


def _attitude_chain(rpy0: torch.Tensor, rates: torch.Tensor, dt: torch.Tensor):
    """Euler-rate integration. Returns (the attitude before each sample
    [M,3], the attitude after the last)."""
    before, rpy = [], rpy0
    for k in range(rates.shape[0]):
        before.append(rpy)
        rpy = se3.wrap_angle(rpy + rates[k] * dt[k])
    return torch.stack(before), rpy


def integrate_imu(window: ImuWindow, pose0, state: ImuState
                  ) -> tuple[torch.Tensor, ImuState]:
    """Integrate one inter-scan IMU window from world pose `pose0`.

    Returns (delta6 in the world frame, updated ImuState). Per-sample euler
    sum for attitude; accelerations rotated to world by the attitude before
    the sample, gravity removed, doubly integrated."""
    pose0 = _f32(pose0)
    dt = _sample_dt(window.stamps, window.mask)
    rpys, rpy = _attitude_chain(pose0[3:6], _f32(window.gyro), dt)
    R = se3.euler_to_matrix(rpys)                                  # [M,3,3]
    gravity = torch.tensor([0.0, 0.0, GRAVITY])
    a_world = torch.matmul(R, _f32(window.accel)[:, :, None])[:, :, 0] - gravity
    pos, vel = pose0[:3], _f32(state.velocity)
    for k in range(dt.shape[0]):
        pos = pos + vel * dt[k] + 0.5 * a_world[k] * dt[k] * dt[k]
        vel = vel + a_world[k] * dt[k]
    delta = torch.cat([pos - pose0[:3], se3.wrap_angle(rpy - pose0[3:6])])
    return delta, ImuState(velocity=vel)


def integrate_wheel_odom(window: OdomWindow, pose0) -> torch.Tensor:
    """Integrate a wheel-odometry twist into a world-frame delta6."""
    pose0 = _f32(pose0)
    dt = _sample_dt(window.stamps, window.mask)
    rpys, rpy = _attitude_chain(pose0[3:6], _f32(window.angular), dt)
    R = se3.euler_to_matrix(rpys)
    v_world = torch.matmul(R, _f32(window.linear)[:, :, None])[:, :, 0]
    pos = pose0[:3]
    for k in range(dt.shape[0]):
        pos = pos + v_world[k] * dt[k]
    return torch.cat([pos - pose0[:3], se3.wrap_angle(rpy - pose0[3:6])])


def combine_imu_odom(imu_delta: torch.Tensor, odom_delta: torch.Tensor) -> torch.Tensor:
    """Wheel translation + IMU rotation."""
    return torch.cat([odom_delta[:3], imu_delta[3:6]])
