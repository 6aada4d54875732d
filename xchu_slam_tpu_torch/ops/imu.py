"""IMU / wheel-odometry integration for NDT initial guesses (port of
`xchu_slam_tpu.ops.imu`).

`integrate_imu` integrates gyro rates into a rotation delta and doubly
integrates gravity-free acceleration for translation; `integrate_wheel_odom`
integrates a wheel-odometry twist; `combine_imu_odom` takes IMU rotation with
wheel translation. The odometry step consumes the resulting delta through
its `ext_delta` input in place of the constant-velocity prediction.

These are chains of 16 dependent 3-vector updates per scan, in the
reference's order of operations, on the device of the pose they are given.
The host engine runs them on CPU float32 tensors from the host copy of the
pose it already holds, and only the 6-vector delta goes to the device.
`ext_guess` is the device engine's whole guess (the reference's
`device_pipeline._ext_guess`): on CUDA tensors it launches the hand-written
kernel `csrc/guess_kernel.cu` (one warp, a lane a chain), on CPU tensors it
runs `ext_guess_ref`, the plain chain. As PyTorch ops on the card the plain
chain is some 300 launches of a few bytes each.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from xchu_slam_tpu_torch.utils import se3

GRAVITY = 9.80665


class ImuWindow(NamedTuple):
    """Fixed-capacity IMU samples between two scans.

    stamps: float32[M]; gyro: float32[M,3] (rad/s, body); accel: float32[M,3]
    (m/s², body, gravity included); mask: bool[M]."""

    stamps: torch.Tensor
    gyro: torch.Tensor
    accel: torch.Tensor
    mask: torch.Tensor


class ImuState(NamedTuple):
    """Velocity estimate carried between scans."""

    velocity: torch.Tensor  # float32[3], world frame


class OdomWindow(NamedTuple):
    """Wheel-odometry twist samples: linear [M,3] + angular [M,3] (body)."""

    stamps: torch.Tensor
    linear: torch.Tensor
    angular: torch.Tensor
    mask: torch.Tensor


def _f32(a, device="cpu") -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _device(pose0) -> torch.device:
    return pose0.device if isinstance(pose0, torch.Tensor) else torch.device("cpu")


def _sample_dt(stamps, mask, device="cpu") -> torch.Tensor:
    """Per-sample integration interval [M]: 0 for sample 0, for masked
    samples and for stamps that run backwards."""
    stamps = _f32(stamps, device)
    dt = torch.diff(stamps, prepend=stamps[:1])
    mask = torch.as_tensor(mask, dtype=torch.bool, device=device)
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

    Returns (delta6 in the world frame, updated ImuState), on pose0's device.
    Per-sample euler sum for attitude; accelerations rotated to world by the
    attitude before the sample, gravity removed, doubly integrated."""
    dev = _device(pose0)
    pose0 = _f32(pose0, dev)
    dt = _sample_dt(window.stamps, window.mask, dev)
    rpys, rpy = _attitude_chain(pose0[3:6], _f32(window.gyro, dev), dt)
    R = se3.euler_to_matrix(rpys)                                  # [M,3,3]
    # filled on the device: a host-built constant would be a copy per call
    gravity = torch.zeros(3, device=dev)
    gravity[2].fill_(GRAVITY)
    a_world = torch.matmul(R, _f32(window.accel, dev)[:, :, None])[:, :, 0] - gravity
    pos, vel = pose0[:3], _f32(state.velocity, dev)
    for k in range(dt.shape[0]):
        pos = pos + vel * dt[k] + 0.5 * a_world[k] * dt[k] * dt[k]
        vel = vel + a_world[k] * dt[k]
    delta = torch.cat([pos - pose0[:3], se3.wrap_angle(rpy - pose0[3:6])])
    return delta, ImuState(velocity=vel)


def integrate_wheel_odom(window: OdomWindow, pose0) -> torch.Tensor:
    """Integrate a wheel-odometry twist into a world-frame delta6, on pose0's
    device."""
    dev = _device(pose0)
    pose0 = _f32(pose0, dev)
    dt = _sample_dt(window.stamps, window.mask, dev)
    rpys, rpy = _attitude_chain(pose0[3:6], _f32(window.angular, dev), dt)
    R = se3.euler_to_matrix(rpys)
    v_world = torch.matmul(R, _f32(window.linear, dev)[:, :, None])[:, :, 0]
    pos = pose0[:3]
    for k in range(dt.shape[0]):
        pos = pos + v_world[k] * dt[k]
    return torch.cat([pos - pose0[:3], se3.wrap_angle(rpy - pose0[3:6])])


def combine_imu_odom(imu_delta: torch.Tensor, odom_delta: torch.Tensor) -> torch.Tensor:
    """Wheel translation + IMU rotation."""
    return torch.cat([odom_delta[:3], imu_delta[3:6]])


def ext_guess_ref(pose0: torch.Tensor, imu: ImuWindow | None, wheel: OdomWindow | None,
                  imu_vel: torch.Tensor, use_imu: bool, use_odom: bool):
    """The device engine's external guess by the plain chain, on pose0's
    device (the reference's `device_pipeline._ext_guess`). Returns (delta
    float32[6], use_ext 0-d bool, imu_vel float32[3]), with nothing read
    back: `use_ext` is true only where every window in use holds a sample
    (the first scan's window is fully masked), and `imu_vel` is the IMU
    chain's velocity (the input where the IMU is off)."""
    dev = pose0.device
    d_imu = d_wheel = None
    have = torch.ones((), dtype=torch.bool, device=dev)
    if use_imu:
        d_imu, st = integrate_imu(imu, pose0, ImuState(velocity=imu_vel))
        imu_vel = st.velocity
        have = have & torch.any(torch.as_tensor(imu.mask, device=dev))
    if use_odom:
        d_wheel = integrate_wheel_odom(wheel, pose0)
        have = have & torch.any(torch.as_tensor(wheel.mask, device=dev))
    if d_imu is not None and d_wheel is not None:
        delta = combine_imu_odom(d_imu, d_wheel)
    elif d_imu is not None:
        delta = d_imu
    elif d_wheel is not None:
        delta = d_wheel
    else:
        return torch.zeros(6, device=dev), torch.zeros((), dtype=torch.bool, device=dev), imu_vel
    return delta, have, imu_vel


def ext_guess(pose0: torch.Tensor, imu: ImuWindow | None, wheel: OdomWindow | None,
              imu_vel: torch.Tensor, use_imu: bool, use_odom: bool):
    """`ext_guess_ref`'s function, routed by pose0's device: CUDA tensors
    launch `csrc/guess_kernel.cu` (or raise), CPU tensors take the plain
    chain."""
    if pose0.device.type == "cpu":
        return ext_guess_ref(pose0, imu, wheel, imu_vel, use_imu, use_odom)
    from xchu_slam_tpu_torch.ops.cuda import guess_kernel

    return guess_kernel.ext_guess(pose0, imu, wheel, imu_vel, use_imu, use_odom)
