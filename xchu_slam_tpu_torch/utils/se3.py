"""SE(3) / euler utilities (port of `xchu_slam_tpu.utils.se3`).

pose6 = [x, y, z, roll, pitch, yaw], R = Rz(yaw) @ Ry(pitch) @ Rx(roll)
(ZYX intrinsic), and SE(3) exp/log for the pose-graph optimizer. All
functions broadcast over leading dimensions and keep their input's device
and dtype. Matrix products are full fp32 (TF32 is off, see the package's
`__init__`).
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def euler_to_matrix(rpy: torch.Tensor) -> torch.Tensor:
    """rpy [..., 3] → rotation matrix [..., 3, 3], R = Rz(y)Ry(p)Rx(r)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], -1)
    return torch.stack([row0, row1, row2], -2)


def matrix_to_euler(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] → rpy [..., 3] (ZYX extraction)."""
    sp = torch.clamp(-R[..., 2, 0], -1.0, 1.0)
    pitch = torch.arcsin(sp)
    # gimbal-safe: near |pitch|=90° fall back to yaw=0 split
    cp = torch.sqrt(torch.clamp(1.0 - sp * sp, min=_EPS))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    near_gimbal = cp < 1e-4
    roll_g = torch.atan2(-R[..., 1, 2], R[..., 1, 1])
    roll = torch.where(near_gimbal, roll_g, roll)
    yaw = torch.where(near_gimbal, torch.zeros_like(yaw), yaw)
    return torch.stack([roll, pitch, yaw], -1)


def _bottom_row(like: torch.Tensor, lead) -> torch.Tensor:
    # filled on the device: a host-built row would be a copy per call
    row = like.new_zeros((*lead, 1, 4))
    row[..., 0, 3] = 1.0
    return row


def pose_to_matrix(pose: torch.Tensor) -> torch.Tensor:
    """pose6 [..., 6] → homogeneous transform [..., 4, 4]."""
    R = euler_to_matrix(pose[..., 3:6])
    t = pose[..., :3]
    top = torch.cat([R, t[..., :, None]], -1)
    return torch.cat([top, _bottom_row(R, R.shape[:-2])], -2)


def matrix_to_pose(T: torch.Tensor) -> torch.Tensor:
    return torch.cat([T[..., :3, 3], matrix_to_euler(T[..., :3, :3])], -1)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] transform to pts [..., N, 3]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.matmul(pts, R.transpose(-1, -2)) + t[..., None, :]


def rotate_translate(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Transform pts [N,3] by pose6 [6] without building the 4×4."""
    R = euler_to_matrix(pose[3:6])
    return torch.matmul(pts, R.T) + pose[:3]


def compose(T_a: torch.Tensor, T_b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(T_a, T_b)


def inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -torch.matmul(Rt, t[..., :, None])[..., 0]
    top = torch.cat([Rt, ti[..., :, None]], -1)
    return torch.cat([top, _bottom_row(T, T.shape[:-2])], -2)


# --------------------------------------------------------------------------- #
# so(3) / se(3)
# --------------------------------------------------------------------------- #


def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] → skew-symmetric [..., 3, 3]."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([z, -w[..., 2], w[..., 1]], -1),
            torch.stack([w[..., 2], z, -w[..., 0]], -1),
            torch.stack([-w[..., 1], w[..., 0], z], -1),
        ],
        -2,
    )


def _eye3(w: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=w.dtype, device=w.device).expand(shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] → [..., 3, 3]."""
    theta2 = torch.sum(w * w, -1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(w)
    I = _eye3(w, W.shape)
    a = torch.sin(theta) / theta
    b = (1.0 - torch.cos(theta)) / theta2.clamp(min=_EPS)
    small = (theta2[..., 0, 0] < 1e-8)[..., None, None]
    a = torch.where(small, 1.0 - theta2 / 6.0, a)
    b = torch.where(small, 0.5 - theta2 / 24.0, b)
    return I + a * W + b * torch.matmul(W, W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] → [..., 3]. Safe near the identity under differentiation
    (double-where guards). Every intermediate keeps a trailing dimension of
    size 1: forward-mode AD of 0-d float32 arithmetic with Python scalars
    yields float64 tangents, which breaks the Jacobians in pose_graph."""
    tr = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2])[..., None]
    # keep arccos' argument strictly inside (−1, 1) so its derivative is finite
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0 + 1e-6, 1.0 - 1e-6)
    theta = torch.arccos(cos_t)
    vee = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        -1,
    )
    small = theta < 1e-4
    theta_safe = torch.where(small, torch.ones_like(theta), theta)
    scale_large = theta_safe / (2.0 * torch.sin(theta_safe))
    scale = torch.where(small, 0.5 + theta ** 2 / 12.0, scale_large)
    return scale * vee


def _V_matrix(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3)."""
    theta2 = torch.sum(w * w, -1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(w)
    I = _eye3(w, W.shape)
    b = (1.0 - torch.cos(theta)) / theta2.clamp(min=_EPS)
    c = (theta - torch.sin(theta)) / (theta2.clamp(min=_EPS) * theta)
    small = (theta2[..., 0, 0] < 1e-8)[..., None, None]
    b = torch.where(small, 0.5 - theta2 / 24.0, b)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, c)
    return I + b * W + c * torch.matmul(W, W)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """twist [..., 6] (v, w) → [..., 4, 4]."""
    v, w = xi[..., :3], xi[..., 3:6]
    R = so3_exp(w)
    t = torch.matmul(_V_matrix(w), v[..., :, None])[..., 0]
    top = torch.cat([R, t[..., :, None]], -1)
    return torch.cat([top, _bottom_row(R, R.shape[:-2])], -2)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] → twist [..., 6] (v, w)."""
    w = so3_log(T[..., :3, :3])
    Vinv = torch.linalg.inv(_V_matrix(w))
    v = torch.matmul(Vinv, T[..., :3, 3][..., :, None])[..., 0]
    return torch.cat([v, w], -1)


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi]."""
    return torch.atan2(torch.sin(a), torch.cos(a))

