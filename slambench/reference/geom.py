"""SE(3) helpers of the reference (numpy and torch)."""

from __future__ import annotations

import numpy as np


def pose_to_matrix_np(p: np.ndarray) -> np.ndarray:
    """[..., 6] (x y z roll pitch yaw, R = Rz·Ry·Rx) → [..., 4, 4]."""
    r, pi, y = p[..., 3], p[..., 4], p[..., 5]
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(pi), np.sin(pi), np.cos(y), np.sin(y)
    T = np.zeros(p.shape[:-1] + (4, 4), p.dtype)
    T[..., 0, 0] = cy * cp
    T[..., 0, 1] = cy * sp * sr - sy * cr
    T[..., 0, 2] = cy * sp * cr + sy * sr
    T[..., 1, 0] = sy * cp
    T[..., 1, 1] = sy * sp * sr + cy * cr
    T[..., 1, 2] = sy * sp * cr - cy * sr
    T[..., 2, 0] = -sp
    T[..., 2, 1] = cp * sr
    T[..., 2, 2] = cp * cr
    T[..., :3, 3] = p[..., :3]
    T[..., 3, 3] = 1.0
    return T
