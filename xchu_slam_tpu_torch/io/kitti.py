"""KITTI / TUM trajectory + velodyne IO (numpy only; a copy of
`xchu_slam_tpu.io.kitti`, which the port may not import).

- velodyne `.bin` scans: float32 [N, 4] (x, y, z, intensity)
- TUM trajectories: `stamp x y z qx qy qz qw`
- KITTI pose files: 12 floats per line, row-major 3×4
- velo→camera extrinsic used for the TUM export of real KITTI runs

A test holds every function equal to the original's on the same input, and
files written by one package are read by the other.
"""

from __future__ import annotations

import os

import numpy as np

# KITTI calib: velodyne → left camera (seq 00-02 calibration, as hard-coded in
# the reference export at pgo_node.cpp:687-691)
T_CAM_VELO = np.array(
    [
        [4.276802385584e-04, -9.999672484946e-01, -8.084491683471e-03, -1.198459927713e-02],
        [-7.210626507497e-03, 8.081198471645e-03, -9.999413164504e-01, -5.403984729748e-02],
        [9.999738645903e-01, 4.859485810390e-04, -7.206933692422e-03, -2.921968648686e-01],
        [0.0, 0.0, 0.0, 1.0],
    ]
)


def read_velodyne_bin(path: str) -> np.ndarray:
    """Read one KITTI velodyne scan → float32 [N, 4]."""
    pts = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return pts[np.isfinite(pts).all(axis=1)]


def list_velodyne_dir(seq_dir: str) -> list[str]:
    files = sorted(f for f in os.listdir(seq_dir) if f.endswith(".bin"))
    return [os.path.join(seq_dir, f) for f in files]


# --------------------------------------------------------------------------- #
# trajectory formats
# --------------------------------------------------------------------------- #


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """[qx, qy, qz, qw] → 3×3."""
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0 else 2.0 / n
    return np.array(
        [
            [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
            [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
            [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
        ]
    )


def matrix_to_quat(R: np.ndarray) -> np.ndarray:
    """3×3 → [qx, qy, qz, qw]."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])


def read_tum(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read TUM file → (stamps [N], poses [N, 4, 4])."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    stamps = data[:, 0]
    poses = np.tile(np.eye(4), (len(data), 1, 1))
    poses[:, :3, 3] = data[:, 1:4]
    for i, q in enumerate(data[:, 4:8]):
        poses[i, :3, :3] = quat_to_matrix(q)
    return stamps, poses


def write_tum(path: str, stamps: np.ndarray, poses: np.ndarray) -> None:
    with open(path, "w") as f:
        for s, T in zip(stamps, poses):
            q = matrix_to_quat(T[:3, :3])
            t = T[:3, 3]
            f.write(
                f"{s:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


def read_kitti_poses(path: str) -> np.ndarray:
    """KITTI 12-float pose file → [N, 4, 4]."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    poses = np.tile(np.eye(4), (len(data), 1, 1))
    poses[:, :3, :4] = data.reshape(-1, 3, 4)
    return poses


def velo_to_cam(poses_velo: np.ndarray) -> np.ndarray:
    """Convert map-frame velodyne poses to the camera frame used by KITTI GT,
    mirroring the reference's TUM export transform (pgo_node.cpp:687-691)."""
    return T_CAM_VELO @ poses_velo @ np.linalg.inv(T_CAM_VELO)
