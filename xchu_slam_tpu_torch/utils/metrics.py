"""Trajectory evaluation: evo-style APE / RPE (numpy-only copy of
`xchu_slam_tpu.utils.metrics`).

The reference is evaluated offline with `evo_ape tum … -a` / `evo_rpe`
(reference `README.md:57-88`). We implement the same metrics in-repo so the
KITTI parity bound (ATE RMSE ≤ 1.61 m on seq 00) is checked by tests/bench
without external tools.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (optionally similarity) alignment src→dst.

    src, dst: [N, 3]. Returns (R, t, s) with dst ≈ s·R@src + t.
    """
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / src.shape[0]
        s = float(np.trace(np.diag(d) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ape_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray, align: bool = True) -> float:
    """Absolute pose error (translation RMSE), SE(3)-aligned like `evo_ape -a`."""
    est = np.asarray(est_xyz, np.float64)
    gt = np.asarray(gt_xyz, np.float64)
    assert est.shape == gt.shape
    if align:
        R, t, _ = umeyama_alignment(est, gt)
        est = est @ R.T + t
    err = est - gt
    return float(np.sqrt((err ** 2).sum(-1).mean()))


def rpe_rmse(
    est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1
) -> float:
    """Relative pose error over pose pairs `delta` apart. Poses: [N, 4, 4]."""
    est = np.asarray(est_poses, np.float64)
    gt = np.asarray(gt_poses, np.float64)
    errs = []
    for i in range(len(est) - delta):
        d_est = np.linalg.inv(est[i]) @ est[i + delta]
        d_gt = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(d_gt) @ d_est
        errs.append(np.linalg.norm(e[:3, 3]))
    return float(np.sqrt(np.mean(np.square(errs))))


def associate(
    est_stamps: np.ndarray, gt_stamps: np.ndarray, max_diff: float = 0.05
) -> tuple[np.ndarray, np.ndarray]:
    """Nearest-timestamp association (what `evo_ape tum` does before
    comparing): for each est stamp, the closest gt stamp within `max_diff`
    seconds. Returns (est_idx, gt_idx), both [M]. A keyframe trajectory
    (sparse stamps) evaluated against per-scan ground truth MUST be
    associated this way — index-by-index pairing compares poses from
    different instants."""
    est = np.asarray(est_stamps, np.float64)
    gt = np.asarray(gt_stamps, np.float64)
    pos = np.searchsorted(gt, est)
    lo = np.clip(pos - 1, 0, len(gt) - 1)
    hi = np.clip(pos, 0, len(gt) - 1)
    gi = np.where(np.abs(gt[hi] - est) < np.abs(gt[lo] - est), hi, lo)
    ok = np.abs(gt[gi] - est) <= max_diff
    return np.nonzero(ok)[0], gi[ok]


def end_drift(est_xyz: np.ndarray, gt_xyz: np.ndarray) -> tuple[float, float]:
    """(final-position error, trajectory length) — reference README drift metric."""
    est = np.asarray(est_xyz, np.float64)
    gt = np.asarray(gt_xyz, np.float64)
    R, t, _ = umeyama_alignment(est, gt)
    est = est @ R.T + t
    drift = float(np.linalg.norm(est[-1] - gt[-1]))
    length = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    return drift, length
