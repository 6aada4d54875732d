"""An ICP verification scene made from a seed with the port's simulator,
shared by the card tests and `chip_smoke.py`: a keyframe cloud of N points
and a submap of M points around it (8 neighbouring scans in the middle
one's frame), padded and masked to the fixed shapes, with a guess 0.4 m /
0.05 rad off the true relative pose."""

import numpy as np
import torch

from xchu_slam_tpu_torch.utils import se3, sim


def scene(device, seed: int = 3, n: int = 4096, m: int = 16384, points: int = 4000):
    """(src [n,3], src_mask [n], tgt [m,3], tgt_mask [m], init_T [4,4]) on
    `device`."""
    world = sim.make_world(seed, extent=60.0)
    rng = np.random.default_rng(seed)
    gt = sim.loop_trajectory(12, radius=15.0, speed=1.0)
    T = se3.pose_to_matrix(torch.from_numpy(np.asarray(gt, np.float32))).numpy()
    sub = []
    for k in range(2, 10):
        xyz = sim.render_scan(world, gt[k], rng, n_points=points)[0]
        rel = np.linalg.inv(T[6]) @ T[k]
        sub.append(xyz @ rel[:3, :3].T + rel[:3, 3])
    tgt = np.vstack(sub).astype(np.float32)[:m]
    tmask = np.arange(m) < len(tgt)
    tgt = np.pad(tgt, ((0, m - len(tgt)), (0, 0)))
    src = sim.render_scan(world, gt[7], rng, n_points=n)[0][:n].astype(np.float32)
    smask = np.arange(n) < len(src)
    src = np.pad(src, ((0, n - len(src)), (0, 0)))
    off = se3.pose_to_matrix(torch.tensor([0.3, -0.25, 0.0, 0.0, 0.0, 0.05])).numpy()
    init = ((np.linalg.inv(T[6]) @ T[7]) @ off).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (src, smask, tgt, tmask, init))


def _packed(device, src, tgt, n, m, init):
    smask, tmask = np.arange(n) < len(src), np.arange(m) < len(tgt)
    src = np.pad(src[:n], ((0, n - min(n, len(src))), (0, 0)))
    tgt = np.pad(tgt[:m], ((0, m - min(m, len(tgt))), (0, 0)))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (src.astype(np.float32), smask, tgt.astype(np.float32), tmask,
                           init.astype(np.float32)))


def planar_scene(device, seed: int = 5, n: int = 4096, m: int = 16384):
    """A flat lot: both clouds sample the plane z = 0 (1 cm of noise) over
    60 m × 60 m, so the cross-covariance is nearly rank 2; the guess is
    0.3 m / 0.05 rad off."""
    rng = np.random.default_rng(seed)

    def lot(k):
        xy = rng.uniform(-30.0, 30.0, (k, 2))
        return np.c_[xy, rng.normal(0.0, 0.01, k)]

    init = se3.pose_to_matrix(torch.tensor([0.3, -0.2, 0.02, 0.0, 0.0, 0.05])).numpy()
    return _packed(device, lot(n - 96), lot(m - 512), n, m, init)


def reflection_scene(device, seed: int = 6, n: int = 4096, m: int = 16384):
    """The submap is the keyframe's mirror image (x → −x): one keyframe point
    in each cell of a 2 m grid in y and z, x within ±0.6 m, and four noisy
    copies of its mirror point in the submap, so each point's nearest
    neighbour is its own mirror. The cross-covariance is then diag(−, +, +)
    (det < 0): the best orthogonal fit is a reflection, and the rotation
    step must return the best proper rotation instead."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(n))
    y, z = np.meshgrid(2.0 * np.arange(side), 2.0 * np.arange(side), indexing="ij")
    src = np.c_[rng.uniform(-0.6, 0.6, side * side), y.ravel() - side, z.ravel() - side]
    tgt = np.vstack([src * [-1.0, 1.0, 1.0] + rng.normal(0.0, 0.01, src.shape)
                     for _ in range(m // len(src))])
    init = se3.pose_to_matrix(torch.tensor([0.05, 0.05, 0.0, 0.0, 0.0, 0.002])).numpy()
    return _packed(device, src, tgt, n, m, init)
