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
