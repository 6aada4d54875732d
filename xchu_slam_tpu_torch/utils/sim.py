"""Synthetic LiDAR world + scan simulator (numpy on the host).

A copy of the part of `xchu_slam_tpu.utils.sim` that the `run-sim` host path
uses: the urban-block world, the squircle circuit, the default
(point-sampled) scan renderer with its optional `WorldIndex`, and the
per-scan IMU / wheel-odometry sample windows. The beam-level sensor model
and moving objects are not ported yet. For the same seed the rendered scans
are bit-identical to the reference's (a test holds them so), because both
draw the same numbers from the same numpy generator in the same order; the
sensor windows agree to 1e-6 (their one float32 rotation is the port's
`se3.euler_to_matrix` on a CPU tensor).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class World(NamedTuple):
    xyz: np.ndarray        # float32 [M, 3]
    intensity: np.ndarray  # float32 [M]


def make_world(
    seed: int = 0,
    extent: float = 120.0,
    n_buildings: int = 14,
    n_pillars: int = 40,
    ground_pts: int = 120_000,
    wall_pts_per_face: int = 4000,
    sensor_height: float = 1.73,
) -> World:
    """Urban-block world. Ground is at z = -sensor_height (sensor at z=0)."""
    rng = np.random.default_rng(seed)
    z0 = -sensor_height
    parts, intens = [], []

    g = np.c_[rng.uniform(-extent, extent, (ground_pts, 2)),
              z0 + rng.normal(0, 0.02, ground_pts)]
    parts.append(g)
    intens.append(np.full(ground_pts, 0.1, np.float32))

    for _ in range(n_buildings):
        cx, cy = rng.uniform(-extent * 0.85, extent * 0.85, 2)
        if np.hypot(cx, cy) < 18.0:
            cx += np.sign(cx or 1.0) * 25.0
        w, d = rng.uniform(8, 25, 2)
        h = rng.uniform(4, 15)
        refl = rng.uniform(0.3, 0.9)
        for face in range(4):
            n = wall_pts_per_face
            u = rng.uniform(0, 1, n)
            v = rng.uniform(0, 1, n)
            if face == 0:
                pts = np.c_[cx + (u - 0.5) * w, np.full(n, cy - d / 2), z0 + v * h]
            elif face == 1:
                pts = np.c_[cx + (u - 0.5) * w, np.full(n, cy + d / 2), z0 + v * h]
            elif face == 2:
                pts = np.c_[np.full(n, cx - w / 2), cy + (u - 0.5) * d, z0 + v * h]
            else:
                pts = np.c_[np.full(n, cx + w / 2), cy + (u - 0.5) * d, z0 + v * h]
            pts += rng.normal(0, 0.02, pts.shape)
            parts.append(pts)
            intens.append(np.full(n, refl, np.float32))

    for _ in range(n_pillars):
        cx, cy = rng.uniform(-extent, extent, 2)
        r = rng.uniform(0.15, 0.5)
        h = rng.uniform(2, 6)
        n = 300
        th = rng.uniform(0, 2 * np.pi, n)
        pts = np.c_[cx + r * np.cos(th), cy + r * np.sin(th),
                    z0 + rng.uniform(0, h, n)]
        parts.append(pts)
        intens.append(np.full(n, 0.95, np.float32))

    return World(
        xyz=np.vstack(parts).astype(np.float32),
        intensity=np.concatenate(intens).astype(np.float32),
    )


def _squircle_dense(radius: float, dense: int = 20000):
    """Densely sampled squircle circuit: (cx, cy, seg, arc, perimeter), the
    single source of the circuit geometry for both trajectory functions."""
    ang = np.linspace(0, 2 * np.pi, dense, endpoint=False)
    cx = radius * np.sign(np.cos(ang)) * np.abs(np.cos(ang)) ** 0.5
    cy = radius * np.sign(np.sin(ang)) * np.abs(np.sin(ang)) ** 0.5
    seg = np.hypot(np.diff(cx, append=cx[:1]), np.diff(cy, append=cy[:1]))
    arc = np.concatenate([[0.0], np.cumsum(seg)])[:-1]
    return cx, cy, seg, arc, arc[-1] + seg[-1]


def loop_trajectory(
    n_scans: int = 300,
    radius: float = 60.0,
    speed: float = 1.2,
    closed: bool = True,
) -> np.ndarray:
    """Rounded-square circuit returning poses [N, 6] (x y z r p y).

    `speed` is metres per scan. A closed circuit revisits its start,
    which guarantees loop-closure opportunities."""
    cx, cy, seg, arc, perimeter = _squircle_dense(radius)
    want = (np.arange(n_scans) * speed) % perimeter if closed else \
        np.minimum(np.arange(n_scans) * speed, perimeter * 0.999)
    ix = np.searchsorted(arc, want, side="right") - 1
    x = np.interp(want, arc, cx)
    y = np.interp(want, arc, cy)
    tx = np.diff(cx, append=cx[:1])[ix]
    ty = np.diff(cy, append=cy[:1])[ix]
    yaw = np.unwrap(np.arctan2(ty, tx))
    poses = np.zeros((n_scans, 6), np.float32)
    poses[:, 0] = x
    poses[:, 1] = y
    poses[:, 5] = yaw
    return poses


def closed_lap_trajectory(n_scans: int, radius: float = 85.0) -> np.ndarray:
    """A closed squircle lap with exactly `n_scans` uniformly spaced poses:
    scan N-1 sits one inter-scan step before scan 0, so a rendered scan list
    cycles seamlessly."""
    *_rest, perimeter = _squircle_dense(radius)
    return loop_trajectory(n_scans=n_scans, radius=radius,
                           speed=perimeter / n_scans, closed=True)


# camera frame (x right, y down, z forward: KITTI cam0, the frame of TUM
# ground-truth files) → z-up body frame (x forward, y left, z up)
CAM_TO_WORLD = np.array([[0.0, 0.0, 1.0],
                         [-1.0, 0.0, 0.0],
                         [0.0, -1.0, 0.0]])


def camera_frame_transform() -> np.ndarray:
    """The [4,4] similarity that takes a z-up trajectory to the camera frame
    (a pure axis rotation: the simulator has no lever arm). Poses map as
    cam_T · T · cam_T⁻¹."""
    cam_T = np.eye(4, dtype=np.float64)
    cam_T[:3, :3] = CAM_TO_WORLD.T
    return cam_T


class WorldIndex:
    """2-D cell index over world points: per-scan candidate gathers touch only
    the cells within sensor range instead of the whole world."""

    def __init__(self, world: World, cell: float = 64.0):
        self.cell = float(cell)
        ij = np.floor(world.xyz[:, :2] / self.cell).astype(np.int64)
        order = np.lexsort((ij[:, 1], ij[:, 0]))
        sij = ij[order]
        change = np.nonzero(np.any(np.diff(sij, axis=0) != 0, axis=1))[0] + 1
        starts = np.concatenate([[0], change, [len(sij)]])
        self.order = order
        self.cells = {
            (int(sij[starts[k], 0]), int(sij[starts[k], 1])):
                (int(starts[k]), int(starts[k + 1]))
            for k in range(len(starts) - 1)
        }

    def query(self, xy, max_range: float) -> np.ndarray:
        """Indices of all world points whose cell intersects the square
        [xy ± max_range] (a superset of the range ball)."""
        i0 = int(np.floor((xy[0] - max_range) / self.cell))
        i1 = int(np.floor((xy[0] + max_range) / self.cell))
        j0 = int(np.floor((xy[1] - max_range) / self.cell))
        j1 = int(np.floor((xy[1] + max_range) / self.cell))
        spans = [self.cells[(i, j)]
                 for i in range(i0, i1 + 1) for j in range(j0, j1 + 1)
                 if (i, j) in self.cells]
        if not spans:
            return np.zeros(0, np.int64)
        return np.concatenate([self.order[lo:hi] for lo, hi in spans])


def render_scan(
    world: World,
    pose6: np.ndarray,
    rng: np.random.Generator,
    max_range: float = 60.0,
    min_range: float = 2.0,
    n_points: int = 24_000,
    noise: float = 0.015,
    index: WorldIndex | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """One scan in the body frame: (xyz [n,3], intensity [n]) float32.

    Points within the range annulus are sampled with ~1/r weighting (denser
    near the sensor) plus isotropic noise."""
    r_, p_, y_ = float(pose6[3]), float(pose6[4]), float(pose6[5])
    cr, sr = np.cos(r_), np.sin(r_)
    cp, sp = np.cos(p_), np.sin(p_)
    cy, sy = np.cos(y_), np.sin(y_)
    R = np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ], np.float32)
    tpos = np.asarray(pose6[:3], np.float32)
    if index is not None:
        cand = index.query(tpos[:2], max_range)
        # stride-thin oversized candidate sets before the distance pass; the
        # index orders candidates by cell block, so a strided subset is
        # spatially unbiased
        budget = 6 * n_points
        if len(cand) > budget:
            step = len(cand) // budget + 1
            cand = cand[int(rng.integers(step))::step]
        world_xyz = world.xyz[cand]
        world_inten = world.intensity[cand]
    else:
        world_xyz = world.xyz
        world_inten = world.intensity
    rel = world_xyz - tpos
    r = np.linalg.norm(rel[:, :2], axis=1)
    sel = (r > min_range) & (r < max_range)
    idx = np.nonzero(sel)[0]
    if len(idx) == 0:
        return (np.zeros((0, 3), np.float32), np.zeros(0, np.float32))

    if len(idx) <= n_points:
        take = idx
    else:
        # ~1/r acceptance sampling (O(M), no weighted choice)
        w = 1.0 / np.maximum(r[idx], 1.0)
        c = n_points / w.sum()
        keep = rng.random(len(idx)) < np.minimum(1.0, 1.15 * c * w)
        take = idx[keep]
        if len(take) > n_points:
            take = take[rng.permutation(len(take))[:n_points]]
    pts_w = world_xyz[take] + rng.normal(0, noise, (len(take), 3))
    body = (pts_w - tpos) @ R  # R⁻¹ = Rᵀ applied on the right
    return body.astype(np.float32), world_inten[take]


class RenderedScans:
    """Indexable lazy scan sequence over (world, poses): scan k is rendered on
    access with a generator of its own, seeded from (seed, k), so that the
    prefetcher's staging threads do the rendering and a long sequence is
    never resident at once. (The scans differ in their noise from those a
    single generator consumed in order gives, as in the reference.)"""

    def __init__(self, world: World, poses: np.ndarray, seed: int = 0,
                 n_points: int = 24_000, index: WorldIndex | None = None,
                 max_range: float = 60.0):
        self.world = world
        self.poses = np.asarray(poses)
        self.seed = seed
        self.n_points = n_points
        self.index = index
        self.max_range = max_range

    def __len__(self) -> int:
        return len(self.poses)

    def __getitem__(self, k: int):
        rng = np.random.default_rng((self.seed + 1) * 1_000_003 + k)
        return render_scan(self.world, self.poses[k], rng, n_points=self.n_points,
                           index=self.index, max_range=self.max_range)


def _interp_traj(gt: np.ndarray, stamps: np.ndarray):
    """(pos(t), rpy(t), vel(t), acc(t)) interpolators over a pose trajectory.

    Angles are unwrapped before interpolation; velocities/accelerations come
    from central differences of the interpolated positions."""
    stamps = np.asarray(stamps, np.float64)
    pos = np.asarray(gt[:, :3], np.float64)
    rpy = np.unwrap(np.asarray(gt[:, 3:6], np.float64), axis=0)

    def pos_t(t):
        return np.stack([np.interp(t, stamps, pos[:, k]) for k in range(3)], -1)

    def rpy_t(t):
        return np.stack([np.interp(t, stamps, rpy[:, k]) for k in range(3)], -1)

    def vel_t(t, h=1e-3):
        return (pos_t(t + h) - pos_t(t - h)) / (2 * h)

    def acc_t(t, h=2e-2):
        return (vel_t(t + h) - vel_t(t - h)) / (2 * h)

    return pos_t, rpy_t, vel_t, acc_t


def _body_rotations(rpy_mid: np.ndarray) -> np.ndarray:
    """float32 rotation matrices [M,3,3] of euler angles [M,3], computed as
    the engine computes them."""
    import torch

    from xchu_slam_tpu_torch.utils import se3

    return se3.euler_to_matrix(
        torch.from_numpy(np.asarray(rpy_mid, np.float32))).numpy()


def imu_windows(gt: np.ndarray, stamps: np.ndarray, samples: int = 16,
                rng: np.random.Generator | None = None,
                gyro_noise: float = 0.0, accel_noise: float = 0.0):
    """Synthesize per-scan IMU sample windows along a pose trajectory.

    Returns numpy arrays shaped for `ops.imu.ImuWindow` with a leading scan
    axis N: (stamps [N,M], gyro [N,M,3], accel [N,M,3], mask [N,M]). Window i
    covers (t_{i-1}, t_i]; window 0 is fully masked (no pre-first-scan data).
    Gyro samples are euler-angle rates; accel is body-frame specific force
    (gravity included) matching `integrate_imu`'s model."""
    from xchu_slam_tpu_torch.ops.imu import GRAVITY

    gt = np.asarray(gt, np.float64)
    stamps = np.asarray(stamps, np.float64)
    N, M = len(gt), samples
    pos_t, rpy_t, vel_t, acc_t = _interp_traj(gt, stamps)
    out_stamps = np.zeros((N, M), np.float32)
    out_gyro = np.zeros((N, M, 3), np.float32)
    out_accel = np.zeros((N, M, 3), np.float32)
    out_mask = np.zeros((N, M), bool)
    gvec = np.array([0.0, 0.0, GRAVITY])
    for i in range(1, N):
        t0, t1 = stamps[i - 1], stamps[i]
        ts = np.linspace(t0, t1, M)
        # sample k integrates over (ts[k-1], ts[k]] → evaluate rates/accels at
        # sub-interval midpoints (sample 0 has dt=0 inside integrate_imu)
        mid = np.concatenate([[t0], 0.5 * (ts[1:] + ts[:-1])])
        gyro = np.gradient(rpy_t(ts), ts, axis=0)
        gyro = np.stack([np.interp(mid, ts, gyro[:, k]) for k in range(3)], -1)
        aw = acc_t(np.clip(mid, stamps[0] + 0.05, stamps[-1] - 0.05))
        R = _body_rotations(rpy_t(mid))
        accel = np.einsum("mba,mb->ma", R, aw + gvec)
        if rng is not None and (gyro_noise or accel_noise):
            gyro = gyro + rng.normal(0, gyro_noise, gyro.shape)
            accel = accel + rng.normal(0, accel_noise, accel.shape)
        out_stamps[i] = ts
        out_gyro[i] = gyro
        out_accel[i] = accel
        out_mask[i] = True
    return out_stamps, out_gyro, out_accel, out_mask


def wheel_windows(gt: np.ndarray, stamps: np.ndarray, samples: int = 16,
                  rng: np.random.Generator | None = None,
                  vel_noise: float = 0.0, gyro_noise: float = 0.0):
    """Synthesize per-scan wheel-odometry twist windows: body-frame linear
    velocity + euler rates. Shapes as `ops.imu.OdomWindow` with a leading
    scan axis; window 0 masked."""
    gt = np.asarray(gt, np.float64)
    stamps = np.asarray(stamps, np.float64)
    N, M = len(gt), samples
    pos_t, rpy_t, vel_t, _ = _interp_traj(gt, stamps)
    out_stamps = np.zeros((N, M), np.float32)
    out_lin = np.zeros((N, M, 3), np.float32)
    out_ang = np.zeros((N, M, 3), np.float32)
    out_mask = np.zeros((N, M), bool)
    for i in range(1, N):
        t0, t1 = stamps[i - 1], stamps[i]
        ts = np.linspace(t0, t1, M)
        mid = np.concatenate([[t0], 0.5 * (ts[1:] + ts[:-1])])
        vw = vel_t(np.clip(mid, stamps[0] + 0.05, stamps[-1] - 0.05))
        ang = np.gradient(rpy_t(ts), ts, axis=0)
        ang = np.stack([np.interp(mid, ts, ang[:, k]) for k in range(3)], -1)
        R = _body_rotations(rpy_t(mid))
        lin = np.einsum("mba,mb->ma", R, vw)
        if rng is not None and (vel_noise or gyro_noise):
            lin = lin + rng.normal(0, vel_noise, lin.shape)
            ang = ang + rng.normal(0, gyro_noise, ang.shape)
        out_stamps[i] = ts
        out_lin[i] = lin
        out_ang[i] = ang
        out_mask[i] = True
    return out_stamps, out_lin, out_ang, out_mask
