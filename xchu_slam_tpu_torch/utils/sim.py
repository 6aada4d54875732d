"""Synthetic LiDAR world + scan simulator (numpy on the host).

A copy of `xchu_slam_tpu.utils.sim`: the urban-block world and the
squircle circuit; a TUM trajectory file as poses (`tum_trajectory_poses`)
and a corridor world along any path (`make_world_along`); the scan
renderer, point-sampled by default, or beam-level with a `SensorModel` and
moving `DynamicObjects` (`run-sim --realism`), with its optional
`WorldIndex`; the lazy per-scan `RenderedScans`; `simulate_sequence`; and
the per-scan IMU / wheel-odometry sample windows. For the same seed the
rendered scans and worlds are bit-identical to the reference's (tests hold
them so), because both draw the same numbers from the same numpy generator
in the same order; the sensor windows agree to 1e-6 (their one float32
rotation is the port's `se3.euler_to_matrix` on a CPU tensor). The render
is numpy on the host by design: it must not contend with the engine for the
card, and it is what the forked workers of `io/procsource.py` run.
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


def _decimate_by_arclen(path_xy_or_xyz: np.ndarray, step: float) -> np.ndarray:
    """Indices of path samples ~`step` metres apart along cumulative arclength."""
    p = np.asarray(path_xy_or_xyz, np.float64)[:, :2]
    seg = np.linalg.norm(np.diff(p, axis=0), axis=1)
    arc = np.concatenate([[0.0], np.cumsum(seg)])
    want = np.arange(0.0, arc[-1], step)
    return np.unique(np.searchsorted(arc, want))


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """Unit quaternions [N,4] (x,y,z,w — TUM order) → rotations [N,3,3]."""
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty((len(q), 3, 3), np.float64)
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - z * w)
    R[:, 0, 2] = 2 * (x * z + y * w)
    R[:, 1, 0] = 2 * (x * y + z * w)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - x * w)
    R[:, 2, 0] = 2 * (x * z - y * w)
    R[:, 2, 1] = 2 * (y * z + x * w)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R


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


def tum_trajectory_poses(
    path: str, max_scans: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Load a TUM trajectory (`ts x y z qx qy qz qw`, camera frame, e.g. a
    KITTI ground-truth sequence in TUM form) as (stamps [N], z-up body
    poses [N, 6] (x y z roll pitch yaw)). Stamps are the file's own, so a
    run stamped with them evaluates against the file by timestamp
    association. It drives the simulator along a real trajectory's
    geometry (streets, junctions, loop revisits)."""
    raw = np.loadtxt(path)
    if max_scans:
        raw = raw[:max_scans]
    p_cam = raw[:, 1:4]
    R_cam = _quat_to_matrix(raw[:, 4:8])
    C = CAM_TO_WORLD
    p_w = p_cam @ C.T
    R_w = np.einsum("ab,nbc,dc->nad", C, R_cam, C)
    poses = np.zeros((len(raw), 6), np.float32)
    poses[:, :3] = p_w
    # ZYX euler matching render_scan / utils.se3: R = Rz(y)·Ry(p)·Rx(r)
    poses[:, 3] = np.arctan2(R_w[:, 2, 1], R_w[:, 2, 2])
    poses[:, 4] = -np.arcsin(np.clip(R_w[:, 2, 0], -1.0, 1.0))
    poses[:, 5] = np.arctan2(R_w[:, 1, 0], R_w[:, 0, 0])
    return raw[:, 0].astype(np.float64), poses


def make_world_along(
    path_xyz: np.ndarray,
    seed: int = 0,
    sensor_height: float = 1.73,
    ground_step: float = 8.0,
    ground_radius: float = 70.0,
    ground_pts_per: int = 1200,
    building_step: float = 20.0,
    building_prob: float = 0.75,
    wall_pts_per_face: int = 1500,
    pillar_step: float = 6.0,
    corridor_clear: float = 7.0,
) -> World:
    """Urban-corridor world along an arbitrary trajectory (vs `make_world`'s
    fixed square block): ground discs riding the path's height profile,
    buildings at lateral offsets off the path tangent, pillars near the
    roadside. Feature positions depend only on (path, seed), so revisited
    streets present identical structure — the property loop closure needs."""
    rng = np.random.default_rng(seed)
    path = np.asarray(path_xyz, np.float64)
    zref = _decimate_by_arclen(path, 4.0)          # z-profile lookup samples
    P = path[zref]

    def nearest_path_z(xy: np.ndarray) -> np.ndarray:
        out = np.empty(len(xy))
        for lo in range(0, len(xy), 65536):
            chunk = xy[lo:lo + 65536]
            d2 = ((chunk[:, None, :] - P[None, :, :2]) ** 2).sum(-1)
            out[lo:lo + 65536] = P[d2.argmin(1), 2]
        return out

    parts, intens = [], []

    gi = _decimate_by_arclen(path, ground_step)
    n_g = len(gi) * ground_pts_per
    th = rng.uniform(0, 2 * np.pi, n_g)
    rr = ground_radius * np.sqrt(rng.uniform(0, 1, n_g))
    centers = np.repeat(path[gi, :2], ground_pts_per, axis=0)
    gxy = centers + np.c_[rr * np.cos(th), rr * np.sin(th)]
    gz = nearest_path_z(gxy) - sensor_height + rng.normal(0, 0.02, n_g)
    parts.append(np.c_[gxy, gz])
    intens.append(np.full(n_g, 0.1, np.float32))

    bi = _decimate_by_arclen(path, building_step)
    tang = np.gradient(path[:, :2], axis=0)
    tang /= np.maximum(np.linalg.norm(tang, axis=1, keepdims=True), 1e-9)
    for i in bi:
        if rng.uniform() > building_prob:
            continue
        nrm = np.array([-tang[i, 1], tang[i, 0]])
        side = rng.choice([-1.0, 1.0])
        off = rng.uniform(14.0, 45.0)
        cx, cy = path[i, :2] + side * off * nrm
        w, d = rng.uniform(8, 25, 2)
        h = rng.uniform(4, 15)
        half_diag = 0.5 * np.hypot(w, d)
        if np.min(np.hypot(P[:, 0] - cx, P[:, 1] - cy)) < half_diag + corridor_clear:
            continue
        z0 = nearest_path_z(np.array([[cx, cy]]))[0] - sensor_height
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

    pi = _decimate_by_arclen(path, pillar_step)
    for i in pi:
        nrm = np.array([-tang[i, 1], tang[i, 0]])
        side = rng.choice([-1.0, 1.0])
        cx, cy = path[i, :2] + side * rng.uniform(4.0, 11.0) * nrm
        r = rng.uniform(0.15, 0.5)
        h = rng.uniform(2, 6)
        n = 250
        z0 = path[zref[np.argmin(np.hypot(P[:, 0] - cx, P[:, 1] - cy))], 2] \
            - sensor_height
        a = rng.uniform(0, 2 * np.pi, n)
        pts = np.c_[cx + r * np.cos(a), cy + r * np.sin(a),
                    z0 + rng.uniform(0, h, n)]
        parts.append(pts)
        intens.append(np.full(n, 0.95, np.float32))

    return World(
        xyz=np.vstack(parts).astype(np.float32),
        intensity=np.concatenate(intens).astype(np.float32),
    )



class WorldIndex:
    """2-D cell index over world points: per-scan candidate gathers touch only
    the cells within sensor range instead of the whole world (a world along
    a long trajectory holds millions of points)."""

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


class SensorModel(NamedTuple):
    """Beam-level LiDAR realism knobs (what makes real data harder than a
    point-sampled world). Modeled on the KITTI
    HDL-64E: 64 discrete elevation beams spanning +2.0°…−24.8°, one return
    per (azimuth, beam) ray with hard occlusion, range/reflectivity-dependent
    dropout, radial (along-ray) range noise, and range-attenuated intensity."""

    n_beams: int = 64
    elev_min: float = -0.4328     # rad (−24.8°, HDL-64E lower bound)
    elev_max: float = 0.0349      # rad (+2.0°)
    beam_tol: float = 0.35        # accept within this fraction of beam spacing
    az_bins: int = 1800           # 0.2° azimuth resolution
    occlusion: bool = True        # keep only the nearest return per ray
    dropout_base: float = 0.02    # always-on miss probability
    dropout_range: float = 0.30   # extra misses at max range (scaled by (r/R)²)
    dropout_dark: float = 0.20    # extra misses for low-reflectivity surfaces
    noise_floor: float = 0.008    # radial σ at 0 m
    noise_per_m: float = 0.0004   # radial σ growth with range
    inten_atten: float = 40.0     # intensity ~ refl / (1 + (r/this)²)


class DynamicObjects:
    """Moving box objects (car-sized) travelling the trajectory corridor —
    traffic the static-world assumption of NDT/SC must survive. Each object
    follows the path arc at its own speed (some opposing), offset into a
    lane; its surface points are rendered per scan time and occlude the
    static world behind them through the sensor z-buffer."""

    def __init__(self, path_xyz: np.ndarray, seed: int = 0,
                 n_objects: int = 12, pts_per: int = 500,
                 speed_range: tuple[float, float] = (3.0, 9.0),
                 lane_offsets: tuple[float, float] = (2.5, 5.0),
                 sensor_height: float = 1.73):
        rng = np.random.default_rng(seed + 77)
        p = np.asarray(path_xyz, np.float64)
        seg = np.linalg.norm(np.diff(p[:, :2], axis=0), axis=1)
        self._arc = np.concatenate([[0.0], np.cumsum(seg)])
        self._path = p
        self._total = float(self._arc[-1])
        n = max(n_objects, 0)
        self._s0 = rng.uniform(0, self._total, n)
        self._v = rng.uniform(*speed_range, n) * rng.choice([-1.0, 1.0], n)
        self._lane = rng.uniform(*lane_offsets, n) * rng.choice([-1.0, 1.0], n)
        self._dims = np.c_[rng.uniform(3.6, 4.8, n),     # length
                           rng.uniform(1.6, 2.0, n),     # width
                           rng.uniform(1.3, 1.7, n)]     # height
        self._refl = rng.uniform(0.4, 0.8, n)
        self._z0 = -sensor_height
        # per-object box surface point template (unit box, local frame)
        self._tmpl = []
        for k in range(n):
            m = pts_per
            u, v, face = (rng.uniform(-0.5, 0.5, m), rng.uniform(0, 1, m),
                          rng.integers(0, 5, m))
            L, W, H = self._dims[k]
            pts = np.zeros((m, 3))
            pts[face == 0] = np.c_[u[face == 0] * L,
                                   np.full((face == 0).sum(), -W / 2),
                                   v[face == 0] * H]
            pts[face == 1] = np.c_[u[face == 1] * L,
                                   np.full((face == 1).sum(), W / 2),
                                   v[face == 1] * H]
            pts[face == 2] = np.c_[np.full((face == 2).sum(), -L / 2),
                                   u[face == 2] * W, v[face == 2] * H]
            pts[face == 3] = np.c_[np.full((face == 3).sum(), L / 2),
                                   u[face == 3] * W, v[face == 3] * H]
            pts[face == 4] = np.c_[u[face == 4] * L, (v[face == 4] - 0.5) * W,
                                   np.full((face == 4).sum(), H)]
            self._tmpl.append(pts)

    def _pose_at_arc(self, s: np.ndarray):
        s = np.mod(s, self._total)
        x = np.interp(s, self._arc, self._path[:, 0])
        y = np.interp(s, self._arc, self._path[:, 1])
        z = np.interp(s, self._arc, self._path[:, 2]) \
            if self._path.shape[1] > 2 else np.zeros_like(x)
        ds = 1.0
        x2 = np.interp(np.mod(s + ds, self._total), self._arc,
                       self._path[:, 0])
        y2 = np.interp(np.mod(s + ds, self._total), self._arc,
                       self._path[:, 1])
        yaw = np.arctan2(y2 - y, x2 - x)
        return x, y, z, yaw

    def points_at(self, t: float) -> tuple[np.ndarray, np.ndarray]:
        """World-frame surface points of every object at time t (seconds)."""
        if len(self._s0) == 0:
            return np.zeros((0, 3), np.float32), np.zeros(0, np.float32)
        x, y, z, yaw = self._pose_at_arc(self._s0 + self._v * t)
        parts, intens = [], []
        for k in range(len(self._s0)):
            c, s = np.cos(yaw[k]), np.sin(yaw[k])
            nrm = np.array([-s, c])
            R = np.array([[c, -s], [s, c]])
            pts = self._tmpl[k].copy()
            pts[:, :2] = pts[:, :2] @ R.T
            pts[:, 0] += x[k] + self._lane[k] * nrm[0]
            pts[:, 1] += y[k] + self._lane[k] * nrm[1]
            pts[:, 2] += z[k] + self._z0
            parts.append(pts)
            intens.append(np.full(len(pts), self._refl[k], np.float32))
        return (np.vstack(parts).astype(np.float32),
                np.concatenate(intens).astype(np.float32))


def render_scan(
    world: World,
    pose6: np.ndarray,
    rng: np.random.Generator,
    max_range: float = 60.0,
    min_range: float = 2.0,
    n_points: int = 24_000,
    noise: float = 0.015,
    index: "WorldIndex | None" = None,
    sensor: SensorModel | None = None,
    dynamics: DynamicObjects | None = None,
    t: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """One scan in the body frame: (xyz [n,3], intensity [n]) float32.

    Default (sensor=None): points within the range annulus sampled with ~1/r
    weighting (denser near the sensor) plus isotropic noise.

    With a `SensorModel`, the scan goes through a beam-level pipeline
    instead: 64-beam elevation quantization, per-(azimuth, beam)-ray hard
    occlusion (nearest return wins — a z-buffer over the polar image),
    range/reflectivity-dependent dropout, radial range noise, and
    range-attenuated intensities. `dynamics` injects moving objects at scan
    time `t` that occlude the static world behind them."""
    # pure NumPy (no device round trip: the simulator must not contend with
    # the SLAM engine for the accelerator)
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
        # stride-thin oversized candidate sets before the distance pass (the
        # render's cost is the norm/accept math over every candidate). The
        # index orders candidates by cell block, so
        # a strided subset is spatially unbiased; 6× the point budget keeps
        # the annulus + 1/r acceptance statistics intact. Skipped for the
        # beam-level sensor model, whose per-ray occlusion needs the full
        # surface sampling.
        budget = 6 * n_points
        if sensor is None and len(cand) > budget:
            step = len(cand) // budget + 1
            cand = cand[int(rng.integers(step))::step]
        world_xyz = world.xyz[cand]
        world_inten = world.intensity[cand]
    else:
        world_xyz = world.xyz
        world_inten = world.intensity
    if dynamics is not None:
        dxyz, dint = dynamics.points_at(t)
        if len(dxyz):
            near = np.linalg.norm(dxyz[:, :2] - tpos[None, :2],
                                  axis=1) < max_range + 3.0
            world_xyz = np.vstack([world_xyz, dxyz[near]])
            world_inten = np.concatenate([world_inten, dint[near]])
    rel = world_xyz - tpos
    r = np.linalg.norm(rel[:, :2], axis=1)
    sel = (r > min_range) & (r < max_range)
    idx = np.nonzero(sel)[0]
    if len(idx) == 0:
        return (np.zeros((0, 3), np.float32), np.zeros(0, np.float32))

    if sensor is not None:
        sm = sensor
        rel_s = rel[idx]
        r_xy = r[idx]
        r3 = np.linalg.norm(rel_s, axis=1)
        inten = world_inten[idx]
        # --- beam quantization: keep points lying on a discrete beam ------ #
        elev = np.arctan2(rel_s[:, 2], r_xy)
        d_el = (sm.elev_max - sm.elev_min) / max(sm.n_beams - 1, 1)
        beam_f = (elev - sm.elev_min) / d_el
        beam = np.round(beam_f).astype(np.int64)
        on_beam = (np.abs(beam_f - beam) <= sm.beam_tol) & \
            (beam >= 0) & (beam < sm.n_beams)
        # --- per-(azimuth, beam) ray z-buffer: nearest return wins -------- #
        az = np.arctan2(rel_s[:, 1], rel_s[:, 0])
        azb = np.minimum((az + np.pi) / (2 * np.pi) * sm.az_bins,
                         sm.az_bins - 1).astype(np.int64)
        ki = np.nonzero(on_beam)[0]
        if sm.occlusion and len(ki):
            key = azb[ki] * sm.n_beams + beam[ki]
            order = np.lexsort((r3[ki], key))
            first = np.concatenate([[True],
                                    np.diff(key[order]) != 0])
            ki = ki[order[first]]
        # --- range/reflectivity-dependent dropout ------------------------- #
        if len(ki):
            p_drop = (sm.dropout_base
                      + sm.dropout_range * (r3[ki] / max_range) ** 2
                      + sm.dropout_dark * np.maximum(0.0, 0.5 - inten[ki]))
            ki = ki[rng.random(len(ki)) > np.clip(p_drop, 0.0, 0.95)]
        if len(ki) > n_points:
            ki = ki[rng.permutation(len(ki))[:n_points]]
        if len(ki) == 0:
            return (np.zeros((0, 3), np.float32), np.zeros(0, np.float32))
        # --- radial range noise + attenuated intensity -------------------- #
        ray = rel_s[ki] / np.maximum(r3[ki], 1e-6)[:, None]
        sig = sm.noise_floor + sm.noise_per_m * r3[ki]
        pts_w = world_xyz[idx[ki]] + ray * (rng.normal(0, 1.0, len(ki))
                                            * sig)[:, None]
        out_int = inten[ki] / (1.0 + (r3[ki] / sm.inten_atten) ** 2)
        out_int = np.clip(out_int + rng.normal(0, 0.02, len(ki)), 0.0, 1.0)
        body = (pts_w - tpos) @ R
        return body.astype(np.float32), out_int.astype(np.float32)

    if len(idx) <= n_points:
        take = idx
    else:
        # ~1/r acceptance sampling (O(M), no weighted choice: that path
        # dominates host time at full-sequence scale)
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
    prefetcher's staging threads (or `io/procsource.py`'s worker processes)
    do the rendering, in any order, and a long sequence is never resident at
    once. (The scans differ in their noise from those a single generator
    consumed in order gives, as in the reference.) Scan k is rendered at
    time `k * scan_period` for the moving objects."""

    def __init__(self, world: World, poses: np.ndarray, seed: int = 0,
                 n_points: int = 24_000, index: WorldIndex | None = None,
                 max_range: float = 60.0, sensor: SensorModel | None = None,
                 dynamics: DynamicObjects | None = None,
                 scan_period: float = 0.1):
        self.world = world
        self.poses = np.asarray(poses)
        self.seed = seed
        self.n_points = n_points
        self.index = index
        self.max_range = max_range
        self.sensor = sensor
        self.dynamics = dynamics
        self.scan_period = scan_period

    def __len__(self) -> int:
        return len(self.poses)

    def __getitem__(self, k: int):
        rng = np.random.default_rng((self.seed + 1) * 1_000_003 + k)
        return render_scan(self.world, self.poses[k], rng,
                           n_points=self.n_points, index=self.index,
                           max_range=self.max_range, sensor=self.sensor,
                           dynamics=self.dynamics,
                           t=k * self.scan_period)


def simulate_sequence(
    seed: int = 0,
    n_scans: int = 200,
    n_points: int = 24_000,
    radius: float = 60.0,
    speed: float = 1.2,
    world: World | None = None,
):
    """Generator of (pose6_gt, xyz_body, intensity) for a closed circuit."""
    world = world if world is not None else make_world(seed, extent=radius * 2.0)
    poses = loop_trajectory(n_scans=n_scans, radius=radius, speed=speed)
    rng = np.random.default_rng(seed + 1)
    for p in poses:
        xyz, inten = render_scan(world, p, rng, n_points=n_points)
        yield p, xyz, inten



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
