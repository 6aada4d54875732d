"""The benchmark's frozen copy of the simulator's numpy parts.

Copied from `xchu_slam_tpu_torch/utils/sim.py` so that a later change to the
program cannot move the yardstick: the urban-block world (`make_world`), the
squircle circuit (`loop_trajectory`, `closed_lap_trajectory`), the 2-D cell
index (`WorldIndex`) and the point-sampled scan renderer (`render_scan`,
without the beam-level sensor model and the moving objects, which no cell
uses). Pure numpy: nothing here touches torch or the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class World(NamedTuple):
    xyz: np.ndarray        # float32 [M, 3]
    intensity: np.ndarray  # float32 [M]


def make_world(seed: int = 0, extent: float = 120.0, n_buildings: int = 14,
               n_pillars: int = 40, ground_pts: int = 120_000,
               wall_pts_per_face: int = 4000, sensor_height: float = 1.73) -> World:
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
        pts = np.c_[cx + r * np.cos(th), cy + r * np.sin(th), z0 + rng.uniform(0, h, n)]
        parts.append(pts)
        intens.append(np.full(n, 0.95, np.float32))

    return World(xyz=np.vstack(parts).astype(np.float32),
                 intensity=np.concatenate(intens).astype(np.float32))


def _squircle_dense(radius: float, dense: int = 20000):
    """Densely sampled squircle circuit: (cx, cy, seg, arc, perimeter)."""
    ang = np.linspace(0, 2 * np.pi, dense, endpoint=False)
    cx = radius * np.sign(np.cos(ang)) * np.abs(np.cos(ang)) ** 0.5
    cy = radius * np.sign(np.sin(ang)) * np.abs(np.sin(ang)) ** 0.5
    seg = np.hypot(np.diff(cx, append=cx[:1]), np.diff(cy, append=cy[:1]))
    arc = np.concatenate([[0.0], np.cumsum(seg)])[:-1]
    return cx, cy, seg, arc, arc[-1] + seg[-1]


def perimeter(radius: float) -> float:
    """The circuit's length in metres."""
    return float(_squircle_dense(radius)[-1])


def loop_trajectory(n_scans: int = 300, radius: float = 60.0, speed: float = 1.2,
                    closed: bool = True) -> np.ndarray:
    """Rounded-square circuit returning poses [N, 6] (x y z r p y); `speed`
    is metres per scan."""
    cx, cy, seg, arc, per = _squircle_dense(radius)
    want = (np.arange(n_scans) * speed) % per if closed else \
        np.minimum(np.arange(n_scans) * speed, per * 0.999)
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
    """A closed lap with exactly `n_scans` uniformly spaced poses: scan N-1
    sits one inter-scan step before scan 0, so the lap cycles seamlessly."""
    return loop_trajectory(n_scans=n_scans, radius=radius,
                           speed=perimeter(radius) / n_scans, closed=True)


class WorldIndex:
    """2-D cell index over world points, so that a render touches only the
    cells within sensor range."""

    def __init__(self, world: World, cell: float = 64.0):
        self.cell = float(cell)
        ij = np.floor(world.xyz[:, :2] / self.cell).astype(np.int64)
        order = np.lexsort((ij[:, 1], ij[:, 0]))
        sij = ij[order]
        change = np.nonzero(np.any(np.diff(sij, axis=0) != 0, axis=1))[0] + 1
        starts = np.concatenate([[0], change, [len(sij)]])
        self.order = order
        self.cells = {(int(sij[starts[k], 0]), int(sij[starts[k], 1])):
                      (int(starts[k]), int(starts[k + 1])) for k in range(len(starts) - 1)}

    def query(self, xy, max_range: float) -> np.ndarray:
        """Indices of the world points whose cell meets [xy ± max_range]."""
        i0 = int(np.floor((xy[0] - max_range) / self.cell))
        i1 = int(np.floor((xy[0] + max_range) / self.cell))
        j0 = int(np.floor((xy[1] - max_range) / self.cell))
        j1 = int(np.floor((xy[1] + max_range) / self.cell))
        spans = [self.cells[(i, j)] for i in range(i0, i1 + 1) for j in range(j0, j1 + 1)
                 if (i, j) in self.cells]
        if not spans:
            return np.zeros(0, np.int64)
        return np.concatenate([self.order[lo:hi] for lo, hi in spans])


def render_scan(world: World, pose6: np.ndarray, rng: np.random.Generator,
                max_range: float = 60.0, min_range: float = 2.0, n_points: int = 24_000,
                noise: float = 0.015, index: WorldIndex | None = None):
    """One scan in the body frame: (xyz [n,3], intensity [n]) float32. Points
    within the range annulus sampled with ~1/r weighting plus isotropic
    noise."""
    r_, p_, y_ = float(pose6[3]), float(pose6[4]), float(pose6[5])
    cr, sr = np.cos(r_), np.sin(r_)
    cp, sp = np.cos(p_), np.sin(p_)
    cy, sy = np.cos(y_), np.sin(y_)
    R = np.array([[cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                  [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                  [-sp, cp * sr, cp * cr]], np.float32)
    tpos = np.asarray(pose6[:3], np.float32)
    if index is not None:
        cand = index.query(tpos[:2], max_range)
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
    idx = np.nonzero((r > min_range) & (r < max_range))[0]
    if len(idx) == 0:
        return np.zeros((0, 3), np.float32), np.zeros(0, np.float32)
    if len(idx) <= n_points:
        take = idx
    else:
        w = 1.0 / np.maximum(r[idx], 1.0)
        c = n_points / w.sum()
        keep = rng.random(len(idx)) < np.minimum(1.0, 1.15 * c * w)
        take = idx[keep]
        if len(take) > n_points:
            take = take[rng.permutation(len(take))[:n_points]]
    pts_w = world_xyz[take] + rng.normal(0, noise, (len(take), 3))
    body = (pts_w - tpos) @ R
    return body.astype(np.float32), world_inten[take]
