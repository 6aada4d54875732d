"""Intensity Scan Context (ISC) descriptor + two-stage loop scoring (port of
`xchu_slam_tpu.ops.isc`).

- `make_descriptor`: polar max-intensity image by one scatter-max (which is
  order-independent), intensities as float in [0,1], with a z passthrough
  band as crude ground removal.
- candidate gating: travel distance ≥ 20 m and position distance
  < Δtravel·0.03.
- `geometry_scores`: binary-occupancy agreement maximized over all column
  shifts (occupancy is `value > 0`). The contraction is over 0/1 values, so
  it is exact in float32 in any order.
- `intensity_scores`: 1 − min mean-L1 over the shifts within ±10 of the best
  geometric shift. The reference scores all 60 shifts of every database row
  in chunks of 64 and then reads 20 of them; here only those 20 shifts are
  formed, per chunk of `chunk` rows, and `detect_loop` scores only the rows
  older than the query (the only ones its gate can pass).

Means are written as sum / count with the count a tensor on the device, so
that they round the same way on every device (`torch.mean`, and a division
by a Python scalar, multiply by the reciprocal on CUDA and divide on the
CPU); the sums are plain (atomic-free) reductions.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from xchu_slam_tpu_torch.utils import collectives


class IscSpec(NamedTuple):
    num_ring: int = 60
    num_sector: int = 60
    max_range: float = 40.0
    skip_neighbor_distance: float = 20.0
    inflation_covariance: float = 0.03
    geometry_thresh: float = 0.67
    intensity_thresh: float = 0.91
    ground_z_min: float = -0.9
    ground_z_max: float = 30.0
    intensity_window: int = 10


def spec_from_config(cfg) -> IscSpec:
    return IscSpec(
        num_ring=cfg.num_ring,
        num_sector=cfg.num_sector,
        max_range=cfg.max_range,
        skip_neighbor_distance=cfg.skip_neighbor_distance,
        inflation_covariance=cfg.inflation_covariance,
        geometry_thresh=cfg.geometry_thresh,
        intensity_thresh=cfg.intensity_thresh,
        ground_z_min=cfg.ground_z_min,
        ground_z_max=cfg.ground_z_max,
    )


def make_descriptor(xyz, intensity, mask, spec: IscSpec) -> torch.Tensor:
    """Polar max-intensity image [R, S] with crude ground removal."""
    keep = mask & (xyz[:, 2] > spec.ground_z_min) & (xyz[:, 2] < spec.ground_z_max)
    r = torch.linalg.norm(xyz[:, :2], dim=-1)
    theta = torch.atan2(xyz[:, 1], xyz[:, 0]) + math.pi
    ring = torch.floor(r / spec.max_range * spec.num_ring).to(torch.int32)
    sector = torch.floor(theta / (2.0 * math.pi) * spec.num_sector).to(torch.int32)
    sector = torch.clamp(sector, 0, spec.num_sector - 1)
    ok = keep & (r < spec.max_range) & (ring >= 0) & (ring < spec.num_ring)
    nbin = spec.num_ring * spec.num_sector
    flat = torch.where(ok, (ring * spec.num_sector + sector).long(), nbin)
    img = torch.zeros((nbin + 1,), dtype=torch.float32, device=xyz.device)
    img = img.scatter_reduce(0, flat, torch.where(ok, intensity, 0.0),
                             reduce="amax", include_self=True)
    return img[:-1].reshape(spec.num_ring, spec.num_sector)


def _cells(spec: IscSpec, device) -> torch.Tensor:
    """The image's cell count as a 0-d float32 tensor on `device`."""
    return torch.full((), float(spec.num_ring * spec.num_sector), device=device)


def _rolled(query: torch.Tensor, S: int) -> torch.Tensor:
    """[S,R,S]: entry s is roll(query, -s, axis=1)."""
    ar = torch.arange(S, device=query.device)
    return query[:, (ar[None, :] + ar[:, None]) % S].permute(1, 0, 2)


def geometry_scores(query, db, spec: IscSpec):
    """Occupancy agreement of `query` [R,S] with every entry of `db` [K,R,S]
    over every shift. Returns (best_score [K], best_shift [K])."""
    S = spec.num_sector
    cells = _cells(spec, db.device)
    oq = (query > 0.0).to(torch.float32)
    oc = (db > 0.0).to(torch.float32).reshape(db.shape[0], -1)
    # agreement = 1 - mean(oq) - mean(oc) + 2·mean(oq·oc)
    inter = torch.matmul(oc, _rolled(oq, S).reshape(S, -1).T) / cells      # [K,S]
    mq = oq.sum() / cells
    mc = oc.sum(dim=1) / cells
    agree = 1.0 - mq - mc[:, None] + 2.0 * inter
    best = torch.max(agree, dim=1)      # ties: the first shift
    return best.values, best.indices


def intensity_scores(query, db, best_shift, spec: IscSpec, chunk: int = 256):
    """1 − min mean-L1 over the shifts within ±window of best_shift, for
    every entry of `db` [K,R,S]. `chunk` bounds the working set at
    chunk · 2·window · R·S floats (74 MB at the defaults)."""
    S, W = spec.num_sector, spec.intensity_window
    cells = _cells(spec, db.device)
    q_roll = _rolled(query, S)                                       # [S,R,S]
    offs = torch.arange(-W, W, device=db.device)
    out = []
    for lo in range(0, db.shape[0], chunk):
        dbc = db[lo:lo + chunk]
        win = (best_shift[lo:lo + chunk, None] + offs[None, :]) % S  # [C,2W]
        diff = torch.abs(q_roll[win] - dbc[:, None]).sum(dim=(2, 3)) / cells
        out.append(1.0 - torch.min(diff, dim=1).values)
    if not out:
        return db.new_zeros((0,))
    return torch.cat(out)


def isc_rgb(desc: torch.Tensor) -> torch.Tensor:
    """Render an ISC descriptor as an RGB image uint8 [R, S, 3] (jet-style
    colormap; empty cells black)."""
    v = torch.clamp(desc, 0.0, 1.0)
    r = torch.clamp(1.5 - torch.abs(4.0 * v - 3.0), 0, 1)
    g = torch.clamp(1.5 - torch.abs(4.0 * v - 2.0), 0, 1)
    b = torch.clamp(1.5 - torch.abs(4.0 * v - 1.0), 0, 1)
    img = torch.stack([r, g, b], -1)
    img = torch.where(v[..., None] > 0.0, img, 0.0)
    return (img * 255.0).to(torch.uint8)


class IscLoop(NamedTuple):
    idx: int      # matched keyframe index (-1 if none)
    score: float  # geometry + intensity score of the match (0 if none)
    yaw: float    # relative yaw estimate (radians)
    found: bool


class DeviceIscLoop(NamedTuple):
    """`IscLoop` as 0-d tensors on the descriptors' device: nothing is read
    back."""

    idx: torch.Tensor     # int64, -1 if none
    score: torch.Tensor   # float32, 0 if none
    yaw: torch.Tensor     # float32
    found: torch.Tensor   # bool


def _gated_scores(query, db, lo: int, hi: int, positions, travel, cur: int, spec: IscSpec):
    """(geometry + intensity score, -inf where a gate or a threshold fails;
    best shift) of the entries lo..hi-1 against the query keyframe `cur`."""
    db_l = db[lo:hi]
    d_travel = travel[cur] - travel[lo:hi]
    pos_dist = torch.linalg.norm(positions[lo:hi] - positions[cur][None], dim=-1)
    gate = (d_travel > spec.skip_neighbor_distance) \
        & (pos_dist < d_travel * spec.inflation_covariance)
    geo, shift = geometry_scores(query, db_l, spec)
    inten = intensity_scores(query, db_l, shift, spec)
    ok = gate & (geo > spec.geometry_thresh) & (inten > spec.intensity_thresh)
    return torch.where(ok, geo + inten, -torch.inf), shift


def detect_loop_on_device(query, db, db_count: int, positions, travel, spec: IscSpec,
                          cur: int | None = None, mesh=None) -> DeviceIscLoop:
    """Best gated two-stage ISC loop for the query keyframe `cur` (default
    `db_count-1`, the newest) among the keyframes before it, as tensors on
    the device.

    positions: [K_max, 3] keyframe positions; travel: [K_max] cumulative
    travel. With a `mesh` (`parallel/distributed.py`), the database is
    sharded over its ranks: each scores the rows of its K/D slice that lie
    before `cur`, the per-rank best (total, index, shift) meet in one
    all-gather and the first maximum in rank order wins, as the
    single-device argmax picks the lower index."""
    cur = db_count - 1 if cur is None else cur
    dev = db.device
    if cur <= 0:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return DeviceIscLoop(idx=torch.full((), -1, dtype=torch.int64, device=dev),
                             score=zero, yaw=zero.clone(),
                             found=torch.zeros((), dtype=torch.bool, device=dev))
    if mesh is None:
        total, shift = _gated_scores(query, db, 0, cur, positions, travel, cur, spec)
        li = torch.argmax(total).reshape(1)
        best_total = total.gather(0, li)[0]
        best, best_shift = li[0], shift.gather(0, li)[0].to(torch.float32)
    else:
        sl = mesh.shard(db.shape[0], "database capacity (max_keyframes)")
        lo, hi = sl.start, min(sl.stop, cur)
        if hi > lo:
            total, shift = _gated_scores(query, db, lo, hi, positions, travel, cur, spec)
            li = torch.argmax(total).reshape(1)
            local = torch.stack([total.gather(0, li)[0], (li[0] + lo).to(torch.float32),
                                 shift.gather(0, li)[0].to(torch.float32)])
        else:       # no row of this shard lies before the query
            local = torch.tensor([-math.inf, 0.0, 0.0], device=dev)
        rows = collectives.shard_allgather(local[None], mesh)           # [D, 3]
        best_total, best, best_shift = rows[torch.argmax(rows[:, 0])]
        best = best.to(torch.int64)
    found = torch.isfinite(best_total)
    yaw = best_shift * (2.0 * math.pi / spec.num_sector)
    yaw = torch.atan2(torch.sin(yaw), torch.cos(yaw))
    return DeviceIscLoop(idx=torch.where(found, best, -1),
                         score=torch.where(found, best_total, 0.0), yaw=yaw, found=found)


def detect_loop(query, db, db_count: int, positions, travel, spec: IscSpec,
                cur: int | None = None, mesh=None) -> IscLoop:
    """`detect_loop_on_device`, read back to the host once."""
    c = detect_loop_on_device(query, db, db_count, positions, travel, spec, cur, mesh)
    idx, score, yaw, found = torch.stack(
        [c.idx.to(torch.float32), c.score, c.yaw, c.found.to(torch.float32)]).cpu().tolist()
    return IscLoop(idx=int(idx), score=score, yaw=yaw, found=found > 0.5)
