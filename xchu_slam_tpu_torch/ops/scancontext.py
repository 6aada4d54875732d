"""Scan Context global descriptor + retrieval (port of
`xchu_slam_tpu.ops.scancontext`).

The descriptor is a polar max-height image built by one scatter-max; the
retrieval scores the query against the whole database over all sector shifts
in one batched contraction (exhaustive, no ring-key kd-tree), with the
reference's column-cosine distance and empty-column exclusion.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class ScSpec(NamedTuple):
    num_ring: int = 20
    num_sector: int = 60
    max_radius: float = 80.0
    lidar_height: float = 2.0
    num_exclude_recent: int = 30
    num_candidates: int = 3
    search_ratio: float = 0.1
    dist_thresh: float = 0.2


def spec_from_config(sc_cfg) -> ScSpec:
    return ScSpec(
        num_ring=sc_cfg.num_ring,
        num_sector=sc_cfg.num_sector,
        max_radius=sc_cfg.max_radius,
        lidar_height=sc_cfg.lidar_height,
        num_exclude_recent=sc_cfg.num_exclude_recent,
        num_candidates=sc_cfg.num_candidates,
        search_ratio=sc_cfg.search_ratio,
        dist_thresh=sc_cfg.dist_thresh,
    )


def make_descriptor(xyz: torch.Tensor, mask: torch.Tensor, spec: ScSpec) -> torch.Tensor:
    """Polar max-height image [R, S]; empty bins are 0."""
    r = torch.linalg.norm(xyz[:, :2], dim=-1)
    theta = torch.atan2(xyz[:, 1], xyz[:, 0]) + math.pi  # [0, 2π)
    ring = torch.floor(r / spec.max_radius * spec.num_ring).to(torch.int32)
    sector = torch.floor(theta / (2.0 * math.pi) * spec.num_sector).to(torch.int32)
    sector = torch.clamp(sector, 0, spec.num_sector - 1)
    ok = mask & (ring >= 0) & (ring < spec.num_ring)
    nbin = spec.num_ring * spec.num_sector
    flat = torch.where(ok, (ring * spec.num_sector + sector).long(), nbin)
    z = torch.where(ok, xyz[:, 2] + spec.lidar_height, -torch.inf)
    img = torch.full((nbin + 1,), -torch.inf, dtype=torch.float32, device=xyz.device)
    img = img.scatter_reduce(0, flat, z, reduce="amax", include_self=True)
    img = img[:-1].reshape(spec.num_ring, spec.num_sector)
    return torch.where(torch.isfinite(img), img, 0.0)


def _normalize_cols(desc: torch.Tensor):
    """Unit-normalize columns; zero columns stay zero. desc [..., R, S]."""
    n = torch.linalg.norm(desc, dim=-2, keepdim=True)
    nonzero = n > 0.0
    return (torch.where(nonzero, desc / torch.where(nonzero, n, 1.0), 0.0),
            nonzero[..., 0, :])


def _shift_index(S: int, device) -> torch.Tensor:
    """[S,S] gather index: row s is the column order of roll(x, -s)."""
    ar = torch.arange(S, device=device)
    return (ar[None, :] + ar[:, None]) % S


def distance_all_rotations(query, db, db_mask, spec: ScSpec):
    """SC distance of `query` [R,S] against every DB entry [K,R,S] over all S
    column shifts. Returns (dist [K], best_shift [K])."""
    S = spec.num_sector
    qn, qvalid = _normalize_cols(query)          # [R,S], [S]
    cn, cvalid = _normalize_cols(db)             # [K,R,S], [K,S]
    idx = _shift_index(S, query.device)          # [S(shift), S(col)]
    # compare query vs roll(c, s) ≡ roll(query, -s) vs c
    qn_roll = qn[:, idx].permute(1, 0, 2)        # [S,R,S]
    qv_roll = qvalid[idx]                        # [S,S]
    cos = torch.einsum("srj,krj->ksj", qn_roll, cn)                      # [K,S,S]
    pair_ok = qv_roll[None, :, :] & cvalid[:, None, :]
    num = torch.sum(torch.where(pair_ok, cos, 0.0), dim=-1)
    den = pair_ok.sum(dim=-1)
    sim = torch.where(den > 0, num / torch.clamp(den, min=1), -1.0)
    dist = torch.where(db_mask[:, None], 1.0 - sim, torch.inf)           # [K,S]
    best = torch.min(dist, dim=1)
    return best.values, best.indices


class LoopCandidate(NamedTuple):
    idx: int      # matched keyframe index (-1 if none)
    dist: float   # SC distance of the best match
    yaw: float    # relative yaw estimate (radians)
    found: bool


def detect_loop(query, db, db_count: int, spec: ScSpec, cur: int | None = None) -> LoopCandidate:
    """Best loop candidate for `query` among the entries at least
    `num_exclude_recent` keyframes older than the query keyframe `cur`
    (default `db_count-1`). Reads the winner back to the host."""
    K = db.shape[0]
    cur = db_count - 1 if cur is None else cur
    eligible = torch.arange(K, device=db.device) < cur + 1 - spec.num_exclude_recent
    dist, shift = distance_all_rotations(query, db, eligible, spec)
    best = torch.argmin(dist)
    # one readback; indices < 2^24 are exact in float32
    best_dist, best_shift, best_i = torch.stack(
        [dist[best], shift[best].to(torch.float32), best.to(torch.float32)]).cpu()
    best_i = int(best_i)
    found = bool(torch.isfinite(best_dist) & (best_dist < spec.dist_thresh))
    yaw = best_shift * (2.0 * math.pi / spec.num_sector)
    yaw = torch.atan2(torch.sin(yaw), torch.cos(yaw))     # wrap to (-pi, pi]
    return LoopCandidate(idx=best_i if found else -1, dist=float(best_dist),
                         yaw=float(yaw), found=found)
