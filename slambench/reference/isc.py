"""Intensity Scan Context retrieval of the reference: a frozen copy of the
port's plain `ops/isc.py` (the polar max-intensity descriptor with its
ground band, the occupancy agreement over every column shift, then 1 − the
mean L1 over the shifts within ±10 of the best geometric one) with the
gates of `detect_loop` (travel since the entry over `skip_neighbor_distance`,
position distance under the travel · `inflation_covariance`), returning
every entry's margins so that the check can leave decisions within rounding
of a threshold to rounding."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class IscSpec(NamedTuple):
    num_ring: int
    num_sector: int
    max_range: float
    skip_neighbor_distance: float
    inflation_covariance: float
    geometry_thresh: float
    intensity_thresh: float
    ground_z_min: float
    ground_z_max: float
    intensity_window: int = 10


def isc_spec(cfg: dict) -> IscSpec:
    return IscSpec(*(cfg[f"isc.{k}"] for k in IscSpec._fields[:-1]))


def make_descriptor(xyz, intensity, mask, spec: IscSpec) -> torch.Tensor:
    """Polar max-intensity image [R, S]; points outside the z band, beyond
    max_range or masked leave their bin at 0."""
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
    img = img.scatter_reduce(0, flat, torch.where(ok, intensity, 0.0), reduce="amax",
                             include_self=True)
    return img[:-1].reshape(spec.num_ring, spec.num_sector)


def _rolled(query: torch.Tensor, S: int) -> torch.Tensor:
    """[S,R,S]: entry s is roll(query, -s, axis=1)."""
    ar = torch.arange(S, device=query.device)
    return query[:, (ar[None, :] + ar[:, None]) % S].permute(1, 0, 2)


def geometry_scores(query, db, spec: IscSpec):
    """Occupancy agreement of `query` [R,S] with every entry of `db` [K,R,S],
    the best over the shifts: (score [K], shift [K], the first on ties)."""
    S = spec.num_sector
    cells = torch.full((), float(spec.num_ring * S), device=db.device)
    oq = (query > 0.0).to(torch.float32)
    oc = (db > 0.0).to(torch.float32).reshape(db.shape[0], -1)
    inter = torch.matmul(oc, _rolled(oq, S).reshape(S, -1).T) / cells
    agree = 1.0 - oq.sum() / cells - (oc.sum(dim=1) / cells)[:, None] + 2.0 * inter
    best = torch.max(agree, dim=1)
    return best.values, best.indices


def intensity_scores(query, db, best_shift, spec: IscSpec, chunk: int = 256):
    """1 − the least mean |Δintensity| over the shifts within ±window of
    each entry's best geometric shift."""
    S, W = spec.num_sector, spec.intensity_window
    cells = torch.full((), float(spec.num_ring * S), device=db.device)
    q_roll = _rolled(query, S)
    offs = torch.arange(-W, W, device=db.device)
    out = []
    for lo in range(0, db.shape[0], chunk):
        win = (best_shift[lo:lo + chunk, None] + offs[None, :]) % S
        diff = torch.abs(q_roll[win] - db[lo:lo + chunk, None]).sum(dim=(2, 3)) / cells
        out.append(1.0 - torch.min(diff, dim=1).values)
    return torch.cat(out)


class Scores(NamedTuple):
    """Every entry older than the query: its score (geometry + intensity),
    best shift, and the smallest margin by which it passes (> 0) or fails
    (< 0) its gates and thresholds, the distance gates' in metres and the
    scores' in score units."""

    total: torch.Tensor
    shift: torch.Tensor
    margin_m: torch.Tensor
    margin_score: torch.Tensor


def score_all(query, db, positions, travel, cur: int, spec: IscSpec) -> Scores:
    """The entries 0..cur−1 of `db` [K,R,S] against the query keyframe
    `cur`; `positions` [K,3] and `travel` [K] float32."""
    d_travel = travel[cur] - travel[:cur]
    pos_dist = torch.linalg.norm(positions[:cur] - positions[cur][None], dim=-1)
    geo, shift = geometry_scores(query, db[:cur], spec)
    inten = intensity_scores(query, db[:cur], shift, spec)
    margin_m = torch.minimum(d_travel - spec.skip_neighbor_distance,
                             d_travel * spec.inflation_covariance - pos_dist)
    margin_score = torch.minimum(geo - spec.geometry_thresh, inten - spec.intensity_thresh)
    return Scores(geo + inten, shift, margin_m, margin_score)
