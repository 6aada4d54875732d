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

from xchu_slam_tpu_torch.utils import collectives


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


def descriptor_partial(xyz: torch.Tensor, mask: torch.Tensor, spec: ScSpec) -> torch.Tensor:
    """Scatter-max polar height image [R, S] with empty bins at -inf. The
    partial form composes across shards: bin each rank's points, take the
    elementwise max over the mesh (`utils/collectives.py::shard_allmax`),
    then clean with `finalize_descriptor` (`parallel/sharded.py::
    slam_superstep`)."""
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
    return img[:-1].reshape(spec.num_ring, spec.num_sector)


def finalize_descriptor(img: torch.Tensor) -> torch.Tensor:
    """Empty bins (-inf) to 0."""
    return torch.where(torch.isfinite(img), img, 0.0)


def make_descriptor(xyz: torch.Tensor, mask: torch.Tensor, spec: ScSpec) -> torch.Tensor:
    """Polar max-height image [R, S]; empty bins are 0."""
    return finalize_descriptor(descriptor_partial(xyz, mask, spec))


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """Row means [.., R] (rotation invariant)."""
    return torch.mean(desc, dim=-1)


def sector_key(desc: torch.Tensor) -> torch.Tensor:
    """Column means [.., S]."""
    return torch.mean(desc, dim=-2)


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


class DeviceCandidate(NamedTuple):
    """`LoopCandidate` as 0-d tensors on the descriptors' device, as the
    reference's traced retrieval returns it: nothing is read back."""

    idx: torch.Tensor     # int64, -1 if none
    dist: torch.Tensor    # float32
    yaw: torch.Tensor     # float32, wrapped to (-pi, pi]
    found: torch.Tensor   # bool


def ring_key_topk(query_key, db_keys, db_mask, k: int = 3):
    """Ring-key nearest candidates (indices [k], distances [k], nearest
    first): the prefilter of a two-stage search. `detect_loop` below searches
    the whole database exhaustively instead."""
    d = torch.linalg.norm(db_keys - query_key[None, :], dim=-1)
    d = torch.where(db_mask, d, torch.inf)
    # a stable sort, so that equal distances keep the lower index first
    order = torch.sort(d, stable=True).indices[:k]
    return order, d[order]


def shift_yaw(shift: torch.Tensor, num_sector: int) -> torch.Tensor:
    """The relative yaw of a column shift, wrapped to (-pi, pi]."""
    yaw = shift.to(torch.float32) * (2.0 * math.pi / num_sector)
    return torch.atan2(torch.sin(yaw), torch.cos(yaw))


def _best_candidate_on_device(query, db, newest_eligible: int, spec: ScSpec) -> DeviceCandidate:
    """The nearest of the first `newest_eligible` entries over all shifts,
    found if its distance is under the threshold; tensors on the device."""
    eligible = torch.arange(db.shape[0], device=db.device) < newest_eligible
    dist, shift = distance_all_rotations(query, db, eligible, spec)
    best = torch.argmin(dist).reshape(1)
    best_dist = dist.gather(0, best)[0]
    found = torch.isfinite(best_dist) & (best_dist < spec.dist_thresh)
    return DeviceCandidate(idx=torch.where(found, best[0], -1), dist=best_dist,
                           yaw=shift_yaw(shift.gather(0, best)[0], spec.num_sector),
                           found=found)


def read_candidate(c: DeviceCandidate) -> LoopCandidate:
    """The host form of a device candidate: one readback (indices < 2^24
    are exact in float32)."""
    idx, dist, yaw, found = torch.stack(
        [c.idx.to(torch.float32), c.dist, c.yaw, c.found.to(torch.float32)]).cpu().tolist()
    return LoopCandidate(idx=int(idx), dist=dist, yaw=yaw, found=found > 0.5)


def best_on_mesh(query, db, newest_eligible: int, spec: ScSpec, mesh) -> torch.Tensor:
    """(dist, index, shift) as float32 [3] on every rank: the nearest of the
    first `newest_eligible` entries over all shifts, with the database
    sharded over the mesh's ranks (each scores its K/D rows). The per-rank
    minima meet in one all-gather and the first minimum in rank order wins,
    so ties break as the single-device argmin breaks them (the lower
    index)."""
    sl = mesh.shard(db.shape[0], "database capacity (max_keyframes)")
    idxs = torch.arange(sl.start, sl.stop, device=db.device)
    dist, shift = distance_all_rotations(query, db[sl], idxs < newest_eligible, spec)
    li = torch.argmin(dist).reshape(1)
    local = torch.stack([dist.gather(0, li)[0], idxs.gather(0, li)[0].to(torch.float32),
                         shift.gather(0, li)[0].to(torch.float32)])
    rows = collectives.shard_allgather(local[None], mesh)              # [D, 3]
    return rows[torch.argmin(rows[:, 0])]


def detect_loop_on_device(query, db, db_count: int, spec: ScSpec,
                          cur: int | None = None, mesh=None) -> DeviceCandidate:
    """Best loop candidate for `query` among the entries at least
    `num_exclude_recent` keyframes older than the query keyframe `cur`
    (default `db_count-1`; a host int, or a 0-d int64 tensor on the
    database's device, where eligibility is a comparison on the card), as
    tensors on the device. With a `mesh`
    (`parallel/distributed.py`), the database is sharded over its ranks
    (`best_on_mesh`) and every rank returns the same candidate."""
    cur = db_count - 1 if cur is None else cur
    newest = cur + 1 - spec.num_exclude_recent
    if mesh is None:
        return _best_candidate_on_device(query, db, newest, spec)
    best_dist, best, best_shift = best_on_mesh(query, db, newest, spec, mesh)
    found = torch.isfinite(best_dist) & (best_dist < spec.dist_thresh)
    return DeviceCandidate(idx=torch.where(found, best.to(torch.int64), -1), dist=best_dist,
                           yaw=shift_yaw(best_shift, spec.num_sector), found=found)


def detect_loop(query, db, db_count: int, spec: ScSpec, cur: int | None = None,
                mesh=None) -> LoopCandidate:
    """`detect_loop_on_device`, read back to the host once."""
    return read_candidate(detect_loop_on_device(query, db, db_count, spec, cur, mesh))


def detect_loop_between_sessions(query, db, db_count: int, spec: ScSpec) -> LoopCandidate:
    """Multi-session place recognition: the query comes from a different
    session, so no recency exclusion applies and every stored entry is
    eligible. One readback."""
    return read_candidate(_best_candidate_on_device(query, db, db_count, spec))
