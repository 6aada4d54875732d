"""Point-cloud preprocessing front-end (port of `xchu_slam_tpu.ops.filter`).

Range crop → voxel downsample → radius or exact statistical outlier removal
→ compact, all fixed-shape and masked. The voxel downsample is a stable sort
on the reference's hashed voxel key plus a segment mean, so capacity
overflow drops the same voxels as the reference does; outlier removal is an
all-pairs distance pass.
"""

from __future__ import annotations

import torch

from xchu_slam_tpu_torch.types import Cloud
from xchu_slam_tpu_torch.utils.scatter import index_add

# bounded integer voxel lattice for exact (collision-free) downsample keys
_KEY_DIM_XY = 512
_KEY_DIM_Z = 128
_INT32_MAX = 2 ** 31 - 1
_KNUTH = -1640531527   # the int32 multiplier of the reference's hash


def _keep(cloud: Cloud, keep: torch.Tensor) -> Cloud:
    return Cloud(xyz=torch.where(keep[:, None], cloud.xyz, 0.0),
                 intensity=torch.where(keep, cloud.intensity, 0.0),
                 mask=keep)


def range_crop(cloud: Cloud, min_range: float, max_range: float) -> Cloud:
    """Annulus crop on horizontal range; non-finite points are dropped."""
    r = torch.linalg.norm(cloud.xyz[:, :2], dim=-1)
    keep = cloud.mask & (r > min_range) & (r < max_range)
    keep = keep & torch.isfinite(cloud.xyz).all(dim=-1)
    return _keep(cloud, keep)


def _voxel_keys(xyz: torch.Tensor, mask: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """Exact bounded-lattice voxel key per point (int64 holding the
    reference's int32 value); invalid → INT32_MAX."""
    idx = torch.floor(xyz / voxel_size).to(torch.int32).long()
    ix = torch.clamp(idx[:, 0] + _KEY_DIM_XY // 2, 0, _KEY_DIM_XY - 1)
    iy = torch.clamp(idx[:, 1] + _KEY_DIM_XY // 2, 0, _KEY_DIM_XY - 1)
    iz = torch.clamp(idx[:, 2] + _KEY_DIM_Z // 2, 0, _KEY_DIM_Z - 1)
    key = (ix * _KEY_DIM_XY + iy) * _KEY_DIM_Z + iz
    return torch.where(mask, key, torch.full_like(key, _INT32_MAX))


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement wrap of an int64 value to the int32 range, kept in
    int64 (so the multiply never overflows a signed type)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x)


def voxel_downsample(cloud: Cloud, voxel_size: float, out_capacity: int) -> Cloud:
    """Centroid voxel downsample via sort + segment mean."""
    key = _voxel_keys(cloud.xyz, cloud.mask, voxel_size)
    # order by the HASHED key (int32 Knuth multiplicative mix, wrapped as the
    # reference's int32 multiply wraps) so that capacity overflow drops a
    # spatially unbiased subset; segment boundaries use the exact key
    h = _wrap_int32(key * _KNUTH) ^ (key >> 7)
    h = torch.where(cloud.mask, h, torch.full_like(h, _INT32_MAX))
    order = torch.sort(h, stable=True).indices
    key_s = key[order]
    xyz_s = cloud.xyz[order]
    inten_s = cloud.intensity[order]
    mask_s = cloud.mask[order]

    new_seg = torch.ones_like(mask_s)
    new_seg[1:] = key_s[1:] != key_s[:-1]
    seg_id = torch.cumsum(new_seg.long(), 0) - 1
    # invalid points and voxels past the capacity are dropped: each goes to
    # its own slot past `out_capacity` (one shared slot would be one long
    # segment, which the sorted deterministic scatter sums serially)
    n = seg_id.shape[0]
    dropped = out_capacity + torch.arange(n, device=seg_id.device)
    seg_id = torch.where(mask_s & (seg_id < out_capacity), seg_id, dropped)

    # one scatter for [Σxyz | Σintensity | count]
    vals = torch.cat([xyz_s, inten_s[:, None], torch.ones_like(inten_s)[:, None]], 1)
    sums = index_add(vals.new_zeros((out_capacity + n, 5)), seg_id, vals)[:out_capacity]
    cnt = sums[:, 4]
    valid = cnt > 0
    denom = torch.clamp(cnt, min=1.0)
    return Cloud(
        xyz=torch.where(valid[:, None], sums[:, :3] / denom[:, None], 0.0),
        intensity=torch.where(valid, sums[:, 3] / denom, 0.0),
        mask=valid,
    )


def _chunked_pairwise(xyz: torch.Tensor, mask: torch.Tensor, chunk: int | None,
                      reducer) -> torch.Tensor:
    """Concatenate `reducer(d2_chunk [C,N], row_mask [C])` over row chunks of
    the full pairwise squared-distance matrix (masked columns at +inf).
    `chunk=None` runs the whole matrix in one pass."""
    n = xyz.shape[0]
    chunk = n if chunk is None else min(chunk, n)
    sq = torch.sum(xyz * xyz, dim=-1)
    out = []
    for i0 in range(0, n, chunk):
        rows = xyz[i0:i0 + chunk]
        d2 = sq[i0:i0 + chunk, None] + sq[None, :] - 2.0 * rows @ xyz.T
        d2 = torch.clamp(d2, min=0.0)
        d2 = torch.where(mask[None, :], d2, torch.inf)
        out.append(reducer(d2, mask[i0:i0 + chunk]))
    return torch.cat(out)


def radius_outlier_removal(cloud: Cloud, radius: float, min_neighbors: int,
                           chunk: int = 1024) -> Cloud:
    """Keep points with at least `min_neighbors` others within `radius`."""
    r2 = radius * radius

    def reducer(d2, rows_mask):
        # neighbor count excluding self (self dist = 0 always counted once)
        cnt = torch.sum(d2 < r2, dim=-1) - 1
        return torch.where(rows_mask, cnt, -1)

    counts = _chunked_pairwise(cloud.xyz, cloud.mask, chunk, reducer)
    return _keep(cloud, cloud.mask & (counts >= min_neighbors))


def statistical_outlier_removal(cloud: Cloud, k: int, stddev_mult: float,
                                chunk: int | None = None) -> Cloud:
    """Exact statistical outlier removal: mean distance to the k nearest
    neighbours; drop points whose mean exceeds µ + stddev_mult·σ."""

    def reducer(d2, rows_mask):
        vals = torch.topk(d2, k + 1, dim=-1, largest=False, sorted=True).values
        d = torch.sqrt(torch.clamp(vals[:, 1:], min=0.0))  # drop self
        return torch.where(rows_mask, d.mean(dim=-1), torch.nan)

    mean_d = _chunked_pairwise(cloud.xyz, cloud.mask, chunk, reducer)
    valid = cloud.mask & torch.isfinite(mean_d)
    n = torch.clamp(valid.sum(), min=1)
    mu = torch.sum(torch.where(valid, mean_d, 0.0)) / n
    var = torch.sum(torch.where(valid, (mean_d - mu) ** 2, 0.0)) / n
    thresh = mu + stddev_mult * torch.sqrt(var)
    return _keep(cloud, valid & (mean_d <= thresh))


def compact(cloud: Cloud, out_capacity: int) -> Cloud:
    """Pack valid points to the front (stable), truncating/padding to
    capacity: each valid point's slot is its running valid count."""
    pos = torch.cumsum(cloud.mask.long(), 0) - 1
    dest = torch.where(cloud.mask & (pos < out_capacity), pos,
                       torch.full_like(pos, out_capacity))
    dev = cloud.xyz.device
    xyz = torch.zeros((out_capacity + 1, 3), dtype=cloud.xyz.dtype, device=dev)
    inten = torch.zeros((out_capacity + 1,), dtype=cloud.intensity.dtype, device=dev)
    xyz[dest] = cloud.xyz          # slot `out_capacity` is the dropped slot
    inten[dest] = cloud.intensity
    n_valid = torch.clamp(cloud.mask.sum(), max=out_capacity)
    mask = torch.arange(out_capacity, device=dev) < n_valid
    return Cloud(
        xyz=torch.where(mask[:, None], xyz[:out_capacity], 0.0),
        intensity=torch.where(mask, inten[:out_capacity], 0.0),
        mask=mask,
    )


def filter_scan(cloud: Cloud, cfg) -> Cloud:
    """Full front-end: crop → voxel downsample → outlier removal → compact.
    `cfg` is a FilterConfig; outlier_method is "radius", "statistical" or
    "none"."""
    c = range_crop(cloud, cfg.min_range, cfg.max_range)
    c = voxel_downsample(c, cfg.voxel_size, cfg.max_points)
    if cfg.outlier_method == "radius":
        c = radius_outlier_removal(c, cfg.radius_outlier_radius,
                                   cfg.radius_outlier_min_neighbors, chunk=4096)
    elif cfg.outlier_method == "statistical":
        # one fused pass up to 16k points; row chunks above that bound the
        # [n,n] distance matrix, as in the reference
        chunk = cfg.stat_chunk or None
        if chunk is None and cfg.max_points > 16384:
            chunk = 8192
        c = statistical_outlier_removal(c, cfg.stat_outlier_k,
                                        cfg.stat_outlier_stddev, chunk=chunk)
    elif cfg.outlier_method != "none":
        raise ValueError(f"outlier_method {cfg.outlier_method!r} is not ported")
    return compact(c, cfg.max_points)
