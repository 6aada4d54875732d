"""Point-cloud preprocessing front-end (port of `xchu_slam_tpu.ops.filter`).

Range crop → voxel downsample → radius or statistical outlier removal →
compact, all fixed-shape and masked. The voxel downsample is a stable sort
on the reference's hashed voxel key plus a segment mean, so capacity
overflow drops the same voxels as the reference does. Outlier removal is an
all-pairs distance pass ("radius", "statistical", "statistical_approx"), or
the spatially bucketed statistical filter ("statistical_bucketed"), whose
k-NN candidates come from the 27 buckets around each point. None of them
reads a value back to the host (no `.item()`, no boolean-mask indexing, no
`nonzero`): the device engine captures the filter in its Part A graph.
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


def _k_smallest(d2: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest entries of each row, ascending (exact)."""
    return torch.topk(d2, k, dim=-1, largest=False, sorted=True).values


def _mean_knn(d2k: torch.Tensor) -> torch.Tensor:
    """Mean distance over the k+1 smallest squared distances of each row,
    ascending, the first (the point itself) dropped."""
    return torch.sqrt(torch.clamp(d2k[:, 1:], min=0.0)).mean(dim=-1)


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
    neighbours; drop points whose mean exceeds µ + stddev_mult·σ.

    It also serves `outlier_method="statistical_approx"`, the reference's
    `approx=True` (`jax.lax.approx_min_k`, the TPU's partial top-k, whose
    promise is a recall of about 0.95 a row): the port takes the exact k
    smallest, which keeps that promise, and the kept mask is then the exact
    filter's. (On the CPU `approx_min_k` returns the exact k smallest too.)"""

    def reducer(d2, rows_mask):
        return torch.where(rows_mask, _mean_knn(_k_smallest(d2, k + 1)), torch.nan)

    mean_d = _chunked_pairwise(cloud.xyz, cloud.mask, chunk, reducer)
    valid = cloud.mask & torch.isfinite(mean_d)
    n = torch.clamp(valid.sum(), min=1)
    mu = torch.sum(torch.where(valid, mean_d, 0.0)) / n
    var = torch.sum(torch.where(valid, (mean_d - mu) ** 2, 0.0)) / n
    thresh = mu + stddev_mult * torch.sqrt(var)
    return _keep(cloud, valid & (mean_d <= thresh))


# Bucket lattice of the bucketed statistical filter. x is the fastest-varying
# key dimension, so the 3 x-neighbours of a bucket are contiguous in sorted
# key order: the 27 buckets around a point are 9 contiguous ranges.
_B_DIM_XY = 128
_B_DIM_Z = 32
_B_TABLE = _B_DIM_XY * _B_DIM_XY * _B_DIM_Z


def _bucket_ids(xyz: torch.Tensor, bucket_size: float):
    """Clipped per-axis bucket indices (int64). Edge buckets are catch-alls:
    clipping merges far space into them, so any point within `bucket_size`
    of a query still lies in the query's clipped 3×3×3 cube; their ranges
    may overflow, which sends the row to the exact fallback."""
    idx = torch.floor(xyz / bucket_size).to(torch.int32).long()
    sx = torch.clamp(idx[:, 0] + _B_DIM_XY // 2, 0, _B_DIM_XY - 1)
    sy = torch.clamp(idx[:, 1] + _B_DIM_XY // 2, 0, _B_DIM_XY - 1)
    sz = torch.clamp(idx[:, 2] + _B_DIM_Z // 2, 0, _B_DIM_Z - 1)
    return sx, sy, sz


def _sq3(d: torch.Tensor) -> torch.Tensor:
    """Σ d² over the last axis of 3, summed in the reference's order."""
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def statistical_outlier_removal_bucketed(cloud: Cloud, k: int, stddev_mult: float,
                                         bucket_size: float, cap: int = 64,
                                         fallback_rows: int = 256,
                                         classes: dict | None = None) -> Cloud:
    """Exact statistical outlier removal by spatial bucketing
    (`xchu_slam_tpu/ops/filter.py:223-363`): the semantics of
    `statistical_outlier_removal` at O(N·candidates).

    Points are binned on a `bucket_size` lattice and sorted by bucket key; a
    point's k-NN candidates are the 9 contiguous ranges of its 27 buckets,
    L = 3·`cap` rows each, gathered from the sorted points padded with rows
    at 1e9. A row is proven exact where no range overflowed L, it has at
    least k+1 candidates, and its k-th squared distance lies below
    bucket_size² (the cube covers that radius). Unproven rows are solved
    again by brute force, up to `fallback_rows` of them, compacted by a
    cumsum; rows past that have no trusted mean: they are kept and left out
    of µ and σ. With `classes` (a dict), it receives the boolean masks
    "proven", "fallback" (unproven and solved again) and "unknown".

    The main pass sums the direct difference Σ(q − c)²; the fallback the
    expanded |f|² + |q|² − 2 f·q, each as the reference writes it, so the
    kept masks match it."""
    n = cloud.xyz.shape[0]
    L = 3 * cap
    if L <= k + 1:
        raise ValueError(f"3*cap ({L}) must exceed k+1 ({k + 1})")
    dev = cloud.xyz.device
    b2 = bucket_size * bucket_size      # compared in float32, as the reference's

    sx, sy, sz = _bucket_ids(cloud.xyz, bucket_size)
    key = (sz * _B_DIM_XY + sy) * _B_DIM_XY + sx
    key = torch.where(cloud.mask, key, torch.full_like(key, _B_TABLE))
    key_s, order = torch.sort(key, stable=True)
    xyz_s = cloud.xyz[order]
    # padded so that every range of L rows from a start ≤ n stays inside
    xyz_pad = torch.cat([xyz_s, torch.full((L, 3), 1e9, dtype=cloud.xyz.dtype, device=dev)])
    q = cloud.xyz
    lane = torch.arange(L, device=dev)
    lo_x = torch.clamp(sx - 1, min=0)
    hi_x = torch.clamp(sx + 1, max=_B_DIM_XY - 1)
    per_range = []
    n_cand = torch.zeros(n, dtype=torch.int64, device=dev)
    overflow = torch.zeros(n, dtype=torch.bool, device=dev)
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            y, z = sy + dy, sz + dz
            row_ok = (y >= 0) & (y < _B_DIM_XY) & (z >= 0) & (z < _B_DIM_Z)
            yz = (torch.clamp(z, 0, _B_DIM_Z - 1) * _B_DIM_XY
                  + torch.clamp(y, 0, _B_DIM_XY - 1)) * _B_DIM_XY
            # a bucket's first sorted position is the count of valid keys
            # below it (the reference's cumsum of the bucket counts; invalid
            # keys sort last)
            start = torch.searchsorted(key_s, yz + lo_x)
            cnt = torch.where(row_ok, torch.searchsorted(key_s, yz + hi_x + 1) - start, 0)
            overflow = overflow | (cnt > L)
            n_cand = n_cand + cnt
            cand = xyz_pad[start[:, None] + lane[None, :]]            # [n, L, 3]
            d2 = _sq3(q[:, None, :] - cand)
            d2 = torch.where(lane[None, :] < cnt[:, None], d2, torch.inf)
            per_range.append(_k_smallest(d2, k + 1))
    d2k = torch.clamp(_k_smallest(torch.cat(per_range, 1), k + 1)[:, 1:], min=0.0)
    mean_d = torch.sqrt(d2k).mean(dim=-1)
    # strict: a point outside the cube lies at least bucket_size away, so a
    # k-th distance below it proves the k found are the k nearest
    resolved = ~overflow & (n_cand >= k + 1) & (d2k[:, -1] < b2)
    unresolved = cloud.mask & ~resolved

    # exact fallback over the first R unresolved rows, compacted by a cumsum
    R = min(fallback_rows, n)
    pos = torch.cumsum(unresolved.long(), 0) - 1
    sel = torch.where(unresolved & (pos < R), pos, torch.full_like(pos, R))
    rows_idx = torch.zeros(R + 1, dtype=torch.int64, device=dev).scatter_(
        0, sel, torch.arange(n, device=dev))[:R]
    fb_valid = torch.arange(R, device=dev) < torch.clamp(unresolved.sum(), max=R)
    fq = q[rows_idx]
    d2f = (torch.sum(fq * fq, -1)[:, None] + torch.sum(q * q, -1)[None, :]
           - 2.0 * fq @ q.T)
    d2f = torch.where(cloud.mask[None, :], torch.clamp(d2f, min=0.0), torch.inf)
    mean_f = _mean_knn(_k_smallest(d2f, k + 1))
    dest = torch.where(fb_valid, rows_idx, torch.full_like(rows_idx, n))
    mean_d = torch.cat([mean_d, mean_d.new_zeros(1)]).scatter(0, dest, mean_f)[:n]
    fb_fixed = torch.zeros(n + 1, dtype=torch.bool, device=dev).scatter(
        0, dest, torch.ones_like(dest, dtype=torch.bool))[:n]

    # the rows whose mean is exact: proven, or solved again by the fallback
    known = cloud.mask & (resolved | fb_fixed) & torch.isfinite(mean_d)
    unknown = cloud.mask & ~known
    nv = torch.clamp(known.sum(), min=1)
    mu = torch.sum(torch.where(known, mean_d, 0.0)) / nv
    var = torch.sum(torch.where(known, (mean_d - mu) ** 2, 0.0)) / nv
    thresh = mu + stddev_mult * torch.sqrt(var)
    if classes is not None:
        classes.update(proven=cloud.mask & resolved, fallback=cloud.mask & ~resolved & fb_fixed,
                       unknown=unknown)
    return _keep(cloud, (known & (mean_d <= thresh)) | unknown)


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
    `cfg` is a FilterConfig; outlier_method is "radius", "statistical",
    "statistical_approx" (the exact filter, see
    `statistical_outlier_removal`), "statistical_bucketed" or "none"."""
    c = range_crop(cloud, cfg.min_range, cfg.max_range)
    c = voxel_downsample(c, cfg.voxel_size, cfg.max_points)
    if cfg.outlier_method == "radius":
        c = radius_outlier_removal(c, cfg.radius_outlier_radius,
                                   cfg.radius_outlier_min_neighbors, chunk=4096)
    elif cfg.outlier_method in ("statistical", "statistical_approx"):
        # one fused pass up to 16k points; row chunks above that bound the
        # [n,n] distance matrix, as in the reference
        chunk = cfg.stat_chunk or None
        if chunk is None and cfg.max_points > 16384:
            chunk = 8192
        c = statistical_outlier_removal(c, cfg.stat_outlier_k,
                                        cfg.stat_outlier_stddev, chunk=chunk)
    elif cfg.outlier_method == "statistical_bucketed":
        # the voxel downsample above bounds a bucket's occupancy at
        # stat_bucket_mult³, so ranges overflow only in the edge buckets
        c = statistical_outlier_removal_bucketed(
            c, cfg.stat_outlier_k, cfg.stat_outlier_stddev,
            bucket_size=cfg.stat_bucket_mult * cfg.voxel_size,
            cap=cfg.stat_bucket_mult ** 3, fallback_rows=cfg.stat_fallback_rows)
    elif cfg.outlier_method != "none":
        raise ValueError(f"outlier_method {cfg.outlier_method!r} is not ported")
    return compact(c, cfg.max_points)
