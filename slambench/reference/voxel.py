"""The NDT voxel map of the reference: a frozen copy of the port's
`ops/voxel_map.py` (a dense rolling grid of voxel statistics, finalized to
per-voxel mean, inflated inverse covariance and validity)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from slambench.reference import linalg
from slambench.reference.scatter import index_add


class VoxelGrid(NamedTuple):
    origin: torch.Tensor   # float32[3]: the corner of voxel (0,0,0)
    stats: torch.Tensor    # float32[V,10]: n, Σx (3), Σxxᵀ upper triangle (6), corner-relative
    fin: torch.Tensor      # float32[V,10]: mean (3), icov upper triangle (6), valid


class GridSpec(NamedTuple):
    """Static grid geometry."""

    gx: int
    gy: int
    gz: int
    resolution: float
    min_points: int
    eig_inflation: float

    @property
    def num_voxels(self) -> int:
        return self.gx * self.gy * self.gz


def spec_from_config(cfg: dict) -> GridSpec:
    return GridSpec(
        gx=cfg["ndt.grid_x"],
        gy=cfg["ndt.grid_y"],
        gz=cfg["ndt.grid_z"],
        resolution=cfg["ndt.resolution"],
        min_points=cfg["ndt.min_points_per_voxel"],
        eig_inflation=cfg["ndt.eig_inflation"],
    )


def make_grid(spec: GridSpec, origin: torch.Tensor) -> VoxelGrid:
    """Empty grid whose voxel (0,0,0) corner sits at `origin` (float32[3]);
    the grid lives on `origin`'s device."""
    V = spec.num_voxels
    dev = origin.device
    return VoxelGrid(
        origin=origin.to(torch.float32),
        stats=torch.zeros((V, 10), dtype=torch.float32, device=dev),
        fin=torch.zeros((V, 10), dtype=torch.float32, device=dev),
    )


def centered_origin(spec: GridSpec, centre_xyz: torch.Tensor) -> torch.Tensor:
    """Voxel-aligned origin placing `centre_xyz` at the grid centre."""
    c = centre_xyz.to(torch.float32)
    # filled on the device: a host-built constant would be a copy per call
    half = torch.stack([torch.full_like(c[0], spec.gx // 2),
                        torch.full_like(c[0], spec.gy // 2),
                        torch.full_like(c[0], spec.gz // 2)]) * spec.resolution
    return torch.floor((c - half) / spec.resolution) * spec.resolution


def _dims(spec: GridSpec, like: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.full_like(like[..., 0], spec.gx),
                        torch.full_like(like[..., 0], spec.gy),
                        torch.full_like(like[..., 0], spec.gz)], -1)


def _voxel_index3(spec: GridSpec, origin: torch.Tensor, xyz: torch.Tensor):
    """World points → integer voxel coords + in-bounds flag."""
    idx = torch.floor((xyz - origin) / spec.resolution).to(torch.int32)
    inb = ((idx >= 0) & (idx < _dims(spec, idx))).all(dim=-1)
    return idx, inb


def _flat(spec: GridSpec, idx3: torch.Tensor) -> torch.Tensor:
    """int voxel coords → flat index (x·gy + y)·gz + z, as int64."""
    idx3 = idx3.long()
    return (idx3[..., 0] * spec.gy + idx3[..., 1]) * spec.gz + idx3[..., 2]


def _point_rows(spec: GridSpec, origin: torch.Tensor, xyz: torch.Tensor,
                mask: torch.Tensor):
    """(flat index [N], accumulator row [N,10]) per point. Dropped points
    (masked or outside the grid) get an index of their own past the grid,
    V + i, so that they sum into rows that are thrown away (one shared
    slot would be one long segment, which the sorted deterministic scatter
    sums serially)."""
    idx3, inb = _voxel_index3(spec, origin, xyz)
    ok = inb & mask
    dropped = spec.num_voxels + torch.arange(xyz.shape[0], device=xyz.device)
    flat = torch.where(ok, _flat(spec, idx3), dropped)
    corner = origin + idx3.to(torch.float32) * spec.resolution
    l = torch.where(ok[:, None], xyz - corner, 0.0)
    row = torch.cat(
        [ok.to(torch.float32)[:, None],
         l,
         torch.stack([l[:, 0] * l[:, 0], l[:, 0] * l[:, 1], l[:, 0] * l[:, 2],
                      l[:, 1] * l[:, 1], l[:, 1] * l[:, 2], l[:, 2] * l[:, 2]],
                     -1)],
        -1,
    )
    return flat, row


def _accumulate(stats: torch.Tensor, flat: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """stats [V,C] + the rows scattered by `flat`, with rows past V dropped
    (a new tensor, as the reference's padded scatter returns)."""
    V = stats.shape[0]
    padded = torch.cat([stats, stats.new_zeros((flat.shape[0], stats.shape[1]))])
    return index_add(padded, flat, row)[:V]


def insert_points(grid: VoxelGrid, xyz: torch.Tensor, mask: torch.Tensor,
                  spec: GridSpec) -> VoxelGrid:
    """Accumulate scan points into the grid statistics."""
    flat, row = _point_rows(spec, grid.origin, xyz, mask)
    return grid._replace(stats=_accumulate(grid.stats, flat, row))


def insert_points_pair(ga: VoxelGrid, gb: VoxelGrid, xyz: torch.Tensor,
                       mask: torch.Tensor, spec: GridSpec, flag=None):
    """Insert the same scan into both localmap grids with one scatter: the
    grids share their origin by construction (created, recentred and
    swapped together), so the voxel indices coincide. With a false `flag`
    every point goes to a dropped slot, so no statistic changes."""
    if flag is not None:
        mask = mask & flag
    flat, row = _point_rows(spec, ga.origin, xyz, mask)
    both = _accumulate(torch.cat([ga.stats, gb.stats], 1), flat,
                       torch.cat([row, row], 1))
    return ga._replace(stats=both[:, :10]), gb._replace(stats=both[:, 10:])


def finalize_stats(stats: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """Accumulators [V,10] → finalized rows [V,10]: per-voxel mean, inflated
    inverse covariance and validity; voxels with fewer than `min_points`
    points are invalid (zero rows)."""
    n, s1, s2 = stats[:, 0], stats[:, 1:4], stats[:, 4:10]
    valid = n >= spec.min_points
    denom = torch.clamp(n, min=1.0)
    m = s1 / denom[:, None]  # voxel-local mean
    mouter = torch.stack(
        [m[:, 0] * m[:, 0], m[:, 0] * m[:, 1], m[:, 0] * m[:, 2],
         m[:, 1] * m[:, 1], m[:, 1] * m[:, 2], m[:, 2] * m[:, 2]],
        -1,
    )
    bessel = torch.clamp(n - 1.0, min=1.0)
    cov6 = (s2 - n[:, None] * mouter) / bessel[:, None]
    icov = linalg.inflate_and_invert_cov(linalg.sym6_to_mat(cov6),
                                         spec.eig_inflation)
    icov6 = torch.where(valid[:, None], linalg.mat_to_sym6(icov), 0.0)
    mean = torch.where(valid[:, None], m, 0.0)
    return torch.cat([mean, icov6, valid.to(torch.float32)[:, None]], -1)


def finalize(grid: VoxelGrid, spec: GridSpec, flag=None) -> VoxelGrid:
    """Per-voxel mean / covariance / inflated inverse covariance from the
    grid's statistics; with a false `flag` the finalized table is kept."""
    fin = finalize_stats(grid.stats, spec)
    if flag is not None:
        fin = torch.where(flag, fin, grid.fin)
    return grid._replace(fin=fin)


def swap(ga: VoxelGrid, gb: VoxelGrid, spec: GridSpec, flag=None):
    """The localmap refresh: the map being started (B) becomes the alignment
    target, finalized, and B restarts empty at the same origin. Returns
    (A, B); with a false `flag` both come back as they were."""
    fresh = finalize(gb, spec)
    empty = make_grid(spec, gb.origin.clone())
    if flag is None:
        return fresh, empty
    return (VoxelGrid(origin=torch.where(flag, gb.origin, ga.origin),
                      stats=torch.where(flag, fresh.stats, ga.stats),
                      fin=torch.where(flag, fresh.fin, ga.fin)),
            VoxelGrid(origin=gb.origin,
                      stats=torch.where(flag, empty.stats, gb.stats),
                      fin=torch.where(flag, empty.fin, gb.fin)))


def recentre(grid: VoxelGrid, new_centre: torch.Tensor, spec: GridSpec,
             flag=None) -> VoxelGrid:
    """Roll the grid so `new_centre` sits at the grid centre: content that
    stays in bounds moves by whole voxels, voxels shifted out are dropped,
    newly exposed voxels start empty. The whole-voxel shift stays on the
    card: every row gathers its source row by an index computed from it (a
    zero shift is the identity). With a false `flag` the shift is zero and
    the origin is kept."""
    new_origin = centered_origin(spec, new_centre)
    shift = torch.round((new_origin - grid.origin) / spec.resolution).to(torch.int64)
    if flag is not None:
        shift = torch.where(flag, shift, 0)
        new_origin = torch.where(flag, new_origin, grid.origin)
    idx = torch.arange(spec.num_voxels, device=grid.stats.device)
    src3 = torch.stack([idx // (spec.gy * spec.gz), (idx // spec.gz) % spec.gy,
                        idx % spec.gz], -1) + shift
    ok = ((src3 >= 0) & (src3 < _dims(spec, src3))).all(dim=-1)
    src = torch.where(ok, _flat(spec, src3), 0)

    def moved(a):
        return torch.where(ok[:, None], a[src], 0.0)

    return VoxelGrid(origin=new_origin, stats=moved(grid.stats),
                     fin=moved(grid.fin))


# the offset tables of the neighbour modes (reference `_MODE_OFFSETS`,
# voxel_map.py:283-318): direct1 the centre only; direct7 centre, ±x, ±y, ±z;
# direct26 and kdtree the 27-cube in `meshgrid(..., indexing="ij")` order
# (PCL's 26 neighbours plus the centre). kdtree then keeps the voxels whose
# mean lies within `resolution` of the point: a centroid that close to the
# query lies inside the 27-cube, so that is the reference's radius search.
# direct7_rows is direct7 (the reference's per-neighbour row gather of the
# same voxels, kept there for A/B measurement).
NEIGHBOR_COUNT = {"direct1": 1, "direct7": 7, "direct7_rows": 7, "direct26": 27,
                  "kdtree": 27}


def neighbor_offsets(mode: str, device) -> torch.Tensor:
    """The mode's offsets [M,3] (int32), built on the device, no host copy."""
    if mode not in NEIGHBOR_COUNT:
        raise ValueError(f"unknown neighbor mode {mode!r}; the modes are "
                         f"{tuple(NEIGHBOR_COUNT)}")
    if mode == "direct1":
        return torch.zeros((1, 3), dtype=torch.int32, device=device)
    if NEIGHBOR_COUNT[mode] == 7:
        e = torch.eye(3, dtype=torch.int32, device=device)
        return torch.stack([e[0] * 0, e[0], -e[0], e[1], -e[1], e[2], -e[2]])
    r = torch.arange(-1, 2, dtype=torch.int32, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(27, 3)


def lookup_neighbors(grid: VoxelGrid, spec: GridSpec, xyz: torch.Tensor,
                     mode: str = "direct7"):
    """For each query point gather its voxel neighbourhood in `mode`:
    (mean_world [N,M,3], icov6 [N,M,6], valid [N,M]), M = 1 / 7 / 27.

    Each neighbour is bounds-checked on its own coordinates, so a centre up
    to one voxel outside the grid still sees its in-bounds neighbours (the
    reference's clip into its border-padded table gives the same answer).
    Entries with valid False hold an arbitrary row and must not be used.
    kdtree also drops the voxels whose mean is `resolution` or more from
    `xyz` (the points where the neighbourhood is gathered)."""
    idx3, _ = _voxel_index3(spec, grid.origin, xyz)
    nidx3 = idx3[:, None, :] + neighbor_offsets(mode, xyz.device)[None, :, :]
    inb = ((nidx3 >= 0) & (nidx3 < _dims(spec, nidx3))).all(dim=-1)
    flat = torch.where(inb, _flat(spec, nidx3), 0)
    rows = grid.fin[flat]                                  # [N,M,10]
    valid = (rows[..., 9] > 0.0) & inb
    corner = grid.origin + nidx3.to(torch.float32) * spec.resolution
    mean_w = corner + rows[..., 0:3]
    if mode == "kdtree":
        d = xyz[:, None, :] - mean_w
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        valid = valid & (d2 < spec.resolution ** 2)
    return mean_w, rows[..., 3:9], valid


def grid_points(grid: VoxelGrid, spec: GridSpec):
    """All valid voxel means as a (means [V,3], mask [V]) pair."""
    idx = torch.arange(spec.num_voxels, device=grid.fin.device)
    iz = idx % spec.gz
    iy = (idx // spec.gz) % spec.gy
    ix = idx // (spec.gy * spec.gz)
    corner = grid.origin + torch.stack([ix, iy, iz], -1).to(torch.float32) * spec.resolution
    return corner + grid.fin[:, 0:3], grid.fin[:, 9] > 0.0
