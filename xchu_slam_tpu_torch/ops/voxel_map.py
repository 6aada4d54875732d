"""Dense rolling NDT voxel-statistics grid (port of
`xchu_slam_tpu.ops.voxel_map`).

The map is a direct-addressed dense tensor of voxel statistics anchored near
the vehicle. Scatter-adds build the statistics, `finalize` turns them into
per-voxel (mean, inverse covariance, valid) rows, and DIRECT7 neighbourhoods
are constant-offset gathers from that base table with a bounds check per
neighbour. Statistics are accumulated in voxel-corner-relative coordinates,
so Σxxᵀ − n·μμᵀ does not cancel in float32 and recentring is an index shift.

Unlike the reference, the finalized table is the [V,10] base table (see
types.VoxelGrid).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from xchu_slam_tpu_torch.types import VoxelGrid
from xchu_slam_tpu_torch.utils import linalg
from xchu_slam_tpu_torch.utils.scatter import index_add


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


def spec_from_config(ndt_cfg) -> GridSpec:
    return GridSpec(
        gx=ndt_cfg.grid_x,
        gy=ndt_cfg.grid_y,
        gz=ndt_cfg.grid_z,
        resolution=ndt_cfg.resolution,
        min_points=ndt_cfg.min_points_per_voxel,
        eig_inflation=ndt_cfg.eig_inflation,
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
    half = torch.stack([c.new_tensor(spec.gx // 2), c.new_tensor(spec.gy // 2),
                        c.new_tensor(spec.gz // 2)]) * spec.resolution
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
                       mask: torch.Tensor, spec: GridSpec):
    """Insert the same scan into both localmap grids with one scatter: the
    grids share their origin by construction (created, recentred and
    swapped together), so the voxel indices coincide."""
    flat, row = _point_rows(spec, ga.origin, xyz, mask)
    both = _accumulate(torch.cat([ga.stats, gb.stats], 1), flat,
                       torch.cat([row, row], 1))
    return ga._replace(stats=both[:, :10]), gb._replace(stats=both[:, 10:])


def finalize(grid: VoxelGrid, spec: GridSpec) -> VoxelGrid:
    """Per-voxel mean / covariance / inflated inverse covariance; voxels
    with fewer than `min_points` points are invalid."""
    n = grid.n
    valid = n >= spec.min_points
    denom = torch.clamp(n, min=1.0)
    m = grid.s1 / denom[:, None]  # voxel-local mean
    mouter = torch.stack(
        [m[:, 0] * m[:, 0], m[:, 0] * m[:, 1], m[:, 0] * m[:, 2],
         m[:, 1] * m[:, 1], m[:, 1] * m[:, 2], m[:, 2] * m[:, 2]],
        -1,
    )
    bessel = torch.clamp(n - 1.0, min=1.0)
    cov6 = (grid.s2 - n[:, None] * mouter) / bessel[:, None]
    icov = linalg.inflate_and_invert_cov(linalg.sym6_to_mat(cov6),
                                         spec.eig_inflation)
    icov6 = torch.where(valid[:, None], linalg.mat_to_sym6(icov), 0.0)
    mean = torch.where(valid[:, None], m, 0.0)
    fin = torch.cat([mean, icov6, valid.to(torch.float32)[:, None]], -1)
    return grid._replace(fin=fin)


def recentre(grid: VoxelGrid, new_centre: torch.Tensor, spec: GridSpec) -> VoxelGrid:
    """Roll the grid so `new_centre` sits at the grid centre: content that
    stays in bounds moves by whole voxels, voxels shifted out are dropped,
    newly exposed voxels start empty. Reads the 3-int shift back to the host
    (recentres are rare: margin crossings only)."""
    new_origin = centered_origin(spec, new_centre)
    shift = torch.round((new_origin - grid.origin) / spec.resolution)
    sx, sy, sz = (int(v) for v in shift.to(torch.int64).tolist())
    dev = grid.stats.device

    def ok_axis(n, s):
        i = torch.arange(n, device=dev)
        return (i + s >= 0) & (i + s < n)

    ok = (ok_axis(spec.gx, sx)[:, None, None] & ok_axis(spec.gy, sy)[None, :, None]
          & ok_axis(spec.gz, sz)[None, None, :])

    def roll3(a):
        g = a.reshape(spec.gx, spec.gy, spec.gz, a.shape[-1])
        g = torch.roll(g, (-sx, -sy, -sz), dims=(0, 1, 2))
        g = torch.where(ok[..., None], g, 0.0)
        return g.reshape(a.shape)

    return VoxelGrid(origin=new_origin, stats=roll3(grid.stats),
                     fin=roll3(grid.fin))


def _offsets7(device) -> torch.Tensor:
    """DIRECT7 offsets [7,3] in the reference's order: centre, ±x, ±y, ±z
    (built on the device, no host copy)."""
    e = torch.eye(3, dtype=torch.int32, device=device)
    return torch.stack([e[0] * 0, e[0], -e[0], e[1], -e[1], e[2], -e[2]])


def lookup_neighbors(grid: VoxelGrid, spec: GridSpec, xyz: torch.Tensor,
                     mode: str = "direct7"):
    """For each query point gather its DIRECT7 voxel neighbourhood:
    (mean_world [N,7,3], icov6 [N,7,6], valid [N,7]).

    Each neighbour is bounds-checked on its own coordinates, so a centre up
    to one voxel outside the grid still sees its in-bounds face neighbours
    (the reference's border-padded table gives the same answer). Entries
    with valid False hold an arbitrary row and must not be used."""
    if mode != "direct7":
        raise ValueError(f"neighbor mode {mode!r} is not ported")
    idx3, _ = _voxel_index3(spec, grid.origin, xyz)
    nidx3 = idx3[:, None, :] + _offsets7(xyz.device)[None, :, :]
    inb = ((nidx3 >= 0) & (nidx3 < _dims(spec, nidx3))).all(dim=-1)
    flat = torch.where(inb, _flat(spec, nidx3), 0)
    rows = grid.fin[flat]                                  # [N,7,10]
    valid = (rows[..., 9] > 0.0) & inb
    corner = grid.origin + nidx3.to(torch.float32) * spec.resolution
    return corner + rows[..., 0:3], rows[..., 3:9], valid


def grid_points(grid: VoxelGrid, spec: GridSpec):
    """All valid voxel means as a (means [V,3], mask [V]) pair."""
    idx = torch.arange(spec.num_voxels, device=grid.fin.device)
    iz = idx % spec.gz
    iy = (idx // spec.gz) % spec.gy
    ix = idx // (spec.gy * spec.gz)
    corner = grid.origin + torch.stack([ix, iy, iz], -1).to(torch.float32) * spec.resolution
    return corner + grid.fin[:, 0:3], grid.fin[:, 9] > 0.0
