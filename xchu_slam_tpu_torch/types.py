"""Core data types: fixed-capacity, masked tensors (as in the reference's
`xchu_slam_tpu.types`)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Cloud(NamedTuple):
    """Fixed-capacity point cloud.

    xyz:       float32[N, 3]  (padded entries are zeros)
    intensity: float32[N]
    mask:      bool[N]        True for valid points
    """

    xyz: torch.Tensor
    intensity: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def count(self) -> torch.Tensor:
        return self.mask.sum()


def make_cloud(xyz, intensity=None, mask=None, capacity: int | None = None,
               device: torch.device | str = "cpu") -> Cloud:
    """Build a Cloud from (possibly ragged) numpy arrays, padded or truncated
    to `capacity` on the host, then moved to `device` in one copy per array."""
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    intensity = (np.zeros((n,), np.float32) if intensity is None
                 else np.asarray(intensity, np.float32))
    mask = (np.ones((n,), bool) if mask is None else np.asarray(mask, bool))
    if capacity is not None and capacity != n:
        if n > capacity:
            xyz, intensity, mask = xyz[:capacity], intensity[:capacity], mask[:capacity]
        else:
            pad = capacity - n
            xyz = np.pad(xyz, ((0, pad), (0, 0)))
            intensity = np.pad(intensity, (0, pad))
            mask = np.pad(mask, (0, pad))
    xyz = np.where(mask[:, None], xyz, 0.0).astype(np.float32)
    return Cloud(xyz=torch.from_numpy(xyz).to(device),
                 intensity=torch.from_numpy(np.ascontiguousarray(intensity)).to(device),
                 mask=torch.from_numpy(np.ascontiguousarray(mask)).to(device))


class VoxelGrid(NamedTuple):
    """Dense rolling NDT voxel-statistics grid (see ops/voxel_map.py).

    origin: float32[3]    world position of voxel (0,0,0) corner
    stats:  float32[V,10] accumulators per voxel (V = gx*gy*gz):
                          [n, Σx (3), Σxxᵀ upper-tri (6)], voxel-corner-relative
    fin:    float32[V,10] finalized stats per voxel:
                          [mean (3), icov upper-tri (6), valid (1.0/0.0)]

    `fin` is the reference's base table, not its DIRECT7-packed [Vp,70] one:
    at the default grid the base table is 6.1 MB and stays in the H100's
    50 MB L2, where the packed table (48.9 MB) would not. The lookup
    bounds-checks each of the 7 neighbours against it instead.
    """

    origin: torch.Tensor
    stats: torch.Tensor
    fin: torch.Tensor

    @property
    def mean(self) -> torch.Tensor:
        return self.fin[:, 0:3]

    @property
    def icov(self) -> torch.Tensor:
        return self.fin[:, 3:9]

    @property
    def valid(self) -> torch.Tensor:
        return self.fin[:, 9] > 0.0

    @property
    def n(self) -> torch.Tensor:
        return self.stats[:, 0]

    @property
    def s1(self) -> torch.Tensor:
        return self.stats[:, 1:4]

    @property
    def s2(self) -> torch.Tensor:
        return self.stats[:, 4:10]
