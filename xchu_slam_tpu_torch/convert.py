"""State carried across between the reference package and the port.

The reference's state arrives as numpy arrays (any object with the
reference's field names: its NamedTuples after `np.asarray` of each leaf
work as they are) and leaves as dicts of numpy arrays under the reference's
field names, which the reference's NamedTuples take as keyword arguments.
The only layout that differs is the voxel grid's finalized table: the
reference keeps a border-padded DIRECT7-packed [Vp,70] table whose lane
block 0 of each interior row is that voxel's base row; the port keeps the
base [V,10] table itself.
"""

from __future__ import annotations

import numpy as np
import torch

from xchu_slam_tpu_torch.models.odometry import OdomState
from xchu_slam_tpu_torch.models.pipeline import KfDb
from xchu_slam_tpu_torch.models.pose_graph import GraphData
from xchu_slam_tpu_torch.ops.voxel_map import GridSpec
from xchu_slam_tpu_torch.types import VoxelGrid

# DIRECT7 offsets in the reference's packing order (centre, ±x, ±y, ±z)
_OFFSETS7 = ((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
             (0, 0, 1), (0, 0, -1))


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def unpack_base(fin_packed: np.ndarray, spec: GridSpec) -> np.ndarray:
    """Reference [Vp,70] → base [V,10] (the reference's `unpack_base`)."""
    px, py, pz = spec.gx + 2, spec.gy + 2, spec.gz + 2
    g = np.asarray(fin_packed)[:, :10].reshape(px, py, pz, 10)
    return g[1:-1, 1:-1, 1:-1].reshape(spec.num_voxels, 10)


def pack_fin7(fin_base: np.ndarray, spec: GridSpec) -> np.ndarray:
    """Base [V,10] → reference [Vp,70] (the reference's `pack_fin7`)."""
    px, py, pz = spec.gx + 2, spec.gy + 2, spec.gz + 2
    g = np.asarray(fin_base).reshape(spec.gx, spec.gy, spec.gz, 10)
    base_p = np.pad(g, ((1, 1), (1, 1), (1, 1), (0, 0))).reshape(px * py * pz, 10)
    offs = [(ox * py + oy) * pz + oz for ox, oy, oz in _OFFSETS7]
    return np.concatenate([np.roll(base_p, -o, axis=0) for o in offs], axis=1)


def voxel_grid_from_ref(grid, spec: GridSpec, device="cpu") -> VoxelGrid:
    return VoxelGrid(origin=_t(grid.origin, device, np.float32),
                     stats=_t(grid.stats, device, np.float32),
                     fin=_t(unpack_base(grid.fin, spec), device, np.float32))


def voxel_grid_to_ref(grid: VoxelGrid, spec: GridSpec) -> dict:
    return {"origin": _np(grid.origin), "stats": _np(grid.stats),
            "fin": pack_fin7(_np(grid.fin), spec)}


def odom_state_from_ref(st, spec: GridSpec, device="cpu") -> OdomState:
    return OdomState(
        pose=_t(st.pose, device, np.float32),
        prev_pose=_t(st.prev_pose, device, np.float32),
        diff=_t(st.diff, device, np.float32),
        grid_a=voxel_grid_from_ref(st.grid_a, spec, device),
        grid_b=voxel_grid_from_ref(st.grid_b, spec, device),
        localmap_travel=_t(st.localmap_travel, device, np.float32),
        added_pose=_t(st.added_pose, device, np.float32),
    )


def odom_state_to_ref(st: OdomState, spec: GridSpec) -> dict:
    return {"pose": _np(st.pose), "prev_pose": _np(st.prev_pose),
            "diff": _np(st.diff),
            "grid_a": voxel_grid_to_ref(st.grid_a, spec),
            "grid_b": voxel_grid_to_ref(st.grid_b, spec),
            "localmap_travel": _np(st.localmap_travel),
            "added_pose": _np(st.added_pose)}


def kfdb_from_ref(db, device="cpu") -> KfDb:
    """The reference's `isc_db` has no counterpart yet (ISC is not ported)
    and is dropped."""
    return KfDb(poses=_t(db.poses, device, np.float32),
                opt_poses=_t(db.opt_poses, device, np.float32),
                stamps=_t(db.stamps, device, np.float32),
                travel=_t(db.travel, device, np.float32),
                clouds=_t(db.clouds, device, np.float32),
                cloud_mask=_t(db.cloud_mask, device, bool),
                sc_db=_t(db.sc_db, device, np.float32),
                count=int(db.count))


def kfdb_to_ref(db: KfDb, isc_shape: tuple[int, int]) -> dict:
    """`isc_db` comes back as zeros of [K, *isc_shape] (descriptors the
    reference fills only with loop.method="isc")."""
    K = db.poses.shape[0]
    return {"poses": _np(db.poses), "opt_poses": _np(db.opt_poses),
            "stamps": _np(db.stamps), "travel": _np(db.travel),
            "clouds": _np(db.clouds), "cloud_mask": _np(db.cloud_mask),
            "sc_db": _np(db.sc_db),
            "isc_db": np.zeros((K, *isc_shape), np.float32),
            "count": np.int32(db.count)}


def graph_from_ref(g, device="cpu") -> GraphData:
    return GraphData(between_T=_t(g.between_T, device, np.float32),
                     kf_mask=_t(g.kf_mask, device, bool),
                     loop_i=_t(g.loop_i, device, np.int64),
                     loop_j=_t(g.loop_j, device, np.int64),
                     loop_T=_t(g.loop_T, device, np.float32),
                     loop_info=_t(g.loop_info, device, np.float32),
                     loop_mask=_t(g.loop_mask, device, bool),
                     gps_alt=_t(g.gps_alt, device, np.float32),
                     gps_mask=_t(g.gps_mask, device, bool))


def graph_to_ref(g: GraphData) -> dict:
    out = {k: _np(v) for k, v in g._asdict().items()}
    out["loop_i"] = out["loop_i"].astype(np.int32)
    out["loop_j"] = out["loop_j"].astype(np.int32)
    return out
