"""Keyframe-window localmap strategies (2) and (3) (port of
`xchu_slam_tpu.models.localmap_keyframes`).

The reference ships three localmap strategies; only the distance-refresh one
is active (`models/odometry.py`). These are the other two, whose call sites
the reference leaves commented out (`odom_node.cpp:186-202`):

- (2) `ExtractSurroundKeyframes`: the localmap is the last `window`
  keyframes' clouds.
- (3) `ExtractSurroundKeyframesByDis`: the keyframes within `radius` of the
  current pose, among the last `max_window`.

Both build a fresh NDT voxel grid from the selected keyframe clouds with the
grid's own insert (a deterministic scatter) and finalize, on the inputs'
device. No pipeline calls them.
"""

from __future__ import annotations

import torch

from xchu_slam_tpu_torch.ops import voxel_map as vm
from xchu_slam_tpu_torch.types import VoxelGrid
from xchu_slam_tpu_torch.utils import se3


def _build(kf_clouds, kf_masks, kf_poses, ksc, ok, centre_xyz, spec: vm.GridSpec) -> VoxelGrid:
    """Grid centred on `centre_xyz` from the keyframes `ksc` where `ok`."""
    pts = se3.transform_points(se3.pose_to_matrix(kf_poses[ksc]), kf_clouds[ksc])   # [W,P,3]
    mask = kf_masks[ksc] & ok[:, None]
    grid = vm.make_grid(spec, vm.centered_origin(spec, centre_xyz))
    grid = vm.insert_points(grid, pts.reshape(-1, 3), mask.reshape(-1), spec)
    return vm.finalize(grid, spec)


def _recent(kf_count, n: int, K: int, device):
    """The last `n` keyframe indices (newest first), clipped into [0, K),
    and which of them exist. `kf_count` is an int or a 0-d tensor."""
    ks = kf_count - 1 - torch.arange(n, device=device)
    return torch.clamp(ks, 0, K - 1), ks >= 0


def build_window_localmap(kf_clouds, kf_masks, kf_poses, kf_count, centre_xyz,
                          spec: vm.GridSpec, window: int = 20) -> VoxelGrid:
    """Strategy (2): a grid from the last `window` keyframes. kf_clouds
    [K,P,3] in the body frame, kf_masks [K,P], kf_poses [K,6]."""
    ksc, ok = _recent(kf_count, window, kf_clouds.shape[0], kf_clouds.device)
    return _build(kf_clouds, kf_masks, kf_poses, ksc, ok, centre_xyz, spec)


def build_distance_localmap(kf_clouds, kf_masks, kf_poses, kf_count, centre_xyz,
                            spec: vm.GridSpec, radius: float = 50.0,
                            max_window: int = 50) -> VoxelGrid:
    """Strategy (3): a grid from the keyframes within `radius` (2-D) of
    `centre_xyz`, among the most recent `max_window`."""
    ksc, ok = _recent(kf_count, max_window, kf_clouds.shape[0], kf_clouds.device)
    d = torch.linalg.norm(kf_poses[ksc, :2] - centre_xyz[:2][None], dim=-1)
    return _build(kf_clouds, kf_masks, kf_poses, ksc, ok & (d < radius), centre_xyz, spec)
