"""NDT scan-to-localmap odometry (port of `xchu_slam_tpu.models.odometry`).

Constant-velocity initial guess with roll/pitch hold, NDT alignment against
the active localmap, and the distance-refresh localmap strategy: every
`min_add_scan_shift` metres of 2-D travel the scan goes into both grids
(A, the alignment target, and B, the map being started); after
`max_localmap_size` metres of insertions A is replaced by B and B restarts
empty; both grids recentre when the vehicle nears A's edge.

The reference's three `lax.cond`s are host branches here, on scalars the
step reads back once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from xchu_slam_tpu_torch.ops import ndt, voxel_map as vm
from xchu_slam_tpu_torch.types import VoxelGrid
from xchu_slam_tpu_torch.utils import se3


class OdomSpec(NamedTuple):
    """Static odometry parameters."""

    gspec: vm.GridSpec
    nspec: ndt.NdtSpec
    min_add_scan_shift: float = 0.5
    max_localmap_size: float = 5.0
    recentre_margin: float = 20.0


def spec_from_config(cfg) -> OdomSpec:
    return OdomSpec(
        gspec=vm.spec_from_config(cfg.ndt),
        nspec=ndt.spec_from_config(cfg.ndt),
        min_add_scan_shift=cfg.odom.min_add_scan_shift,
        max_localmap_size=cfg.odom.max_localmap_size,
        recentre_margin=cfg.ndt.recentre_margin,
    )


class OdomState(NamedTuple):
    pose: torch.Tensor            # float32[6] current pose
    prev_pose: torch.Tensor       # float32[6]
    diff: torch.Tensor            # float32[6] last inter-scan delta
    grid_a: VoxelGrid             # active localmap (alignment target)
    grid_b: VoxelGrid             # tmp localmap being accumulated
    localmap_travel: torch.Tensor  # float32 accumulated insert shift
    added_pose: torch.Tensor      # float32[6] pose at last insertion


class OdomOutput(NamedTuple):
    pose: torch.Tensor
    iterations: int
    converged: bool
    score: float
    matched_frac: torch.Tensor
    fitness: torch.Tensor
    inserted: bool
    swapped: bool


def init_state(spec: OdomSpec, init_pose: torch.Tensor, xyz, mask) -> OdomState:
    """Seed both localmaps with the first scan at `init_pose` (all tensors
    on one device)."""
    init_pose = init_pose.to(torch.float32)
    pts_map = se3.rotate_translate(init_pose, xyz)
    origin = vm.centered_origin(spec.gspec, init_pose[:3])
    ga = vm.make_grid(spec.gspec, origin)
    gb = vm.make_grid(spec.gspec, origin.clone())
    ga = vm.insert_points(ga, pts_map, mask, spec.gspec)
    gb = vm.insert_points(gb, pts_map, mask, spec.gspec)
    ga = vm.finalize(ga, spec.gspec)
    return OdomState(
        pose=init_pose,
        prev_pose=init_pose.clone(),
        diff=torch.zeros_like(init_pose),
        grid_a=ga,
        grid_b=gb,
        localmap_travel=init_pose.new_zeros(()),
        added_pose=init_pose.clone(),
    )


def _guess(state: OdomState) -> torch.Tensor:
    """Constant-velocity prediction with roll/pitch held at the previous
    values and yaw wrapped."""
    g = state.pose + state.diff
    return torch.cat([g[:3], state.pose[3:5], se3.wrap_angle(g[5:6])])


def step(state: OdomState, xyz, mask, spec: OdomSpec):
    """One odometry scan step. Returns (new_state, OdomOutput)."""
    guess = _guess(state)
    res = ndt.align(state.grid_a, xyz, mask, guess, spec.gspec, spec.nspec)
    pose = res.pose
    diff = pose - state.pose
    diff = torch.cat([diff[:3], se3.wrap_angle(diff[3:])])

    shift = torch.linalg.norm(pose[:2] - state.added_pose[:2])
    # one readback for the host branches below
    g = spec.gspec
    half = torch.tensor([g.gx, g.gy, g.gz], dtype=torch.float32) * (g.resolution / 2.0)
    shift_h, travel_h, *pose_h = torch.cat(
        [shift[None], state.localmap_travel[None], pose[:2],
         state.grid_a.origin[:2]]).cpu().unbind()
    ga, gb, travel, added = (state.grid_a, state.grid_b,
                             state.localmap_travel, state.added_pose)

    do_insert = bool(shift_h >= spec.min_add_scan_shift)
    if do_insert:
        pts_map = se3.rotate_translate(pose, xyz)
        ga, gb = vm.insert_points_pair(ga, gb, pts_map, mask, g)
        ga = vm.finalize(ga, g)
        travel, added = travel + shift, pose
        travel_h = travel_h + shift_h

    do_swap = bool(travel_h >= spec.max_localmap_size)
    if do_swap:
        ga = vm.finalize(gb, g)
        gb = vm.make_grid(g, gb.origin.clone())
        travel = torch.zeros_like(travel)

    # recentre both grids when the vehicle nears the active grid's edge
    # (grid A and B share their origin, read above)
    px, py, ox, oy = pose_h
    margin_xy = torch.minimum(half[0], half[1]) - spec.recentre_margin
    off = torch.maximum(torch.abs(px - (ox + half[0])), torch.abs(py - (oy + half[1])))
    if bool(off > margin_xy):
        ga = vm.recentre(ga, pose[:3], g)
        gb = vm.recentre(gb, pose[:3], g)

    new_state = OdomState(pose=pose, prev_pose=state.pose, diff=diff,
                          grid_a=ga, grid_b=gb, localmap_travel=travel,
                          added_pose=added)
    out = OdomOutput(pose=pose, iterations=res.iterations,
                     converged=res.converged, score=res.score,
                     matched_frac=res.matched_frac, fitness=res.fitness,
                     inserted=do_insert, swapped=do_swap)
    return new_state, out
