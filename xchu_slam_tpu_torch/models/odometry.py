"""NDT scan-to-localmap odometry (port of `xchu_slam_tpu.models.odometry`).

Constant-velocity initial guess with roll/pitch hold, NDT alignment against
the active localmap, and the distance-refresh localmap strategy: every
`min_add_scan_shift` metres of 2-D travel the scan goes into both grids
(A, the alignment target, and B, the map being started); after
`max_localmap_size` metres of insertions A is replaced by B and B restarts
empty; both grids recentre when the vehicle nears A's edge.

Both forms of the step align through `ndt.align`, which on the card is the
hand-written kernel and returns device tensors. The reference's three
`lax.cond`s run in two forms. `step` by default branches on the host, on
scalars that the step reads back once, after the align, together with the
align's trip count, convergence flag and score: one readback a scan (the
host engine's form). `step(..., on_device=True)` decides them on the card:
insertion, swap and recentring take device flags (`ops/voxel_map.py`) and
leave the grids bit-equal where a flag is false, so the step reads nothing
back.
`chunk_step` runs filter + that step over a staged batch of scans.

With a `mesh` (`parallel/distributed.py`; every tensor replicated on each
rank) the NDT align shards the scan's points over the ranks
(`ndt.align(mesh=)`), and insertion, finalize, swap and recentring run
replicated, so every rank's grids stay equal bit for bit with no
communication.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from xchu_slam_tpu_torch.ops import ndt, voxel_map as vm
from xchu_slam_tpu_torch.ops.filter import filter_scan
from xchu_slam_tpu_torch.types import Cloud, VoxelGrid
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
    """One step's results; with `on_device` every field is a tensor."""

    pose: torch.Tensor
    iterations: int
    converged: bool
    score: float
    matched_frac: torch.Tensor
    fitness: torch.Tensor
    inserted: bool
    swapped: bool


def chunk_step(state: OdomState, clouds, fcfg, spec: OdomSpec, mesh=None):
    """Filter + odometry for a chunk of scans: the on-device step over the
    leading axis of a staged Cloud batch (io/prefetch.DeviceChunkPrefetcher),
    with no readback between the scans.

    Empty trailing slots (mask all False, short final chunk) are no-ops by
    construction: zero valid points give a zero NDT gradient and a zero step.

    Returns (new_state, OdomOutput of tensors stacked along the chunk axis)."""
    outs = []
    for s in range(clouds.xyz.shape[0]):
        filt = filter_scan(Cloud(clouds.xyz[s], clouds.intensity[s], clouds.mask[s]),
                           fcfg)
        state, out = step(state, filt.xyz, filt.mask, spec, on_device=True, mesh=mesh)
        outs.append(out)
    return state, OdomOutput(*(torch.stack(field) for field in zip(*outs)))


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


def _guess(state: OdomState, ext_delta=None) -> torch.Tensor:
    """Initial-guess prediction with roll/pitch held at the previous values
    and yaw wrapped: the constant-velocity model, or, given `ext_delta`, the
    delta of an external provider (IMU / wheel odometry, see ops/imu.py)."""
    g = state.pose + (state.diff if ext_delta is None else ext_delta)
    return torch.cat([g[:3], state.pose[3:5], se3.wrap_angle(g[5:6])])


def _near_edge(pose, origin, spec: OdomSpec):
    """Whether the vehicle is within `recentre_margin` of the active grid's
    edge in x or y (a 0-d bool tensor on the inputs' device)."""
    g = spec.gspec
    half_x, half_y = g.gx * g.resolution / 2.0, g.gy * g.resolution / 2.0
    margin_xy = min(half_x, half_y) - spec.recentre_margin
    off = torch.maximum(torch.abs(pose[0] - (origin[0] + half_x)),
                        torch.abs(pose[1] - (origin[1] + half_y)))
    return off > margin_xy


def _step_on_device(state: OdomState, xyz, mask, spec: OdomSpec, ext_delta=None,
                    use_ext=None, mesh=None, align_event=None):
    """`step` with its three branches decided on the card. With `ext_delta`
    the guess's delta is `where(use_ext, ext_delta, diff)`, `use_ext` a 0-d
    bool tensor on the state's device (the reference's `_guess`).
    `align_event` (a CUDA event) is recorded between the align and the map
    update."""
    g = spec.gspec
    delta = None if ext_delta is None else torch.where(use_ext, ext_delta, state.diff)
    res = ndt.align(state.grid_a, xyz, mask, _guess(state, delta), g, spec.nspec, mesh=mesh)
    if align_event is not None:
        align_event.record()
    pose = res.pose
    diff = pose - state.pose
    diff = torch.cat([diff[:3], se3.wrap_angle(diff[3:])])

    shift = torch.linalg.norm(pose[:2] - state.added_pose[:2])
    do_insert = shift >= spec.min_add_scan_shift
    pts_map = se3.rotate_translate(pose, xyz)
    ga, gb = vm.insert_points_pair(state.grid_a, state.grid_b, pts_map, mask, g,
                                   flag=do_insert)
    ga = vm.finalize(ga, g, flag=do_insert)
    travel = torch.where(do_insert, state.localmap_travel + shift,
                         state.localmap_travel)
    added = torch.where(do_insert, pose, state.added_pose)

    do_swap = travel >= spec.max_localmap_size
    ga, gb = vm.swap(ga, gb, g, flag=do_swap)
    travel = torch.where(do_swap, torch.zeros_like(travel), travel)

    do_recentre = _near_edge(pose, ga.origin, spec)
    ga = vm.recentre(ga, pose[:3], g, flag=do_recentre)
    gb = vm.recentre(gb, pose[:3], g, flag=do_recentre)

    new_state = OdomState(pose=pose, prev_pose=state.pose, diff=diff,
                          grid_a=ga, grid_b=gb, localmap_travel=travel,
                          added_pose=added)
    out = OdomOutput(pose=pose, iterations=res.iterations,
                     converged=res.converged, score=res.score,
                     matched_frac=res.matched_frac, fitness=res.fitness,
                     inserted=do_insert, swapped=do_swap)
    return new_state, out


def step(state: OdomState, xyz, mask, spec: OdomSpec, ext_delta=None,
         use_ext: bool = False, on_device: bool = False, mesh=None, align_event=None):
    """One odometry scan step. Returns (new_state, OdomOutput). With
    `use_ext`, `ext_delta` (float32[6] on the state's device) replaces the
    constant-velocity delta in the NDT guess. With `on_device` the step reads
    nothing back and every output is a tensor; there `use_ext` is a 0-d bool
    tensor on the state's device, decided on the card, and `align_event`, a
    CUDA event where given, marks the end of the align. With a `mesh` the
    align is sharded over its ranks and the rest runs replicated."""
    if on_device:
        return _step_on_device(state, xyz, mask, spec, ext_delta, use_ext, mesh, align_event)
    guess = _guess(state, ext_delta if use_ext else None)
    res = ndt.align(state.grid_a, xyz, mask, guess, spec.gspec, spec.nspec, mesh=mesh)
    pose = res.pose
    diff = pose - state.pose
    diff = torch.cat([diff[:3], se3.wrap_angle(diff[3:])])

    shift = torch.linalg.norm(pose[:2] - state.added_pose[:2])
    # the step's one readback: the align's scalars and what the host
    # branches below decide on
    g = spec.gspec
    half = torch.tensor([g.gx, g.gy, g.gz], dtype=torch.float32) * (g.resolution / 2.0)
    shift_h, travel_h, px, py, ox, oy, iters_h, conv_h, score_h = torch.cat(
        [shift[None], state.localmap_travel[None], pose[:2],
         state.grid_a.origin[:2], res.iterations[None].float(),
         res.converged[None].float(), res.score[None]]).cpu().unbind()
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
        ga, gb = vm.swap(ga, gb, g)
        travel = torch.zeros_like(travel)

    # recentre both grids when the vehicle nears the active grid's edge
    # (grid A and B share their origin, read above)
    margin_xy = torch.minimum(half[0], half[1]) - spec.recentre_margin
    off = torch.maximum(torch.abs(px - (ox + half[0])), torch.abs(py - (oy + half[1])))
    if bool(off > margin_xy):
        ga = vm.recentre(ga, pose[:3], g)
        gb = vm.recentre(gb, pose[:3], g)

    new_state = OdomState(pose=pose, prev_pose=state.pose, diff=diff,
                          grid_a=ga, grid_b=gb, localmap_travel=travel,
                          added_pose=added)
    out = OdomOutput(pose=pose, iterations=int(iters_h), converged=bool(conv_h),
                     score=float(score_h), matched_frac=res.matched_frac,
                     fitness=res.fitness, inserted=do_insert, swapped=do_swap)
    return new_state, out
