"""Sharded SLAM ops over a mesh of ranks (port of
`xchu_slam_tpu.parallel.sharded`).

The reference runs each of these as one `shard_map` program over a JAX mesh.
The port runs one process a rank (`parallel/distributed.py`), every rank
holding the inputs whole, and each function here is the mesh branch of the
op it names, with the collectives of `utils/collectives.py` between the
ranks:
- NDT with the scan's POINTS sharded: each rank's pass sums reduced in rank
  order, the Newton and line-search control identical on every rank
  (`ops/ndt.py::align`);
- Scan Context retrieval with the descriptor DATABASE sharded: each rank
  scores its K/D rows, the per-rank minima meet in one all-gather
  (`ops/scancontext.py::detect_loop`);
- the pose-graph solve with the FACTORS sharded: the system's sums reduced,
  the factors' blocks gathered, the same CG on every rank
  (`models/pose_graph.py::sharded_gn_solve`);
and `slam_superstep` composes the three in one call. Every rank returns the
same results.
"""

from __future__ import annotations

import torch
from torch.func import grad

from xchu_slam_tpu_torch.models import pose_graph as pg
from xchu_slam_tpu_torch.ops import ndt, scancontext as sc
from xchu_slam_tpu_torch.parallel.distributed import Mesh, global_mesh
from xchu_slam_tpu_torch.utils import collectives, se3


def make_mesh(n_devices: int | None = None) -> Mesh:
    """The mesh over every rank of the process group (`distributed.
    initialize` formed it); `n_devices`, where given, must be its size."""
    mesh = global_mesh()
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"the process group has {mesh.size} ranks, not {n_devices}: "
                         "a mesh is the whole group")
    return mesh


def sharded_ndt_align(mesh: Mesh, grid, src_xyz, src_mask, init_pose, gspec, nspec):
    """NDT align with the source cloud sharded over the mesh; (pose,
    iterations, converged), the same on every rank."""
    res = ndt.align(grid, src_xyz, src_mask, init_pose, gspec, nspec, mesh=mesh)
    return res.pose, res.iterations, res.converged


def sharded_sc_detect(mesh: Mesh, query, db, db_count: int, spec) -> sc.DeviceCandidate:
    """Loop retrieval with the descriptor database sharded over the mesh: the
    best entry at least `num_exclude_recent` older than the newest, as
    tensors on the rank's device."""
    return sc.detect_loop_on_device(query, db, db_count, spec, mesh=mesh)


def sharded_pgo_solve(mesh: Mesh, poses6, graph, spec):
    """The pose-graph solve with its factors sharded over the mesh (poses
    replicated): the optimized [K,6], the same on every rank."""
    return pg.solve(poses6, graph, spec, mesh=mesh)


def sharded_pgo_hvp_demo(mesh: Mesh, poses6, graph, spec):
    """The gradient of the odometry part of the pose-graph objective at the
    poses, with the between factors sharded over the mesh and the shards'
    gradients summed: the reduction `slam_superstep`'s solve relies on,
    checked on its own. Row i of the shard is the edge (k−1, k), k =
    clip(base + i, 1, K−1), weighted by the keyframe mask of k ≥ 1, as in
    the reference's demonstration."""
    K = poses6.shape[0]
    rows = mesh.shard(K, "keyframe slots (max_keyframes)")
    dev = poses6.device
    T = se3.pose_to_matrix(poses6)
    k = torch.arange(rows.start, rows.stop, device=dev)
    gi = torch.clamp(k, 1, K - 1)
    live = (graph.kf_mask & (torch.arange(K, device=dev) >= 1))[rows]
    info = torch.tensor([spec.odom_info_t] * 3 + [spec.odom_info_r] * 3, device=dev)
    w = torch.where(live[:, None], info[None, :], 0.0)
    mask0 = torch.ones((K, 1), device=dev)
    mask0[0].fill_(0.0)

    def local_obj(xi):
        Tn = torch.matmul(T, se3.se3_exp(xi * mask0))
        r = pg._between_residual(Tn[gi - 1], Tn[gi], graph.between_T[rows])
        return 0.5 * torch.sum(w * r * r)

    return collectives.shard_allsum(grad(local_obj)(torch.zeros_like(poses6)), mesh)


def slam_superstep(mesh: Mesh, grid, src_xyz, src_mask, pose_guess, gspec, nspec,
                   db, db_count: int, scspec, poses6, graph, pgspec):
    """One multi-rank SLAM step of the three sharding regimes:
      1. NDT with the scan's points sharded (`ops/ndt.py::align`);
      2. the scan's Scan Context descriptor from each rank's points
         (`descriptor_partial`) maxed over the mesh and finalized, then
         retrieved against the database sharded by keyframe
         (`scancontext.best_on_mesh`);
      3. the pose-graph solve with its factors sharded.
    Returns (pose, iterations, descriptor, candidate: (dist, index, shift)
    float32 [3], optimized poses), the same on every rank."""
    D = mesh.size
    for name, n in (("database capacity", db.shape[0]), ("keyframe slots", poses6.shape[0]),
                    ("loop slots", graph.loop_i.shape[0]), ("source points", src_xyz.shape[0])):
        if n % D:
            raise ValueError(f"{name}: leading axis {n} is not divisible by the mesh size {D}")
    pose, iters, _conv = sharded_ndt_align(mesh, grid, src_xyz, src_mask, pose_guess,
                                           gspec, nspec)
    sl = mesh.shard(src_xyz.shape[0], "source points")
    part = sc.descriptor_partial(src_xyz[sl], src_mask[sl], scspec)
    desc = sc.finalize_descriptor(collectives.shard_allmax(part, mesh))
    cand = sc.best_on_mesh(desc, db, db_count - scspec.num_exclude_recent, scspec, mesh)
    opt = sharded_pgo_solve(mesh, poses6, graph, pgspec)
    return pose, iters, desc, cand, opt
