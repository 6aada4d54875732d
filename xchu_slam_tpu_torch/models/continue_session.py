"""Session continuation: relocalize into a saved map, then keep mapping
(port of `xchu_slam_tpu.models.continue_session`).

`continue_session` loads a device-engine checkpoint (keyframe store, factor
graph, descriptors), relocalizes the new session's first scan against the
saved map (`SessionLocalizer`: the Scan Context retrieval, then the ICP
refinement, whose nearest-neighbour search and iteration run as the CUDA
kernels on the card), and returns a `DeviceSlamPipeline` that continues
mapping in the saved session's frame:

- the new keyframes follow the saved ones in the same fixed-capacity store;
- the first new keyframe (`K0`, the saved count) is tied to the saved graph
  twice: a between factor from the last saved keyframe (from the
  relocalized pose) and a loop factor against the matched saved keyframe
  that carries the ICP measurement;
- loop detection then searches the whole store, so later revisits close
  against both sessions' keyframes.

The seed is a one-time edit of the loaded state, made in place (the CUDA
graphs of the PGO solve and of the ICP verification keep their tensors'
addresses), outside the engine's no-synchronisation check. With a `mesh`
every rank of the group makes the same edit with no collective (load,
relocalize, append), so each rank's seeded state equals the single-device
continuation's bit for bit, and the pipeline returned is a mesh pipeline.
"""

from __future__ import annotations

import numpy as np
import torch

from xchu_slam_tpu_torch.models import device_pipeline as dp, odometry
from xchu_slam_tpu_torch.models.pipeline import subsample_cloud
from xchu_slam_tpu_torch.models.relocalize import SessionLocalizer
from xchu_slam_tpu_torch.ops import isc as isc_ops, scancontext as sc
from xchu_slam_tpu_torch.ops.filter import filter_scan
from xchu_slam_tpu_torch.types import Cloud, make_cloud
from xchu_slam_tpu_torch.utils import se3


class ContinuationError(RuntimeError):
    """Raised when the first scan cannot be placed in the saved map."""


def continue_session(checkpoint_path: str, first_xyz, first_intensity=None,
                     stamp: float = 0.0, log_capacity: int = 8192,
                     device: torch.device | str | None = None,
                     mesh=None) -> dp.DeviceSlamPipeline:
    """Load a saved device-engine session on `device` (default "cuda", or
    the mesh's device) and return a `DeviceSlamPipeline` that continues it,
    over `mesh` (this rank's `parallel.distributed.Mesh`) where one is given.

    The returned pipeline has already consumed `first_xyz` (relocalized and
    stored as the first new keyframe); feed the next scans with
    `process_scan` / `process_chunk` as usual. Raises ContinuationError for
    a host-engine file, a store at capacity, or a first scan that is not
    placed (no retrieval hit, or the ICP verification failed)."""
    from xchu_slam_tpu_torch.utils.checkpoint import load_checkpoint

    # loaded single-device: the seed is the same collective-free edit on
    # every rank
    old = load_checkpoint(checkpoint_path,
                          device=mesh.device if device is None and mesh is not None else device)
    if getattr(old, "state", None) is None:
        raise ContinuationError(
            "continuation requires a device-engine checkpoint "
            "(run-sim --engine device --checkpoint-every ...)")
    cfg, state, dev = old.cfg, old.state, old.device
    K0 = state.db.count
    if K0 >= cfg.pgo.max_keyframes:
        raise ContinuationError("saved session already at keyframe capacity")

    cloud = first_xyz if isinstance(first_xyz, Cloud) else make_cloud(
        first_xyz, first_intensity, capacity=cfg.filter.max_raw_points, device=dev)

    # 1. relocalize the first scan against the saved map
    r = SessionLocalizer(state.db, cfg).localize(cloud)
    if not r.found:
        raise ContinuationError(
            f"relocalization failed (sc_dist={r.sc_dist:.3f}, "
            f"icp_fitness={r.icp_fitness:.3f}, converged={r.icp_converged})")
    reloc_pose = torch.from_numpy(r.pose).to(dev)

    # 2. the first new keyframe K0, tied to the saved graph; the store's rows
    # as `device_pipeline._add_keyframe_branch` writes them
    spec = dp.spec_from_config(cfg, kf_points=old.kf_points, log_capacity=log_capacity)
    filt = filter_scan(cloud, cfg.filter)
    cxyz, cmask, _ = subsample_cloud(filt.xyz, filt.mask, old.kf_points)
    db = state.db
    travel0 = torch.clamp(db.travel[K0 - 1], min=0.0)
    db.poses[K0].copy_(reloc_pose)
    db.opt_poses[K0].copy_(reloc_pose)
    db.stamps[K0].fill_(float(stamp))
    db.travel[K0].copy_(travel0)
    db.clouds[K0].copy_(cxyz)
    db.cloud_mask[K0].copy_(cmask)
    db.sc_db[K0].copy_(sc.make_descriptor(filt.xyz, filt.mask, spec.scspec))
    if spec.method == "isc":
        db.isc_db[K0].copy_(isc_ops.make_descriptor(filt.xyz, filt.intensity, filt.mask,
                                                    spec.iscspec))
    else:
        db.isc_db[K0].zero_()
    db = db._replace(count=K0 + 1)
    # between factor old tail → new head, both poses in the map frame
    # (optimized poses), where the relocalized pose lives
    graph = state.graph
    T_new = se3.pose_to_matrix(reloc_pose)
    graph.between_T[K0].copy_(torch.matmul(
        se3.inverse(se3.pose_to_matrix(db.opt_poses[K0 - 1])), T_new))
    graph.kf_mask[K0].fill_(True)
    # the loop factor carrying the relocalization's measurement: the new
    # keyframe in the matched keyframe's frame, the convention of the
    # in-session loops (`device_pipeline._verify_and_apply`)
    q = int(state.loop_count)
    if q < spec.gspec.max_loops:
        graph.loop_i[q].fill_(r.kf_idx)
        graph.loop_j[q].fill_(K0)
        graph.loop_T[q].copy_(torch.matmul(
            se3.inverse(se3.pose_to_matrix(db.opt_poses[r.kf_idx])), T_new))
        graph.loop_info[q].copy_(1.0 / torch.clamp(
            torch.full((), r.icp_fitness, dtype=torch.float32, device=dev), min=1e-2))
        graph.loop_mask[q].fill_(True)
        q += 1

    # 3. the continued engine's state: fresh odometry at the relocalized
    # pose, a fresh log ring with its row 0, the counters carried over
    def full(value, dtype=torch.float32):
        return torch.full((), value, dtype=dtype, device=dev)

    log = torch.zeros((spec.log_capacity, dp.LOG_COLS), device=dev)
    log[0, :6] = reloc_pose
    log[0, 6:11] = torch.tensor([0.0, 0.0, 1.0, 1.0, float(stamp)], device=dev)
    log[0, 11:] = torch.tensor(dp._DIAG_RESET, device=dev)
    new_state = dp.DevState(
        odom=odometry.init_state(spec.ospec, reloc_pose, filt.xyz, filt.mask),
        db=db, graph=graph,
        kf_accum=full(0.0), travel=travel0.clone(), last_kf_odom=reloc_pose.clone(),
        loop_count=full(q, torch.int64), scan_count=full(1, torch.int64),
        kf_count=full(K0 + 1, torch.int64), imu_vel=torch.zeros(3, device=dev),
        last_stamp=full(float(stamp)), log=log,
        diag=dp._diag_reset().to(dev))
    pipe = dp.DeviceSlamPipeline(cfg, kf_points=old.kf_points, log_capacity=log_capacity,
                                 device=dev, mesh=mesh)
    pipe.restore(new_state, 1)
    pipe.continuation = {"matched_kf": int(r.kf_idx),
                         "reloc_pose": np.asarray(r.pose),
                         "sc_dist": float(r.sc_dist),
                         "icp_fitness": float(r.icp_fitness),
                         "old_keyframes": K0}
    return pipe
