"""Multi-session place recognition / relocalization against a saved session
(port of `xchu_slam_tpu.models.relocalize`).

Load a previous session's keyframe database (utils/checkpoint.py serializes
it) and localize arbitrary new scans against that map:

    scan → filter → SC descriptor → whole-DB rotation-search retrieval
         (ops/scancontext.detect_loop_between_sessions, no recency exclusion)
         → ICP refinement against the ±W keyframe submap at the saved
           optimized poses (models/pipeline.build_submap)
         → metric pose in the saved session's map frame.

The retrieval and the refinement are the functions the in-session loop chain
runs (the ICP's nearest-neighbour search is the CUDA kernel on the card);
only the orchestration differs: a single query and no graph.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from xchu_slam_tpu_torch.config import SlamConfig
from xchu_slam_tpu_torch.models.pipeline import KfDb, build_submap, subsample_cloud
from xchu_slam_tpu_torch.ops import icp, scancontext as sc
from xchu_slam_tpu_torch.ops.filter import filter_scan
from xchu_slam_tpu_torch.types import Cloud, make_cloud
from xchu_slam_tpu_torch.utils import se3


class LocalizeResult(NamedTuple):
    found: bool            # retrieval hit AND ICP verification passed
    kf_idx: int            # matched keyframe in the saved session (-1 if none)
    pose: np.ndarray       # float32[6] query pose in the saved map frame
    sc_dist: float         # Scan Context distance of the match
    yaw: float             # descriptor-estimated relative yaw (rad)
    icp_fitness: float     # mean-sq NN distance after refinement
    icp_converged: bool


class SessionLocalizer:
    """Localize scans against a saved session's keyframe database.

    `db` is the saved KfDb (e.g. `load_checkpoint(path).db`), whose tensors
    decide the device; `cfg` supplies the filter / SC / ICP parameters: use
    the config the session was mapped with, so the descriptors bin
    identically."""

    def __init__(self, db: KfDb, cfg: SlamConfig):
        self.db = db
        self.cfg = cfg
        self.device = db.poses.device
        self.scspec = sc.spec_from_config(cfg.sc)
        self.icpspec = icp.spec_from_config(cfg.loop)

    def localize(self, xyz, intensity=None, max_points: int | None = None
                 ) -> LocalizeResult:
        """Place one scan (raw points [n,3] with their intensities, or a
        Cloud on the store's device) in the saved map."""
        cfg = self.cfg
        if isinstance(xyz, Cloud):
            cloud = xyz
        else:
            cloud = make_cloud(xyz, intensity, capacity=cfg.filter.max_raw_points,
                               device=self.device)
        filt = filter_scan(cloud, cfg.filter)
        desc = sc.make_descriptor(filt.xyz, filt.mask, self.scspec)
        cand = sc.detect_loop_between_sessions(
            desc, self.db.sc_db, self.db.count, self.scspec)
        if not cand.found:
            return LocalizeResult(False, -1, np.zeros(6, np.float32),
                                  cand.dist, cand.yaw, float("inf"), False)
        k, yaw = cand.idx, cand.yaw

        # metric refinement: query cloud (body frame) onto the ±W submap
        # expressed in the matched keyframe's frame; the initial guess is the
        # descriptor's rotation estimate (−yaw = query heading in the match's
        # frame, the convention of the in-session verifier)
        n_src = max_points or self.db.clouds.shape[1]
        src_xyz, src_mask, _ = subsample_cloud(filt.xyz, filt.mask, n_src)
        tgt_xyz, tgt_mask, _ = build_submap(
            self.db, k, k, cfg.loop.submap_half_width, cfg.loop.submap_points)
        T_init = se3.pose_to_matrix(torch.tensor(
            [0.0, 0.0, 0.0, 0.0, 0.0, -yaw], dtype=torch.float32, device=self.device))
        res = icp.align(src_xyz, src_mask, tgt_xyz, tgt_mask, T_init, self.icpspec)
        # query pose in the map frame: T_map(match) ∘ T_refined; one readback
        # with the ICP's result
        T_q = torch.matmul(se3.pose_to_matrix(self.db.opt_poses[k]), res.T)
        host = torch.cat([se3.matrix_to_pose(T_q), res.converged.to(torch.float32)[None],
                          res.fitness[None]]).cpu().numpy()
        pose, converged, fitness = host[:6].copy(), bool(host[6] > 0.5), float(host[7])
        ok = converged and fitness <= cfg.loop.icp_fitness_thresh
        return LocalizeResult(ok, k, pose, cand.dist, yaw, fitness, converged)


def localizer_from_checkpoint(path: str, device: torch.device | str = "cuda"
                              ) -> SessionLocalizer:
    """Build a SessionLocalizer on `device` from a saved checkpoint of
    either engine."""
    from xchu_slam_tpu_torch.utils.checkpoint import load_checkpoint

    pipe = load_checkpoint(path, device=device)
    db = pipe.state.db if getattr(pipe, "state", None) is not None else pipe.db
    return SessionLocalizer(db, pipe.cfg)
