"""Full SLAM pipeline: filter → odometry → keyframes → loop closure → PGO
(port of the synchronous host engine `xchu_slam_tpu.models.pipeline`).

Per scan: filter and NDT odometry on the device; a keyframe every
`keyframe_gap` metres of odometric travel; every `detect_period`-th
keyframe a Scan Context query over the whole database, ICP verification of
the candidate against a ±`submap_half_width` keyframe submap at the
optimized poses, and a pose-graph solve per accepted loop. Between solves,
new keyframes chain onto the last optimized pose.

Ported: synchronous mode, loop methods "sc" and "radius", no IMU / wheel /
GPS / ground branches. The keyframe database and the factor graph are
preallocated at full capacity and updated in place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from xchu_slam_tpu_torch.config import SlamConfig
from xchu_slam_tpu_torch.models import odometry, pose_graph as pg
from xchu_slam_tpu_torch.ops import icp, scancontext as sc
from xchu_slam_tpu_torch.ops.filter import filter_scan
from xchu_slam_tpu_torch.types import Cloud, make_cloud
from xchu_slam_tpu_torch.utils import se3


class KfDb(NamedTuple):
    """Fixed-capacity keyframe database."""

    poses: torch.Tensor       # [K,6] odometry poses
    opt_poses: torch.Tensor   # [K,6] optimized poses (rewritten on PGO solve)
    stamps: torch.Tensor      # [K]
    travel: torch.Tensor      # [K] cumulative odometric travel
    clouds: torch.Tensor      # [K,P,3] body-frame keyframe clouds
    cloud_mask: torch.Tensor  # [K,P]
    sc_db: torch.Tensor       # [K,R,S]
    count: int                # live keyframes


def empty_db(cfg: SlamConfig, kf_points: int, device="cpu") -> KfDb:
    K = cfg.pgo.max_keyframes

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return KfDb(poses=z(K, 6), opt_poses=z(K, 6), stamps=z(K), travel=z(K),
                clouds=z(K, kf_points, 3),
                cloud_mask=z(K, kf_points, dtype=torch.bool),
                sc_db=z(K, cfg.sc.num_ring, cfg.sc.num_sector), count=0)


def subsample_cloud(xyz: torch.Tensor, mask: torch.Tensor, n_out: int):
    """Spatially unbiased fixed-size subsample: compact valid points then
    take an even stride. Returns (xyz [n_out,3], mask [n_out],
    src_idx [n_out])."""
    N = xyz.shape[0]
    dev = xyz.device
    pos = torch.cumsum(mask.long(), 0) - 1
    dest = torch.where(mask, pos, N)
    xyz_c = torch.zeros((N + 1, 3), dtype=xyz.dtype, device=dev)
    src_c = torch.zeros((N + 1,), dtype=torch.int64, device=dev)
    xyz_c[dest] = xyz            # slot N is the dropped slot
    src_c[dest] = torch.arange(N, device=dev)
    n_valid = mask.sum()
    ar = torch.arange(n_out, device=dev)
    idx = torch.clamp((ar * torch.clamp(n_valid, min=1)) // n_out, 0, N - 1)
    take = ar < torch.clamp(n_valid, max=n_out)
    return torch.where(take[:, None], xyz_c[idx], 0.0), take, src_c[idx]


def _add_keyframe(db: KfDb, pose6, stamp, travel, cloud_xyz, cloud_mask,
                  sc_desc, opt_pose6) -> KfDb:
    """Write keyframe `db.count` in place; returns the db with count + 1."""
    k = db.count
    db.poses[k] = pose6
    db.opt_poses[k] = opt_pose6
    db.stamps[k] = stamp
    db.travel[k] = travel
    db.clouds[k] = cloud_xyz
    db.cloud_mask[k] = cloud_mask
    db.sc_db[k] = sc_desc
    return db._replace(count=k + 1)


def build_submap(db: KfDb, centre_idx: int, frame_idx: int, half_width: int,
                 out_n: int):
    """±half_width keyframe clouds at optimized poses, expressed in keyframe
    `frame_idx`'s frame, subsampled to `out_n` points."""
    K = db.poses.shape[0]
    dev = db.poses.device
    ks = centre_idx + torch.arange(-half_width, half_width + 1, device=dev)
    ok = (ks >= 0) & (ks < db.count)
    ksc = torch.clamp(ks, 0, K - 1)
    T_w = se3.pose_to_matrix(db.opt_poses[ksc])             # [W,4,4]
    T_i_inv = se3.inverse(se3.pose_to_matrix(db.opt_poses[frame_idx]))
    T_rel = torch.einsum("ab,wbc->wac", T_i_inv, T_w)
    pts = se3.transform_points(T_rel, db.clouds[ksc])        # [W,P,3]
    mask = db.cloud_mask[ksc] & ok[:, None]
    return subsample_cloud(pts.reshape(-1, 3), mask.reshape(-1), out_n)


def _radius_candidate(db: KfDb, cur_idx: int, cur_stamp: float, radius: float,
                      min_time: float) -> int:
    """Nearest keyframe (2-D, optimized poses) within `radius` that is at
    least `min_time` seconds older; -1 if none."""
    K = db.poses.shape[0]
    pos = db.opt_poses[cur_idx, :2]
    d = torch.linalg.norm(db.opt_poses[:, :2] - pos[None], dim=-1)
    eligible = (torch.arange(K, device=d.device) < db.count) \
        & (db.stamps < cur_stamp - min_time)
    d = torch.where(eligible, d, torch.inf)
    best = torch.argmin(d)
    dist, best = torch.stack([d[best], best.to(torch.float32)]).cpu()
    return int(best) if float(dist) < radius else -1


class LoopRecord(NamedTuple):
    i: int
    j: int
    fitness: float
    method: str


class VerifiedLoop(NamedTuple):
    i: int
    j: int
    T: torch.Tensor   # [4,4] pose of keyframe j in keyframe i's frame
    fitness: float
    method: str


class SlamPipeline:
    """End-to-end SLAM engine instance on one device. Feed scans; read
    trajectories."""

    def __init__(self, cfg: SlamConfig, kf_points: int = 4096,
                 device: torch.device | str = "cpu"):
        loop = cfg.loop
        if loop.method not in ("sc", "radius") or loop.async_detect \
                or cfg.odom.use_imu or cfg.odom.use_odom or cfg.pgo.use_gps \
                or cfg.filter.detect_ground:
            raise ValueError("only the synchronous sc/radius engine without "
                             "IMU, wheel, GPS or ground branches is ported")
        self.cfg = cfg
        self.device = torch.device(device)
        self.ospec = odometry.spec_from_config(cfg)
        self.scspec = sc.spec_from_config(cfg.sc)
        self.icpspec = icp.spec_from_config(cfg.loop)
        self.gspec = pg.spec_from_config(cfg.pgo)
        self.kf_points = kf_points

        self.db = empty_db(cfg, kf_points, self.device)
        self.graph = pg.empty_graph(self.gspec, self.device)
        self.odom_state = None
        self.loop_count = 0
        self.loops: list[LoopRecord] = []
        self.scan_count = 0
        self.kf_count = 0
        self.kf_gate_accum = 0.0
        self.travel = 0.0
        self.icp_verifications = 0   # ICP verifications run (accepted or not)
        self._last_odom_pose = None
        self._last_kf_odom = None
        self._dirty_graph = False
        self.odom_log: list[dict] = []

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

    # ------------------------------------------------------------------ #
    def process_scan(self, xyz: np.ndarray, intensity: np.ndarray | None,
                     stamp: float) -> dict:
        """Feed one scan of raw body-frame points [n,3]."""
        cfg = self.cfg
        cloud = make_cloud(xyz, intensity, capacity=cfg.filter.max_raw_points,
                           device=self.device)
        filt = filter_scan(cloud, cfg.filter)
        if self.odom_state is None:
            init = torch.zeros(6, dtype=torch.float32, device=self.device)
            self.odom_state = odometry.init_state(self.ospec, init, filt.xyz, filt.mask)
            pose = np.zeros(6, np.float32)
            self._last_odom_pose = pose
            self._add_kf(pose, stamp, filt, opt_pose=pose)
            self.scan_count += 1
            return {"pose": pose, "keyframe": True, "loop": None}
        self.odom_state, out = odometry.step(self.odom_state, filt.xyz,
                                             filt.mask, self.ospec)
        return self._consume(out, filt, stamp)

    def _consume(self, out: odometry.OdomOutput, filt: Cloud, stamp: float) -> dict:
        cfg = self.cfg
        # one readback per scan
        host = torch.cat([out.pose, out.matched_frac.reshape(1).float(),
                          out.fitness.reshape(1)]).cpu().numpy()
        pose, mfrac, fit = host[:6].copy(), host[6], host[7]
        prev_pose = self._last_odom_pose
        step_d = float(np.linalg.norm(pose[:2] - prev_pose[:2]))
        self.travel += step_d
        self.kf_gate_accum += step_d
        self._last_odom_pose = pose
        self.scan_count += 1
        self.odom_log.append({"stamp": stamp, "pose": pose,
                              "iterations": int(out.iterations),
                              "matched_frac": float(mfrac),
                              "fitness": float(fit)})

        is_kf = (self.kf_gate_accum >= cfg.pgo.keyframe_gap
                 and self.kf_count < cfg.pgo.max_keyframes)
        loop_rec = None
        if is_kf:
            self.kf_gate_accum = 0.0
            opt_pose = self._chain_opt_pose(pose)
            self._add_kf(pose, stamp, filt, opt_pose=opt_pose)
            k = self.kf_count - 1
            if k >= 1 and k % cfg.loop.detect_period == 0:
                loop_rec = self._detect_and_verify(k, stamp)
        return {"pose": pose, "keyframe": is_kf, "loop": loop_rec}

    # ------------------------------------------------------------------ #
    def _relative(self, pose_a, pose_b) -> torch.Tensor:
        """T_a⁻¹ · T_b for host poses (on the device)."""
        return torch.matmul(se3.inverse(se3.pose_to_matrix(self._tensor(pose_a))),
                            se3.pose_to_matrix(self._tensor(pose_b)))

    def _chain_opt_pose(self, odom_pose: np.ndarray) -> np.ndarray:
        """New keyframe's optimized pose = previous optimized ∘ odometric
        delta (what iSAM2 yields for a chain extension)."""
        if self._last_kf_odom is None:
            return odom_pose
        T_prev_opt = se3.pose_to_matrix(self.db.opt_poses[self.kf_count - 1])
        Z = self._relative(self._last_kf_odom, odom_pose)
        return se3.matrix_to_pose(torch.matmul(T_prev_opt, Z)).cpu().numpy()

    def _add_kf(self, pose, stamp, filt: Cloud, opt_pose):
        cxyz, cmask, _ = subsample_cloud(filt.xyz, filt.mask, self.kf_points)
        # descriptors come from the full filtered cloud; the kf_points
        # subsample only bounds the stored submap clouds
        sc_desc = sc.make_descriptor(filt.xyz, filt.mask, self.scspec)
        self.db = _add_keyframe(self.db, self._tensor(pose), float(stamp),
                                self.travel, cxyz, cmask, sc_desc,
                                self._tensor(opt_pose))
        self.kf_count += 1
        k = self.kf_count - 1
        if k >= 1:
            self.graph.between_T[k] = self._relative(self._last_kf_odom, pose)
        self.graph.kf_mask[k] = True
        self._last_kf_odom = np.asarray(pose, np.float32)

    # ------------------------------------------------------------------ #
    def detect_and_verify_snapshot(self, k: int, stamp: float) -> VerifiedLoop | None:
        """Detection + ICP verification of keyframe k against the current
        database. Mutates nothing but the verification counter."""
        cfg = self.cfg
        db = self.db
        method = cfg.loop.method
        yaw = None  # descriptor-measured relative yaw (ψ_cand − ψ_query)
        if method == "sc":
            res = sc.detect_loop(db.sc_db[k], db.sc_db, db.count, self.scspec, cur=k)
            cand = res.idx
            if res.found:
                yaw = res.yaw
        else:
            cand = _radius_candidate(db, k, stamp, cfg.loop.radius_search,
                                     cfg.loop.min_time_diff)
        if cand < 0:
            return None

        # 2-D sanity gate
        d2 = float(torch.linalg.norm(db.opt_poses[k, :2] - db.opt_poses[cand, :2]))
        if d2 > cfg.loop.max_loop_dist:
            return None

        # ICP verification: current kf cloud vs submap around candidate
        tgt_xyz, tgt_mask, _ = build_submap(db, cand, cand, cfg.loop.submap_half_width,
                                            cfg.loop.submap_points)
        T_init = torch.matmul(se3.inverse(se3.pose_to_matrix(db.opt_poses[cand])),
                              se3.pose_to_matrix(db.opt_poses[k]))
        if cfg.loop.use_sc_yaw and yaw is not None:
            # the true relative heading (query in cand's frame) is −yaw
            p_init = se3.matrix_to_pose(T_init)
            p_init[5] = -yaw
            T_init = se3.pose_to_matrix(p_init)
        res = icp.align(db.clouds[k], db.cloud_mask[k], tgt_xyz, tgt_mask,
                        T_init, self.icpspec)
        self.icp_verifications += 1
        if not (res.converged and res.fitness <= cfg.loop.icp_fitness_thresh):
            return None
        # divergence guard: the odometric guess bounds a genuine correction
        corr = float(torch.linalg.norm(res.T[:3, 3] - T_init[:3, 3]))
        if corr > cfg.loop.max_correction:
            return None
        return VerifiedLoop(i=cand, j=k, T=res.T, fitness=res.fitness, method=method)

    def _apply_loop(self, v: VerifiedLoop) -> LoopRecord | None:
        """Add a verified loop factor and re-solve the graph."""
        if self.loop_count >= self.gspec.max_loops:
            return None
        q = self.loop_count
        g = self.graph
        g.loop_i[q] = v.i
        g.loop_j[q] = v.j
        g.loop_T[q] = v.T
        g.loop_info[q] = 1.0 / max(v.fitness, 1e-2)
        g.loop_mask[q] = True
        self.loop_count += 1
        rec = LoopRecord(i=v.i, j=v.j, fitness=v.fitness, method=v.method)
        self.loops.append(rec)
        self._dirty_graph = True
        self._solve_graph()
        return rec

    def _detect_and_verify(self, k: int, stamp: float):
        v = self.detect_and_verify_snapshot(k, stamp)
        return None if v is None else self._apply_loop(v)

    def _solve_graph(self, full: bool = False):
        """`full=False` (in-run, per accepted loop) uses the warm-started
        inloop spec and honours the solve_every cadence."""
        spec = self.gspec
        if not full:
            if spec.solve_every > 1 and self.loop_count % spec.solve_every:
                return
            spec = pg.inloop_spec(spec)
        opt = pg.solve(self.db.opt_poses, self.graph, spec)
        self.db = self.db._replace(opt_poses=opt)
        self._dirty_graph = False

    # ------------------------------------------------------------------ #
    def finalize(self):
        """Final full-strength PGO solve."""
        if self._dirty_graph or self.loop_count > 0:
            self._solve_graph(full=True)

    def keyframe_trajectory(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(stamps, odometry poses6, optimized poses6) for live keyframes."""
        n = self.kf_count
        return (self.db.stamps[:n].cpu().numpy(),
                self.db.poses[:n].cpu().numpy(),
                self.db.opt_poses[:n].cpu().numpy())

    def odometry_trajectory(self) -> np.ndarray:
        return np.array([r["pose"] for r in self.odom_log], np.float32)
