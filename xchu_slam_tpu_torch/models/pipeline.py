"""Full SLAM pipeline: filter → odometry → keyframes → loop closure → PGO
(port of the synchronous host engine `xchu_slam_tpu.models.pipeline`).

Per scan: filter and NDT odometry on the device; a keyframe every
`keyframe_gap` metres of odometric travel; every `detect_period`-th
keyframe a loop query over the whole database (Scan Context, Intensity Scan
Context or a radius search), ICP verification of the candidate against a
±`submap_half_width` keyframe submap at the optimized poses, and a
pose-graph solve per accepted loop. Between solves, new keyframes chain onto
the last optimized pose.

Ported: the host engine with loop methods "sc", "isc", "radius" and
"none"; the IMU / wheel-odometry NDT guess (`odom.use_imu`,
`odom.use_odom`; integrated on the host, see ops/imu.py); GPS altitude
factors (`pgo.use_gps`); `assemble_map`; device-staged `Cloud` input
(io/prefetch.DeviceScanPrefetcher); and `defer_sync`, a one-scan
pipelining: scan k is enqueued with the step form that decides its map
updates on the card and reads nothing back (`odometry.step(...,
on_device=True)`), its pose and diagnostics are copied to the host right
behind it, and only then are scan k - 1's results (waiting for scan k - 1's
copy alone) read and consumed, so the host never waits on the scan it just
enqueued. With IMU or wheel windows the pending scan is consumed before
the guess, which integrates from the last consumed pose. The
results are those of the synchronous mode, one call later; `finalize`
consumes the last. `filter.detect_ground` fits the ground plane of every
filtered scan (ops/ground.py, on the scan's device, nothing read back): the
scan's result carries it as `"ground"`. `loop.async_detect` runs detection
and verification on a worker thread (models/async_worker.py, its own CUDA
stream on the card) that reads the published snapshot of the database; the
loops it verifies are applied at the next scan boundary. The keyframe
database and the factor graph are preallocated at full capacity and updated
in place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from xchu_slam_tpu_torch.config import SlamConfig
from xchu_slam_tpu_torch.models import odometry, pose_graph as pg
# VerifiedLoop lives with the worker; it is imported here under its old name
from xchu_slam_tpu_torch.models.async_worker import AsyncLoopWorker, VerifiedLoop
from xchu_slam_tpu_torch.ops import (ground as ground_ops, icp, imu as imu_ops,
                                     isc as isc_ops, scancontext as sc)
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
    isc_db: torch.Tensor      # [K,Ri,Si] (filled only with loop.method="isc")
    count: int                # live keyframes


def empty_db(cfg: SlamConfig, kf_points: int, device="cpu") -> KfDb:
    K = cfg.pgo.max_keyframes

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return KfDb(poses=z(K, 6), opt_poses=z(K, 6), stamps=z(K), travel=z(K),
                clouds=z(K, kf_points, 3),
                cloud_mask=z(K, kf_points, dtype=torch.bool),
                sc_db=z(K, cfg.sc.num_ring, cfg.sc.num_sector),
                isc_db=z(K, cfg.isc.num_ring, cfg.isc.num_sector), count=0)


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
                  sc_desc, isc_desc, opt_pose6, k: torch.Tensor | None = None) -> KfDb:
    """Write keyframe `db.count` in place; returns the db with count + 1.
    `isc_desc=None` leaves the row's ISC image at its zeros. With `k` (a
    one-element int64 tensor on the store's device, the row `db.count`
    holds) the row is written by `index_copy_` with no host index, as a
    CUDA graph replays it; `stamp` and `travel` are then 0-d tensors."""
    if k is not None:
        rows = [(db.poses, pose6), (db.opt_poses, opt_pose6), (db.stamps, stamp),
                (db.travel, travel), (db.clouds, cloud_xyz), (db.cloud_mask, cloud_mask),
                (db.sc_db, sc_desc)]
        if isc_desc is not None:
            rows.append((db.isc_db, isc_desc))
        for t, v in rows:
            t.index_copy_(0, k, v.reshape(1, *t.shape[1:]).to(t.dtype))
        return db._replace(count=db.count + 1)
    k = db.count
    db.poses[k] = pose6
    db.opt_poses[k] = opt_pose6
    db.stamps[k].fill_(stamp)
    db.travel[k].fill_(travel)
    db.clouds[k] = cloud_xyz
    db.cloud_mask[k] = cloud_mask
    db.sc_db[k] = sc_desc
    if isc_desc is not None:
        db.isc_db[k] = isc_desc
    return db._replace(count=k + 1)


def build_submap(db: KfDb, centre_idx: int, frame_idx: int, half_width: int,
                 out_n: int):
    """±half_width keyframe clouds at optimized poses, expressed in keyframe
    `frame_idx`'s frame, subsampled to `out_n` points. The indices are host
    ints or one-element integer tensors."""
    K = db.poses.shape[0]
    dev = db.poses.device
    ks = centre_idx + torch.arange(-half_width, half_width + 1, device=dev)
    ok = (ks >= 0) & (ks < db.count)
    ksc = torch.clamp(ks, 0, K - 1)
    T_w = se3.pose_to_matrix(db.opt_poses[ksc])             # [W,4,4]
    if isinstance(frame_idx, torch.Tensor):   # on the device: no readback
        frame = db.opt_poses.index_select(0, frame_idx.reshape(1).to(torch.int64))[0]
    else:
        frame = db.opt_poses[frame_idx]
    T_i_inv = se3.inverse(se3.pose_to_matrix(frame))
    T_rel = torch.einsum("ab,wbc->wac", T_i_inv, T_w)
    pts = se3.transform_points(T_rel, db.clouds[ksc])        # [W,P,3]
    mask = db.cloud_mask[ksc] & ok[:, None]
    return subsample_cloud(pts.reshape(-1, 3), mask.reshape(-1), out_n)


def _transform_all_clouds(poses6: torch.Tensor, clouds: torch.Tensor) -> torch.Tensor:
    """Batched keyframe-cloud → map-frame transform: poses6 [n,6], clouds
    [n,P,3] → [n,P,3]."""
    return se3.transform_points(se3.pose_to_matrix(poses6), clouds)


def radius_candidate_on_device(db: KfDb, cur_idx: int, cur_stamp: float, radius: float,
                               min_time: float):
    """Nearest keyframe (2-D, optimized poses) within `radius` that is at
    least `min_time` seconds older: (idx or -1, found) as 0-d tensors on
    the device."""
    K = db.poses.shape[0]
    pos = db.opt_poses[cur_idx, :2]
    d = torch.linalg.norm(db.opt_poses[:, :2] - pos[None], dim=-1)
    eligible = (torch.arange(K, device=d.device) < db.count) \
        & (db.stamps < cur_stamp - min_time)
    d = torch.where(eligible, d, torch.inf)
    best = torch.argmin(d).reshape(1)
    found = d.gather(0, best)[0] < radius
    return torch.where(found, best[0], -1), found


def _radius_candidate(db: KfDb, cur_idx: int, cur_stamp: float, radius: float,
                      min_time: float) -> int:
    """`radius_candidate_on_device` read back: the index, -1 if none."""
    return int(radius_candidate_on_device(db, cur_idx, cur_stamp, radius, min_time)[0])


class LoopRecord(NamedTuple):
    i: int
    j: int
    fitness: float
    method: str


class SlamPipeline:
    """End-to-end SLAM engine instance on one device. Feed scans; read
    trajectories."""

    def __init__(self, cfg: SlamConfig, kf_points: int = 4096,
                 device: torch.device | str = "cpu"):
        if cfg.loop.method not in ("sc", "isc", "radius", "none"):
            raise ValueError(f"unknown loop.method {cfg.loop.method!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.ospec = odometry.spec_from_config(cfg)
        self.scspec = sc.spec_from_config(cfg.sc)
        self.iscspec = isc_ops.spec_from_config(cfg.isc)
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
        self._last_stamp = None
        self._last_kf_odom = None
        self._dirty_graph = False
        # IMU guess state: the velocity estimate carried between scans
        self._imu_state = imu_ops.ImuState(velocity=torch.zeros(3))
        self.odom_log: list[dict] = []
        # one-scan pipelining (see the module docstring): the enqueued scan
        # whose results are consumed at the next call, and the two pinned
        # host slots its readback is copied into behind its step
        self.defer_sync = False
        self._pending = None
        self._slots = None
        self._slot = 0
        self._use_ext = {flag: torch.tensor(flag, device=self.device)
                         for flag in (False, True)}
        self.gnd_spec = ground_ops.spec_from_config(cfg.ground)
        # the database as the loop worker may read it, and the event after
        # the writes that made it (see `_publish`)
        self._snapshot = (self.db, None)
        self._worker = AsyncLoopWorker(self) if cfg.loop.async_detect else None

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

    def _ext_guess(self, imu, wheel):
        """Integrate the per-scan IMU / wheel windows into the delta of the
        NDT guess, per the configured mode, on the host from the host copy of
        the current pose. Returns (delta6 on the device | None, use)."""
        cfg = self.cfg.odom
        pose0 = self._last_odom_pose
        d_imu = d_wheel = None
        if cfg.use_imu and imu is not None:
            d_imu, self._imu_state = imu_ops.integrate_imu(imu, pose0, self._imu_state)
        if cfg.use_odom and wheel is not None:
            d_wheel = imu_ops.integrate_wheel_odom(wheel, pose0)
        if d_imu is not None and d_wheel is not None:
            delta = imu_ops.combine_imu_odom(d_imu, d_wheel)
        elif d_imu is not None:
            delta = d_imu
        elif d_wheel is not None:
            delta = d_wheel
        else:
            return None, False
        return delta.to(self.device), True

    # ------------------------------------------------------------------ #
    def process_scan(self, xyz: np.ndarray | Cloud, intensity: np.ndarray | None,
                     stamp: float, gps_alt: float | None = None,
                     imu: imu_ops.ImuWindow | None = None,
                     wheel: imu_ops.OdomWindow | None = None) -> dict | None:
        """Feed one scan: raw body-frame points [n,3], or a Cloud already
        staged on the device (io/prefetch.DeviceScanPrefetcher). `imu` /
        `wheel` carry the sensor samples since the previous scan; with
        `odom.use_imu` / `odom.use_odom` they replace the constant-velocity
        NDT guess. `gps_alt` is the altitude measured at this scan, if any;
        with `pgo.use_gps` it becomes a factor when the scan is a keyframe.
        Returns the scan's result; with `defer_sync`, the previous scan's
        (None when there is none)."""
        cfg = self.cfg
        if isinstance(xyz, Cloud):
            cloud = xyz
        else:
            cloud = make_cloud(xyz, intensity, capacity=cfg.filter.max_raw_points,
                               device=self.device)
        filt = filter_scan(cloud, cfg.filter)
        if self.odom_state is None:
            init = torch.zeros(6, dtype=torch.float32, device=self.device)
            self.odom_state = odometry.init_state(self.ospec, init, filt.xyz, filt.mask)
            pose = np.zeros(6, np.float32)
            self._last_odom_pose = pose
            self._last_stamp = float(stamp)
            self._add_kf(pose, stamp, filt, opt_pose=pose, gps_alt=gps_alt)
            self.scan_count += 1
            return {"pose": pose, "keyframe": True, "loop": None,
                    "ground": self._maybe_ground(filt)}
        result = None
        if self.defer_sync and self._pending is not None and \
                (cfg.odom.use_imu or cfg.odom.use_odom):
            # the guess integrates from the host copy of the last pose, and
            # the IMU's from the velocity that consuming a scan resets: so
            # the pending scan is consumed before the guess
            result = self._consume(*self._pending)
            self._pending = None
        ext_delta, use_ext = self._ext_guess(imu, wheel)
        if not self.defer_sync:
            self.odom_state, out = odometry.step(self.odom_state, filt.xyz, filt.mask,
                                                 self.ospec, ext_delta, use_ext)
            return self._consume(out, filt, stamp, gps_alt)
        self.odom_state, out = odometry.step(self.odom_state, filt.xyz, filt.mask,
                                             self.ospec, ext_delta, self._use_ext[use_ext],
                                             on_device=True)
        staged = self._stage_readback(out)
        if self._pending is not None:
            result = self._consume(*self._pending)
        self._pending = (out, filt, stamp, gps_alt, staged)
        return result

    def _stage_readback(self, out: odometry.OdomOutput):
        """Enqueue the copy of the step's pose and diagnostics to the host
        right behind the step: (host tensor [9], event that marks the copy
        done, None on the CPU). Waiting on the event later waits for this
        scan only, not for the scans enqueued after it."""
        vals = torch.cat([out.pose, out.matched_frac.reshape(1).float(),
                          out.fitness.reshape(1), out.iterations.reshape(1).float()])
        if vals.device.type != "cuda":
            return vals, None
        if self._slots is None:
            self._slots = [torch.empty(9, pin_memory=True) for _ in range(2)]
        host = self._slots[self._slot]
        self._slot ^= 1
        host.copy_(vals, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _consume(self, out: odometry.OdomOutput, filt: Cloud, stamp: float,
                 gps_alt: float | None, staged=None) -> dict:
        cfg = self.cfg
        ground_res = self._maybe_ground(filt)
        if staged is not None:
            # defer_sync: the copy enqueued behind the step (`_stage_readback`)
            host, done = staged
            if done is not None:
                done.synchronize()
            host = host.numpy()
            iters = int(host[8])
        else:
            # the engine's readback of the pose and the diagnostics; the step
            # made its own, for its branches, right after the align
            host = torch.cat([out.pose, out.matched_frac.reshape(1).float(),
                              out.fitness.reshape(1)]).cpu().numpy()
            iters = out.iterations
        pose, mfrac, fit = host[:6].copy(), host[6], host[7]
        prev_pose = self._last_odom_pose
        step_d = float(np.linalg.norm(pose[:2] - prev_pose[:2]))
        self.travel += step_d
        self.kf_gate_accum += step_d
        self._last_odom_pose = pose
        self.scan_count += 1
        if cfg.odom.use_imu and self._last_stamp is not None:
            # reset the IMU velocity from the SLAM result every scan: pure
            # double integration is a velocity random walk that degrades
            # below constant-velocity
            dt = float(stamp) - self._last_stamp
            if dt > 1e-6:
                self._imu_state = imu_ops.ImuState(velocity=torch.from_numpy(
                    ((pose[:3] - prev_pose[:3]) / dt).astype(np.float32)))
        self._last_stamp = float(stamp)
        self.odom_log.append({"stamp": stamp, "pose": pose,
                              "iterations": int(iters),
                              "matched_frac": float(mfrac),
                              "fitness": float(fit)})

        is_kf = (self.kf_gate_accum >= cfg.pgo.keyframe_gap
                 and self.kf_count < cfg.pgo.max_keyframes)
        loop_rec = None
        if is_kf:
            self.kf_gate_accum = 0.0
            opt_pose = self._chain_opt_pose(pose)
            self._add_kf(pose, stamp, filt, opt_pose=opt_pose, gps_alt=gps_alt)
            k = self.kf_count - 1
            if k >= 1 and k % cfg.loop.detect_period == 0:
                if self._worker is not None:
                    self._worker.submit(k, stamp)
                else:
                    loop_rec = self._detect_and_verify(k, stamp)
        # loops the worker verified are applied at scan boundaries
        if self._worker is not None:
            for v in self._worker.drain():
                if self._apply_loop(v) is not None:
                    loop_rec = self.loops[-1]
        return {"pose": pose, "keyframe": is_kf, "loop": loop_rec, "ground": ground_res}

    def _maybe_ground(self, filt: Cloud) -> ground_ops.GroundResult | None:
        if not self.cfg.filter.detect_ground:
            return None
        return ground_ops.detect_plane(filt.xyz, filt.mask, self.gnd_spec)

    def _publish(self) -> None:
        """Publish the database for the loop worker, with an event on this
        thread's stream after the writes that made it (none on the CPU)."""
        if self._worker is None:
            return
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        self._snapshot = (self.db, ready)

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

    def _add_kf(self, pose, stamp, filt: Cloud, opt_pose, gps_alt=None):
        cxyz, cmask, _ = subsample_cloud(filt.xyz, filt.mask, self.kf_points)
        # descriptors come from the full filtered cloud; the kf_points
        # subsample only bounds the stored submap clouds
        sc_desc = sc.make_descriptor(filt.xyz, filt.mask, self.scspec)
        isc_desc = None
        if self.cfg.loop.method == "isc":
            isc_desc = isc_ops.make_descriptor(filt.xyz, filt.intensity,
                                               filt.mask, self.iscspec)
        self.db = _add_keyframe(self.db, self._tensor(pose), float(stamp),
                                self.travel, cxyz, cmask, sc_desc, isc_desc,
                                self._tensor(opt_pose))
        self.kf_count += 1
        k = self.kf_count - 1
        if k >= 1:
            self.graph.between_T[k] = self._relative(self._last_kf_odom, pose)
        self.graph.kf_mask[k] = True
        if gps_alt is not None and self.cfg.pgo.use_gps:
            self.graph.gps_alt[k] = gps_alt
            self.graph.gps_mask[k] = True
        self._last_kf_odom = np.asarray(pose, np.float32)
        self._publish()

    # ------------------------------------------------------------------ #
    def detect_and_verify_snapshot(self, k: int, stamp: float,
                                   db: KfDb | None = None) -> VerifiedLoop | None:
        """Detection + ICP verification of keyframe k against `db` (by
        default the current database; the loop worker passes the published
        snapshot). Mutates nothing but the verification counter. Two
        readbacks: the candidate with its 2-D gate distance, then the ICP
        result (the ICP loop reads nothing back on the card)."""
        cfg = self.cfg
        db = self.db if db is None else db
        method = cfg.loop.method
        if method == "sc":
            c = sc.detect_loop_on_device(db.sc_db[k], db.sc_db, db.count, self.scspec, cur=k)
            cand, found, yaw = c.idx, c.found, c.yaw
        elif method == "isc":
            c = isc_ops.detect_loop_on_device(db.isc_db[k], db.isc_db, db.count,
                                              db.poses[:, :3], db.travel, self.iscspec, cur=k)
            cand, found, yaw = c.idx, c.found, c.yaw
        elif method == "radius":
            cand, found = radius_candidate_on_device(db, k, stamp, cfg.loop.radius_search,
                                                     cfg.loop.min_time_diff)
            yaw = torch.zeros((), device=cand.device)
        else:
            return None
        # 2-D sanity gate, read back with the candidate
        other = db.opt_poses.index_select(0, torch.clamp(cand, min=0).reshape(1))[0]
        d2 = torch.linalg.norm(db.opt_poses[k, :2] - other[:2])
        cand, found, yaw, d2 = torch.stack([cand.to(torch.float32), found.to(torch.float32),
                                            yaw, d2]).cpu().tolist()
        cand = int(cand)
        if cand < 0 or d2 > cfg.loop.max_loop_dist:
            return None

        # ICP verification: current kf cloud vs submap around candidate
        tgt_xyz, tgt_mask, _ = build_submap(db, cand, cand, cfg.loop.submap_half_width,
                                            cfg.loop.submap_points)
        T_init = torch.matmul(se3.inverse(se3.pose_to_matrix(db.opt_poses[cand])),
                              se3.pose_to_matrix(db.opt_poses[k]))
        if cfg.loop.use_sc_yaw and method in ("sc", "isc") and found > 0.5:
            # the true relative heading (query in cand's frame) is −yaw
            p_init = se3.matrix_to_pose(T_init)
            p_init[5] = -yaw
            T_init = se3.pose_to_matrix(p_init)
        res = icp.align(db.clouds[k], db.cloud_mask[k], tgt_xyz, tgt_mask,
                        T_init, self.icpspec)
        self.icp_verifications += 1
        # divergence guard: the odometric guess bounds a genuine correction
        corr = torch.linalg.norm(res.T[:3, 3] - T_init[:3, 3])
        conv, fitness, corr = torch.stack([res.converged.to(torch.float32), res.fitness,
                                           corr]).cpu().tolist()
        if not (conv > 0.5 and fitness <= cfg.loop.icp_fitness_thresh):
            return None
        if corr > cfg.loop.max_correction:
            return None
        return VerifiedLoop(i=cand, j=k, T=res.T, fitness=fitness, method=method)

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
        # a fresh tensor on either route (never the CUDA graph's buffer), so
        # a snapshot the worker holds keeps its poses
        opt = pg.solve(self.db.opt_poses, self.graph, spec)
        self.db = self.db._replace(opt_poses=opt)
        self._dirty_graph = False
        self._publish()

    # ------------------------------------------------------------------ #
    def finalize(self):
        """Consume the pending scan (`defer_sync`); stop the loop worker
        first, then apply what it verified (the other order loses the last
        loop); then the final full-strength PGO solve."""
        if self._pending is not None:
            self._consume(*self._pending)
            self._pending = None
        if self._worker is not None:
            worker, self._worker = self._worker, None
            worker.stop()
            for v in worker.drain():
                self._apply_loop(v)
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

    def assemble_map(self, voxel: float = 0.5, max_points: int = 1 << 20) -> np.ndarray:
        """Aggregate keyframe clouds at optimized poses into one map cloud
        [n,3]: one batched transform on the device over the live keyframes,
        one readback of their valid points, then an exact voxel dedup on the
        host (the first point of each `voxel`-sized cell is kept)."""
        n = self.kf_count
        if n == 0:
            return np.zeros((0, 3), np.float32)
        pts = _transform_all_clouds(self.db.opt_poses[:n], self.db.clouds[:n])
        allp = pts[self.db.cloud_mask[:n]].cpu().numpy()
        if voxel > 0 and len(allp):
            # packed int64 key: 21 bits per axis, ±1e6 voxels
            keys = np.floor(allp / voxel).astype(np.int64) + (1 << 20)
            flat = keys[:, 0] | (keys[:, 1] << 21) | (keys[:, 2] << 42)
            _, idx = np.unique(flat, return_index=True)
            allp = allp[idx]
        return allp[:max_points]
