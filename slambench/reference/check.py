"""How `correct` is decided: session 0 of the window, its outputs judged
against the plain reference.

The odometry chain is chaotic at the last bit (an unaligned chain drifts
0.6-1.0 m over 1,824 scans), so the reference cannot run its own chain and
compare poses. It follows the program's own state step by step instead, as
the repository's parity tests do, working out again from the generator's
scans everything the program derived from them:

- the completeness of the log (`scans_missing`) and the keyframe gate
  recomputed from the logged poses (`gate_mismatch`, decisions within
  rounding of the threshold left out);
- Part A at aligns drawn from the seed: the voxel map rebuilt from the
  reference's own filter of the scans the map held, at the logged poses
  (inserts, swaps and recentring replayed from the poses), the scan's own
  filter, the guess from the two logged poses before it (the constant
  velocity, or with IMU or wheel windows fed the reference's integration of
  the scan's windows, `imu.py`), the reference's Newton align; against the
  logged pose and iteration count (`ndt_pose_gap_m`, `ndt_rot_gap_rad`,
  `ndt_iter_mismatch`);
- the filter's kept points: the program's stored keyframe clouds against the
  reference's filter of the same scans (`kf_cloud_outlier_pct`);
- with GPS altitudes fed, the fix each keyframe stored against the feed's
  at its scan (`gps_mismatch`);
- Part B over every keyframe in order: the optimized poses chained from the
  logged odometric poses, the reference's retrieval at every detection, Scan
  Context or ISC (`isc.py`) as the configuration runs (`sc_mismatch`), and
  its 2-D gate (`verify_mismatch`), the reference's ICP at verifications
  drawn from the seed (`icp_fitness_gap`, `icp_T_gap_m`, `accept_mismatch`),
  the in-loop solve after every loop the program accepted, with the
  program's loop factors (the state it followed) and the feed's altitude
  factors, then the full solve (`pgo_gap_m`);
- the end result: the program's optimized keyframes against the generator's
  ground truth (`ate_m`), read and reported but compared in no cell: the
  TF32 control reads the same as sound runs.

With `mode="control"` the same steps also run in TF32 (`lowp.py`) and the
TF32 outputs are judged in the program's place: the control's readings.
Everything runs after the window, in float32 with TF32 off (the solve in
float64), on the run's device.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from slambench.reference import filt, geom, imu, isc, loop, lowp, ndt, pgo, se3, voxel

ALIGN_SAMPLES = 12
CATCH_UP_GN = 4          # Gauss-Newton steps that bring the replayed graph up to date
KF_SAMPLES = 8
VERIFY_SAMPLES = 12
ROUNDING = 1e-4          # a decision this close to its threshold is rounding's to make
MATCH_M = 1e-3           # a stored point this close to a reference point is the same point
AMBIGUOUS_SPAN = 12      # scans after an ambiguous map decision left out of the sample
SC_ROUNDING = 1e-4       # Scan Context distances this close are rounding's to order
GATE_ROUNDING_M = 0.05   # the replayed poses' distance to the 2-D gate that they may disagree by
ICP_ROUNDING = 1e-3      # an ICP fitness this close to its threshold


def plan(cell, seed: int, kf_count: int) -> dict:
    """The keyframes whose stored clouds are compared, drawn from the seed
    (copied off the card with the window closed)."""
    rng = np.random.default_rng([7, seed])
    pool = np.arange(1, kf_count)
    kfs = rng.choice(pool, size=min(KF_SAMPLES, len(pool)), replace=False) if len(pool) else []
    return {"keyframes": sorted(int(k) for k in kfs)}


def gt_map_frame(lap_poses: np.ndarray, lap_index: np.ndarray) -> np.ndarray:
    """Ground truth [n,4,4] of a session's scans relative to its first scan
    (the program's map frame)."""
    T = geom.pose_to_matrix_np(lap_poses[lap_index].astype(np.float64))
    return np.einsum("ab,nbc->nac", np.linalg.inv(T[0]), T)


def aligned_ate(est_xyz: np.ndarray, gt_xyz: np.ndarray) -> float:
    """RMSE of the positions after the best rigid alignment (Umeyama, no
    scale), as evo's `-a`."""
    mu_e, mu_g = est_xyz.mean(0), gt_xyz.mean(0)
    E, G = est_xyz - mu_e, gt_xyz - mu_g
    U, _s, Vt = np.linalg.svd(G.T @ E)
    S = np.eye(3)
    S[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ S @ Vt
    d = E @ R.T - G
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def _wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def _worst(so_far: float, gap: float) -> float:
    """The larger gap; a gap that is not a finite number is the worst."""
    return max(so_far, gap) if np.isfinite(gap) else float("inf")


class Scans:
    """The session's raw scans and the reference's filter of each, cached
    by scan index, on `device`."""

    def __init__(self, scans, prog: dict, device, lowp_on: bool):
        self.scans, self.prog, self.device, self.lowp = scans, prog, device, lowp_on
        self.cache = {}

    def filtered(self, i: int) -> filt.Cloud:
        if i not in self.cache:
            xyz, inten = self.scans[i]
            c = filt.make_cloud(xyz, inten, self.prog["filter.max_raw_points"], self.device)
            with lowp.tf32(self.lowp):
                self.cache[i] = filt.filter_scan(c, self.prog)
        return self.cache[i]


# ------------------------------------------------------------------ Part A --
def map_history(rows: np.ndarray, prog: dict):
    """The odometry's map bookkeeping replayed from the logged poses in
    float32, as the port's step decides it: for every scan the op list of
    grid A as the align of that scan saw it (("insert", j) and
    ("recentre", i)) with the origin the list began at, and the scans left
    out because a decision there lay within rounding of its threshold."""
    gx, gy, res = prog["ndt.grid_x"], prog["ndt.grid_y"], prog["ndt.resolution"]
    if prog["ndt.ls_mode"] != "backtrack" or prog["ndt.regather_dist"] != 0.0:
        raise ValueError("the reference replays the backtracking align at regather_dist 0")
    half = np.float32(min(gx, gy) * res / 2.0)
    margin = half - np.float32(prog["ndt.recentre_margin"])
    f32 = np.float32
    poses = rows[:, :6].astype(np.float32)
    added = poses[0].copy()
    travel = f32(0.0)
    origin = _centered_origin(poses[0, :3], prog)
    ops_a, ops_b = [("insert", 0)], [("insert", 0)]
    start_a = start_b = origin           # the origin at each list's start
    seen, ambiguous = {}, set()
    for i in range(1, len(rows)):
        seen[i] = (list(ops_a), start_a)
        p = poses[i]
        d = p[:2] - added[:2]
        shift = np.sqrt(f32(d[0] * d[0] + d[1] * d[1]))
        amb = abs(float(shift) - prog["odom.min_add_scan_shift"]) < ROUNDING
        if shift >= f32(prog["odom.min_add_scan_shift"]):
            ops_a.append(("insert", i))
            ops_b.append(("insert", i))
            travel = f32(travel + shift)
            added = p.copy()
        amb |= abs(float(travel) - prog["odom.max_localmap_size"]) < ROUNDING
        if travel >= f32(prog["odom.max_localmap_size"]):
            ops_a, start_a = ops_b, start_b
            ops_b, start_b = [], origin
            travel = f32(0.0)
        off = max(abs(p[0] - (origin[0] + f32(gx * res / 2.0))),
                  abs(p[1] - (origin[1] + f32(gy * res / 2.0))))
        amb |= abs(float(off) - float(margin)) < ROUNDING
        if off > margin:
            origin = _centered_origin(p[:3], prog)
            ops_a = ops_a + [("recentre", i)]
            ops_b = ops_b + [("recentre", i)]
        if amb:
            ambiguous.update(range(i + 1, i + 1 + AMBIGUOUS_SPAN))
    return seen, ambiguous


def _centered_origin(c: np.ndarray, prog: dict) -> np.ndarray:
    res = np.float32(prog["ndt.resolution"])
    half = np.array([prog["ndt.grid_x"] // 2, prog["ndt.grid_y"] // 2,
                     prog["ndt.grid_z"] // 2], np.float32) * res
    return (np.floor((c.astype(np.float32) - half) / res) * res).astype(np.float32)


def build_map(ops, start, rows, scans: Scans, gspec, device) -> voxel.VoxelGrid:
    """Grid A replayed from its op list, from the origin it began at: each
    insert of a scan's filtered points at its logged pose, each recentre on
    a logged pose."""
    grid = voxel.make_grid(gspec, torch.as_tensor(start, device=device))
    with lowp.tf32(scans.lowp):
        for kind, j in ops:
            pose = torch.as_tensor(rows[j, :6].astype(np.float32), device=device)
            if kind == "insert":
                c = scans.filtered(j)
                grid = voxel.insert_points(grid, se3.rotate_translate(pose, c.xyz), c.mask, gspec)
            else:
                grid = voxel.recentre(grid, pose[:3], gspec)
        return grid._replace(fin=voxel.finalize_stats(grid.stats, gspec))


def guess(rows: np.ndarray, k: int, device, feeds=None) -> torch.Tensor:
    """The guess of scan k from the logged poses of scans k−1 and k−2 (roll
    and pitch held, yaw wrapped): the constant-velocity delta, or, where
    `feeds` holds IMU or wheel windows, the external delta over scan k's
    windows wherever each window in use holds a sample."""
    p1 = torch.as_tensor(rows[k - 1, :6].astype(np.float32), device=device)
    if k >= 2:
        p2 = torch.as_tensor(rows[k - 2, :6].astype(np.float32), device=device)
        d = p1 - p2
        d = torch.cat([d[:3], se3.wrap_angle(d[3:])])
    else:
        d = torch.zeros_like(p1)
    if feeds is not None and (feeds.imu is not None or feeds.wheel is not None):
        vel = (imu.imu_velocity(rows, k, feeds.imu, device) if feeds.imu is not None
               else torch.zeros(3, device=device))
        delta, use = imu.ext_guess(p1, imu.window(feeds.imu, k, device),
                                   imu.window(feeds.wheel, k, device), vel)
        d = torch.where(use, delta, d)
    g = p1 + d
    return torch.cat([g[:3], p1[3:5], se3.wrap_angle(g[5:6])])


def align_at(k, rows, seen, scans: Scans, prog, device, feeds=None):
    """The reference's align of scan k from the program's state: (pose [6],
    iterations)."""
    gspec, nspec = voxel.spec_from_config(prog), ndt.spec_from_config(prog)
    ops, start = seen[k]
    grid = build_map(ops, start, rows, scans, gspec, device)
    c = scans.filtered(k)
    with lowp.tf32(scans.lowp):
        res = ndt.align_ref(grid, c.xyz, c.mask, guess(rows, k, device, feeds), gspec, nspec)
    return res.pose.cpu().numpy().astype(np.float64), int(res.iterations)


# ------------------------------------------------------------------ Part B --
class BackEnd:
    """The reference's replay of Part B over the session's keyframes."""

    def __init__(self, rec: dict, scans: Scans, prog: dict, device):
        self.rec, self.scans, self.prog, self.device = rec, scans, prog, device
        rows = rec["rows"]
        self.kf_scan = np.nonzero(rows[:, 9] > 0.5)[0]
        self.scspec = loop.sc_spec(prog)
        self.isc = prog["loop.method"] == "isc"
        if self.isc:
            # ISC's gates read each keyframe's odometric position and the
            # odometric travel at its scan, a float32 sum over the scans
            self.iscspec = isc.isc_spec(prog)
            f32 = rows[:, :3].astype(np.float32)
            p = torch.as_tensor(f32, device=device)
            step = torch.linalg.norm(p[1:, :2] - p[:-1, :2], dim=-1).cpu().numpy()
            travel = np.add.accumulate(np.concatenate([[0.0], step]).astype(np.float32))
            self.positions = p[self.kf_scan]
            self.travel = torch.as_tensor(travel[self.kf_scan], device=device)
        self.num_sector = (self.iscspec if self.isc else self.scspec).num_sector
        self.desc = {}
        self.clouds = {}

    def keyframe(self, k: int):
        if k not in self.desc:
            c = self.scans.filtered(int(self.kf_scan[k]))
            with lowp.tf32(self.scans.lowp):
                if self.isc:
                    self.desc[k] = isc.make_descriptor(c.xyz, c.intensity, c.mask, self.iscspec)
                else:
                    self.desc[k] = loop.make_descriptor(c.xyz, c.mask, self.scspec)
                xyz, mask, _ = loop.subsample_cloud(c.xyz, c.mask, self.rec["kf_points"])
            self.clouds[k] = (xyz, mask)
        return self.desc[k]

    def detect_isc(self, k: int) -> isc.Scores:
        """Every entry older than keyframe k scored against it."""
        db = torch.stack([self.keyframe(i) for i in range(k + 1)])
        with lowp.tf32(self.scans.lowp):
            return isc.score_all(db[k], db, self.positions, self.travel, k, self.iscspec)

    def detect(self, k: int):
        """(candidate or −1, found, distance and shift of every eligible
        entry) among the entries at least num_exclude_recent keyframes
        older."""
        newest = k + 1 - self.scspec.num_exclude_recent
        q = self.keyframe(k)
        if newest <= 0:
            return -1, False, None, None
        db = torch.stack([self.keyframe(i) for i in range(newest)])
        with lowp.tf32(self.scans.lowp):
            dist, shift = loop.distance_all_rotations(
                q, db, torch.ones(newest, dtype=torch.bool, device=self.device), self.scspec)
        best = int(torch.argmin(dist))
        found = bool(torch.isfinite(dist[best]) and dist[best] < self.scspec.dist_thresh)
        return (best if found else -1), found, dist, shift

    def submap(self, c: int, frame: np.ndarray, opt: torch.Tensor):
        """±half_width keyframe clouds at the optimized poses in frame
        `frame`'s coordinates, subsampled to submap_points."""
        hw, n_out = self.prog["loop.submap_half_width"], self.prog["loop.submap_points"]
        ks = [i for i in range(c - hw, c + hw + 1) if 0 <= i < opt.shape[0]]
        Tinv = se3.inverse(frame)
        pts, masks = [], []
        with lowp.tf32(self.scans.lowp):
            for i in ks:
                self.keyframe(i)
                xyz, mask = self.clouds[i]
                T = torch.matmul(Tinv, opt[i]).to(torch.float32)
                pts.append(se3.transform_points(T, xyz))
                masks.append(mask)
            xyz, mask, _ = loop.subsample_cloud(torch.cat(pts), torch.cat(masks), n_out)
        return xyz, mask


def _T(pose6, dtype, device):
    return se3.pose_to_matrix(torch.as_tensor(np.asarray(pose6), dtype=dtype, device=device))


def replay_back_end(rec, scans: Scans, prog, device, verify_sample: set, lowp_state=False,
                    gps=None):
    """The reference's Part B over every keyframe, following the program's
    accepted loops. The optimized poses chain from the logged odometric
    poses; the graph is solved (float64, exact) before each sampled
    verification, with the loops accepted so far, and at the end with every
    loop, and with the altitude factors of `gps` (`gps_factors`). Returns
    the comparisons and the final transforms [n,4,4]. `lowp_state` rounds
    the solve's state to TF32 after every update (the control)."""
    rows = rec["rows"]
    dtype = torch.float64
    be = BackEnd(rec, scans, prog, device)
    n = len(be.kf_scan)
    T_odo = _T(rows[be.kf_scan, :6], dtype, device)
    between = torch.cat([torch.eye(4, dtype=dtype, device=device)[None],
                         torch.matmul(se3.inverse(T_odo[:-1]), T_odo[1:])])
    odom_info = torch.tensor([1.0 / prog["pgo.odom_noise_trans"]] * 3
                             + [1.0 / prog["pgo.odom_noise_rot"]] * 3, dtype=dtype, device=device)
    rnd = (lambda T: lowp.round_tf32(T.to(torch.float32)).to(dtype)) if lowp_state else None
    accepted = {int(j): q for q, j in enumerate(rec["loop_j"])}
    gps_t = None
    if gps is not None:
        alt, valid = gps
        gps_t = (torch.as_tensor(np.where(valid, alt, 0.0), dtype=dtype, device=device),
                 torch.as_tensor(np.where(valid, 1.0 / prog["pgo.gps_noise_alt"], 0.0),
                                 dtype=dtype, device=device))
    opt = T_odo[:1].clone()
    loops, solved = [], 0
    out = {"sc_mismatch": 0, "verify_mismatch": 0, "accept_mismatch": 0,
           "icp_fitness_gap": 0.0, "icp_T_gap_m": 0.0, "detections": 0, "icp_runs": 0,
           "icp_s": 0.0, "solve_s": 0.0, "accept_cases": []}
    period, method = prog["loop.detect_period"], prog["loop.method"]
    thresh, gate = prog["sc.dist_thresh"], prog["loop.max_loop_dist"]

    def catch_up(k, iterations):
        nonlocal opt, solved
        t = time.perf_counter()
        opt = pgo.solve(opt, loops, odom_info, prog["pgo.cauchy_k"], iterations,
                        between[:k + 1], rnd, gps_t)
        solved = len(loops)
        out["solve_s"] += time.perf_counter() - t

    for k in range(1, n):
        opt = torch.cat([opt, torch.matmul(opt[k - 1], between[k])[None]])
        if method == "none" or k % period:
            continue
        if method not in ("sc", "isc"):
            raise ValueError(f"the reference replays Scan Context and ISC loops, not {method!r}")
        row = rows[be.kf_scan[k]]
        p_cand, p_found, p_ran = int(row[11]), row[12] > 0.5, row[15] > 0.5
        p_ok = k in accepted
        sampled = p_ran and k in verify_sample
        if sampled and solved < len(loops):
            catch_up(k, CATCH_UP_GN)
        out["detections"] += 1
        # a retrieval differs where the two sides take different decisions
        # that rounding cannot decide
        if be.isc:
            scores = be.detect_isc(k)
            ok = (scores.margin_m > 0) & (scores.margin_score > 0)
            found = bool(ok.any())
            cand = int(torch.argmax(torch.where(ok, scores.total, -torch.inf))) if found else -1
            shift = scores.shift
            differs = _isc_differs(scores, p_found, p_cand)
        else:
            cand, found, dist, shift = be.detect(k)
            differs = _sc_differs(dist, cand, found, p_cand, p_found, thresh)
        out["sc_mismatch"] += int(differs)
        c = p_cand if p_found else cand
        if c >= 0:
            d2 = float(torch.linalg.norm(opt[k, :2, 3] - opt[c, :2, 3]))
            if (d2 <= gate) != p_ran and abs(d2 - gate) > GATE_ROUNDING_M:
                out["verify_mismatch"] += 1
        elif p_ran:
            out["verify_mismatch"] += 1
        if sampled and c >= 0:
            t_icp = time.perf_counter()
            out["icp_runs"] += 1
            T_init = torch.matmul(se3.inverse(opt[c]), opt[k]).to(torch.float32)
            if prog["loop.use_sc_yaw"]:
                yaw = loop.shift_yaw(shift[c], be.num_sector)
                p_init = se3.matrix_to_pose(T_init)
                p_init[5] = -yaw
                T_init = se3.pose_to_matrix(p_init)
            tgt, tmask = be.submap(c, opt[c], opt)
            src, smask = be.clouds[k]
            with lowp.tf32(scans.lowp):
                res = loop.align_ref(src, smask, tgt, tmask, T_init, loop.icp_spec(prog))
            corr = float(torch.linalg.norm(res.T[:3, 3] - T_init[:3, 3]))
            fit = float(res.fitness)
            ok = (bool(res.converged) and fit <= prog["loop.icp_fitness_thresh"]
                  and corr <= prog["loop.max_correction"] and len(loops) < prog["pgo.max_loops"])
            # rounding decides an accept near either threshold, and a
            # convergence the reference's ICP had not reached by its last
            # iteration: its host update and the kernel's differ in the last
            # bits, and such a case read the same fitness to 1e-5 on both
            # sides with the reference's stop test unmet at the cap
            near = (abs(fit - prog["loop.icp_fitness_thresh"]) < ICP_ROUNDING
                    or abs(corr - prog["loop.max_correction"]) < GATE_ROUNDING_M
                    or int(res.iterations) >= prog["loop.icp_max_iterations"])
            out["icp_fitness_gap"] = _worst(out["icp_fitness_gap"], abs(fit - float(row[13])))
            out["accept_mismatch"] += int(ok != p_ok and not near)
            if ok != p_ok:
                out["accept_cases"].append(
                    {"kf": k, "cand": c, "fitness": fit, "program_fitness": float(row[13]),
                     "correction": corr, "program_correction": float(row[14]),
                     "converged": bool(res.converged), "iterations": int(res.iterations),
                     "accepted_by_program": p_ok, "near": near})
            if p_ok:
                pT = rec["loop_T"][accepted[k]]
                gap = float(np.linalg.norm(pT[:3, 3] - res.T[:3, 3].cpu().numpy()))
                out["icp_T_gap_m"] = _worst(out["icp_T_gap_m"], gap)
            out["icp_s"] += time.perf_counter() - t_icp
        if p_ok:
            q = accepted[k]
            loops.append((int(rec["loop_i"][q]), k, rec["loop_T"][q], float(rec["loop_info"][q])))
    if solved < len(loops):
        catch_up(n - 1, CATCH_UP_GN)
    catch_up(n - 1, prog["pgo.gn_iterations"])
    return out, opt


def _sc_differs(dist, cand: int, found: bool, p_cand: int, p_found: bool,
                thresh: float) -> bool:
    """Whether the program's Scan Context retrieval takes a decision that
    rounding cannot: a found flag away from the threshold, or a candidate
    whose distance is not within rounding of the best (`dist` None: no
    entry was eligible)."""
    if dist is None:
        return p_found
    best = float(dist[cand if found else int(torch.argmin(dist))])
    if found != p_found:
        return abs(best - thresh) > SC_ROUNDING
    return found and cand != p_cand and float(dist[p_cand]) - best > SC_ROUNDING


def _isc_differs(scores: isc.Scores, p_found: bool, p_cand: int) -> bool:
    """Whether the program's ISC retrieval takes a decision that rounding
    cannot: no candidate where an entry passes every gate and threshold by
    more than rounding, a candidate that fails one by more, or a candidate
    whose score such an entry beats by more than rounding."""
    sure = (scores.margin_m > GATE_ROUNDING_M) & (scores.margin_score > SC_ROUNDING)
    if not p_found:
        return bool(sure.any())
    if not 0 <= p_cand < len(scores.total):
        return True
    if float(scores.margin_m[p_cand]) < -GATE_ROUNDING_M or \
            float(scores.margin_score[p_cand]) < -SC_ROUNDING:
        return True
    return bool((sure & (scores.total > scores.total[p_cand] + SC_ROUNDING)).any())


def gps_factors(feeds, kf_scan: np.ndarray):
    """(altitude, valid) of every keyframe from the feed at its scan, or
    None without GPS. The seed keyframe takes no fix: it holds the gauge."""
    if feeds is None or feeds.gps_alts is None:
        return None
    alt = feeds.gps_alts[kf_scan].astype(np.float32)
    valid = np.isfinite(alt)
    valid[:1] = False
    return alt, valid


# ------------------------------------------------------------------- judge --
def _sample(rng, pool, size):
    pool = list(pool)
    return sorted(int(x) for x in rng.choice(pool, size=min(size, len(pool)),
                                              replace=False)) if pool else []


def readings(rec, scans_src, prog, cell, seed, lap_poses, lap_index, plan_, device,
             lowp_on: bool, feeds=None) -> dict:
    """Every number compared, for the program (`lowp_on` false: the
    reference in float32 judges the program's outputs) or for the control
    (true: the reference in TF32 takes the program's place and the float32
    reference judges it). `feeds` (`gen/feeds.py`) are the sensor feeds the
    program was handed, None where the configuration feeds none."""
    rows = rec["rows"]
    nums, info = {}, {}
    nums["scans_missing"] = float(abs(rec["scans_fed"] - len(rows)))
    # the keyframe gate from the logged poses
    gap = prog["pgo.keyframe_gap"]
    acc, kf = 0.0, 1
    mism = 0
    for i in range(1, len(rows)):
        acc += float(np.hypot(rows[i, 0] - rows[i - 1, 0], rows[i, 1] - rows[i - 1, 1]))
        is_kf = acc >= gap and kf < prog["pgo.max_keyframes"]
        near = abs(acc - gap) < ROUNDING
        if rows[i, 9] > 0.5:            # follow the program's own resets
            acc, kf = 0.0, kf + 1
        if not near and is_kf != (rows[i, 9] > 0.5):
            mism += 1
    nums["gate_mismatch"] = float(mism)

    ref = Scans(scans_src, prog, device, False)
    sub = Scans(scans_src, prog, device, True) if lowp_on else None
    rng = np.random.default_rng([11, seed])
    seen, ambiguous = map_history(rows, prog)
    pool = [k for k in range(2, len(rows)) if k not in ambiguous]
    samples = _sample(rng, pool, ALIGN_SAMPLES)
    pose_gap = rot_gap = 0.0
    iter_mis = 0
    t0 = time.perf_counter()
    for k in samples:
        p_ref, it_ref = align_at(k, rows, seen, ref, prog, device, feeds)
        if lowp_on:
            p_out, it_out = align_at(k, rows, seen, sub, prog, device, feeds)
        else:
            p_out, it_out = rows[k, :6], int(rows[k, 6])
        pose_gap = _worst(pose_gap, float(np.linalg.norm(p_out[:3] - p_ref[:3])))
        rot_gap = _worst(rot_gap, float(np.max(np.abs(_wrap(p_out[3:] - p_ref[3:])))))
        iter_mis += int(it_out != it_ref)
    nums["ndt_pose_gap_m"], nums["ndt_rot_gap_rad"] = pose_gap, rot_gap
    nums["ndt_iter_mismatch"] = float(iter_mis)
    info["aligns"] = len(samples)
    info["part_a_s"] = time.perf_counter() - t0

    # the filter's kept points, through the stored keyframe clouds
    kf_scan = np.nonzero(rows[:, 9] > 0.5)[0]
    out_pts = tot = 0
    counts = []
    for k in plan_["keyframes"]:
        if k not in rec["kf_clouds"] or k >= len(kf_scan):
            continue
        c = ref.filtered(int(kf_scan[k]))
        counts.append(int(c.mask.sum()))
        if lowp_on:
            s = sub.filtered(int(kf_scan[k]))
            xyz, mask, _ = loop.subsample_cloud(s.xyz, s.mask, rec["kf_points"])
            xyz, mask = xyz.cpu().numpy(), mask.cpu().numpy()
        else:
            xyz, mask = rec["kf_clouds"][k]
        P = torch.as_tensor(xyz[mask], device=device)
        R = c.xyz[c.mask]
        if len(P) == 0:
            continue
        d = torch.cat([torch.min(torch.sum((P[i:i + 1024, None, :] - R[None]) ** 2, -1), 1).values
                       for i in range(0, len(P), 1024)])
        out_pts += int((~(d <= MATCH_M ** 2)).sum())     # a non-finite point matches nothing
        tot += len(P)
    nums["kf_cloud_outlier_pct"] = 100.0 * out_pts / max(tot, 1)
    info["filters_s"] = time.perf_counter() - t0 - info["part_a_s"]
    info["filtered_points_mean"] = float(np.mean(counts)) if counts else None

    # the fixes the keyframes stored (the control stores the feed's)
    gps = gps_factors(feeds, kf_scan)
    if gps is not None:
        n_kf = len(kf_scan)
        alt, valid = gps
        p_valid = np.asarray(rec["gps_mask"][:n_kf], bool)
        p_alt = np.asarray(rec["gps_alt"][:n_kf], np.float32)
        differs = (p_valid != valid) | (valid & (p_alt != alt))
        nums["gps_mismatch"] = 0.0 if lowp_on else float(differs.sum())
        info["gps_keyframes"] = int(valid.sum())

    # Part B
    t0 = time.perf_counter()
    verified = [k for k in range(len(kf_scan)) if rows[kf_scan[k], 15] > 0.5]
    vs = set(_sample(np.random.default_rng([13, seed]), verified, VERIFY_SAMPLES))
    src = sub if lowp_on else ref
    b_out, opt = replay_back_end(rec, src, prog, device, vs, lowp_state=lowp_on, gps=gps)
    if lowp_on:
        # the control in the program's place: its decisions against the
        # reference's on the same keyframes, its poses against the
        # reference's
        b_cmp, opt_ref = replay_back_end(rec, ref, prog, device, vs, gps=gps)
        for key in ("sc_mismatch", "verify_mismatch", "accept_mismatch"):
            b_out[key] = abs(b_out[key] - b_cmp[key])
        final = opt
        opt = opt_ref
    else:
        final = _T(rec["kf_opt"], torch.float64, device)
    for key in ("sc_mismatch", "verify_mismatch", "icp_fitness_gap", "icp_T_gap_m",
                "accept_mismatch"):
        nums[key] = float(b_out[key])
    nums["pgo_gap_m"] = _worst(0.0, float(torch.max(torch.linalg.norm(
        final[:, :3, 3] - opt[:, :3, 3], dim=-1)))) if len(final) else 0.0
    if b_out["accept_cases"]:
        info["accept_cases"] = b_out["accept_cases"]
    info.update(detections=b_out["detections"], icp_runs=b_out["icp_runs"],
                icp_s=b_out["icp_s"], solve_s=b_out["solve_s"], part_b_s=time.perf_counter() - t0)

    gt = gt_map_frame(lap_poses, lap_index[:len(rows)])
    est = final[:, :3, 3].cpu().numpy()
    nums["ate_m"] = aligned_ate(est, gt[kf_scan, :3, 3]) if len(kf_scan) >= 3 else 0.0
    return {"numbers": nums, "info": info}


def judge(cell, seed, rec, scans_src, lap_index, lap_poses, plan_, device, mode="program",
          feeds=None):
    """The program's numbers, each beside the cell's limit, and `correct`;
    with `mode="control"` also the control's numbers and whether the
    limits fail it. `feeds`: the sensor feeds the program was handed."""
    lowp.fp32_matmul_off()
    prog = dict(cell.config["program"])
    prog.update(rec.get("prog_overrides", {}))
    rec = dict(rec, kf_points=cell.config["engine"]["kf_points"])
    r = readings(rec, scans_src, prog, cell, seed, lap_poses, lap_index, plan_, device, False,
                 feeds)
    limits = cell.limits.get("numbers", {})
    out = {"numbers": {}, "correct": True, "info": r["info"],
           "filtered_points_mean": r["info"]["filtered_points_mean"],
           "counts": {"scans": int(len(rec["rows"])), "keyframes": int(rec["kf_count"]),
                      "loops": int(rec["loop_count"]),
                      "verifications": int(rec["icp_verifications"]),
                      "retrievals_found": int(np.sum((rec["rows"][:, 9] > 0.5)
                                                     & (rec["rows"][:, 12] > 0.5)))}}
    for name, v in r["numbers"].items():
        if name not in limits:
            out["info"][name] = v       # read, not compared in this cell
            continue
        lim = limits[name]["limit"]
        ok = v <= lim
        out["numbers"][name] = {"value": v, "limit": lim, "ok": ok}
        out["correct"] &= ok
    if not out["numbers"]:
        out["correct"] = False          # a cell with no limits judges nothing
    if mode == "control":
        c = readings(rec, scans_src, prog, cell, seed, lap_poses, lap_index, plan_, device, True,
                     feeds)
        fails = [n for n, v in c["numbers"].items() if n in limits and v > limits[n]["limit"]]
        out["control"] = {"numbers": c["numbers"], "fails": fails, "info": c["info"]}
    return out
