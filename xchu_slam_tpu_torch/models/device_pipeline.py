"""The device engine (port of `xchu_slam_tpu.models.device_pipeline`).

The reference runs the whole SLAM iteration as one jitted device program
with its control under `lax.cond` / `lax.while_loop`, fed staged chunks of
scans. PyTorch has no such program, so the port splits the step in two and
keeps the reference's results in scan order:

- Part A, every scan, no host synchronisation: filter → with `odom.use_imu`
  / `odom.use_odom` the scan's IMU / wheel windows integrated into the NDT
  guess on the card (`ops/imu.py::ext_guess`, the CUDA kernel
  `csrc/guess_kernel.cu`; the IMU velocity reset from the SLAM delta after
  the step) → NDT odometry (the
  align's trip counts decided by the CUDA kernel `csrc/ndt_kernel.cu`; map
  insertion, swap and recentring under device flags) → travel, the keyframe
  gate `is_kf = (kf_accum ≥ keyframe_gap) & (keyframes < capacity)`, the
  gate's resets and the keyframe counter → the scan's log row. On a CUDA
  device Part A of one scan is captured once as a CUDA graph and replayed per
  scan. Part A keeps, per slot of the chunk, what Part B needs: the filtered
  cloud, the pose, the stamp and the travel.
- one readback per chunk: the chunk's log rows (they hold `is_kf`).
- Part B, in scan order, for the flagged slots only: the keyframe branch
  (`_add_keyframe_branch` with `_detect_candidate` and `_verify_and_apply`),
  decided on the card as the reference's nested `lax.cond`s decide it. The
  host holds only what the readback gave (which slots are keyframes, their
  stamps and travel) and the store's count, and decides the detection
  cadence (`k % detect_period`); the candidate, the 2-D gate, the ICP
  verification (its CUDA graph replayed with `live` = the gate),
  acceptance, the masked loop-table writes, `loop_count`, the solve's
  cadence and its kernel's `run` flag, the diagnostics (columns 11-15 of
  that scan's log row) and the verification counter are tensors on the
  card. The counters are read in `finalize`. On a CUDA device (no mesh,
  `use_graph`) Part B is itself CUDA-graph replays (`_PartBGraphs`): the
  keyframe index is a 0-d tensor on the card set by a fill, the scan's row
  and cloud are copied on the device, and the store, the retrieval, the
  verification's set-up, its acceptance and the per-keyframe tail are
  chains captured per pipeline on the state's tensors (at the first
  keyframe that runs each, after it ran eagerly; again after `restore`),
  with the ICP graph and the in-loop solve's Gauss-Newton graph replayed
  between them: one replay a keyframe that detects nothing, five (four
  with ISC, whose retrieval stays eager) and those graphs' (ICP once,
  Gauss-Newton `inloop_gn_iterations` times) a detection keyframe. Every
  state tensor is updated in place; the results are the eager route's bit
  for bit. The seed keyframe, the mesh engine, CPU tensors and
  `use_graph=False` take the eager route.

Part A reads nothing that Part B writes (the keyframe store, the graph): it
needs only the gate's own scalars, which stay on the card. So the results
are those of the reference's step in order. `process_scan` is a chunk of
one. With `check_sync` the whole of a chunk but its one readback runs under
`torch.cuda.set_sync_debug_mode("error")` (the first scan's seed, once a
run, is outside it).

Spans (`utils/profiling.Spans`, the engine's `spans`; always on, host
clock, no synchronisation): every `process_chunk` is a `chunk` (its records'
chunk id: the pipeline's serial and the chunk's index), holding
`session.seed` (`init_state`, the first chunk only), `part_a_enqueue` (its
children `part_a.eager`, `part_a.capture`, `part_a.replay`),
`readback_wait` and `part_b`, which holds for each keyframe `part_b.store`
(subsample, descriptors, store writes, the between factor),
`part_b.retrieve` (`_detect_candidate`) and `part_b.verify`
(`_verify_and_apply`, holding the in-loop solve `part_b.solve`), on the
graph route each around its chains' replays (the ICP graph's in
`part_b.verify`, the Gauss-Newton iterations' and the tail's in
`part_b.solve`), and `part_b.capture` (the captures); `finalize` holds
`finalize.solve` and `finalize.readback`. `stage_seconds` holds their
totals by name (self seconds under `self.<name>`). Part A's graph holds four
timing events (filter | guess and NDT align | map update, swap, recentre,
gate and log row); after each chunk's readback, which has waited for every
replay, the last replay's three intervals are added as device seconds
(`device.part_a.filter`, `device.part_a.align`, `device.part_a.map`, with
`device.samples` the scans sampled). Inside `profiling.recording()` the Part
B stages also carry timing events, resolved at the next readback. Under a
mesh the host spans run and the device times are left out (Part A runs
eagerly there).

`utils/checkpoint.py` saves and restores this engine's state in the
reference's layout at a chunk boundary; `models/continue_session.py` seeds
it from a saved session.

With a `mesh` (`parallel/distributed.py`: this rank's view of a group of
processes, one a rank) the engine is one session run by every rank of the
group, the reference's `make_mesh_fns`: the state is replicated on every
rank and the hot ops are sharded over the ranks, down the call chain that
the reference's mesh axis takes. Part A's NDT align shards the scan's
points (`odometry.step(mesh=)`; insertion, finalize, swap and recentring
stay replicated); Part B's Scan Context / ISC retrievals shard the
database, the ICP verification the keyframe cloud and the in-loop solve the
factors (`icp.align(live=, mesh=)`, `pose_graph.solve(run=, mesh=)`); the
radius retrieval and the descriptors stay replicated. The seed (keyframe 0
detects nothing) and `finalize`'s full-strength solve run replicated, with
no collective. Part A runs eagerly, not as a CUDA graph: the sharded align
paces its Newton loop from the host, a readback a pass, and a gloo
collective is a host call. Every host decision comes from bits that are
equal on every rank; once a chunk, after its readback, the ranks all-gather
the chunk's log rows (its keyframe flags among them) and raise, naming the
chunk and the ranks, where they differ, before a divergence could deadlock
the next collective. `filter.max_points`, `kf_points`, `pgo.max_keyframes`
and `pgo.max_loops` must divide by the mesh's size.

Not ported: the reference's `sync_every` (a soft synchronisation of its
relay; `run-sim --sync-every` is refused by name).
"""

from __future__ import annotations

import contextlib
import itertools
import warnings
from typing import NamedTuple

import numpy as np
import torch

from xchu_slam_tpu_torch.config import SlamConfig
from xchu_slam_tpu_torch.models import odometry, pose_graph as pg
from xchu_slam_tpu_torch.models.pipeline import (KfDb, LoopRecord, SlamPipeline,
                                                 _add_keyframe, build_submap,
                                                 empty_db, subsample_cloud)
from xchu_slam_tpu_torch.ops import icp, imu as imu_ops, isc as isc_ops, scancontext as sc
from xchu_slam_tpu_torch.ops.cuda import guess_kernel, ndt_kernel, nn_kernel
from xchu_slam_tpu_torch.ops.filter import filter_scan
from xchu_slam_tpu_torch.types import Cloud, make_cloud
from xchu_slam_tpu_torch.utils import collectives, profiling, se3


class DevSpec(NamedTuple):
    """Static pipeline parameters."""

    fcfg: object                # FilterConfig
    ospec: odometry.OdomSpec
    scspec: sc.ScSpec
    iscspec: isc_ops.IscSpec
    icpspec: icp.IcpSpec
    gspec: pg.GraphSpec
    kf_points: int
    keyframe_gap: float
    detect_period: int
    method: str                 # "sc" | "isc" | "radius" | "none"
    radius_search: float
    min_time_diff: float
    max_loop_dist: float
    icp_fitness_thresh: float
    max_correction: float
    submap_half_width: int
    submap_points: int
    use_gps: bool
    use_sc_yaw: bool = True
    log_capacity: int = 8192
    # the IMU / wheel-odometry NDT guess: per-scan windows integrated on the
    # card (the reference's use_imu / use_odom launch modes)
    use_imu: bool = False
    use_odom: bool = False


def spec_from_config(cfg: SlamConfig, kf_points: int = 4096,
                     log_capacity: int = 8192) -> DevSpec:
    return DevSpec(
        fcfg=cfg.filter,
        ospec=odometry.spec_from_config(cfg),
        scspec=sc.spec_from_config(cfg.sc),
        iscspec=isc_ops.spec_from_config(cfg.isc),
        icpspec=icp.spec_from_config(cfg.loop),
        gspec=pg.spec_from_config(cfg.pgo),
        kf_points=kf_points,
        keyframe_gap=cfg.pgo.keyframe_gap,
        detect_period=cfg.loop.detect_period,
        method=cfg.loop.method,
        radius_search=cfg.loop.radius_search,
        min_time_diff=cfg.loop.min_time_diff,
        max_loop_dist=cfg.loop.max_loop_dist,
        icp_fitness_thresh=cfg.loop.icp_fitness_thresh,
        max_correction=cfg.loop.max_correction,
        submap_half_width=cfg.loop.submap_half_width,
        submap_points=cfg.loop.submap_points,
        use_gps=cfg.pgo.use_gps,
        use_sc_yaw=cfg.loop.use_sc_yaw,
        log_capacity=log_capacity,
        use_imu=cfg.odom.use_imu,
        use_odom=cfg.odom.use_odom,
    )


class GuessWindows(NamedTuple):
    """The sensor windows of the external guess: `imu` an ops.imu.ImuWindow,
    `wheel` an ops.imu.OdomWindow, each None where its mode is off. For
    `process_chunk` every leaf has a leading [chunk] axis."""

    imu: object
    wheel: object


class DevState(NamedTuple):
    """The engine's state, on the device. Part A's fields are tensors that
    keep their address (they are updated in place, as a CUDA graph needs);
    Part B's are the host engine's store and graph, whose only host value is
    the store's `count` (the keyframe rows come from the chunk's readback)."""

    odom: odometry.OdomState
    db: KfDb                    # `count` is a host int (Part B's)
    graph: pg.GraphData
    kf_accum: torch.Tensor      # f32: travel since the last keyframe
    travel: torch.Tensor        # f32: total odometric travel
    last_kf_odom: torch.Tensor  # f32[6]: odometric pose at the last keyframe
    loop_count: torch.Tensor    # i64 on the device (Part B's)
    scan_count: torch.Tensor    # i64 on the device: indexes the log ring
    kf_count: torch.Tensor      # i64 on the device: the gate's keyframe counter
    imu_vel: torch.Tensor       # f32[3]: the IMU velocity estimate (world
    #                             frame), reset from the SLAM delta every scan
    last_stamp: torch.Tensor    # f32: the previous scan's stamp
    log: torch.Tensor           # f32[LOG,16]: pose6, iters, fitness, mfrac,
    #                             is_kf, stamp, + loop diagnostics: cand idx,
    #                             retrieval found, icp fitness, icp correction,
    #                             verify ran
    diag: torch.Tensor          # f32[5]: Part B's diagnostics scratch


_DIAG_RESET = (-1.0, 0.0, 0.0, 0.0, 0.0)
LOG_COLS = 16


def _diag_reset() -> torch.Tensor:
    return torch.tensor(_DIAG_RESET, dtype=torch.float32)


def _span(spans, name: str):
    """Part B stage `name` of the owner `spans` (none where it is None), with
    timing events while spans are recorded."""
    return contextlib.nullcontext() if spans is None else spans.span(name, device=True)


def _as(x, dtype, dev) -> torch.Tensor:
    """`x` as a 0-d tensor of `dtype` on `dev`; a host value becomes a fill
    (no copy from host memory)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.full((), x, dtype=dtype, device=dev)


def _row(t: torch.Tensor, k) -> torch.Tensor:
    """Row `k` of `t`: a host int indexes, a 0-d or one-element tensor on the
    device gathers (no readback; the form a CUDA graph replays)."""
    if isinstance(k, torch.Tensor):
        return t.index_select(0, k.reshape(1))[0]
    return t[k]


def _older_than(stamp, dt: float):
    """`stamp - dt` as the host computes it for a host stamp: in float64, so
    that a stamp on the device (a float32 tensor) meets the same threshold
    when compared with float32 stamps."""
    if isinstance(stamp, torch.Tensor):
        return stamp.to(torch.float64) - dt
    return stamp - dt


def _sc_radius_candidate(state: DevState, k, stamp, spec: DevSpec):
    """Loop method "radius": the nearest keyframe before `k` (2-D, optimized
    poses) that is at least `min_time_diff` older, if within
    `radius_search`. `k` and `stamp` are host values or 0-d tensors on the
    device. Returns (idx or -1, found) as 0-d tensors on the device."""
    db = state.db
    K = db.poses.shape[0]
    pos = _row(db.opt_poses, k)[:2]
    d = torch.linalg.norm(db.opt_poses[:, :2] - pos[None], dim=-1)
    eligible = (torch.arange(K, device=d.device) < k) \
        & (db.stamps < _older_than(stamp, spec.min_time_diff))
    d = torch.where(eligible, d, torch.inf)
    best = torch.argmin(d).reshape(1)
    found = d.gather(0, best)[0] < spec.radius_search
    return torch.where(found, best[0], -1), found


def _detect_candidate(state: DevState, k, stamp, spec: DevSpec, mesh=None):
    """Method-dispatched retrieval. Returns (idx, found, yaw) as 0-d tensors
    on the device: yaw is the descriptor-measured relative heading
    ψ_cand − ψ_query (0 for methods without a rotation estimate). With a
    `mesh` SC and ISC score the database sharded over its ranks; the radius
    retrieval stays replicated. `k` and `stamp` may be 0-d tensors on the
    device for "sc" and "radius"; "isc" scores the rows before `k`, a host
    int."""
    db = state.db
    dev = db.poses.device
    if spec.method == "sc":
        res = sc.detect_loop_on_device(_row(db.sc_db, k), db.sc_db, db.count, spec.scspec,
                                       cur=k, mesh=mesh)
        return res.idx, res.found, res.yaw
    if spec.method == "isc":
        res = isc_ops.detect_loop_on_device(db.isc_db[k], db.isc_db, db.count,
                                            db.poses[:, :3], db.travel, spec.iscspec, cur=k,
                                            mesh=mesh)
        return res.idx, res.found, res.yaw
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if spec.method == "radius":
        idx, found = _sc_radius_candidate(state, k, stamp, spec)
        return idx, found, zero
    return (torch.full((), -1, dtype=torch.int64, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev), zero)


def _candidate_diag(diag: torch.Tensor, cand, found):
    """(cand or -1, the diagnostics with the retrieval's two columns set)."""
    cand = torch.where(found, cand, -1)
    return cand, torch.cat([torch.stack([cand.to(torch.float32), found.to(torch.float32)]),
                            diag[2:]])


def _masked_put(t: torch.Tensor, q: torch.Tensor, ok: torch.Tensor, val) -> None:
    """t[q] = val where `ok`, in place, with q and ok on the device."""
    old = t.index_select(0, q)
    new = val if isinstance(val, torch.Tensor) else torch.full_like(old, val)
    t.index_copy_(0, q, torch.where(ok, new.reshape(old.shape).to(t.dtype), old))


def _verify_gate(db: KfDb, k, cand: torch.Tensor, yaw: torch.Tensor, spec: DevSpec):
    """The verification's inputs: the 2-D sanity gate (ICP's `live` flag),
    the candidate's submap and the initial transform. `k` is a host int or a
    0-d tensor on the device; `cand` (-1 for none) and `yaw` 0-d tensors.
    Returns (do_verify, tgt_xyz, tgt_mask, T_init)."""
    c = torch.clamp(cand, min=0).reshape(1)
    opt_c = db.opt_poses.index_select(0, c)[0]
    opt_k = _row(db.opt_poses, k)
    # 2-D sanity gate
    d2 = torch.linalg.norm(opt_k[:2] - opt_c[:2])
    do_verify = (cand >= 0) & (d2 <= spec.max_loop_dist)

    if isinstance(k, torch.Tensor):
        # a graph's store: its host count is not the replay's; keyframe k is
        # the newest row
        db = db._replace(count=k + 1)
    tgt_xyz, tgt_mask, _ = build_submap(db, c, c, spec.submap_half_width, spec.submap_points)
    T_init = torch.matmul(se3.inverse(se3.pose_to_matrix(opt_c)), se3.pose_to_matrix(opt_k))
    if spec.use_sc_yaw and spec.method in ("sc", "isc"):
        # heading from the descriptor's rotation estimate (−yaw = the query's
        # heading in cand's frame) instead of the drifted pose difference
        p_init = se3.matrix_to_pose(T_init)
        p_init[5] = -yaw
        T_init = se3.pose_to_matrix(p_init)
    return do_verify, tgt_xyz, tgt_mask, T_init


def _accept_loop(state: DevState, k, cand: torch.Tensor, res: icp.IcpResult,
                 T_init: torch.Tensor, do_verify: torch.Tensor, spec: DevSpec):
    """Acceptance of a verification and its masked loop-table writes (in
    place). Returns (loop_count, diag, run): the new loop count and
    diagnostics, and the in-loop solve's run flag, as tensors on the
    device."""
    dev = state.db.poses.device
    corr = torch.linalg.norm(res.T[:3, 3] - T_init[:3, 3])
    loop_count = _as(state.loop_count, torch.int64, dev)
    # accept only converged ICP: a verification that hits the iteration cap
    # while still moving must not become a loop factor
    ok = (do_verify & res.converged & (res.fitness <= spec.icp_fitness_thresh)
          & (corr <= spec.max_correction) & (loop_count < spec.gspec.max_loops))
    diag = _as(state.diag, torch.float32, dev)
    ran = torch.stack([res.fitness, corr, torch.ones_like(corr)])
    diag = torch.cat([diag[:2], torch.where(do_verify, ran, diag[2:])])

    g = state.graph
    q = torch.clamp(loop_count, max=g.loop_i.shape[0] - 1).reshape(1)
    _masked_put(g.loop_i, q, ok, cand)
    _masked_put(g.loop_j, q, ok, k)
    _masked_put(g.loop_T, q, ok, res.T)
    _masked_put(g.loop_info, q, ok, 1.0 / torch.clamp(res.fitness, min=1e-2))
    _masked_put(g.loop_mask, q, ok, True)
    loop_count = loop_count + ok.to(torch.int64)
    # warm-started in-step solve at the configured cadence (its kernel's run
    # flag); finalize() always runs the full-strength solve
    run = ok
    if spec.gspec.solve_every > 1:
        run = ok & (loop_count % spec.gspec.solve_every == 0)
    return loop_count, diag, run


def _verify_and_apply(state: DevState, k: int, cand, yaw, spec: DevSpec,
                      mesh=None, spans=None) -> DevState:
    """ICP-verify the candidate and, on acceptance, add the loop factor and
    re-solve the graph, all decided on the card as the reference's nested
    conds decide it: the 2-D gate is the ICP's `live` flag, acceptance the
    masked loop-table writes and the solve's `run` flag. `cand` (-1 for
    none) and `yaw` are 0-d tensors or host values; `loop_count` and `diag`
    come back as tensors on the device, and nothing is read back. With a
    `mesh` the verification and the solve are sharded over its ranks (they
    read `live` and `run` back: bits equal on every rank). The solve is the
    span `part_b.solve` of `spans`."""
    db = state.db
    dev = db.poses.device
    cand = _as(cand, torch.int64, dev)
    yaw = _as(yaw, torch.float32, dev)
    do_verify, tgt_xyz, tgt_mask, T_init = _verify_gate(db, k, cand, yaw, spec)
    res = icp.align(db.clouds[k], db.cloud_mask[k], tgt_xyz, tgt_mask, T_init,
                    spec.icpspec, live=do_verify, mesh=mesh)
    loop_count, diag, run = _accept_loop(state, k, cand, res, T_init, do_verify, spec)
    with _span(spans, "part_b.solve"):
        opt = pg.solve(db.opt_poses, state.graph, pg.inloop_spec(spec.gspec), run=run,
                       mesh=mesh)
    return state._replace(db=db._replace(opt_poses=opt), loop_count=loop_count, diag=diag)


def _chain_pose(db: KfDb, prev, pose: torch.Tensor):
    """(Z, optimized pose) of a keyframe at odometric `pose` after keyframe
    `prev` (a host int or a one-element tensor): the odometric increment
    since it, and the optimized pose chained onto its optimized pose by
    that increment."""
    Z = torch.matmul(se3.inverse(se3.pose_to_matrix(_row(db.poses, prev))),
                     se3.pose_to_matrix(pose))
    return Z, se3.matrix_to_pose(torch.matmul(se3.pose_to_matrix(_row(db.opt_poses, prev)), Z))


def _add_keyframe_branch(state: DevState, filt: Cloud, pose: torch.Tensor,
                         stamp: float, travel: float, gps_alt: float,
                         gps_valid: bool, spec: DevSpec, mesh=None, spans=None) -> DevState:
    """Store keyframe `db.count` and, at the detection cadence, look for a
    loop and verify it (over `mesh` where one is given; the descriptors are
    computed replicated). `pose` [6] (on the device), `stamp` and `travel`
    are the scan's own, as Part A left them in its slot; the gate's scalars
    were reset by Part A. The stages are spans of `spans` (where given):
    `part_b.store`, `part_b.retrieve`, `part_b.verify`."""
    db = state.db
    k = db.count  # new keyframe index

    with _span(spans, "part_b.store"):
        cxyz, cmask, _src_idx = subsample_cloud(filt.xyz, filt.mask, spec.kf_points)
        # descriptors from the full filtered cloud; the subsample only bounds
        # the stored ICP submap clouds
        sc_desc = sc.make_descriptor(filt.xyz, filt.mask, spec.scspec)
        isc_desc = None
        if spec.method == "isc":
            isc_desc = isc_ops.make_descriptor(filt.xyz, filt.intensity, filt.mask,
                                               spec.iscspec)
        # the optimized pose chains onto the previous optimized pose by the
        # odometric increment since the last keyframe (whose odometric pose
        # is the store's row k-1)
        if k >= 1:
            Z, opt_pose = _chain_pose(db, k - 1, pose)
            state.graph.between_T[k] = Z
        else:
            opt_pose = pose
        db = _add_keyframe(db, pose, stamp, travel, cxyz, cmask, sc_desc, isc_desc,
                           opt_pose)
        state.graph.kf_mask[k].fill_(True)
        if spec.use_gps and gps_valid:
            state.graph.gps_alt[k].fill_(gps_alt)
            state.graph.gps_mask[k].fill_(True)
        state = state._replace(db=db)

    # loop detection every detect_period-th keyframe
    if spec.method != "none" and k >= 1 and k % spec.detect_period == 0:
        with _span(spans, "part_b.retrieve"):
            cand, found, yaw = _detect_candidate(state, k, stamp, spec, mesh)
            cand, diag = _candidate_diag(state.diag, cand, found)
        with _span(spans, "part_b.verify"):
            state = _verify_and_apply(state._replace(diag=diag), k, cand, yaw, spec, mesh,
                                      spans)
    return state


def raw_state(spec: DevSpec, cloud0: Cloud, cfg: SlamConfig) -> DevState:
    """Fresh engine state on `cloud0`'s device with odometry seeded from the
    first scan, before keyframe 0 is stored."""
    dev = cloud0.xyz.device
    filt = filter_scan(cloud0, spec.fcfg)
    odom0 = odometry.init_state(spec.ospec, torch.zeros(6, device=dev),
                                filt.xyz, filt.mask)

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return DevState(
        odom=odom0,
        db=empty_db(cfg, spec.kf_points, dev),
        graph=pg.empty_graph(spec.gspec, dev),
        kf_accum=z(), travel=z(), last_kf_odom=z(6),
        loop_count=z(dtype=torch.int64),
        scan_count=z(dtype=torch.int64), kf_count=z(dtype=torch.int64),
        imu_vel=z(3), last_stamp=z(),
        log=z(spec.log_capacity, LOG_COLS),
        diag=_diag_reset().to(dev),
    )


def init_state(spec: DevSpec, cloud0: Cloud, stamp0: float, cfg: SlamConfig) -> DevState:
    """Seed odometry with the first scan and store keyframe 0 (the host
    pipeline's first-scan path). Keyframe 0 detects nothing, so under a mesh
    every rank runs this as it is, with no collective (the reference's
    `_mesh_seed`)."""
    state = raw_state(spec, cloud0, cfg)
    filt = filter_scan(cloud0, spec.fcfg)
    pose0 = torch.zeros(6, device=cloud0.xyz.device)
    state = _add_keyframe_branch(state, filt, pose0, float(stamp0), 0.0, 0.0,
                                 False, spec)
    state.log[0] = torch.tensor([0.0] * 6 + [0.0, 0.0, 1.0, 1.0, float(stamp0)]
                                + list(_DIAG_RESET))
    state.scan_count.fill_(1)
    state.kf_count.fill_(1)
    state.last_stamp.fill_(float(stamp0))
    return state


@contextlib.contextmanager
def _sync_debug_mode(mode: str):
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _map_windows(wins: GuessWindows | None, fn) -> GuessWindows | None:
    """`fn` applied to every tensor of the windows (None stays None)."""
    if wins is None:
        return None
    return GuessWindows(*(None if w is None else type(w)(*map(fn, w)) for w in wins))


def _assign(dst, src) -> None:
    """Copy the tensors of `src` into those of `dst` in place (both nested
    tuples of tensors). A source that is itself one of the destinations is
    copied aside first."""
    pairs = []

    def walk(d, s):
        if d is None or isinstance(d, torch.Tensor):
            pairs.append((d, s))
        else:
            for dd, ss in zip(d, s):
                walk(dd, ss)

    walk(dst, src)
    pairs = [(d, s) for d, s in pairs if d is not None]
    held = {d.data_ptr() for d, _ in pairs}
    pairs = [(d, s.clone() if s.data_ptr() in held and s is not d else s)
             for d, s in pairs]
    for d, s in pairs:
        if s is not d:
            d.copy_(s)


def _state_tensors(state: DevState) -> tuple:
    """The tensors of `state` that Part B's graphs read or write."""
    return (*state.db[:-1], *state.graph, state.loop_count, state.diag, state.log)


def _captured(fn, stream: torch.cuda.Stream) -> torch.cuda.CUDAGraph:
    """`fn` captured as a CUDA graph on `stream` (thread-local: the staging
    threads go on copying), in a private memory pool. Unlike
    `torch.cuda.graph` it neither synchronises the device nor empties the
    caches: the engine captures in the middle of a session."""
    graph = torch.cuda.CUDAGraph()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("default")
    try:
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                fn()
            except BaseException:
                with contextlib.suppress(Exception):
                    graph.capture_end()
                raise
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    return graph


class _PartBGraphs:
    """Part B's keyframe branch as chains of CUDA graphs over one state's
    tensors (the graph route of `DeviceSlamPipeline`). Each chain runs
    eagerly at its first use and is captured after it; later keyframes
    replay it. The chains, in a keyframe's order:

    - `store`: the subsample, the descriptors, the between factor and the
      optimized-pose chain, the store's and the graph's writes (GPS a masked
      write), the diagnostics reset;
    - `retrieve` (Scan Context, radius): the retrieval, the candidate and the
      diagnostics' retrieval columns. ISC's retrieval scores only the rows
      older than the query, a shape that grows every keyframe, so it stays
      eager and writes the candidate with `set_candidate`;
    - `verify`: the 2-D gate, the submap, the initial transform, copied into
      the ICP graph's static buffers (the ICP graph is replayed next);
    - `accept`: the ICP result, acceptance, the masked loop-table writes,
      `loop_count`, the solve's run flag, copied into the Gauss-Newton
      graph's static buffers (its iterations are replayed next);
    - `tail`: the solve's poses into `opt_poses`, the diagnostics into the
      scan's log row, the verification counter.

    The static inputs are set per keyframe by `load` (and `slot`) with
    device fills and device-to-device copies: the keyframe index `k`, the
    scan's log row and filtered cloud, the GPS altitude and its valid bit,
    the log slot. Every state tensor is updated in place, so the graphs stay
    valid while `bound_to` the state."""

    STORE, DETECT = ("store",), ("retrieve", "verify", "accept", "tail")

    def __init__(self, state: DevState, spec: DevSpec, like: Cloud,
                 diag_reset: torch.Tensor, verifications: torch.Tensor):
        dev = like.xyz.device
        self.st, self.spec = state, spec
        self._bound = _state_tensors(state)
        self.diag_reset, self.verifications = diag_reset, verifications
        self.k = torch.zeros((), dtype=torch.int64, device=dev)
        self.slot = torch.zeros((), dtype=torch.int64, device=dev)
        self.row = torch.zeros(LOG_COLS + 1, device=dev)
        self.filt = Cloud(*(torch.zeros_like(t) for t in like))
        self.gps = torch.zeros((), device=dev)
        self.gps_ok = torch.zeros((), dtype=torch.bool, device=dev)
        self.cand = torch.zeros((), dtype=torch.int64, device=dev)
        self.yaw = torch.zeros((), device=dev)
        self.icp = self.gn = None
        if spec.method != "none":
            self.icp = icp.align_graph(state.db.clouds.shape[1], spec.submap_points,
                                       spec.icpspec, dev)
            self.gn = pg.gn_graph(state.graph, pg.inloop_spec(spec.gspec), dev)
            icp.live_counter(dev)
        self.graphs = {}
        self._handed = {}        # what a chain hands the next: verify's, accept's
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def bound_to(self, state: DevState) -> bool:
        return all(a is b for a, b in zip(self._bound, _state_tensors(state)))

    def variants(self, detect: bool) -> list:
        """The chains a keyframe runs, a variant each: the store, and at a
        detection keyframe the detection chain (less ISC's retrieval)."""
        if not detect:
            return [self.STORE]
        return [self.STORE, self.DETECT[1:] if self.spec.method == "isc" else self.DETECT]

    def load(self, k: int, filt: Cloud, row: torch.Tensor, gps_alt: float,
             gps_valid: bool) -> None:
        """The keyframe's static inputs: `k` a fill, its log row and filtered
        cloud copies on the device, the GPS altitude and valid bit fills."""
        self.k.fill_(k)
        self.row.copy_(row)
        self.filt.xyz.copy_(filt.xyz)
        self.filt.mask.copy_(filt.mask)
        if self.spec.method == "isc":
            self.filt.intensity.copy_(filt.intensity)
        if self.spec.use_gps:
            self.gps.fill_(gps_alt)
            self.gps_ok.fill_(gps_valid)

    def step(self, name: str) -> bool:
        """Chain `name`: a replay once captured (True), else run eagerly."""
        graph = self.graphs.get(name)
        if graph is None:
            getattr(self, "_" + name)()
            return False
        graph.replay()
        return True

    def capture(self, chain) -> None:
        for name in chain:
            self.graphs[name] = _captured(getattr(self, "_" + name), self._stream)

    # the chains: the eager route's helpers on the static inputs
    def _store(self) -> None:
        st, spec, filt, row = self.st, self.spec, self.filt, self.row
        k = self.k.reshape(1)
        pose = row[:6]
        cxyz, cmask, _src_idx = subsample_cloud(filt.xyz, filt.mask, spec.kf_points)
        sc_desc = sc.make_descriptor(filt.xyz, filt.mask, spec.scspec)
        isc_desc = None
        if spec.method == "isc":
            isc_desc = isc_ops.make_descriptor(filt.xyz, filt.intensity, filt.mask,
                                               spec.iscspec)
        Z, opt_pose = _chain_pose(st.db, k - 1, pose)
        st.graph.between_T.index_copy_(0, k, Z[None])
        _add_keyframe(st.db, pose, row[10], row[LOG_COLS], cxyz, cmask, sc_desc, isc_desc,
                      opt_pose, k=k)
        st.graph.kf_mask.index_fill_(0, k, True)
        if spec.use_gps:
            _masked_put(st.graph.gps_alt, k, self.gps_ok, self.gps)
            _masked_put(st.graph.gps_mask, k, self.gps_ok, True)
        st.diag.copy_(self.diag_reset)

    def _retrieve(self) -> None:
        self.set_candidate(*_detect_candidate(self.st, self.k, self.row[10], self.spec))

    def set_candidate(self, cand, found, yaw) -> None:
        cand, diag = _candidate_diag(self.st.diag, cand, found)
        self.cand.copy_(cand)
        self.yaw.copy_(yaw)
        self.st.diag.copy_(diag)

    def _verify(self) -> None:
        db, k = self.st.db, self.k
        do_verify, tgt_xyz, tgt_mask, T_init = _verify_gate(db, k, self.cand, self.yaw,
                                                            self.spec)
        self.icp.load(_row(db.clouds, k), _row(db.cloud_mask, k), tgt_xyz, tgt_mask, T_init,
                      do_verify)
        self._handed["verify"] = (T_init, do_verify)

    def _accept(self) -> None:
        st = self.st
        T_init, do_verify = self._handed["verify"]
        loop_count, diag, run = _accept_loop(st, self.k, self.cand, self.icp.result(), T_init,
                                             do_verify, self.spec)
        st.loop_count.copy_(loop_count)
        st.diag.copy_(diag)
        self.gn.load(st.db.opt_poses, st.graph, run)
        self._handed["accept"] = run

    def _tail(self) -> None:
        st = self.st
        opt_poses = st.db.opt_poses
        opt_poses.copy_(self.gn.result(opt_poses, st.graph, self._handed["accept"]))
        self.verifications.add_(st.diag[4])
        slot = self.slot.reshape(1)
        row = st.log.index_select(0, slot)
        row[0, 11:LOG_COLS] = st.diag
        st.log.index_copy_(0, slot, row)


_SERIALS = itertools.count()     # the pipelines of the process, in the spans' chunk ids
OLD_STAGES = ("part_a_enqueue", "readback_wait", "part_b")
# Part A's phases: the pairs of its graph's four timing events
PART_A_PHASES = (("device.part_a.filter", 0, 1), ("device.part_a.align", 1, 2),
                 ("device.part_a.map", 2, 3))


class DeviceSlamPipeline:
    """Host shell around the device step: feed staged clouds, read results at
    the end. After `finalize()` it exposes the `.db/.graph/.loop_count/
    .kf_count/.odom_log/.loops` surface that `io/export.save_run` reads."""

    def __init__(self, cfg: SlamConfig, kf_points: int = 4096,
                 log_capacity: int = 8192, device: torch.device | str | None = None,
                 use_graph: bool | None = None, check_sync: bool = False, mesh=None):
        """`device` defaults to "cuda", or to the mesh's device. `use_graph`
        (default: on a CUDA device without a mesh) replays Part A of a scan
        as one CUDA graph, captured after the first scan has run eagerly,
        and Part B as its chains' graphs (`_PartBGraphs`; counted by
        `part_b_replays` and `part_b_captures`).
        `check_sync` runs every chunk, Part B included, under
        `torch.cuda.set_sync_debug_mode("error")` but for its one readback:
        it raises on a host synchronisation that PyTorch makes (it cannot see
        one made through `ctypes`). With `mesh` (this rank's
        `parallel.distributed.Mesh`) the engine runs the session on every
        rank of the group, its hot ops sharded (see the module's docstring);
        the capacities must divide by the mesh's size, and neither
        `use_graph` nor `check_sync` is taken (the sharded ops read back)."""
        if cfg.loop.method not in ("sc", "isc", "radius", "none"):
            raise ValueError(f"unknown loop.method {cfg.loop.method!r}")
        # the reference's device engine has neither: both run in the host
        # engine (`SlamPipeline`)
        if cfg.loop.async_detect:
            raise ValueError("loop.async_detect: the device engine has no loop worker "
                             "(the reference's has none); use the host engine")
        if cfg.filter.detect_ground:
            raise ValueError("filter.detect_ground: the device engine has no ground path "
                             "(the reference's has none); use the host engine")
        self.cfg = cfg
        self.mesh = mesh
        self.device = torch.device("cuda" if device is None else device)
        if mesh is not None:
            if use_graph:
                raise ValueError("use_graph: Part A under a mesh runs eagerly, not as a CUDA "
                                 "graph (the sharded align reads back a pass, and a gloo "
                                 "collective is a host call)")
            if check_sync:
                raise ValueError("check_sync: the mesh engine's sharded ops synchronise "
                                 "with the host (a readback a pass, a trip, a collective)")
            for name, val in (("filter.max_points", cfg.filter.max_points),
                              ("kf_points", kf_points),
                              ("pgo.max_keyframes", cfg.pgo.max_keyframes),
                              ("pgo.max_loops", cfg.pgo.max_loops)):
                if val % mesh.size != 0:
                    raise ValueError(f"{name} ({val}) must be divisible by the mesh size "
                                     f"({mesh.size}) for sharded compute")
            if device is not None and self.device.type != mesh.device.type:
                raise ValueError(f"device {self.device}: the mesh's rank computes on "
                                 f"{mesh.device}")
            self.device = mesh.device
            use_graph = False
        self.spec = spec_from_config(cfg, kf_points, log_capacity)
        self.use_graph = (self.device.type == "cuda") if use_graph is None else use_graph
        self.check_sync = check_sync and self.device.type == "cuda"
        # sub-spec aliases shared with SlamPipeline (io/export reads
        # pipe.gspec for the g2o information matrices)
        self.gspec = self.spec.gspec
        self.scspec = self.spec.scspec
        self.iscspec = self.spec.iscspec
        self.icpspec = self.spec.icpspec
        self.ospec = self.spec.ospec
        self.kf_points = kf_points
        self.state: DevState | None = None
        self._diag_reset_dev = _diag_reset().to(self.device)
        # Part A as a CUDA graph: static inputs, the graph, its outputs, and
        # the kernel launches one replay makes
        self._graph = None
        self._in = None
        self._out = None
        self._replay_launches = {}
        self._eager_scans = 0
        self.part_a_replays = 0
        # Part B as CUDA graphs (same condition as Part A's: a CUDA device,
        # no mesh, use_graph), bound to the state; the replays of its own
        # graphs and its captures (a variant a capture: the store, the
        # detection chain)
        self._graph_part_b = self.use_graph and self.device.type == "cuda"
        self._part_b = None
        self.part_b_replays = 0
        self.part_b_captures = 0
        self.chunk_readbacks = 0
        # the spans of the engine (module docstring); Part A's timing events
        # (recorded only while the graph is captured) and their device seconds
        self.serial = next(_SERIALS)
        self.spans = profiling.Spans(cuda=self.device.type == "cuda" and mesh is None)
        self._chunks = 0
        self._marks = None
        self._phase_events = None
        self._device_seconds = {}
        # ICP verifications run: a device counter during the run, a host int
        # after finalize()
        self._verifications = None
        self.icp_verifications = 0
        # log-wrap protection: the device log is a ring of log_capacity rows.
        # The host archives the ring before a feed would overwrite rows not
        # yet archived; size log_capacity to the run to avoid the readback.
        self._scans_fed = 0
        self._archived = 0
        self._log_archive: list[np.ndarray] = []
        self._warned_wrap = False
        # filled by finalize()
        self.db = None
        self.graph = None
        self.loop_count = 0
        self.kf_count = 0
        self.scan_count = 0
        self.odom_log: list[dict] = []
        self.loops: list = []

    @property
    def stage_seconds(self) -> dict:
        """Host seconds by span name (`self.<name>`: self seconds), with
        `OLD_STAGES` always present (Part A's enqueue, the wait in the
        chunk's readback for the card to finish Part A, Part B's enqueue),
        and Part A's device seconds by phase with `device.samples` where
        sampled."""
        return {**dict.fromkeys(OLD_STAGES, 0.0), **self.spans.totals(),
                **self._device_seconds}

    def _read_part_a_phases(self) -> None:
        """Add the last replay's three phase intervals (its events passed: the
        chunk's readback waited for every replay)."""
        ev, dev = self._phase_events, self._device_seconds
        for key, a, b in PART_A_PHASES:
            dev[key] = dev.get(key, 0.0) + 1e-3 * ev[a].elapsed_time(ev[b])
        dev["device.samples"] = dev.get("device.samples", 0) + 1

    # ------------------------------------------------------------ Part A -- #
    def _part_a(self, cloud: Cloud, stamp: torch.Tensor, win: GuessWindows | None = None):
        """One scan's every-scan half, with no host synchronisation (under a
        mesh, but for the sharded align's): updates Part A's state in place
        and returns (filtered cloud, row [17]: the log row's 16 columns and
        the travel). `win` holds the scan's windows where a guess mode is
        on."""
        st, spec = self.state, self.spec
        marks = self._marks
        if marks is not None:
            marks[0].record()
        filt = filter_scan(cloud, spec.fcfg)
        if marks is not None:
            marks[1].record()
        ext_delta = use_ext = None
        imu_vel = st.imu_vel
        if spec.use_imu or spec.use_odom:
            ext_delta, use_ext, imu_vel = imu_ops.ext_guess(
                st.odom.pose, win.imu, win.wheel, st.imu_vel, spec.use_imu, spec.use_odom)
        new_odom, out = odometry.step(st.odom, filt.xyz, filt.mask, spec.ospec,
                                      ext_delta, use_ext, on_device=True, mesh=self.mesh,
                                      align_event=None if marks is None else marks[2])
        pose = out.pose
        if spec.use_imu:
            # reset the IMU velocity from the SLAM delta every scan: pure
            # double integration is a velocity random walk. The divisor is a
            # 0-d tensor: CUDA division by a Python scalar multiplies by its
            # reciprocal
            dt = stamp - st.last_stamp
            vel_slam = (pose[:3] - st.odom.pose[:3]) / torch.clamp(dt, min=1e-6)
            imu_vel = torch.where(dt > 1e-6, vel_slam, imu_vel)
        step_d = torch.linalg.norm(pose[:2] - st.odom.pose[:2])
        kf_accum = st.kf_accum + step_d
        travel = st.travel + step_d
        is_kf = (kf_accum >= spec.keyframe_gap) & (st.kf_count < st.db.poses.shape[0])
        f32 = torch.float32
        row = torch.cat([
            pose,
            torch.stack([out.iterations.to(f32), out.fitness.to(f32),
                         out.matched_frac.to(f32), is_kf.to(f32), stamp]),
            self._diag_reset_dev, travel[None]])
        slot = (st.scan_count % spec.log_capacity).reshape(1)
        st.log.index_copy_(0, slot, row[None, :LOG_COLS])
        _assign((st.odom, st.kf_accum, st.travel, st.last_kf_odom, st.last_stamp,
                 st.imu_vel if spec.use_imu else None),
                (new_odom, torch.where(is_kf, torch.zeros_like(kf_accum), kf_accum),
                 travel, torch.where(is_kf, pose, st.last_kf_odom), stamp, imu_vel))
        st.kf_count.add_(is_kf.to(torch.int64))
        st.scan_count.add_(1)
        if marks is not None:
            marks[3].record()
        return filt, row

    def _capture(self, like: Cloud, win: GuessWindows | None, phase_events: bool = True) -> None:
        """Capture Part A of one scan as a CUDA graph over static inputs (the
        windows among them where a guess mode is on), with the four timing
        events of its phases as event nodes (`phase_events`: off only to
        measure what the nodes cost a replay)."""
        self._in = (Cloud(*(torch.zeros_like(t) for t in like)),
                    torch.zeros((), device=self.device), _map_windows(win, torch.zeros_like))
        counts = {"ndt": ndt_kernel.launches, "nn": nn_kernel.launches,
                  "guess": guess_kernel.launches}
        graph = torch.cuda.CUDAGraph()
        # entering a capture synchronises the device, once: not Part A's doing
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("default")
        try:
            # thread-local: the staging threads go on copying while this thread captures
            if phase_events:
                self._marks = [torch.cuda.Event(enable_timing=True, external=True)
                               for _ in range(4)]
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._out = self._part_a(*self._in)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
            self._phase_events, self._marks = self._marks, None
        # a capture records launches, it makes none: a replay makes them
        self._replay_launches = {"ndt": ndt_kernel.launches - counts["ndt"],
                                 "nn": nn_kernel.launches - counts["nn"],
                                 "guess": guess_kernel.launches - counts["guess"]}
        ndt_kernel.launches, nn_kernel.launches = counts["ndt"], counts["nn"]
        guess_kernel.launches = counts["guess"]
        self._graph = graph

    def _run_part_a(self, cloud: Cloud, stamp: torch.Tensor, win: GuessWindows | None = None):
        """Part A of one scan, eagerly or as a graph replay; returns tensors
        of its own (a replay's outputs are copied out of the graph's)."""
        if not self.use_graph or (self._graph is None and self._eager_scans < 1):
            # on a graph engine the first scan runs eagerly: it warms every lazy start
            self._eager_scans += 1
            with self.spans.span("part_a.eager"):
                return self._part_a(cloud, stamp, win)
        if self._graph is None:
            with self.spans.span("part_a.capture"):
                self._capture(cloud, win)
        with self.spans.span("part_a.replay"):
            _assign(self._in, (cloud, stamp, win))
            self._graph.replay()
            self.part_a_replays += 1
            ndt_kernel.launches += self._replay_launches["ndt"]
            nn_kernel.launches += self._replay_launches["nn"]
            guess_kernel.launches += self._replay_launches["guess"]
            filt, row = self._out
            return Cloud(*(t.clone() for t in filt)), row.clone()

    # ------------------------------------------------------------- feeds -- #
    def process_scan(self, cloud, intensity=None, stamp: float = 0.0,
                     gps_alt: float | None = None, imu=None, wheel=None) -> None:
        """Feed one scan: a staged Cloud (io/prefetch.py) or raw points
        [n,3]. A chunk of one. `imu` / `wheel` (ops.imu.ImuWindow /
        OdomWindow) carry the sensor samples since the previous scan; with
        `odom.use_imu` / `odom.use_odom` they are integrated on the card into
        the NDT guess."""
        if not isinstance(cloud, Cloud):
            cloud = make_cloud(cloud, intensity, capacity=self.cfg.filter.max_raw_points,
                               device=self.device)
        clouds = Cloud(*(t[None] for t in cloud))
        alts = None if gps_alt is None else [gps_alt]
        wins = _map_windows(GuessWindows(imu, wheel), lambda t: torch.as_tensor(t)[None])
        self.process_chunk(clouds, [stamp], 1, gps_alts=alts, wins=wins)

    def process_chunk(self, clouds: Cloud, stamps, n_real: int, gps_alts=None,
                      wins: GuessWindows | None = None) -> None:
        """Feed a staged chunk (a Cloud batch [chunk,...] from
        io/prefetch.DeviceChunkPrefetcher). `stamps` is per slot [chunk];
        `n_real` ≤ chunk says how many slots hold real scans (a short final
        chunk); the others are skipped. `gps_alts` [chunk] holds NaN where a
        scan has no altitude. `wins` holds the windows of every slot (numpy
        arrays or CPU tensors with a leading [chunk] axis) for each guess
        mode that is on; they go to the card in one copy each."""
        chunk = clouds.xyz.shape[0]
        stamps = np.asarray(stamps, np.float32)
        if gps_alts is None:
            alts = np.full((chunk,), np.nan, np.float32)
        else:
            alts = np.asarray(gps_alts, np.float32)
        if chunk > self.spec.log_capacity:
            raise ValueError(f"chunk ({chunk}) exceeds log_capacity "
                             f"({self.spec.log_capacity}): rows would be lost mid-feed")
        n_real = int(n_real)
        self.spans.chunk = (self.serial, self._chunks)
        self._chunks += 1
        with self.spans.span("chunk"):
            first = 0
            if self.state is None:
                if n_real < 1:
                    return
                cloud0 = Cloud(*(t[0] for t in clouds))
                with self.spans.span("session.seed"):
                    self.state = init_state(self.spec, cloud0, float(stamps[0]), self.cfg)
                self._scans_fed = 1
                first = 1
            self._reserve_log(n_real - first)
            if n_real <= first:
                return
            stamps_h = torch.from_numpy(stamps)
            wins_h = self._host_windows(wins, chunk)
            if self.device.type == "cuda":
                stamps_h = stamps_h.pin_memory()
                wins_h = _map_windows(wins_h, lambda t: t.pin_memory())
            with self._sync_check():
                self._chunk(clouds, stamps_h, alts, first, n_real, wins_h)

    def _host_windows(self, wins: GuessWindows | None, chunk: int) -> GuessWindows | None:
        """The windows of the modes that are on, as contiguous CPU tensors
        [chunk, ...]; None where no mode is on. A mode that is on needs its
        windows: they are inputs of Part A's graph."""
        spec = self.spec
        if not (spec.use_imu or spec.use_odom):
            return None
        out = []
        for on, name, key, cls in ((spec.use_imu, "imu", "odom.use_imu", imu_ops.ImuWindow),
                                   (spec.use_odom, "wheel", "odom.use_odom",
                                    imu_ops.OdomWindow)):
            w = None if wins is None else getattr(wins, name)
            if not on:
                out.append(None)
                continue
            if w is None:
                raise ValueError(f"{key} is on: the feed needs the {name} windows")
            w = cls(*(torch.as_tensor(t).contiguous() for t in w))
            if any(t.shape[0] != chunk for t in w):
                raise ValueError(f"the {name} windows hold {w.stamps.shape[0]} slots, "
                                 f"the chunk {chunk}")
            out.append(w)
        return GuessWindows(*out)

    def _sync_check(self, mode: str = "error"):
        """Sync debug mode `mode` inside the block where `check_sync` is on."""
        if not self.check_sync:
            return contextlib.nullcontext()
        return _sync_debug_mode(mode)

    def _chunk(self, clouds: Cloud, stamps_h, alts, first: int, n_real: int,
               wins_h: GuessWindows | None = None) -> None:
        """Part A of the real slots, the chunk's one readback, then Part B of
        the flagged slots, in scan order, on the card."""
        # Part A for every real slot, nothing read back
        stamps_d = stamps_h.to(self.device, non_blocking=True)
        wins_d = _map_windows(wins_h, lambda t: t.to(self.device, non_blocking=True))
        replays = self.part_a_replays
        with self.spans.span("part_a_enqueue"):
            slots = [self._run_part_a(Cloud(*(t[s] for t in clouds)), stamps_d[s],
                                      _map_windows(wins_d, lambda t: t[s]))
                     for s in range(first, n_real)]
            rows_d = torch.stack([row for _filt, row in slots])
        # the one readback of the chunk; after it every event recorded before
        # it has passed
        with self.spans.span("readback_wait"):
            with self._sync_check("default"):
                rows = rows_d.cpu().numpy()
                if self._phase_events is not None and self.part_a_replays > replays:
                    self._read_part_a_phases()
                rec = profiling.active_recording()
                if rec is not None:
                    rec.resolve()
            self.chunk_readbacks += 1
            if self.mesh is not None:
                self._check_ranks_agree(rows_d, first, n_real)

        # Part B, in scan order, for the flagged slots: the keyframe rows and
        # stamps are host values from the readback, every decision below the
        # retrieval a tensor on the card
        with self.spans.span("part_b"):
            if self._verifications is None:
                self._verifications = torch.zeros((), device=self.device)
            for j, (filt, _r) in enumerate(slots):
                if rows[j, 9] <= 0.5:
                    continue
                s = first + j
                slot = (self._scans_fed + j) % self.spec.log_capacity
                gps_alt, gps_valid = float(np.nan_to_num(alts[s])), bool(np.isfinite(alts[s]))
                if self._graph_part_b and self.state.db.count >= 1:
                    self._keyframe_on_graphs(filt, rows_d[j], float(rows[j, 10]), gps_alt,
                                             gps_valid, slot)
                    continue
                self.state = _add_keyframe_branch(
                    self.state._replace(diag=self._diag_reset_dev.clone()), filt,
                    rows_d[j, :6], float(rows[j, 10]), float(rows[j, LOG_COLS]),
                    gps_alt, gps_valid, self.spec, self.mesh, self.spans)
                self._verifications += self.state.diag[4]
                self.state.log[slot, 11:LOG_COLS] = self.state.diag
            self._scans_fed += n_real - first

    def _keyframe_on_graphs(self, filt: Cloud, row: torch.Tensor, stamp: float,
                            gps_alt: float, gps_valid: bool, slot: int) -> None:
        """Part B of one keyframe (k ≥ 1) as replays of `_PartBGraphs`' chains
        with the ICP and Gauss-Newton graphs replayed between them: one replay
        a store-only keyframe, five (four with ISC) and the ICP and
        Gauss-Newton graphs' a detection keyframe. A chain's first use runs
        eagerly; the variants it completes are captured after it (span
        `part_b.capture`). The results are the eager route's bit for bit: the
        same helpers on the same values, in the same order. A store-only
        keyframe skips the eager route's diagnostics write and counter add:
        they rewrite Part A's reset values and add 0."""
        spec, spans = self.spec, self.spans
        st = self.state
        b = self._part_b
        if b is None or not b.bound_to(st):
            b = self._part_b = _PartBGraphs(st, spec, filt, self._diag_reset_dev,
                                            self._verifications)
        k = st.db.count
        detect = spec.method != "none" and k % spec.detect_period == 0
        with _span(spans, "part_b.store"):
            b.load(k, filt, row, gps_alt, gps_valid)
            self._part_b_step(b, "store")
        self.state = st._replace(db=st.db._replace(count=k + 1))
        if detect:
            b.slot.fill_(slot)
            with _span(spans, "part_b.retrieve"):
                if spec.method == "isc":
                    b.set_candidate(*_detect_candidate(self.state, k, stamp, spec))
                else:
                    self._part_b_step(b, "retrieve")
            with _span(spans, "part_b.verify"):
                self._part_b_step(b, "verify")
                b.icp.replay()
                self._part_b_step(b, "accept")
                with _span(spans, "part_b.solve"):
                    b.gn.iterate(pg.inloop_spec(spec.gspec).gn_iterations)
                    self._part_b_step(b, "tail")
        todo = [chain for chain in b.variants(detect) if chain[0] not in b.graphs]
        if todo:
            with spans.span("part_b.capture"):
                for chain in todo:
                    b.capture(chain)
                    self.part_b_captures += 1

    def _part_b_step(self, b: _PartBGraphs, name: str) -> None:
        if b.step(name):
            self.part_b_replays += 1

    def _check_ranks_agree(self, rows_d: torch.Tensor, first: int, n_real: int) -> None:
        """The rank agreement guard of a mesh: the chunk's log rows (its
        keyframe flags, poses and stamps among them), as bits, all-gathered
        in one collective and held to rank 0's. Every host decision of Part
        B comes from them; a rank that disagrees raises here, naming the
        chunk and the ranks, where it would otherwise deadlock in a later
        collective."""
        bits = rows_d.contiguous().view(torch.int32).reshape(1, -1)
        every = collectives.shard_allgather(bits, self.mesh).cpu()      # [D, n]
        bad = [r for r in range(1, self.mesh.size) if not torch.equal(every[r], every[0])]
        if bad:
            lo = self._scans_fed
            raise RuntimeError(
                f"mesh: chunk {self.chunk_readbacks} (scans {lo}-{lo + n_real - first - 1}): "
                f"ranks {bad} disagree with rank 0 on the chunk's keyframe flags and log rows")

    def restore(self, state: DevState, scan_count: int) -> None:
        """Take `state` (a checkpoint's or a continuation's, on this
        pipeline's device) at a chunk boundary after `scan_count` scans: the
        host's count of scans fed follows it, and the ring's rows older than
        its capacity are not in it. The next chunk seeds nothing, and captures
        Part A's and Part B's graphs again."""
        self.state = state
        self._scans_fed = scan_count
        self._archived = max(0, scan_count - self.spec.log_capacity)
        self._log_archive = []
        # the graphs hold the old state's addresses: captured again on it
        self._graph = None
        self._part_b = None

    def _reserve_log(self, n_new: int) -> None:
        """Archive device log rows to the host before a feed of `n_new` scans
        would overwrite rows not yet archived (ring wrap)."""
        cap = self.spec.log_capacity
        if self._scans_fed + n_new - self._archived <= cap:
            return
        if not self._warned_wrap:
            warnings.warn(
                f"device log capacity ({cap}) is smaller than the run; archiving "
                f"rows to host mid-run (costs a device readback: set "
                f"log_capacity >= the expected scan count to avoid it)",
                RuntimeWarning, stacklevel=3)
            self._warned_wrap = True
        log = self.state.log.cpu().numpy().copy()   # on the CPU `.cpu()` is a view
        self._log_archive.extend(
            log[t % cap] for t in range(self._archived, self._scans_fed))
        self._archived = self._scans_fed

    # ----------------------------------------------------------- results -- #
    def finalize(self) -> None:
        """Final full-strength pose-graph solve and one compact readback of
        the small fields (counters, log, loop table); the keyframe clouds and
        descriptor stores stay on the device. Under a mesh every rank runs
        the single-device solve, with no collective (the reference runs it
        outside its `shard_map`)."""
        self.spans.chunk = (self.serial, None)
        with self.spans.span("finalize"):
            self._finalize()

    def _finalize(self) -> None:
        st = self.state
        with self.spans.span("finalize.solve"):
            opt = pg.solve(st.db.opt_poses, st.graph, self.spec.gspec)
        with self.spans.span("finalize.readback"):
            self._read_results(st._replace(db=st.db._replace(opt_poses=opt)))
            rec = profiling.active_recording()
            if rec is not None:
                rec.resolve()

    def _read_results(self, st: DevState) -> None:
        """The compact readback of `finalize` (its counters checked against
        the host's) into the `save_run` surface."""
        self.state = st
        self.db = st.db
        self.graph = st.graph
        self.kf_count = st.db.count
        verifications = (torch.zeros((), device=self.device) if self._verifications is None
                         else self._verifications)
        counts = torch.stack([st.loop_count.to(torch.float32), st.scan_count.to(torch.float32),
                              st.kf_count.to(torch.float32), verifications]).cpu().tolist()
        self.loop_count, self.scan_count, kf_dev, self.icp_verifications = map(int, counts)
        if kf_dev != self.kf_count or self.scan_count != self._scans_fed:
            raise RuntimeError("the device's counters and the host's disagree: "
                               f"keyframes {kf_dev} / {self.kf_count}, "
                               f"scans {self.scan_count} / {self._scans_fed}")
        cap = self.spec.log_capacity
        host_log = st.log.cpu().numpy()
        tail = [host_log[t % cap] for t in range(self._archived, self.scan_count)]
        log = np.asarray(self._log_archive + tail, np.float32).reshape(-1, LOG_COLS)
        self.odom_log = [
            {"stamp": float(r[10]), "pose": r[:6],
             "iterations": int(r[6]), "fitness": float(r[7]),
             "matched_frac": float(r[8]), "keyframe": bool(r[9] > 0.5),
             # the loop accept / reject decisions as data
             "loop_cand": int(r[11]), "loop_found": bool(r[12] > 0.5),
             "loop_icp_fitness": float(r[13]),
             "loop_icp_correction": float(r[14]),
             "loop_verify_ran": bool(r[15] > 0.5)}
            for r in log
        ]
        loop_i = st.graph.loop_i.cpu().numpy()
        loop_j = st.graph.loop_j.cpu().numpy()
        loop_info = st.graph.loop_info.cpu().numpy()
        self.loops = [
            LoopRecord(i=int(loop_i[q]), j=int(loop_j[q]),
                       fitness=float(1.0 / max(loop_info[q], 1e-9)),
                       method=self.spec.method)
            for q in range(self.loop_count)
        ]

    def keyframe_trajectory(self):
        """(stamps, odometry poses6, optimized poses6) for live keyframes."""
        n = self.kf_count
        return (self.db.stamps[:n].cpu().numpy(), self.db.poses[:n].cpu().numpy(),
                self.db.opt_poses[:n].cpu().numpy())

    def odometry_trajectory(self) -> np.ndarray:
        return np.array([r["pose"] for r in self.odom_log], np.float32)

    def assemble_map(self, voxel: float = 0.5, max_points: int = 1 << 20) -> np.ndarray:
        return SlamPipeline.assemble_map(self, voxel, max_points)
