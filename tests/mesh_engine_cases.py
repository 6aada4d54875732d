"""Rank bodies of the mesh engine's tests (`tests/test_torch_mesh_engine.py`):
each runs on every rank of a group that
`xchu_slam_tpu_torch.parallel.distributed.launch` starts (fresh interpreters
that import torch and the port, never JAX), drives
`DeviceSlamPipeline(mesh=)` and returns numpy results, which the test
process compares with the JAX package, with the port's single-device engine
and across the ranks. The inputs arrive as numpy arrays made from seeds in
the test process."""

import numpy as np
import torch

from xchu_slam_tpu_torch import cli
from xchu_slam_tpu_torch.config import SlamConfig, default_config
from xchu_slam_tpu_torch.io.prefetch import DeviceChunkPrefetcher
from xchu_slam_tpu_torch.models import continue_session as cs, device_pipeline as dp
from xchu_slam_tpu_torch.models import pipeline, pose_graph as pg
from xchu_slam_tpu_torch.ops import ndt
from xchu_slam_tpu_torch.utils import checkpoint, collectives


def _np(x):
    return x.detach().cpu().numpy().copy()


def planted_state(cfg, planted: dict, kf_points: int, log_capacity: int):
    """The port's `DevState` from the planted store's arrays (`planted`:
    cloud [n,3], poses [K,6], stamps, travel)."""
    spec = dp.spec_from_config(cfg, kf_points=kf_points, log_capacity=log_capacity)
    K = len(planted["poses"])
    poses = torch.from_numpy(planted["poses"])
    db = pipeline.empty_db(cfg, kf_points)
    db.poses[:K] = poses
    db.opt_poses[:K] = poses
    db.stamps[:K] = torch.from_numpy(planted["stamps"])
    db.travel[:K] = torch.from_numpy(planted["travel"])
    db.clouds[:K] = torch.from_numpy(planted["cloud"])
    db.cloud_mask[:K] = True
    db = db._replace(count=K)
    graph = pg.empty_graph(spec.gspec)
    graph.between_T[:, 0, 3] = 2.0
    graph.kf_mask[:K] = True
    state = dp.DevState(
        odom=None, db=db, graph=graph, kf_accum=torch.zeros(()),
        travel=torch.tensor(float(planted["travel"][-1]) + 2.0),
        last_kf_odom=poses[-1].clone(), loop_count=torch.zeros((), dtype=torch.int64),
        scan_count=torch.tensor(K), kf_count=torch.tensor(K), imu_vel=torch.zeros(3),
        last_stamp=torch.zeros(()), log=torch.zeros((log_capacity, dp.LOG_COLS)),
        diag=torch.tensor(dp._DIAG_RESET))
    return spec, state


def verified(out) -> dict:
    g = out.graph
    return {"loop_count": int(out.loop_count), "loop_i": _np(g.loop_i), "loop_j": _np(g.loop_j),
            "loop_T": _np(g.loop_T), "loop_info": _np(g.loop_info),
            "loop_mask": _np(g.loop_mask), "opt_poses": _np(out.db.opt_poses),
            "diag": _np(out.diag)}


def planted_case(mesh, overrides: dict, planted: dict, k: int, cand: int) -> dict:
    """`_verify_and_apply` of keyframe k against `cand` on the planted store,
    sharded over the mesh, with the collectives it executed."""
    cfg = default_config().override(overrides)
    spec, state = planted_state(cfg, planted, kf_points=len(planted["cloud"]),
                                log_capacity=64)
    before = collectives.collectives
    out = dp._verify_and_apply(state, k, cand, 0.0, spec, mesh)
    return {**verified(out), "collectives": collectives.collectives - before}


def _feed(pipe, scans, stamps, chunk: int, capacity: int, device) -> None:
    base = 0
    with DeviceChunkPrefetcher(scans, capacity=capacity, chunk=chunk, depth=2, threads=2,
                               device=device) as pf:
        for clouds, n_real in pf:
            idx = np.minimum(base + np.arange(clouds.xyz.shape[0]), len(stamps) - 1)
            pipe.process_chunk(clouds, stamps[idx], n_real)
            base += n_real


def single_case(mesh, overrides: dict, scans: list, stamps, chunk: int, kf_points: int,
                log_capacity: int) -> dict:
    """The single-device engine on `scans` in a process of its own (the
    group's one rank leaves its mesh unused)."""
    cfg = default_config().override(overrides)
    pipe = dp.DeviceSlamPipeline(cfg, kf_points=kf_points, log_capacity=log_capacity,
                                 device=mesh.device)
    _feed(pipe, scans, stamps, chunk, cfg.filter.max_raw_points, mesh.device)
    pipe.finalize()
    return finished(pipe)


def finished(pipe) -> dict:
    """What a finished pipeline holds: the log rows, the keyframe store's
    small fields, the loop table, the counters."""
    n = pipe.scan_count
    db, g = pipe.db, pipe.graph
    return {"rows": _np(pipe.state.log[:n]), "kf_count": pipe.kf_count,
            "loop_count": pipe.loop_count, "scan_count": n,
            "odometry": pipe.odometry_trajectory(),
            "store": {k: _np(getattr(db, k)) for k in ("poses", "opt_poses", "stamps",
                                                        "travel", "clouds", "cloud_mask",
                                                        "sc_db", "isc_db")},
            "loops": {k: _np(getattr(g, k)) for k in ("loop_i", "loop_j", "loop_T",
                                                       "loop_info", "loop_mask")},
            "icp_verifications": pipe.icp_verifications}


def _state_arrays(state) -> dict:
    out = {}

    def walk(prefix, tree):
        if isinstance(tree, torch.Tensor):
            out[prefix] = _np(tree)
        elif isinstance(tree, int):
            out[prefix] = np.asarray(tree)
        elif tree is not None:
            for name, val in zip(tree._fields, tree):
                walk(f"{prefix}.{name}", val)

    walk("state", state)
    return out


def _recording_align(align, record: list):
    """`align` (`ndt.align`) that, on a mesh, also aligns the same inputs
    through the single-device route and records (mesh iterations,
    single-device iterations, max |Δpose|, max |Δpose| against the
    single-device route held to the mesh's iteration count) of every call.
    The last runs the single-device route with no convergence stop
    (trans_eps 0) for exactly the mesh's Newton iterations; where the two
    counts agree it is the third."""
    def recording(grid, xyz, mask, init, gspec, nspec, mesh=None):
        res = align(grid, xyz, mask, init, gspec, nspec, mesh=mesh)
        if mesh is not None:
            ref = ndt.align_ref(grid, xyz, mask, init, gspec, nspec)
            its, ref_its = int(res.iterations), int(ref.iterations)
            dpose = float((res.pose - ref.pose).abs().max())
            if its != ref_its:
                held = ndt.align_ref(grid, xyz, mask, init, gspec,
                                     nspec._replace(max_iterations=its, trans_eps=0.0))
                held_dpose = float((res.pose - held.pose).abs().max())
            else:
                held_dpose = dpose
            record.append((its, ref_its, dpose, held_dpose))
        return res

    return recording


def engine_case(mesh, overrides: dict, scans: list, stamps, chunk: int, kf_points: int,
                log_capacity: int, save_at: int, path: str, resume_chunks: int,
                cont_scans: list, cont_stamp: float) -> dict:
    """The whole engine over the mesh on `scans` (chunks of `chunk`), a
    checkpoint written after scan `save_at` (rank 0 writes `path`); with
    `resume_chunks`, the checkpoint restored on the mesh and fed that many
    chunks; with `cont_scans`, `continue_session` of the checkpoint on the
    mesh beside the single-device continuation on this rank (their seeded
    states compared here), then two chunks of the continued session. Every
    align of the first run is also made through the single-device route on
    the same inputs (`aligns`)."""
    cfg = default_config().override(overrides)
    dev = mesh.device
    cap = cfg.filter.max_raw_points
    pipe = dp.DeviceSlamPipeline(cfg, kf_points=kf_points, log_capacity=log_capacity,
                                 mesh=mesh)
    before = collectives.collectives
    aligns = []
    align, ndt.align = ndt.align, _recording_align(ndt.align, aligns)
    try:
        _feed(pipe, scans[:save_at], stamps[:save_at], chunk, cap, dev)
        checkpoint.save_checkpoint(pipe, path)
        _feed(pipe, scans[save_at:], stamps[save_at:], chunk, cap, dev)
    finally:
        ndt.align = align
    pipe.finalize()
    out = {"engine": finished(pipe), "collectives": collectives.collectives - before,
           "chunks": pipe.chunk_readbacks, "aligns": aligns}
    # every rank reads the file only after rank 0 has written it
    collectives.shard_allsum(torch.zeros(1, device=dev), mesh)
    if resume_chunks:
        again = checkpoint.load_checkpoint(path, mesh=mesh)
        hi = save_at + resume_chunks * chunk
        _feed(again, scans[save_at:hi], stamps[save_at:hi], chunk, cap, dev)
        again.finalize()
        out["resumed"] = {"rows": _np(again.state.log[save_at:hi]),
                          "scan_count": again.scan_count}
    if cont_scans:
        single = cs.continue_session(path, *cont_scans[0], stamp=cont_stamp,
                                     log_capacity=log_capacity, device=dev)
        cont = cs.continue_session(path, *cont_scans[0], stamp=cont_stamp,
                                   log_capacity=log_capacity, mesh=mesh)
        a, b = _state_arrays(cont.state), _state_arrays(single.state)
        n = len(cont_scans)
        _feed(cont, cont_scans[1:], cont_stamp + 0.1 * np.arange(1, n), chunk, cap, dev)
        cont.finalize()
        out["continued"] = {
            "seed_fields": sorted(a), "seed_differs": sorted(k for k in a if k not in b or
                                                            not np.array_equal(a[k], b[k])),
            "continuation": {k: v for k, v in cont.continuation.items()
                             if k != "reloc_pose"},
            **finished(cont)}
    return out


def library_run(mesh, cfg_json: str, scans: list, stamps, gps_alts, chunk: int) -> dict:
    """`DeviceSlamPipeline(mesh=)` with the config `cfg_json`, fed directly as
    `run-sim --engine device` feeds it (kf_points 4096, log capacity
    max(scans, 8192)): its pose hash as the CLI computes it."""
    cfg = SlamConfig.from_json(cfg_json)
    pipe = dp.DeviceSlamPipeline(cfg, kf_points=4096, log_capacity=max(len(scans), 8192),
                                 mesh=mesh)
    base = 0
    with DeviceChunkPrefetcher(scans, capacity=cfg.filter.max_raw_points, chunk=chunk,
                               depth=2, threads=2, device=mesh.device) as pf:
        for clouds, n_real in pf:
            idx = np.minimum(base + np.arange(clouds.xyz.shape[0]), len(scans) - 1)
            pipe.process_chunk(clouds, stamps[idx], n_real,
                               gps_alts=None if gps_alts is None else gps_alts[idx])
            base += n_real
    pipe.finalize()
    return {"pose_hash": cli.pose_hash(pipe), "kf_count": pipe.kf_count,
            "loop_count": pipe.loop_count}
