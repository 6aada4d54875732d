"""The mesh device engine of the port (`DeviceSlamPipeline(mesh=)`,
`odometry.step` / `chunk_step(mesh=)`, `load_checkpoint(mesh=)`,
`continue_session(mesh=)`, `run-sim` / `run-kitti --mesh N`,
`tools/torch_run_mp_spmd.py`) on groups of gloo ranks, against the JAX
package's mesh engine on a D-device mesh of the test process's virtual CPU
devices and against the port's single-device engine.

Each rank group is started by `parallel/distributed.launch` (fresh
interpreters, a `file://` store, every wait bounded) and runs its rank body
in `tests/mesh_engine_cases.py`; the groups and the single-device runs a
module needs are started once, in the background of the module's
fixtures, while the test process runs the JAX side. Inputs are made from
seeds with numpy. Tolerances are stated beside each assert; the whole
engine is held with the reference test's own bounds
(`tests/test_mesh_engine.py`), and the ranks bit for bit."""

import concurrent.futures
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

import mesh_engine_cases as cases
from xchu_slam_tpu import config as jconfig
from xchu_slam_tpu.io import prefetch as jprefetch
from xchu_slam_tpu.models import device_pipeline as jdp, pipeline as jpipe
from xchu_slam_tpu.models import pose_graph as jpg
from xchu_slam_tpu_torch import cli, config as tconfig, convert
from xchu_slam_tpu_torch.models import device_pipeline as tdp
from xchu_slam_tpu_torch.parallel import distributed
from xchu_slam_tpu_torch.utils import sim

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
AXIS = "data"
GROUP_TIMEOUT_S = 240          # every launch's bound
POOL = concurrent.futures.ThreadPoolExecutor(max_workers=4)

# the reference's mesh-engine test config (tests/test_mesh_engine.py::_cfg)
BASE = {
    "filter.max_raw_points": 4096, "filter.max_points": 2048,
    "filter.outlier_method": "none",
    "ndt.grid_x": 48, "ndt.grid_y": 48, "ndt.grid_z": 16,
    "pgo.max_keyframes": 64, "pgo.max_loops": 8,
    "pgo.odom_noise_trans": 1e-3, "pgo.odom_noise_rot": 1e-3,
    "loop.icp_fitness_thresh": 1.5, "loop.submap_half_width": 4, "loop.submap_points": 2048,
}
ISC = {**BASE, "loop.method": "isc", "loop.icp_fitness_thresh": 3.0}
CHUNK, KF_POINTS, LOG_CAP = 8, 1024, 128
SAVE_AT, RESUME_CHUNKS = 48, 2     # the checkpoint after scan 48, resumed for 2 chunks
CONT_SCANS, CONT_STAMP = 17, 100.0  # the continued session: its seed, then 2 chunks


def _launch(world, target, args):
    return distributed.launch(world, f"mesh_engine_cases:{target}", args,
                              timeout_s=GROUP_TIMEOUT_S, path=(HERE,))


def _background(world, target, args) -> concurrent.futures.Future:
    return POOL.submit(_launch, world, target, args)


def _jmesh(D):
    return JMesh(np.array(jax.devices()[:D]), (AXIS,))


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------ (a) planted verification -- #
def _planted():
    """The reference test's planted revisit (tests/test_mesh_engine.py:155-
    206): 12 keyframes 2 m apart on a line, all with one structured cloud
    of 2048 points, so that ICP must accept keyframe 11 against 10."""
    rng = np.random.default_rng(0)
    n = 2048
    g = np.c_[rng.uniform(-10, 10, (n // 2, 2)), rng.normal(0, 0.02, n // 2)]
    w1 = np.c_[rng.uniform(-10, 10, n // 4), np.full(n // 4, 6.0), rng.uniform(0, 3, n // 4)]
    m = n - n // 2 - n // 4
    w2 = np.c_[np.full(m, -8.0), rng.uniform(-10, 10, m), rng.uniform(0, 3, m)]
    K = 12
    poses = np.zeros((K, 6), np.float32)
    poses[:, 0] = np.arange(K) * 2.0
    return {"cloud": np.vstack([g, w1, w2]).astype(np.float32), "poses": poses,
            "stamps": (0.5 * np.arange(K)).astype(np.float32),
            "travel": (2.0 * np.arange(K)).astype(np.float32)}


PLANTED = {**BASE, "loop.max_correction": 5.0}


def _reference_planted_on_mesh(state, tspec, D):
    """The reference's `_verify_and_apply` under `shard_map` on a D-device
    JAX mesh, from the port's planted state carried through convert.py."""
    d = convert.dev_state_to_ref(state, tspec.ospec.gspec)
    as_j = lambda tree: {k: jnp.asarray(v) for k, v in tree.items()}  # noqa: E731
    jstate = jdp.DevState(
        odom=None, db=jpipe.KfDb(**as_j(d["db"])), graph=jpg.GraphData(**as_j(d["graph"])),
        **{k: jnp.asarray(d[k]) for k in ("kf_accum", "travel", "last_kf_odom", "loop_count",
                                          "scan_count", "imu_vel", "last_stamp", "log",
                                          "diag")})
    mesh = _jmesh(D)
    jspec = jdp.spec_from_config(jconfig.default_config().override(PLANTED),
                                 kf_points=2048, log_capacity=64, axis=AXIS)
    jstate = jax.device_put(jstate, NamedSharding(mesh, P()))
    f = jax.jit(shard_map(
        lambda s: jdp._verify_and_apply(s, jnp.int32(11), jnp.int32(10), jnp.float32(0.0),
                                        jspec),
        mesh=mesh, in_specs=(P(),), out_specs=P(), check_vma=False))
    return jax.tree.map(np.asarray, f(jstate))


@pytest.mark.parametrize("D", [2, 4])
def test_planted_verification_on_a_mesh(D):
    """The sharded ICP and the factor-sharded solve inside `_verify_and_apply`
    accept the loop 10 → 11 as the reference's shard_map does (loop_T and
    opt_poses[:12] within 5e-3 of it, the reference test's own bound) and as
    the port's single-device route does (within 1e-4); the ranks hold the
    same bits."""
    planted = _planted()
    ranks = _background(D, "planted_case", (PLANTED, planted, 11, 10))
    tcfg = tconfig.default_config().override(PLANTED)
    tspec, state = cases.planted_state(tcfg, planted, kf_points=2048, log_capacity=64)
    jout = _reference_planted_on_mesh(state, tspec, D)
    single = cases.verified(tdp._verify_and_apply(state, 11, 10, 0.0, tspec))
    ranks = ranks.result()
    r0 = ranks[0]
    for r in ranks[1:]:
        assert _same(r, r0)
    assert r0["loop_count"] == single["loop_count"] == int(jout.loop_count) == 1
    assert r0["loop_i"][0] == 10 and r0["loop_j"][0] == 11 and r0["loop_mask"][0]
    assert r0["diag"][4] == 1.0 and r0["collectives"] > 0
    np.testing.assert_allclose(r0["loop_T"][0], np.asarray(jout.graph.loop_T[0]), atol=5e-3)
    np.testing.assert_allclose(r0["opt_poses"][:12], np.asarray(jout.db.opt_poses[:12]),
                               atol=5e-3)
    np.testing.assert_allclose(r0["loop_T"][0], single["loop_T"][0], atol=1e-4)
    np.testing.assert_allclose(r0["opt_poses"][:12], single["opt_poses"][:12], atol=1e-4)


# ------------------------------------------------------- (b) whole engine -- #
@pytest.fixture(scope="module")
def revisit():
    """The reference test's 100-scan closed loop (tests/test_mesh_engine.py:
    105-112): the tail revisits the head, so retrieval, ICP and the solve
    fire. Stamped 0.1·i."""
    world = sim.make_world(3, extent=60.0, ground_pts=30000)
    gt = sim.loop_trajectory(n_scans=100, radius=12.0, speed=1.0)
    rng = np.random.default_rng(5)
    scans = [sim.render_scan(world, p, rng, n_points=3000) for p in gt]
    stamps = 0.1 * np.arange(len(scans))
    # a second session along the same path, noise of its own
    rng = np.random.default_rng(55)
    cont = [sim.render_scan(world, p, rng, n_points=3000) for p in gt[:CONT_SCANS]]
    return scans, stamps, cont


@pytest.fixture(scope="module")
def single_run(revisit):
    """The port's single-device engine on the revisit, in a process of its
    own (a group of one whose rank ignores its mesh), in the background."""
    scans, stamps, _ = revisit
    return _background(1, "single_case", (ISC, scans, stamps, CHUNK, KF_POINTS, LOG_CAP))


@pytest.fixture(scope="module")
def engine_runs(revisit, tmp_path_factory):
    """The mesh engine on the revisit at D = 2 (with the checkpoint's resume
    and the continuation) and D = 4, each group started in the background
    at first use."""
    scans, stamps, cont = revisit
    d = tmp_path_factory.mktemp("mesh_engine")
    futures = {}

    def get(D):
        if D not in futures:
            extra = (RESUME_CHUNKS, cont) if D == 2 else (0, [])
            futures[D] = _background(D, "engine_case", (
                ISC, scans, stamps, CHUNK, KF_POINTS, LOG_CAP, SAVE_AT,
                str(d / f"checkpoint_{D}.npz"), *extra, CONT_STAMP))
        return futures[D]

    return get


def _reference_engine(scans, D):
    """The reference's mesh engine (D devices) on the revisit, chunked as
    the reference test feeds it."""
    cfg = jconfig.default_config().override(ISC)
    pipe = jdp.DeviceSlamPipeline(cfg, kf_points=KF_POINTS, log_capacity=LOG_CAP,
                                  mesh=_jmesh(D))
    pf = jprefetch.DeviceChunkPrefetcher(scans, capacity=cfg.filter.max_raw_points,
                                         chunk=CHUNK, depth=2, threads=2)
    base = 0
    for clouds, n_real in pf:
        pipe.process_chunk(clouds, 0.1 * (base + np.arange(clouds.xyz.shape[0])), n_real)
        base += n_real
    pipe.finalize()
    return pipe


SAME_ITERS = 0.9      # share of aligns with the single-device route's Newton count
# m and rad, on those aligns: sum orders part an ill-conditioned align of
# these 3000-point scans by up to ~5e-4 at the same count, where the one
# well-conditioned align of tests/test_torch_parallel.py agrees to 1e-4 (the
# reference's own sharded-align test holds 5e-2 m and 2e-2 rad, to the truth)
ALIGN_TOL = 1e-3
# m and rad, on every align against the single-device route held to the
# mesh's Newton count: the NDT spec's trans_eps, the step its convergence
# test takes for none (a backtracking trial that flips with the sum order
# changes one step of the same count)
HELD_TOL = 1e-2
KF_TOL_M = 0.15       # the reference test's keyframe bound (tests/test_mesh_engine.py:101)
ODOM_TOL_M = 0.15     # the reference test's per-scan odometry bound (its :152), at D = 2


def _keyframes_at_common_stamps(a_stamps, a_opt, b_stamps, b_opt) -> np.ndarray:
    """|Δposition| of the optimized keyframes the two runs made at the same
    scan (a borderline gate flip shifts a keyframe by a scan)."""
    _, ia, ib = np.intersect1d(np.rint(a_stamps / 0.1), np.rint(b_stamps / 0.1),
                               return_indices=True)
    return np.linalg.norm(a_opt[ia, :3] - b_opt[ib, :3], axis=1)


@pytest.mark.parametrize("D", [2, 4])
def test_mesh_engine_matches_reference_and_single(D, revisit, single_run, engine_runs):
    """The whole engine, chunks of 8, ISC loops, at D ranks: the ranks'
    log rows, keyframe store and loop table equal bit for bit; against the
    reference's mesh engine at D devices and the port's single-device
    engine, the reference test's bounds: the same scan count, loops ≥ 1 and
    within ±1, keyframes within ±1, the loop-closed keyframe poses made at
    the same scan within 0.15 m, and at D = 2 the per-scan odometry within
    0.15 m. Every align of the session is also held against the
    single-device route on the same inputs: the same Newton count on ≥ 90 %
    and |Δpose| ≤ 1e-3 on those, and on every align |Δpose| ≤ 1e-2 against
    that route held to the mesh's count. (At D = 4 the chain parts from
    both by 0.21 m, every align of it agreeing to 2.1e-4 at the same count:
    a state that parted at the last ulp makes an ill-conditioned align stop
    elsewhere, and the chain carries that on; the reference's own mesh
    engine parts from its single-device engine by 0.14 m at D = 2.)"""
    scans, _, _ = revisit
    group = engine_runs(D)
    ref = _reference_engine(scans, D)
    single = single_run.result()[0]
    ranks = group.result()
    mine = ranks[0]["engine"]
    for r in ranks[1:]:
        assert _same(r["engine"], mine)
    assert ranks[0]["collectives"] > ranks[0]["chunks"]
    assert mine["scan_count"] == single["scan_count"] == ref.scan_count == len(scans)
    assert mine["loop_count"] >= 1 and single["loop_count"] >= 1
    n = mine["kf_count"]
    kf = (mine["store"]["stamps"][:n], mine["store"]["opt_poses"][:n])
    ref_stamps, _, ref_opt = ref.keyframe_trajectory()
    m = single["kf_count"]
    for other_kf, other_loops, other_stamps, other_opt in (
            (m, single["loop_count"], single["store"]["stamps"][:m],
             single["store"]["opt_poses"][:m]),
            (ref.kf_count, ref.loop_count, np.asarray(ref_stamps), np.asarray(ref_opt))):
        assert abs(n - other_kf) <= 1
        assert abs(mine["loop_count"] - other_loops) <= 1
        d = _keyframes_at_common_stamps(*kf, other_stamps, other_opt)
        assert len(d) > n // 2 and d.max() < KF_TOL_M, d.max()
    if D == 2:
        odo = mine["odometry"][:, :3]
        for other in (single["odometry"], ref.odometry_trajectory()):
            d = np.linalg.norm(odo - np.asarray(other)[:, :3], axis=1)
            assert d.max() < ODOM_TOL_M, d.max()
    aligns = np.asarray(ranks[0]["aligns"])
    assert len(aligns) == len(scans) - 1
    same = aligns[:, 0] == aligns[:, 1]
    assert same.mean() >= SAME_ITERS and aligns[same, 2].max() <= ALIGN_TOL, \
        (same.mean(), aligns[same, 2].max())
    assert aligns[:, 3].max() <= HELD_TOL, aligns[~same].tolist()


def test_mesh_checkpoint_resume_is_bit_identical(engine_runs):
    """A checkpoint of the D = 2 run after scan 48 (rank 0 writes it),
    restored on the mesh (`load_checkpoint(mesh=)`) and fed 2 chunks: its
    log rows equal the uninterrupted mesh run's, bit for bit, on every
    rank."""
    ranks = engine_runs(2).result()
    hi = SAVE_AT + RESUME_CHUNKS * CHUNK
    for r in ranks:
        assert r["resumed"]["scan_count"] == hi
        np.testing.assert_array_equal(r["resumed"]["rows"], r["engine"]["rows"][SAVE_AT:hi])


def test_continue_session_on_a_mesh(engine_runs):
    """`continue_session(mesh=)` of the D = 2 checkpoint: every rank's seeded
    state equals the single-device continuation's bit for bit (compared on
    the rank); then 2 chunks of the continued session, the ranks holding the
    same rows, store and loop table."""
    ranks = engine_runs(2).result()
    r0 = ranks[0]["continued"]
    for r in ranks:
        c = r["continued"]
        assert c["seed_differs"] == [], c["seed_differs"]
        assert len(c["seed_fields"]) > 20
        assert _same({k: c[k] for k in ("rows", "store", "loops", "continuation")},
                     {k: r0[k] for k in ("rows", "store", "loops", "continuation")})
    k0 = r0["continuation"]["old_keyframes"]
    assert r0["scan_count"] == CONT_SCANS and r0["kf_count"] > k0 + 1
    assert r0["loop_count"] >= 1          # the relocalization's loop factor


# ------------------------------------------------------------ (e) refusals -- #
def _no_group(size):
    """A mesh of `size` with no process group: enough for the constructor's
    checks, which run before any collective."""
    return distributed.Mesh(group=None, rank=0, size=size, backend="gloo",
                            device=torch.device("cpu"))


@pytest.mark.parametrize("field,over,kf_points", [
    ("filter.max_points", {}, 1023),
    ("kf_points", {"filter.max_points": 3072}, 1024),
    ("pgo.max_keyframes", {"filter.max_points": 3072}, 1023),
    ("pgo.max_loops", {"filter.max_points": 3072, "pgo.max_keyframes": 66}, 1023)])
def test_mesh_capacities_must_divide_by_the_mesh_size(field, over, kf_points):
    """Each capacity the mesh shards is refused by name where the mesh size
    does not divide it, in the reference's words (its constructor on a
    3-device mesh raises the same message)."""
    cfg = {**BASE, **over}
    with pytest.raises(ValueError) as port:
        tdp.DeviceSlamPipeline(tconfig.default_config().override(cfg), kf_points=kf_points,
                               mesh=_no_group(3))
    with pytest.raises(ValueError) as ref:
        jdp.DeviceSlamPipeline(jconfig.default_config().override(cfg), kf_points=kf_points,
                               mesh=_jmesh(3))
    assert str(port.value) == str(ref.value)
    assert str(port.value).startswith(f"{field} (")


@pytest.mark.parametrize("flag", ["use_graph", "check_sync"])
def test_mesh_refuses_graph_and_sync_check_by_name(flag):
    with pytest.raises(ValueError, match=flag):
        tdp.DeviceSlamPipeline(tconfig.default_config().override(BASE), kf_points=1024,
                               mesh=_no_group(2), **{flag: True})


@pytest.mark.parametrize("argv,want", [
    (["run-sim", "--engine", "host", "--mesh", "2"], "--mesh needs --engine device"),
    (["run-kitti", "--velodyne-dir", ".", "--mesh", "2"], "--mesh needs --engine device"),
    (["run-sim", "--engine", "device", "--mesh", "-1"], "--mesh must be >= 0")])
def test_cli_refuses_mesh_pairs_by_name(argv, want, capsys):
    with pytest.raises(SystemExit) as err:
        cli.main([*argv, "--device", "cpu"])
    assert err.value.code == 2
    assert want in capsys.readouterr().err


# ------------------------------------------------------------------ (f) CLI -- #
SMALL = ["--set", "filter.max_points=4096", "--set", "pgo.max_keyframes=64",
         "--set", "loop.submap_points=4096"]
CLI_SCANS = 12
# the circuit's flags of the CLI mesh runs
CLI_RUN = ["run-sim", "--scans", str(CLI_SCANS), "--radius", "20", "--device", "cpu",
           "--engine", "device", "--chunk", "5", "--gps", "--loop-method", "radius",
           "--mesh", "2", *SMALL]


@pytest.fixture(scope="module")
def library_mesh_run():
    """`DeviceSlamPipeline(mesh=)` on two ranks fed the CLI run's scans and
    altitudes directly: each rank's result, in the background."""
    overrides = [kv for kv in SMALL if kv != "--set"]
    cfg = cli.sim_config(overrides, "radius", gps=True)
    stamps, gt, world = cli._sim_world_and_traj(CLI_SCANS, 20.0, 0)
    lazy = sim.RenderedScans(world, gt, seed=0, n_points=24_000)
    _windows, alts = cli._sim_feeds(cfg, gt, stamps, np.random.default_rng(0))
    return _background(2, "library_run", (cfg.to_json(), [lazy[i] for i in range(len(gt))],
                                          stamps, alts, 5))


def test_cli_run_sim_on_a_mesh_is_the_library_mesh_run(library_mesh_run, tmp_path, capsys):
    """`run-sim --engine device --mesh 2 --device cpu` launches two ranks
    whose every pose equals `DeviceSlamPipeline(mesh=)` fed the same scans
    and altitudes directly (the pose hash, bit for bit); rank 0 alone wrote
    the export."""
    cli.main([*CLI_RUN, "--out", str(tmp_path)])
    summary = json.loads(capsys.readouterr().out)
    lib = library_mesh_run.result()
    assert lib[0]["pose_hash"] == lib[1]["pose_hash"]
    assert summary["mesh"] == 2 and summary["backend"] == "gloo"
    assert summary["ranks_agree"] is True and summary["pose_hash"] == lib[0]["pose_hash"]
    assert summary["keyframes"] == lib[0]["kf_count"] >= 3 and summary["scans"] == CLI_SCANS
    assert summary["ate_rmse_m"] < 0.5
    assert len((tmp_path / "odom_log.jsonl").read_text().splitlines()) == CLI_SCANS
    for name, path in summary["artifacts"].items():
        assert os.path.exists(path), name


def test_cli_run_sim_on_a_mesh_with_render_workers(library_mesh_run, capsys):
    """`run-sim --mesh 2 --render-procs 2`: each rank forks its 2 render
    workers before it forms its group and renders the whole stream there.
    The ranks agree, their poses are the run's without workers (the library
    run fed the same scans, which the CLI run without workers equals, bit for
    bit), no scan was rendered inline on either rank, and the summary counts
    the group's render processes beside the host's cores."""
    cli.main([*CLI_RUN, "--render-procs", "2"])
    summary = json.loads(capsys.readouterr().out)
    assert summary["ranks_agree"] is True and summary["mesh"] == 2
    assert summary["pose_hash"] == library_mesh_run.result()[0]["pose_hash"]
    assert summary["render_procs"] == 2 and summary["inline_renders"] == [0, 0]
    assert summary["render_processes"] == 4 and summary["cpu_count"] == os.cpu_count()


def test_cli_mesh_1_is_the_single_device_engine(tmp_path, capsys):
    """`--mesh 1` (as 0) is the single-device engine: the run's export
    equals the run without the flag, byte for byte."""
    outs = []
    for flags in ([], ["--mesh", "1"]):
        out = tmp_path / f"run{len(flags)}"
        cli.main(["run-sim", "--scans", "8", "--radius", "20", "--device", "cpu",
                  "--engine", "device", "--chunk", "4", "--out", str(out), *flags, *SMALL])
        summary = json.loads(capsys.readouterr().out)
        assert "mesh" not in summary
        outs.append(out)
    for name in ("odom_log.jsonl", "odom_tum.txt", "pose_graph.g2o"):
        assert (outs[0] / name).read_bytes() == (outs[1] / name).read_bytes(), name


def test_cli_joins_a_torchrun_group(tmp_path):
    """Where torchrun's variables are set, `--mesh 2` joins that group (two
    processes started here as torchrun starts them, gloo on the CPU through
    a store on localhost) instead of launching one: the ranks agree, and
    rank 0 alone prints the summary and writes the export."""
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(HERE)
    procs = []
    try:
        for r in range(2):
            env = dict(os.environ, WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                       PYTHONPATH=repo)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "xchu_slam_tpu_torch.cli", "run-sim", "--scans", "8",
                 "--radius", "20", "--device", "cpu", "--engine", "device", "--chunk", "4",
                 "--mesh", "2", "--out", str(tmp_path), *SMALL],
                env=env, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=GROUP_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], [err[-2000:] for _, err in outs]
    summary = json.loads(outs[0][0])
    assert outs[1][0].strip() == ""
    assert summary["mesh"] == 2 and summary["backend"] == "gloo"
    assert summary["ranks_agree"] is True and summary["scans"] == 8
    assert len((tmp_path / "odom_log.jsonl").read_text().splitlines()) == 8


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    """12 velodyne scans of a small circuit, written as KITTI `.bin` files."""
    vdir = tmp_path_factory.mktemp("mesh_kitti") / "velodyne"
    vdir.mkdir()
    world = sim.make_world(3, extent=70.0, ground_pts=40_000)
    gt = sim.loop_trajectory(n_scans=12, radius=12.0, speed=1.0)
    rng = np.random.default_rng(7)
    for i, p in enumerate(gt):
        xyz, inten = sim.render_scan(world, p, rng, n_points=6000)
        np.c_[xyz, inten].astype(np.float32).tofile(vdir / f"{i:06d}.bin")
    return str(vdir)


def test_cli_run_kitti_on_a_mesh(kitti_dir, tmp_path, capsys):
    """`run-kitti --engine device --mesh 2` on the written scans with the
    capacities shrunk: two ranks that agree; rank 0 wrote the export."""
    cli.main(["run-kitti", "--velodyne-dir", kitti_dir, "--out", str(tmp_path),
              "--engine", "device", "--mesh", "2", "--device", "cpu",
              "--set", "filter.max_raw_points=8192", "--set", "filter.max_points=4096",
              "--set", "filter.outlier_method=none", "--set", "ndt.grid_x=48",
              "--set", "ndt.grid_y=48", "--set", "ndt.grid_z=16",
              "--set", "pgo.max_keyframes=64", "--set", "pgo.max_loops=8"])
    summary = json.loads(capsys.readouterr().out)
    assert summary["mesh"] == 2 and summary["ranks_agree"] is True
    assert summary["scans"] == 12 and summary["keyframes"] > 2 and summary["engine"] == "device"
    for name, path in summary["artifacts"].items():
        assert os.path.exists(path), name


# ---------------------------------------------------------------- (g) tool -- #
def test_tool_runs_the_reference_workers_scenario_on_meshes():
    """`tools/torch_run_mp_spmd.py`: the reference worker's scenario at D = 2
    and 4 and on one device; every group's ranks agree bit for bit, and each
    group is within the tool's tolerance of the single-device engine (the
    counterpart of `tests/test_multiprocess_spmd.py`)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_run_mp_spmd", os.path.join(HERE, "..", "tools", "torch_run_mp_spmd.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    cmp = tool.launch(scans=16, radius=12.0, device="cpu")
    assert set(cmp["groups"]) == {2, 4}
    for world, g in cmp["groups"].items():
        assert [t["process_count"] for t in g["topology"]] == [world] * world
        assert g["procs_agree"], g
    assert cmp["procs_agree"] and cmp["within_tolerance_of_single"], cmp
    assert cmp["kf_count"] > 5
