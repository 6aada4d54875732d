"""The port's device engine on the CPU (its kernels' plain routes) against
the JAX device engine and against the port's host engine: the flagged voxel
map forms, `odometry.chunk_step`, `DeviceSlamPipeline` per scan and chunked,
the log ring, the keyframe capacity, the planted-state verify path carried
through `convert.py` into both packages, and the CLI."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xchu_slam_tpu import config as jconfig
from xchu_slam_tpu.io import prefetch as jprefetch
from xchu_slam_tpu.models import device_pipeline as jdp, odometry as jodom
from xchu_slam_tpu.models import pipeline as jpipe, pose_graph as jpg
from xchu_slam_tpu.ops import filter as jfilter, voxel_map as jvm
from xchu_slam_tpu.types import VoxelGrid as JVoxelGrid, make_cloud as jmake_cloud
from xchu_slam_tpu_torch import cli, config as tconfig, convert
from xchu_slam_tpu_torch.io import prefetch as tprefetch
from xchu_slam_tpu_torch.models import device_pipeline as tdp, odometry as todom
from xchu_slam_tpu_torch.models import pipeline as tpipe, pose_graph as tpg
from xchu_slam_tpu_torch.ops import filter as tfilter, ndt as tndt, voxel_map as tvm
from xchu_slam_tpu_torch.types import make_cloud as tmake_cloud
from xchu_slam_tpu_torch.utils import sim

torch.set_num_threads(2)

OVERRIDES = {
    "filter.max_raw_points": 8192, "filter.max_points": 4096,
    "filter.outlier_method": "statistical",
    "ndt.grid_x": 48, "ndt.grid_y": 48, "ndt.grid_z": 16,
    "pgo.max_keyframes": 64, "pgo.max_loops": 8,
    "pgo.odom_noise_trans": 1e-3, "pgo.odom_noise_rot": 1e-3,
    "loop.submap_points": 2048, "loop.submap_half_width": 4,
    "loop.icp_fitness_thresh": 1.5,
}
CAP = OVERRIDES["filter.max_raw_points"]


def _cfg(mod, **over):
    return mod.default_config().override({**OVERRIDES, **over})


@pytest.fixture(scope="module")
def scans():
    """30 scans of 6000 points along a 15 m circuit, made from a seed."""
    world = sim.make_world(4, extent=50.0, ground_pts=40_000)
    gt = sim.loop_trajectory(30, radius=15.0, speed=1.0)
    rng = np.random.default_rng(4)
    return [sim.render_scan(world, p, rng, n_points=6000) for p in gt]


# ------------------------------------------------------ voxel map forms -- #
def _seeded_grid(seed=0, n=3000):
    """A populated grid of the small geometry, as numpy (origin, stats, fin)."""
    cfg = _cfg(tconfig)
    spec = tvm.spec_from_config(cfg.ndt)
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * [12.0, 12.0, 3.0]).astype(np.float32)
    grid = tvm.make_grid(spec, tvm.centered_origin(spec, torch.zeros(3)))
    grid = tvm.finalize(tvm.insert_points(grid, torch.from_numpy(pts),
                                          torch.ones(n, dtype=torch.bool), spec), spec)
    return spec, grid, pts


@pytest.mark.parametrize("centre", [(0.0, 0.0, 0.0), (-7.0, 3.0, -2.5),
                                    (500.0, -300.0, 40.0)],
                         ids=["zero", "negative", "larger-than-grid"])
def test_recentre_with_device_shift_matches_reference(centre):
    """`recentre` keeps its shift in a tensor; against the reference's
    `vm.recentre` (a host-free roll) for a zero, a negative and a
    larger-than-grid shift; a false flag leaves the grid bit-equal."""
    spec, grid, _ = _seeded_grid()
    jspec = jvm.spec_from_config(_cfg(jconfig).ndt)
    jgrid = JVoxelGrid(**{k: jnp.asarray(v) for k, v in
                          convert.voxel_grid_to_ref(grid, spec).items()})
    want = jvm.recentre(jgrid, jnp.asarray(centre, jnp.float32), jspec)
    c = torch.tensor(centre)
    for flag in (None, torch.tensor(True)):
        got = tvm.recentre(grid, c, spec, flag=flag)
        np.testing.assert_array_equal(got.origin.numpy(), np.asarray(want.origin))
        np.testing.assert_array_equal(got.stats.numpy(), np.asarray(want.stats))
        np.testing.assert_array_equal(got.fin.numpy(),
                                      convert.unpack_base(np.asarray(want.fin), spec))
    if centre == (0.0, 0.0, 0.0):
        assert torch.equal(got.stats, grid.stats)
    kept = tvm.recentre(grid, c, spec, flag=torch.tensor(False))
    for a, b in zip(kept, grid):
        assert torch.equal(a, b)


@pytest.mark.parametrize("form", ["insert", "finalize", "swap"])
def test_flagged_forms_leave_the_grid_bit_equal_where_false(form):
    """The flagged insert / finalize / swap: a false flag returns the grids
    bit-equal, a true flag what the unflagged form returns."""
    spec, ga, pts = _seeded_grid(1)
    _, gb, _ = _seeded_grid(2)
    gb = gb._replace(origin=ga.origin.clone(), fin=torch.zeros_like(gb.fin))
    xyz = torch.from_numpy(pts[:500] + 0.3)
    mask = torch.ones(500, dtype=torch.bool)
    no, yes = torch.tensor(False), torch.tensor(True)

    def run(flag):
        if form == "insert":
            return tvm.insert_points_pair(ga, gb, xyz, mask, spec, flag=flag)
        if form == "finalize":
            stale = ga._replace(fin=torch.zeros_like(ga.fin))
            return (tvm.finalize(stale, spec, flag=flag), stale)
        return tvm.swap(ga, gb, spec, flag=flag)

    kept, plain, flagged = run(no), run(None), run(yes)
    before = (ga, gb) if form != "finalize" else (kept[1], kept[1])
    for got, want in zip(kept, before):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    changed = False
    for got, want, old in zip(flagged, plain, before):
        for a, b, o in zip(got, want, old):
            assert torch.equal(a, b)
            changed |= not torch.equal(a, o)
    assert changed


def test_align_on_device_route_on_cpu_is_the_host_route(scans):
    """On CPU tensors `align` is the plain version (`align_ref`) with its
    results as tensors: the one route both forms of the step take there."""
    cfg = _cfg(tconfig)
    ospec = todom.spec_from_config(cfg)
    f0 = tfilter.filter_scan(tmake_cloud(*scans[0], capacity=CAP), cfg.filter)
    f1 = tfilter.filter_scan(tmake_cloud(*scans[1], capacity=CAP), cfg.filter)
    st = todom.init_state(ospec, torch.zeros(6), f0.xyz, f0.mask)
    a = tndt.align_ref(st.grid_a, f1.xyz, f1.mask, st.pose, ospec.gspec, ospec.nspec)
    b = tndt.align(st.grid_a, f1.xyz, f1.mask, st.pose, ospec.gspec, ospec.nspec)
    assert torch.equal(a.pose, b.pose)
    assert isinstance(b.iterations, torch.Tensor) and int(b.iterations) == int(a.iterations)
    assert bool(b.converged) == bool(a.converged) and float(b.score) == float(a.score)
    assert int(a.iterations) >= 1


# ----------------------------------------------------------- chunk_step -- #
def test_chunk_step_matches_reference_and_sequential(scans):
    """`odometry.chunk_step` over staged chunks (one short) against the
    reference's `chunk_step` (poses atol 1e-3, equal iteration counts) and,
    bit for bit, against the port's sequential host-branch `step`."""
    use = scans[:14]
    tcfg, jcfg = _cfg(tconfig), _cfg(jconfig)
    tspec, jspec = todom.spec_from_config(tcfg), jodom.spec_from_config(jcfg)

    f0 = tfilter.filter_scan(tmake_cloud(*use[0], capacity=CAP), tcfg.filter)
    st = todom.init_state(tspec, torch.zeros(6), f0.xyz, f0.mask)
    seq, seq_iters = [], []
    for xyz, inten in use[1:]:
        f = tfilter.filter_scan(tmake_cloud(xyz, inten, capacity=CAP), tcfg.filter)
        st, out = todom.step(st, f.xyz, f.mask, tspec)
        seq.append(out.pose.numpy())
        seq_iters.append(out.iterations)

    st = todom.init_state(tspec, torch.zeros(6), f0.xyz, f0.mask)
    got, got_iters = [], []
    with tprefetch.DeviceChunkPrefetcher(use[1:], capacity=CAP, chunk=8, depth=2,
                                         threads=2, device="cpu") as pf:
        for clouds, n_real in pf:
            st, outs = todom.chunk_step(st, clouds, tcfg.filter, tspec)
            assert outs.pose.shape == (8, 6) and outs.inserted.dtype == torch.bool
            got.append(outs.pose.numpy()[:n_real])
            got_iters += outs.iterations.tolist()[:n_real]
    got = np.vstack(got)
    np.testing.assert_array_equal(got, np.stack(seq))
    assert got_iters == seq_iters

    jf0 = jfilter.filter_scan(jmake_cloud(*use[0], capacity=CAP), jcfg.filter)
    jst = jodom.init_state(jspec, jnp.zeros(6), jf0.xyz, jf0.mask)
    want, want_iters = [], []
    for clouds, n_real in jprefetch.DeviceChunkPrefetcher(use[1:], capacity=CAP,
                                                          chunk=8, depth=2, threads=2):
        jst, outs = jodom.chunk_step(jst, clouds, jcfg.filter, jspec)
        want.append(np.asarray(outs.pose)[:n_real])
        want_iters += np.asarray(outs.iterations).tolist()[:n_real]
    np.testing.assert_allclose(got, np.vstack(want), atol=1e-3)
    assert got_iters == want_iters


# ------------------------------------------------------------ the engine -- #
@pytest.fixture(scope="module")
def engines(scans):
    """30 scans through the port's device engine (per scan), the port's
    host engine and the reference's device engine."""
    tcfg, jcfg = _cfg(tconfig), _cfg(jconfig)
    dev = tdp.DeviceSlamPipeline(tcfg, kf_points=1024, log_capacity=64, device="cpu")
    host = tpipe.SlamPipeline(tcfg, kf_points=1024)
    ref = jdp.DeviceSlamPipeline(jcfg, kf_points=1024, log_capacity=64)
    for i, (xyz, inten) in enumerate(scans):
        dev.process_scan(xyz, inten, stamp=0.1 * i)
        host.process_scan(xyz, inten, stamp=0.1 * i)
        ref.process_scan(jmake_cloud(xyz, inten, capacity=CAP), stamp=0.1 * i)
    for p in (dev, host, ref):
        p.finalize()
    return dev, host, ref


def test_device_engine_matches_reference_device_engine(engines, scans):
    dev, _host, ref = engines
    assert dev.scan_count == ref.scan_count == len(scans)
    assert dev.kf_count == ref.kf_count > 5
    assert dev.loop_count == ref.loop_count
    assert [r["keyframe"] for r in dev.odom_log] == [r["keyframe"] for r in ref.odom_log]
    assert [r["iterations"] for r in dev.odom_log] == [r["iterations"] for r in ref.odom_log]
    np.testing.assert_allclose(dev.odometry_trajectory(), ref.odometry_trajectory(),
                               atol=1e-3)
    ds, do, dopt = dev.keyframe_trajectory()
    rs, ro, ropt = ref.keyframe_trajectory()
    np.testing.assert_allclose(ds, rs, atol=1e-6)
    np.testing.assert_allclose(do, ro, atol=1e-3)
    np.testing.assert_allclose(dopt, ropt, atol=1e-3)
    for key in ("stamp", "loop_cand", "loop_found", "loop_verify_ran"):
        assert [r[key] for r in dev.odom_log] == pytest.approx(
            [r[key] for r in ref.odom_log], abs=1e-6)


def test_device_engine_matches_host_engine(engines, scans):
    """The reference holds its two engines together (tests/
    test_device_pipeline.py:58-68); so does the port."""
    dev, host, _ref = engines
    assert dev.kf_count == host.kf_count
    assert dev.scan_count == host.scan_count == len(scans)
    hs, ho, hopt = host.keyframe_trajectory()
    ds, do, dopt = dev.keyframe_trajectory()
    np.testing.assert_allclose(ds, hs, atol=1e-6)
    np.testing.assert_array_equal(do, ho)
    np.testing.assert_allclose(dopt, hopt, atol=1e-3)
    assert sum(r["keyframe"] for r in dev.odom_log) == dev.kf_count
    # the host engine does not log the first (seed) scan; the device engine logs all
    np.testing.assert_allclose(dev.odometry_trajectory()[1:],
                               host.odometry_trajectory(), atol=1e-6)
    assert [r["iterations"] for r in dev.odom_log[1:]] == \
        [r["iterations"] for r in host.odom_log]


def test_chunked_matches_per_scan(engines, scans):
    """`process_chunk` over staged chunks, a short final one included,
    reproduces per-scan `process_scan` exactly; one readback a chunk."""
    ref, _host, _jref = engines
    chunked = tdp.DeviceSlamPipeline(_cfg(tconfig), kf_points=1024, log_capacity=64,
                                     device="cpu")
    base = 0
    with tprefetch.DeviceChunkPrefetcher(scans, capacity=CAP, chunk=8, depth=2,
                                         threads=2, device="cpu") as pf:
        for clouds, n_real in pf:
            chunked.process_chunk(clouds, 0.1 * (base + np.arange(8)), n_real)
            base += n_real
    chunked.finalize()
    assert chunked.chunk_readbacks == 4
    assert chunked.scan_count == ref.scan_count == len(scans)
    assert chunked.kf_count == ref.kf_count and chunked.loop_count == ref.loop_count
    np.testing.assert_array_equal(chunked.odometry_trajectory(), ref.odometry_trajectory())
    _, co, copt = chunked.keyframe_trajectory()
    _, ro, ropt = ref.keyframe_trajectory()
    np.testing.assert_array_equal(co, ro)
    np.testing.assert_allclose(copt, ropt, atol=1e-5)
    assert chunked.odom_log[-1].keys() == ref.odom_log[-1].keys()


def test_keyframe_capacity_respected(scans):
    dev = tdp.DeviceSlamPipeline(_cfg(tconfig, **{"pgo.max_keyframes": 4}),
                                 kf_points=1024, log_capacity=64, device="cpu")
    for i, (xyz, inten) in enumerate(scans[:20]):
        dev.process_scan(xyz, inten, stamp=0.1 * i)
    dev.finalize()
    assert dev.kf_count == 4   # gated in Part A, no overflow writes
    assert sum(r["keyframe"] for r in dev.odom_log) == 4


@pytest.mark.parametrize("chunked", [False, True], ids=["per-scan", "chunked"])
def test_log_wrap_archives_rows(engines, scans, chunked):
    """A run longer than log_capacity loses no row: the ring is archived to
    the host before a feed would overwrite rows not yet archived."""
    ref, _host, _jref = engines
    small = tdp.DeviceSlamPipeline(_cfg(tconfig), kf_points=1024, log_capacity=12,
                                   device="cpu")
    with pytest.warns(RuntimeWarning, match="log capacity"):
        if chunked:
            base = 0
            with tprefetch.DeviceChunkPrefetcher(scans, capacity=CAP, chunk=8, depth=2,
                                                 threads=2, device="cpu") as pf:
                for clouds, n_real in pf:
                    small.process_chunk(clouds, 0.1 * (base + np.arange(8)), n_real)
                    base += n_real
        else:
            for i, (xyz, inten) in enumerate(scans):
                small.process_scan(xyz, inten, stamp=0.1 * i)
    small.finalize()
    assert small.scan_count == len(scans) == len(small.odom_log)
    np.testing.assert_array_equal(small.odometry_trajectory(), ref.odometry_trajectory())
    assert [r["stamp"] for r in small.odom_log] == [r["stamp"] for r in ref.odom_log]
    assert [r["keyframe"] for r in small.odom_log] == [r["keyframe"] for r in ref.odom_log]


def test_chunk_larger_than_log_is_refused(scans):
    tiny = tdp.DeviceSlamPipeline(_cfg(tconfig), kf_points=1024, log_capacity=4,
                                  device="cpu")
    clouds, n_real = tprefetch.ChunkStager(CAP, 8, device="cpu").stage(scans[:8])
    with pytest.raises(ValueError, match="log_capacity"):
        tiny.process_chunk(clouds, np.zeros(8, np.float32), n_real)


@pytest.mark.parametrize("key", ["odom.use_imu", "odom.use_odom"])
def test_constructor_refuses_the_sensor_guesses_by_name(key, scans):
    """The constructor takes a guess mode (the guess runs on the card since
    the sensor windows were ported); a feed without that mode's windows is
    refused by the mode's name, since the windows are inputs of Part A."""
    dev = tdp.DeviceSlamPipeline(_cfg(tconfig, **{key: True}), device="cpu")
    assert getattr(dev.spec, key.split(".")[1])
    dev.process_scan(*scans[0], stamp=0.0)
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        dev.process_scan(*scans[1], stamp=0.1)


# ------------------------------------------- planted state, both packages -- #
def _planted(tcfg, seed=0):
    """A port `DevState` whose store holds a guaranteed revisit: 12
    keyframes 2 m apart on a line, all with the same structured cloud."""
    spec = tdp.spec_from_config(tcfg, kf_points=2048, log_capacity=64)
    rng = np.random.default_rng(seed)
    n = 2048
    g = np.c_[rng.uniform(-10, 10, (n // 2, 2)), rng.normal(0, 0.02, n // 2)]
    w1 = np.c_[rng.uniform(-10, 10, n // 4), np.full(n // 4, 6.0),
               rng.uniform(0, 3, n // 4)]
    m = n - n // 2 - n // 4
    w2 = np.c_[np.full(m, -8.0), rng.uniform(-10, 10, m), rng.uniform(0, 3, m)]
    cloud = torch.from_numpy(np.vstack([g, w1, w2]).astype(np.float32))
    K = 12
    db = tpipe.empty_db(tcfg, 2048)
    poses = torch.zeros((K, 6))
    poses[:, 0] = torch.arange(K) * 2.0
    db.poses[:K] = poses
    db.opt_poses[:K] = poses
    db.stamps[:K] = 0.5 * torch.arange(K)
    db.travel[:K] = 2.0 * torch.arange(K)
    db.clouds[:K] = cloud
    db.cloud_mask[:K] = True
    db = db._replace(count=K)
    graph = tpg.empty_graph(spec.gspec)
    graph.between_T[:, 0, 3] = 2.0
    graph.kf_mask[:K] = True
    state = tdp.DevState(
        odom=None, db=db, graph=graph, kf_accum=torch.zeros(()),
        travel=torch.tensor(2.0 * K), last_kf_odom=poses[-1].clone(), loop_count=0,
        scan_count=torch.tensor(K), kf_count=torch.tensor(K), imu_vel=torch.zeros(3),
        last_stamp=torch.zeros(()), log=torch.zeros((64, 16)),
        diag=torch.tensor(tdp._DIAG_RESET))
    return spec, state


def _to_reference(state, tspec):
    """The planted state carried through convert.py into the reference's
    `DevState`."""
    d = convert.dev_state_to_ref(state, tspec.ospec.gspec)
    as_j = lambda tree: {k: jnp.asarray(v) for k, v in tree.items()}  # noqa: E731
    return jdp.DevState(
        odom=None, db=jpipe.KfDb(**as_j(d["db"])), graph=jpg.GraphData(**as_j(d["graph"])),
        **{k: jnp.asarray(d[k]) for k in ("kf_accum", "travel", "last_kf_odom",
                                          "loop_count", "scan_count", "imu_vel",
                                          "last_stamp", "log", "diag")})


def _verify_both(cand, **over):
    tcfg, jcfg = _cfg(tconfig, **over), _cfg(jconfig, **over)
    tspec, state = _planted(tcfg)
    jspec = jdp.spec_from_config(jcfg, kf_points=2048, log_capacity=64)
    jout = jdp._verify_and_apply(_to_reference(state, tspec), jnp.int32(11),
                                 jnp.int32(cand), jnp.float32(0.0), jspec)
    tout = tdp._verify_and_apply(state, 11, cand, 0.0, tspec)
    return tout, jax.tree.map(np.asarray, jout)


def test_dev_state_round_trips_through_convert():
    tcfg = _cfg(tconfig)
    tspec, state = _planted(tcfg)
    back = convert.dev_state_from_ref(
        jax.tree.map(np.asarray, _to_reference(state, tspec)), tspec.ospec.gspec)
    assert back.db.count == state.db.count == int(back.kf_count) == 12
    assert back.loop_count == 0 and back.odom is None
    for a, b in zip(back.db[:-1] + tuple(back.graph), state.db[:-1] + tuple(state.graph)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for name in ("kf_accum", "travel", "last_kf_odom", "scan_count", "log", "diag"):
        assert torch.equal(getattr(back, name), getattr(state, name))


def test_verify_and_apply_accepts_true_loop():
    """Candidate 10 is 2 m away with an identical cloud: ICP converges to the
    true offset, in both packages alike."""
    tout, jout = _verify_both(10, **{"loop.max_correction": 5.0})
    assert tout.loop_count == int(jout.loop_count) == 1
    g = tout.graph
    assert int(g.loop_i[0]) == int(jout.graph.loop_i[0]) == 10
    assert int(g.loop_j[0]) == int(jout.graph.loop_j[0]) == 11
    assert bool(g.loop_mask[0])
    T = g.loop_T[0].numpy()
    assert abs(T[0, 3] - 2.0) < 0.3
    np.testing.assert_allclose(T, jout.graph.loop_T[0], atol=1e-3)
    np.testing.assert_allclose(g.loop_info[0].numpy(), jout.graph.loop_info[0], rtol=1e-3)
    np.testing.assert_allclose(tout.diag.numpy(), jout.diag, atol=1e-3)
    np.testing.assert_allclose(tout.db.opt_poses.numpy(), jout.db.opt_poses, atol=1e-3)


def test_verify_and_apply_rejects_far_candidate():
    tout, jout = _verify_both(0, **{"loop.max_loop_dist": 3.0})
    assert tout.loop_count == int(jout.loop_count) == 0
    assert float(tout.diag[4]) == float(jout.diag[4]) == 0.0   # gated before ICP
    tout, jout = _verify_both(-1, **{"loop.max_loop_dist": 3.0})
    assert tout.loop_count == int(jout.loop_count) == 0


def test_verify_rejects_unconverged_icp():
    """A capped, still-moving ICP must be rejected though its fitness passes
    the threshold."""
    over = {"loop.max_correction": 5.0, "loop.icp_max_iterations": 1}
    tout, jout = _verify_both(10, **over)
    assert float(tout.diag[4]) == float(jout.diag[4]) == 1.0   # the verify ran
    assert float(tout.diag[2]) <= 1.5 and float(jout.diag[2]) <= 1.5
    assert tout.loop_count == int(jout.loop_count) == 0


def test_radius_candidate_searches_optimised_poses():
    """The radius retrieval runs on the optimised poses: a loop correction
    that pulled keyframe 10 back to the start must be found, by both
    packages and by the port's host-engine helper."""
    tcfg = _cfg(tconfig, **{"loop.radius_search": 5.0})
    tspec, state = _planted(tcfg)
    K = 11
    raw = np.zeros((64, 6), np.float32)
    raw[:K, 0] = np.arange(K) * 10.0
    opt = raw.copy()
    opt[10, 0] = 1.0
    stamps = np.zeros(64, np.float32)
    stamps[:K] = 40.0 * np.arange(K)
    db = state.db._replace(poses=torch.from_numpy(raw), opt_poses=torch.from_numpy(opt),
                           stamps=torch.from_numpy(stamps), count=K)
    state = state._replace(db=db)
    idx, found = tdp._sc_radius_candidate(state, 10, 400.0, tspec)
    assert found and idx == 0
    assert tpipe._radius_candidate(db, 10, 400.0, 5.0, 30.0) == 0
    jspec = jdp.spec_from_config(_cfg(jconfig, **{"loop.radius_search": 5.0}),
                                 kf_points=2048, log_capacity=64)
    jidx, jfound = jdp._sc_radius_candidate(_to_reference(state, tspec), jnp.int32(10),
                                            jnp.float32(400.0), jspec)
    assert bool(jfound) and int(jidx) == idx
    # raw poses alone would miss it
    far = state._replace(db=db._replace(opt_poses=torch.from_numpy(raw)))
    assert tdp._sc_radius_candidate(far, 10, 400.0, tspec) == (-1, False)


# ------------------------------------------------------------------- CLI -- #
SMALL = ["--set", "filter.max_points=4096", "--set", "pgo.max_keyframes=64",
         "--set", "loop.submap_points=4096"]


def test_cli_device_engine_end_to_end(tmp_path, capsys):
    cli.main(["run-sim", "--scans", "12", "--radius", "20", "--device", "cpu",
              "--engine", "device", "--chunk", "5", "--gps", "--loop-method", "radius",
              "--out", str(tmp_path), *SMALL])
    summary = json.loads(capsys.readouterr().out)
    assert summary["engine"] == "device" and summary["scans"] == 12
    assert summary["keyframes"] >= 3 and summary["ate_rmse_m"] < 0.5
    assert summary["chunk_attribution"]["chunks"] == 3
    assert len((tmp_path / "odom_log.jsonl").read_text().splitlines()) == 12
    assert len((tmp_path / "odom_tum.txt").read_text().splitlines()) == summary["keyframes"]


@pytest.mark.parametrize("flags", [["--mesh", "2", "--engine", "host"],
                                   ["--render-procs", "-1"],
                                   ["--sync-every", "4"], ["--chunk", "0"],
                                   ["--prefetch-threads", "0"]])
def test_cli_rejects_unported_flags_of_the_device_engine(flags, capsys):
    """The reference's run-sim flag the port has not taken (`--sync-every`)
    is refused by name, and so are `--mesh` with the host engine (the mesh
    engine is the device engine; tests/test_torch_mesh_engine.py runs it)
    and counts out of range of the flags it has taken (`--imu`, `--wheel`,
    `--checkpoint-every` and `--continue-session` are taken since the device
    engine's session was ported, tests/test_torch_device_sensors.py;
    `--render-procs`, `--realism` and `--trajectory` since the scan sources
    were, tests/test_torch_procsource.py and tests/test_torch_sim_realism.py)."""
    with pytest.raises(SystemExit) as err:
        cli.main(["run-sim", "--scans", "4", "--device", "cpu", "--engine", "device",
                  *flags])
    assert err.value.code == 2
    want = {"--mesh": "--mesh needs --engine device",
            "--sync-every": "not ported yet"}.get(flags[0], "must be >= ")
    assert want in capsys.readouterr().err
