"""The sensor-aided mapping session of the port, end to end on the CPU:
IMU / wheel / GPS inputs through both host engines, checkpoints crossing
between the packages, `localize` against a saved session, an ISC circuit,
and the command line. Small sizes; tolerances are stated per test."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bounded import within
from xchu_slam_tpu import config as jconfig
from xchu_slam_tpu.models import pipeline as jpipe, pose_graph as jpg, relocalize as jreloc
from xchu_slam_tpu.ops import imu as jimu
from xchu_slam_tpu.utils import checkpoint as jckpt, sim as jsim
from xchu_slam_tpu_torch import cli, config as tconfig, convert
from xchu_slam_tpu_torch.io import kitti
from xchu_slam_tpu_torch.models import pipeline as tpipe, pose_graph as tpg, relocalize as treloc
from xchu_slam_tpu_torch.models.device_pipeline import DeviceSlamPipeline
from xchu_slam_tpu_torch.ops import imu as timu
from xchu_slam_tpu_torch.utils import checkpoint as tckpt, metrics, se3, sim
from xchu_slam_tpu_torch.utils.profiling import StageTimers

torch.set_num_threads(2)

N_SCANS, SAVE_AT = 30, 19      # checkpoints are written after scan SAVE_AT


def _small(mod, **loop):
    return mod.SlamConfig(
        filter=mod.FilterConfig(max_raw_points=8192, max_points=2048,
                                outlier_method="statistical"),
        ndt=mod.NdtConfig(grid_x=40, grid_y=40, grid_z=12, max_iterations=20),
        odom=mod.OdomConfig(use_imu=True, use_odom=True),
        loop=mod.LoopConfig(submap_points=2048, submap_half_width=5, **loop),
        pgo=mod.PgoConfig(max_keyframes=64, max_loops=8, use_gps=True))


def _feeds(n, seed=2):
    """Scans and sensor feeds of an n-scan arc, drawn from one generator in
    the CLI's order: IMU windows, wheel windows, altimeter, scans."""
    world = sim.make_world(seed, extent=50.0, ground_pts=40_000)
    gt = sim.loop_trajectory(n, radius=15.0, speed=1.0)
    stamps = 0.1 * np.arange(n)
    rng = np.random.default_rng(seed)
    imu = sim.imu_windows(gt, stamps, samples=16, rng=rng, gyro_noise=0.002, accel_noise=0.05)
    wheel = sim.wheel_windows(gt, stamps, samples=16, rng=rng, vel_noise=0.03, gyro_noise=0.002)
    alts = gt[:, 2] + rng.normal(0.0, 0.5, n)
    alts[rng.random(n) < 0.2] = np.nan
    scans = [sim.render_scan(world, p, rng, n_points=6000) for p in gt]
    return world, gt, stamps, imu, wheel, alts, scans


def _feed(pipe, mod, feeds, i):
    """process_scan of scan i with its windows in `mod`'s types."""
    _, _, stamps, imu, wheel, alts, scans = feeds
    as_arr = jnp.asarray if mod is jimu else torch.from_numpy
    return pipe.process_scan(
        *scans[i], stamp=float(stamps[i]),
        gps_alt=float(alts[i]) if np.isfinite(alts[i]) else None,
        imu=mod.ImuWindow(*(as_arr(a[i]) for a in imu)),
        wheel=mod.OdomWindow(*(as_arr(a[i]) for a in wheel)))


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """N_SCANS scans with IMU + wheel + GPS through both host engines, each
    saving a checkpoint after scan SAVE_AT."""
    feeds = _feeds(N_SCANS)
    d = tmp_path_factory.mktemp("session")
    paths = {"j": str(d / "ref.npz"), "t": str(d / "port.npz")}
    jp = jpipe.SlamPipeline(_small(jconfig), kf_points=512)
    tp = tpipe.SlamPipeline(_small(tconfig), kf_points=512)
    rows = []
    for i in range(N_SCANS):
        rows.append((_feed(jp, jimu, feeds, i), _feed(tp, timu, feeds, i)))
        if i == SAVE_AT:
            jckpt.save_checkpoint(jp, paths["j"])
            tckpt.save_checkpoint(tp, paths["t"])
    return feeds, jp, tp, rows, paths


def test_sensor_prefix_matches_reference(session):
    """Per-scan poses within 1e-3 m (rad), identical keyframe flags and
    Newton iteration counts, with the IMU + wheel guess and GPS altitudes."""
    _, jp, tp, rows, _ = session
    for rj, rt in rows:
        np.testing.assert_allclose(rt["pose"], rj["pose"], atol=1e-3)
        assert rt["keyframe"] == rj["keyframe"]
    assert [r["iterations"] for r in tp.odom_log] == [r["iterations"] for r in jp.odom_log]
    assert tp.kf_count == jp.kf_count > 5
    np.testing.assert_allclose(tp._imu_state.velocity.numpy(),
                               np.asarray(jp._imu_state.velocity), atol=1e-2)
    # the velocity reset follows the SLAM result: about 1 m per 0.1 s
    assert 8.0 < float(torch.linalg.norm(tp._imu_state.velocity)) < 12.0
    for a, b in zip(tp.keyframe_trajectory(), jp.keyframe_trajectory()):
        np.testing.assert_allclose(a, b, atol=1e-3)


def test_external_guess_is_used(session):
    """The IMU + wheel guess lands nearer the pose NDT settles on than the
    constant-velocity guess would on this arc, so Newton needs no more
    iterations than without it, and fewer in total."""
    feeds, _, tp, _, _ = session
    cfg = _small(tconfig)
    plain = tpipe.SlamPipeline(
        cfg.override({"odom.use_imu": False, "odom.use_odom": False}), kf_points=512)
    for i in range(12):
        _feed(plain, timu, feeds, i)     # windows given, switches off: ignored
    with_ext = sum(r["iterations"] for r in tp.odom_log[:11])
    without = sum(r["iterations"] for r in plain.odom_log)
    assert with_ext != without
    assert not np.array_equal(plain.odom_log[5]["pose"], tp.odom_log[5]["pose"])


def test_gps_factors_enter_the_graph_and_the_solve(session):
    """The altitude factors are those the reference stores (equal masks,
    altitudes within 1e-6), on keyframes only and never on a dropout; a
    full solve over them moves z and agrees with the reference to 1e-3."""
    feeds, jp, tp, rows, _ = session
    alts = feeds[5]
    gm = tp.graph.gps_mask.numpy()
    assert np.array_equal(gm, np.asarray(jp.graph.gps_mask))
    np.testing.assert_allclose(tp.graph.gps_alt.numpy(), np.asarray(jp.graph.gps_alt), atol=1e-6)
    kf_scans = [i for i, (_, rt) in enumerate(rows) if rt["keyframe"]]
    want = np.array([np.isfinite(alts[i]) for i in kf_scans])
    assert np.array_equal(gm[:len(kf_scans)], want) and not gm[len(kf_scans):].any()
    assert gm.any()
    spec = jpg.spec_from_config(jp.cfg.pgo)._replace(gps_info_z=50.0)
    oj = np.asarray(jpg.solve(jp.db.opt_poses, jp.graph, spec))
    ot = tpg.solve(tp.db.opt_poses.clone(), tp.graph, tpg.GraphSpec(*spec)).numpy()
    n = tp.kf_count
    assert np.abs(ot[:n, 2] - tp.db.opt_poses[:n, 2].numpy()).max() > 1e-2
    np.testing.assert_allclose(ot, oj, atol=1e-3)


# -------------------------------------------------------- checkpoints ---- #

def _continue(pipe, mod, feeds, lo=SAVE_AT + 1, hi=N_SCANS):
    return np.stack([_feed(pipe, mod, feeds, i)["pose"] for i in range(lo, hi)])


def test_port_loads_reference_checkpoint(session):
    """The port continues 10 scans from a file the reference saved, within
    1e-3 of the reference continuing from the same file."""
    feeds, jp, _, _, paths = session
    tp = tckpt.load_checkpoint(paths["j"], device="cpu")
    jp2 = jckpt.load_checkpoint(paths["j"])
    assert tp.kf_count == jp2.kf_count and tp.scan_count == jp2.scan_count == SAVE_AT + 1
    assert tp.travel == jp2.travel and tp.kf_gate_accum == jp2.kf_gate_accum
    assert tp.db.isc_db.shape == tuple(jp2.db.isc_db.shape)
    # the reference's file holds no IMU state: zero velocity, no last stamp
    assert not tp._imu_state.velocity.any() and tp._last_stamp is None
    np.testing.assert_allclose(_continue(tp, timu, feeds), _continue(jp2, jimu, feeds),
                               atol=1e-3)
    assert tp.kf_count == jp2.kf_count


def test_reference_loads_port_checkpoint(session):
    """The reference continues from a file the port saved, within 1e-3 of
    the port's own uninterrupted run. The reference ignores the port's two
    extra `__meta__` keys and starts from zero IMU velocity; with the wheel
    feed on, the guess takes its translation from the wheel delta, so the
    poses stay within the bound from the first scan on."""
    feeds, _, tp, rows, paths = session
    jp2 = jckpt.load_checkpoint(paths["t"])
    assert jp2.kf_count == int(np.asarray(jp2.db.count))
    assert jp2.db.count.dtype == jnp.int32 and jp2.graph.loop_i.dtype == jnp.int32
    got = _continue(jp2, jimu, feeds)
    want = np.stack([rt["pose"] for _, rt in rows[SAVE_AT + 1:]])
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert jp2.kf_count == tp.kf_count


def test_port_resume_is_bit_identical(session):
    """Port → port: the resumed run's poses, keyframe store and graph equal
    the uninterrupted run's, bit for bit."""
    feeds, _, tp, rows, paths = session
    tp2 = tckpt.load_checkpoint(paths["t"], device="cpu")
    assert tp2._last_stamp == pytest.approx(0.1 * SAVE_AT, abs=0) and tp2._imu_state.velocity.any()
    got = _continue(tp2, timu, feeds)
    assert np.array_equal(got, np.stack([rt["pose"] for _, rt in rows[SAVE_AT + 1:]]))
    assert tp2.kf_count == tp.kf_count and tp2.travel == tp.travel
    for a, b in zip(tp2.db[:-1] + tp2.graph, tp.db[:-1] + tp.graph):
        assert torch.equal(a, b)
    assert torch.equal(tp2.odom_state.grid_a.fin, tp.odom_state.grid_a.fin)


def test_checkpoint_layout_is_the_references(session):
    """Both packages' files have the same keys with the same dtypes and
    shapes; `__meta__` has the reference's keys plus the port's two."""
    _, _, _, _, paths = session
    with np.load(paths["j"]) as fj, np.load(paths["t"]) as ft:
        assert set(fj.files) == set(ft.files)
        for k in fj.files:
            if k != "__meta__":
                assert fj[k].dtype == ft[k].dtype and fj[k].shape == ft[k].shape, k
        mj = json.loads(bytes(fj["__meta__"]).decode())
        mt = json.loads(bytes(ft["__meta__"]).decode())
        assert ft["odom.grid_a.fin"].shape[1] == 10
    assert set(mt) - set(mj) == {"imu_velocity", "last_stamp"} and set(mj) <= set(mt)
    assert mt["engine"] == "host" and json.loads(mt["config"]) == json.loads(mj["config"])


def _rewrite(src, dst, edit):
    with np.load(src) as f:
        data = dict(f.items())
    meta = json.loads(bytes(data["__meta__"]).decode())
    edit(data, meta)
    data["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(dst, **data)


def test_unloadable_checkpoints_say_why(session, tmp_path):
    """A host file labelled as the device engine's is refused with a clear
    error naming the device state it lacks, not read as a host file; a file
    that lacks an array names the array."""
    paths = session[4]
    dev = str(tmp_path / "device.npz")
    _rewrite(paths["t"], dev, lambda d, m: m.update(engine="device"))
    with pytest.raises(ValueError, match=r"missing 'state\."):
        tckpt.load_checkpoint(dev, device="cpu")
    cut = str(tmp_path / "cut.npz")
    _rewrite(paths["t"], cut, lambda d, m: d.pop("db.travel"))
    with pytest.raises(ValueError, match="db.travel"):
        tckpt.load_checkpoint(cut, device="cpu")


def test_legacy_checkpoint_migrates(session, tmp_path):
    """The older layout with a grid's `mean` / `icov` / `valid` tables apart
    loads to the same state, as in the reference."""
    paths = session[4]
    old = str(tmp_path / "legacy.npz")

    def split(d, m):
        for g in ("odom.grid_a", "odom.grid_b"):
            fin = d.pop(f"{g}.fin")
            d[f"{g}.mean"], d[f"{g}.icov"] = fin[:, :3], fin[:, 3:9]
            d[f"{g}.valid"] = fin[:, 9] > 0
    _rewrite(paths["t"], old, split)
    a = tckpt.load_checkpoint(old, device="cpu")
    b = tckpt.load_checkpoint(paths["t"], device="cpu")
    assert torch.equal(a.odom_state.grid_a.fin, b.odom_state.grid_a.fin)
    assert torch.equal(a.odom_state.grid_b.fin, b.odom_state.grid_b.fin)
    ja = jckpt.load_checkpoint(old)
    assert np.array_equal(convert.unpack_base(np.asarray(ja.odom_state.grid_a.fin),
                                              a.ospec.gspec), a.odom_state.grid_a.fin.numpy())


# ----------------------------------------------------------- localize ---- #

def test_localize_matches_reference(session):
    """Fresh scans against the session's store, carried across by `convert`:
    the same keyframe and `found`, SC distance within 1e-5, pose within 1e-3,
    ICP fitness within 1e-3 relative; the found ones are near the truth."""
    feeds, jp, _, _, _ = session
    world, gt = feeds[0], feeds[1]
    cfg_over = {"sc.dist_thresh": 0.35, "loop.icp_fitness_thresh": 2.0}  # 512-point clouds
    jloc = jreloc.SessionLocalizer(jp.db, jp.cfg.override(cfg_over))
    tdb = convert.kfdb_from_ref(type(jp.db)(*(np.asarray(a) for a in jp.db)))
    tloc = treloc.SessionLocalizer(tdb, _small(tconfig).override(cfg_over))
    gtT = se3.pose_to_matrix(torch.from_numpy(gt)).numpy()
    gt_rel = np.einsum("ab,nbc->nac", np.linalg.inv(gtT[0]), gtT)
    rng = np.random.default_rng(99)
    found = 0
    for i in (3, 14, 26):
        xyz, inten = sim.render_scan(world, gt[i], rng, n_points=6000)
        rj, rt = jloc.localize(xyz, inten), tloc.localize(xyz, inten)
        assert rt.found == rj.found and rt.kf_idx == rj.kf_idx
        assert abs(rt.sc_dist - rj.sc_dist) <= 1e-5 and abs(rt.yaw - rj.yaw) <= 1e-6
        if rj.kf_idx >= 0:
            assert rt.icp_converged == rj.icp_converged
            np.testing.assert_allclose(rt.pose, rj.pose, atol=1e-3)
            assert abs(rt.icp_fitness - rj.icp_fitness) <= 1e-3 * rj.icp_fitness
        if rt.found:
            found += 1
            assert np.linalg.norm(rt.pose[:3] - gt_rel[i, :3, 3]) < 1.0
    assert found >= 2
    # a scan of nothing the session saw is not placed
    far = rng.normal(size=(3000, 3)).astype(np.float32) * [30, 30, 0.05]
    miss = tloc.localize(far, np.zeros(3000, np.float32))
    assert not miss.found and miss.kf_idx == -1 and not miss.pose.any()


def test_localizer_from_checkpoint(session):
    feeds, _, tp, _, paths = session
    loc = treloc.localizer_from_checkpoint(paths["t"], device="cpu")
    assert loc.db.count > 3
    assert loc.cfg == tp.cfg
    xyz, inten = feeds[6][0]            # the scan keyframe 0 was made from
    r = loc.localize(xyz, inten, max_points=256)
    assert r.kf_idx == 0 and r.sc_dist < 1e-6 and np.isfinite(r.icp_fitness)


# --------------------------------------------------------- ISC circuit --- #

@pytest.fixture(scope="module")
def isc_circuit():
    """A 114-scan closed lap (radius 12 m) on the port alone, ISC loops,
    GPS altitude factors from a noisy altimeter."""
    cfg = tconfig.SlamConfig(
        filter=tconfig.FilterConfig(max_raw_points=8192, max_points=4096,
                                    outlier_method="none"),
        ndt=tconfig.NdtConfig(grid_x=56, grid_y=56, grid_z=12, max_iterations=20),
        loop=tconfig.LoopConfig(method="isc", detect_period=2, submap_half_width=6,
                                submap_points=4096, icp_fitness_thresh=1.0),
        pgo=tconfig.PgoConfig(max_keyframes=128, max_loops=16, odom_noise_trans=1e-3,
                              odom_noise_rot=1e-3, gn_iterations=6, cg_iterations=60,
                              use_gps=True))
    pipe = tpipe.SlamPipeline(cfg, kf_points=1024)
    radius = 12.0
    world = sim.make_world(21, extent=radius * 2.8, ground_pts=60_000)
    gt = sim.loop_trajectory(n_scans=int(7.02 * radius) + 30, radius=radius, speed=1.0)
    rng = np.random.default_rng(21)
    alts = gt[:, 2] + rng.normal(0.0, 0.5, len(gt))
    for i, p in enumerate(gt):
        xyz, inten = sim.render_scan(world, p, rng, n_points=6000, max_range=45.0)
        pipe.process_scan(xyz, inten, stamp=0.1 * i, gps_alt=float(alts[i]))
    pipe.finalize()
    return pipe, gt


def test_isc_circuit_closes_loops(isc_circuit):
    """ISC retrieval closes the lap: ≥ 1 verified loop between keyframes a
    lap apart, aligned ATE under 1.0 m (the SC circuit's bound), and the
    ISC images are stored for every keyframe."""
    pipe, gt = isc_circuit
    assert pipe.loop_count >= 1 and pipe.icp_verifications >= pipe.loop_count
    for rec in pipe.loops:
        assert rec.method == "isc" and rec.j - rec.i > 20
        assert rec.fitness <= pipe.cfg.loop.icp_fitness_thresh
    assert bool((pipe.db.isc_db[:pipe.kf_count].amax(dim=(1, 2)) > 0).all())
    assert not pipe.db.isc_db[pipe.kf_count:].any()
    gtT = se3.pose_to_matrix(torch.from_numpy(gt)).numpy()
    gt_xyz = np.einsum("ab,nbc->nac", np.linalg.inv(gtT[0]), gtT)[:, :3, 3]
    stamps, _, kf_opt = pipe.keyframe_trajectory()
    idx = np.round(stamps / 0.1).astype(int)
    assert metrics.ape_rmse(kf_opt[:, :3], gt_xyz[idx], align=True) < 1.0
    assert np.isfinite(kf_opt).all()
    assert bool(pipe.graph.gps_mask[:pipe.kf_count].all())


@pytest.mark.parametrize("over,match", [
    ({"loop.async_detect": True}, "async_detect"),
    ({"filter.detect_ground": True}, "detect_ground"),
    ({"loop.method": "kdtree"}, "unknown loop.method"),
])
def test_constructor_refuses_what_is_not_ported(over, match):
    """The host engine runs the worker and the ground path; the device
    engine refuses both by name, as the reference's device engine has
    neither. An unknown loop method is refused by both."""
    cfg = tconfig.tiny_config().override(over)
    with pytest.raises(ValueError, match=match):
        DeviceSlamPipeline(cfg, device="cpu")
    if "loop.method" in over:
        with pytest.raises(ValueError, match=match):
            tpipe.SlamPipeline(cfg)


def test_loop_method_none_detects_nothing(isc_circuit):
    pipe, _ = isc_circuit
    off = tpipe.SlamPipeline(pipe.cfg.override({"loop.method": "none"}), kf_points=1024)
    off.db, off.kf_count = pipe.db, pipe.kf_count
    assert off.detect_and_verify_snapshot(pipe.kf_count - 1, 11.0) is None
    assert off.icp_verifications == 0


# ------------------------------------------------------------- the CLI --- #

@pytest.mark.parametrize("argv", [["--help"], ["run-sim", "--help"], ["eval", "--help"],
                                  ["localize", "--help"], ["info", "--help"],
                                  ["run-kitti", "--help"]])
def test_cli_help(argv, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 0 and "usage:" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["run-sim", "--engine", "host", "--mesh", "2", "--render-procs", "2"],
    ["run-sim", "--mesh", "4"],
    ["run-sim", "--continue-session", "x.npz"],
    ["run-sim", "--engine", "host", "--render-procs", "2"],
    ["run-sim", "--sync-every", "4"], ["run-sim", "--loop-method", "kdtree"],
    ["run-kitti", "--velodyne-dir", "x", "--mesh", "2"],
])
def test_cli_rejects_what_is_not_ported(argv, capsys):
    """A flag of the reference CLI that is not ported is an argparse error,
    not accepted and ignored; so is `--continue-session` with the host
    engine, as in the reference, `--render-procs` with the host engine,
    which draws every scan from one shared generator (the reference ignores
    it there) and `--mesh` with the host engine (the reference ignores it
    there too), alone or with `--render-procs`. (`--mesh` with
    `--render-procs` on the device engine runs: each rank forks its render
    workers before it forms its group, tests/test_torch_mesh_engine.py.)"""
    with pytest.raises(SystemExit) as e:
        cli.main(argv + ["--device", "cpu"])
    assert e.value.code == 2
    capsys.readouterr()


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """A TUM lap in the camera frame and a directory of 3 velodyne scans."""
    root = tmp_path_factory.mktemp("cli_inputs")
    cam = sim.camera_frame_transform()
    T = se3.pose_to_matrix(torch.from_numpy(sim.closed_lap_trajectory(16, radius=8.0))).numpy()
    kitti.write_tum(str(root / "lap_tum.txt"), 0.1 * np.arange(16),
                    cam @ T @ np.linalg.inv(cam))
    (root / "velodyne").mkdir()
    world = sim.make_world(3, extent=40.0, ground_pts=20_000)
    rng = np.random.default_rng(1)
    for i, p in enumerate(sim.loop_trajectory(3, radius=10.0)):
        xyz, inten = sim.render_scan(world, p, rng, n_points=3000)
        np.c_[xyz, inten].astype(np.float32).tofile(root / "velodyne" / f"{i:06d}.bin")
    return root


CLI_SMALL = ["--set", "filter.max_points=2048", "--set", "pgo.max_keyframes=16",
             "--set", "loop.submap_points=2048", "--set", "ndt.grid_x=40",
             "--set", "ndt.grid_y=40", "--set", "ndt.grid_z=12"]
NOW_PORTED = {
    "run-sim --realism": ["run-sim", "--scans", "3", "--radius", "15", "--realism"],
    "run-sim --trajectory": ["run-sim", "--scans", "3", "--trajectory", "{root}/lap_tum.txt"],
    "run-sim --render-procs": ["run-sim", "--scans", "3", "--radius", "15", "--engine",
                               "device", "--chunk", "2", "--render-procs", "2"],
    "run-kitti": ["run-kitti", "--velodyne-dir", "{root}/velodyne",
                  "--set", "filter.max_raw_points=4096"],
    "localize --trajectory": ["localize", "--session", "{out}/checkpoint.npz", "--trajectory",
                              "{root}/lap_tum.txt", "--scans", "3", "--queries", "1"],
}


@pytest.mark.parametrize("case", list(NOW_PORTED))
def test_cli_runs_what_is_now_ported(case, cli_inputs, tmp_path, capsys):
    """Each flag that the port once refused runs: 3 scans on the CPU, exit
    without error, a JSON summary on stdout."""
    out = tmp_path / "out"
    if case == "localize --trajectory":
        cli.main(["run-sim", "--scans", "3", "--trajectory", str(cli_inputs / "lap_tum.txt"),
                  "--checkpoint-every", "2", "--out", str(out), "--device", "cpu", *CLI_SMALL])
        capsys.readouterr()
    argv = [a.format(root=cli_inputs, out=out) for a in NOW_PORTED[case]]
    if argv[0] != "localize":
        argv += ["--out", str(out), *CLI_SMALL]
    # bounded: the --render-procs case forks
    within(240, lambda: cli.main(argv + ["--device", "cpu"]))
    summary = json.loads(capsys.readouterr().out)
    if case == "localize --trajectory":
        assert summary["queries"] == 1
    else:
        assert summary["scans"] == 3 and summary["keyframes"] >= 1


def test_cli_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["localize", "--session", "none.npz"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.run_sim(3)


def test_cli_info(capsys):
    cli.main(["info"])
    out = json.loads(capsys.readouterr().out)
    assert out["torch"] == torch.__version__ and "jax" not in out
    assert out["default_config"]["isc"]["num_ring"] == 60


def test_cli_feeds_are_the_reference_clis():
    """One generator, consumed in the reference CLI's order (IMU windows,
    wheel windows, altimeter noise and dropouts, then every scan): the
    port's run sees bit-identical scans and altitudes, and sensor windows
    within 1e-6 / one ulp, of what the reference's functions make."""
    seen = []
    cli.run_sim(4, 20.0, 3, "cpu", ["filter.max_points=2048", "pgo.max_keyframes=16"],
                on_scan=lambda i, res, scan: seen.append(scan),
                loop_method="isc", imu=True, wheel=True, gps=True)
    world = jsim.make_world(3, extent=50.0)
    gt = jsim.loop_trajectory(n_scans=4, radius=20.0, speed=1.0)
    stamps = 0.1 * np.arange(4)
    rng = np.random.default_rng(3)
    imu = jsim.imu_windows(gt, stamps, samples=16, rng=rng, gyro_noise=0.002, accel_noise=0.05)
    wheel = jsim.wheel_windows(gt, stamps, samples=16, rng=rng, vel_noise=0.03, gyro_noise=0.002)
    alts = gt[:, 2] + rng.normal(0.0, 0.5, 4)
    alts[rng.random(4) < 0.2] = np.nan
    for i, scan in enumerate(seen):
        xyz, inten = jsim.render_scan(world, gt[i], rng, n_points=24_000)
        assert np.array_equal(scan["xyz"], xyz) and np.array_equal(scan["intensity"], inten)
        assert scan["gps_alt"] == (float(alts[i]) if np.isfinite(alts[i]) else None)
        for got, want in zip(tuple(scan["imu"]) + tuple(scan["wheel"]),
                             [a[i] for a in imu + wheel]):
            np.testing.assert_allclose(got.numpy(), want, rtol=1.2e-7, atol=1e-6)


def test_cli_session_end_to_end(tmp_path, capsys):
    """run-sim with every sensor and a checkpoint → the export files → eval
    of the exported trajectory against a ground-truth TUM file → localize
    against the checkpoint, all through `cli.main` on the CPU."""
    out = tmp_path / "run"
    small = ["--set", "filter.max_points=4096", "--set", "pgo.max_keyframes=64",
             "--set", "loop.submap_points=4096"]
    cli.main(["run-sim", "--scans", "16", "--radius", "20", "--seed", "1", "--device", "cpu",
              "--loop-method", "isc", "--imu", "--wheel", "--gps", "--checkpoint-every", "12",
              "--verbose", "--out", str(out)] + small)
    cap = capsys.readouterr()
    summary = json.loads(cap.out)
    assert "scan 0: kf=1 loops=0" in cap.err and "slam" in cap.err and "checkpoint" in cap.err
    assert summary["scans"] == 16 and summary["keyframes"] >= 4
    for key, path in summary["artifacts"].items():
        assert (out / path.split("/")[-1]).exists(), key
    stamps, est = kitti.read_tum(summary["artifacts"]["odom_tum"])
    assert len(stamps) == summary["keyframes"]

    # ground truth in the camera frame, relative to the first pose
    gt = sim.loop_trajectory(n_scans=16, radius=20.0, speed=1.0)
    gt_rel = cli._gt_in_map_frame(gt)
    cam_T = sim.camera_frame_transform()
    gt_path = str(tmp_path / "gt_tum.txt")
    kitti.write_tum(gt_path, 0.1 * np.arange(16), cam_T @ gt_rel @ np.linalg.inv(cam_T))
    cli.main(["eval", "--est", summary["artifacts"]["odom_tum"], "--gt", gt_path])
    ev = json.loads(capsys.readouterr().out)
    assert ev["pairs"] == summary["keyframes"]
    assert abs(ev["ape_rmse_m"] - summary["ate_rmse_m"]) <= 1e-3
    assert abs(ev["rpe_rmse_m"] - summary["rpe_rmse_m"]) <= 1e-3
    # the KITTI ground-truth format, one row per scan
    kitti_path = str(tmp_path / "gt_kitti.txt")
    np.savetxt(kitti_path, (cam_T @ gt_rel @ np.linalg.inv(cam_T))[:, :3, :4].reshape(16, 12))
    assert cli.evaluate(summary["artifacts"]["odom_tum"], kitti_path,
                        gt_format="kitti")["ape_rmse_m"] == pytest.approx(ev["ape_rmse_m"], abs=1e-4)

    cli.main(["localize", "--session", str(out / "checkpoint.npz"), "--queries", "3",
              "--scans", "16", "--radius", "20", "--seed", "1", "--device", "cpu",
              "--fitness-thresh", "1.5"])
    loc = json.loads(capsys.readouterr().out)
    assert loc["queries"] == 3 and loc["localized"] >= 1
    assert loc["median_err_m"] < 1.0
    assert loc["results"][0]["found"] and loc["results"][0]["kf_idx"] == 0


def test_checkpoint_every_needs_an_output_directory():
    with pytest.raises(ValueError, match="output directory"):
        cli.run_sim(3, device="cpu", checkpoint_every=2)


def test_stage_timers():
    timers = StageTimers("cpu")
    for _ in range(3):
        with timers.time("a"):
            pass
    with pytest.raises(RuntimeError):
        with timers.time("b"):
            raise RuntimeError("x")
    assert timers.count["a"] == 3 and timers.count["b"] == 1      # counted though it raised
    assert timers.mean_ms("a") >= 0.0 and timers.mean_ms("never") == 0.0
    assert [ln.split()[0] for ln in timers.report().splitlines()] == ["a", "b"]
