"""The port's SLAM pipeline end to end: a 30-scan prefix against the JAX
host engine, a loop circuit on the port alone, the keyframe-database
helpers, and the CLI."""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xchu_slam_tpu import config as jconfig
from xchu_slam_tpu.models import pipeline as jpipe
from xchu_slam_tpu_torch import cli, config as tconfig, convert
from xchu_slam_tpu_torch.models import pipeline as tpipe
from xchu_slam_tpu_torch.ops.cuda import _build, ndt_kernel
from xchu_slam_tpu_torch.utils import metrics, se3, sim

torch.set_num_threads(2)


def _small(mod):
    return mod.SlamConfig(
        filter=mod.FilterConfig(max_raw_points=8192, max_points=2048,
                                outlier_method="statistical"),
        ndt=mod.NdtConfig(grid_x=40, grid_y=40, grid_z=12, max_iterations=20),
        loop=mod.LoopConfig(submap_points=2048, submap_half_width=5),
        pgo=mod.PgoConfig(max_keyframes=64, max_loops=8))


def test_pipeline_prefix_matches_reference():
    """30 scans through both host engines: per-scan poses within 1e-3 m
    (rad), identical keyframe flags and Newton iteration counts."""
    world = sim.make_world(2, extent=50.0, ground_pts=40_000)
    gt = sim.loop_trajectory(30, radius=15.0, speed=1.0)
    rng = np.random.default_rng(2)
    scans = [sim.render_scan(world, p, rng, n_points=6000) for p in gt]
    jp = jpipe.SlamPipeline(_small(jconfig), kf_points=512)
    tp = tpipe.SlamPipeline(_small(tconfig), kf_points=512)
    for i, (xyz, inten) in enumerate(scans):
        rj = jp.process_scan(xyz, inten, stamp=0.1 * i)
        rt = tp.process_scan(xyz, inten, stamp=0.1 * i)
        np.testing.assert_allclose(rt["pose"], rj["pose"], atol=1e-3)
        assert rt["keyframe"] == rj["keyframe"]
    assert [r["iterations"] for r in tp.odom_log] == [r["iterations"] for r in jp.odom_log]
    assert tp.kf_count == jp.kf_count > 5
    _, kj, oj = jp.keyframe_trajectory()
    _, kt, ot = tp.keyframe_trajectory()
    np.testing.assert_allclose(kt, kj, atol=1e-3)
    np.testing.assert_allclose(ot, oj, atol=1e-3)


def _circuit_cfg():
    """tests/test_pipeline.py's circuit config, on the port."""
    return tconfig.SlamConfig(
        filter=tconfig.FilterConfig(max_raw_points=16384, max_points=8192,
                                    outlier_method="none"),
        ndt=tconfig.NdtConfig(grid_x=72, grid_y=72, grid_z=16, max_iterations=30),
        loop=tconfig.LoopConfig(method="sc", detect_period=2, submap_half_width=10,
                                submap_points=16384, icp_fitness_thresh=0.5),
        pgo=tconfig.PgoConfig(max_keyframes=256, max_loops=32,
                              odom_noise_trans=1e-3, odom_noise_rot=1e-3,
                              gn_iterations=6, cg_iterations=80))


@pytest.fixture(scope="module")
def circuit():
    """The reference's pipeline-test circuit (tests/test_pipeline.py) on the
    port, with 2048-point keyframe clouds instead of 4096 to halve the ICP
    cost on the CPU."""
    pipe = tpipe.SlamPipeline(_circuit_cfg(), kf_points=2048)
    world = sim.make_world(21, extent=70.0, ground_pts=80_000)
    radius = 25.0
    n_scans = int(7.02 * radius) + 40
    gt = sim.loop_trajectory(n_scans=n_scans, radius=radius, speed=1.0)
    rng = np.random.default_rng(21)
    for i, p in enumerate(gt):
        xyz, inten = sim.render_scan(world, p, rng, n_points=12_000, max_range=50.0)
        pipe.process_scan(xyz, inten, stamp=0.1 * i)
    pipe.finalize()
    return pipe, gt


def test_circuit_closes_loops(circuit):
    pipe, _ = circuit
    assert 70 < pipe.kf_count < 140
    assert pipe.loop_count >= 1
    assert pipe.icp_verifications >= pipe.loop_count
    for rec in pipe.loops:
        assert rec.fitness <= pipe.cfg.loop.icp_fitness_thresh
        assert rec.j - rec.i > 10


def test_circuit_trajectory_accuracy(circuit):
    pipe, gt = circuit
    gtT = se3.pose_to_matrix(torch.from_numpy(gt)).numpy()
    gt_xyz = np.einsum("ab,nbc->nac", np.linalg.inv(gtT[0]), gtT)[:, :3, 3]
    odo = pipe.odometry_trajectory()
    ate_odo = metrics.ape_rmse(odo[:, :3], gt_xyz[1:len(odo) + 1], align=False)
    stamps, _, kf_opt = pipe.keyframe_trajectory()
    idx = np.round(stamps / 0.1).astype(int)
    ate_opt = metrics.ape_rmse(kf_opt[:, :3], gt_xyz[idx], align=False)
    assert ate_opt < 1.0, (ate_odo, ate_opt)
    assert ate_opt <= ate_odo * 1.2 + 0.05


def test_circuit_loop_transforms_accurate(circuit):
    pipe, gt = circuit
    stamps, _, _ = pipe.keyframe_trajectory()
    idx = np.round(stamps / 0.1).astype(int)
    gtT = se3.pose_to_matrix(torch.from_numpy(gt)).numpy()
    for q, rec in enumerate(pipe.loops):
        Z = pipe.graph.loop_T[q].numpy()
        true_rel = np.linalg.inv(gtT[idx[rec.i]]) @ gtT[idx[rec.j]]
        assert np.linalg.norm(Z[:3, 3] - true_rel[:3, 3]) < 0.25 + 1.0 * rec.fitness


def _ref_db(rng, K=24, P=256, count=17):
    cfg = jconfig.SlamConfig(pgo=jconfig.PgoConfig(max_keyframes=K))
    db = jpipe.empty_db(cfg, P)
    poses = np.c_[rng.uniform(-20, 20, (K, 2)), np.zeros(K),
                  np.zeros((K, 2)), rng.uniform(-3, 3, K)].astype(np.float32)
    clouds = rng.normal(size=(K, P, 3)).astype(np.float32) * 10
    mask = rng.random((K, P)) > 0.3
    return db._replace(poses=jnp.asarray(poses), opt_poses=jnp.asarray(poses + 0.1),
                       stamps=jnp.arange(K, dtype=jnp.float32),
                       clouds=jnp.asarray(clouds), cloud_mask=jnp.asarray(mask),
                       isc_db=jnp.asarray(rng.random(db.isc_db.shape).astype(np.float32)),
                       count=jnp.int32(count))


def test_keyframe_db_helpers_match_reference():
    rng = np.random.default_rng(4)
    jdb = _ref_db(rng)
    tdb = convert.kfdb_from_ref(type(jdb)(*(np.asarray(a) for a in jdb)))
    for centre, frame in [(3, 3), (16, 10), (0, 0)]:
        ja = [np.asarray(a) for a in jpipe.build_submap(
            jdb, jnp.int32(centre), jnp.int32(frame), 4, 1024)]
        ta = [a.numpy() for a in tpipe.build_submap(tdb, centre, frame, 4, 1024)]
        assert np.array_equal(ta[1], ja[1]) and np.array_equal(ta[2], ja[2])
        np.testing.assert_allclose(ta[0], ja[0], atol=1e-4)
    xyz = rng.normal(size=(500, 3)).astype(np.float32)
    mask = rng.random(500) > 0.5
    for n_out in (64, 400):
        ja = [np.asarray(a) for a in jpipe.subsample_cloud(jnp.asarray(xyz), jnp.asarray(mask), n_out)]
        ta = [a.numpy() for a in tpipe.subsample_cloud(torch.from_numpy(xyz),
                                                       torch.from_numpy(mask), n_out)]
        for a, b in zip(ta, ja):
            assert np.array_equal(a, b)
    jr = jpipe._radius_candidate(jdb, jnp.int32(16), jnp.float32(16.0), 20.0, 5.0)
    assert tpipe._radius_candidate(tdb, 16, 16.0, 20.0, 5.0) == \
        (int(jr[0]) if bool(jr[1]) else -1)


def test_convert_kfdb_roundtrip():
    jdb = _ref_db(np.random.default_rng(5))
    ref = type(jdb)(*(np.asarray(a) for a in jdb))
    back = convert.kfdb_to_ref(convert.kfdb_from_ref(ref))
    for f in ref._fields:
        assert np.array_equal(back[f], getattr(ref, f)), f
    assert back["isc_db"].any()      # the ISC images are carried both ways


def test_cli_run_sim_on_cpu(capsys, tmp_path):
    """The CLI's summary on a short circuit at reduced capacities."""
    cli.main(["run-sim", "--scans", "12", "--radius", "20", "--device", "cpu",
              "--out", str(tmp_path / "sim"),
              "--set", "filter.max_points=4096", "--set", "pgo.max_keyframes=64"])
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"scans", "keyframes", "loops", "ate_rmse_m",
                        "ate_unaligned_m", "rpe_rmse_m", "end_drift_m", "length_m",
                        "drift_pct", "scans_per_sec", "artifacts"}
    assert out["scans"] == 12 and out["keyframes"] >= 3
    assert out["ate_rmse_m"] < 0.1
    assert all((tmp_path / "sim").joinpath(name).exists()
               for name in ("odom_tum.txt", "finalMap.pcd", "pose_graph.g2o"))


@pytest.mark.parametrize("sensors", [False, True], ids=["plain", "imu-wheel-gps"])
def test_host_engine_on_cpu_takes_the_plain_ndt_version(monkeypatch, sensors):
    """`run-sim --engine host --device cpu`, with and without the sensor
    guess: the NDT kernel's launch function is never reached, and every scan
    logs its trip count as an int."""
    def no_launch(*_a, **_k):
        raise AssertionError("the NDT kernel was reached on CPU tensors")

    monkeypatch.setattr(ndt_kernel, "_launch", no_launch)
    before = ndt_kernel.launches
    kw = dict(loop_method="isc", imu=True, wheel=True, gps=True) if sensors else {}
    pipe, summary = cli.run_sim(8, 20.0, 0, "cpu", overrides=(
        "filter.max_points=4096", "pgo.max_keyframes=64", "loop.submap_points=4096"), **kw)
    assert ndt_kernel.launches == before
    assert summary["scans"] == 8 and len(pipe.odom_log) == 7
    assert all(type(r["iterations"]) is int and r["iterations"] >= 1
               for r in pipe.odom_log)
    assert summary["ate_rmse_m"] < 0.1


def test_no_cpu_fallback_without_a_card():
    """Asking for the card where there is none fails; it does not run on the
    CPU. Building the kernel without nvcc fails too."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit):
        cli.main(["run-sim", "--scans", "3", "--device", "cuda"])
    if shutil.which("nvcc") is None and not \
            os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError):
            _build.nvcc()
