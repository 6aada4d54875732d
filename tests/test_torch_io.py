"""The port's file formats against the JAX reference's: the numpy copy of
`io/kitti.py`, the PCD / g2o / markers writers, and `save_run` on the same
pipeline state carried across by `convert`. Tolerances per test."""

import inspect
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xchu_slam_tpu import config as jconfig
from xchu_slam_tpu.io import export as jexport, kitti as jkitti
from xchu_slam_tpu.models import pipeline as jpipe, pose_graph as jpg
from xchu_slam_tpu_torch import config as tconfig, convert
from xchu_slam_tpu_torch.io import export as texport, kitti as tkitti
from xchu_slam_tpu_torch.models import pipeline as tpipe
from xchu_slam_tpu_torch.utils import se3

torch.set_num_threads(2)


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    p = np.c_[rng.uniform(-60, 60, (n, 2)), rng.uniform(-2, 2, n),
              rng.uniform(-0.1, 0.1, (n, 2)), rng.uniform(-3.1, 3.1, n)].astype(np.float32)
    return se3.pose_to_matrix(torch.from_numpy(p)).numpy().astype(np.float64)


# ------------------------------------------------------------- kitti ---- #

def test_kitti_module_is_a_copy():
    """Every function of the numpy copy has the original's source, and the
    extrinsic is the original's."""
    names = ["read_velodyne_bin", "list_velodyne_dir", "quat_to_matrix",
             "matrix_to_quat", "read_tum", "write_tum", "read_kitti_poses",
             "velo_to_cam"]
    for name in names:
        assert inspect.getsource(getattr(tkitti, name)) == \
            inspect.getsource(getattr(jkitti, name)), name
    assert np.array_equal(tkitti.T_CAM_VELO, jkitti.T_CAM_VELO)


def test_quaternions_cover_every_branch():
    """matrix_to_quat's four branches (trace > 0 and each dominant axis)
    round-trip through quat_to_matrix to 1e-12."""
    for rpy in ([0.1, 0.2, 0.3], [3.0, 0.1, 0.1], [0.1, 3.0, 0.2], [0.1, 0.2, 3.0]):
        R = se3.euler_to_matrix(torch.tensor(rpy, dtype=torch.float64)).numpy()
        q = tkitti.matrix_to_quat(R)
        np.testing.assert_allclose(tkitti.quat_to_matrix(q), R, atol=1e-12)
        assert np.array_equal(q, jkitti.matrix_to_quat(R))


@pytest.mark.parametrize("writer,reader", [(tkitti, jkitti), (jkitti, tkitti)])
def test_tum_files_cross_between_packages(tmp_path, writer, reader):
    """A TUM file written by one package is read by the other with equal
    arrays (and by its own package too); one-row files keep their shape."""
    T = _poses(9, 1)
    stamps = 0.1 * np.arange(9)
    path = str(tmp_path / "traj.txt")
    writer.write_tum(path, stamps, T)
    s_a, T_a = reader.read_tum(path)
    s_b, T_b = writer.read_tum(path)
    assert np.array_equal(s_a, s_b) and np.array_equal(T_a, T_b)
    np.testing.assert_allclose(s_a, stamps, atol=1e-6)
    np.testing.assert_allclose(T_a, T, atol=2e-6)
    writer.write_tum(path, stamps[:1], T[:1])
    assert reader.read_tum(path)[1].shape == (1, 4, 4)


def test_kitti_pose_and_velodyne_readers(tmp_path):
    T = _poses(5, 2)
    path = str(tmp_path / "00.txt")
    np.savetxt(path, T[:, :3, :4].reshape(5, 12))
    assert np.array_equal(tkitti.read_kitti_poses(path), jkitti.read_kitti_poses(path))
    np.testing.assert_allclose(tkitti.read_kitti_poses(path), T, atol=1e-12)
    np.testing.assert_array_equal(tkitti.velo_to_cam(T), jkitti.velo_to_cam(T))
    scan = np.random.default_rng(3).normal(size=(50, 4)).astype(np.float32)
    scan[7, 1] = np.nan
    for name in ("000001.bin", "000000.bin"):
        scan.tofile(str(tmp_path / name))
    files = tkitti.list_velodyne_dir(str(tmp_path))
    assert [os.path.basename(f) for f in files] == ["000000.bin", "000001.bin"]
    pts = tkitti.read_velodyne_bin(files[0])
    assert pts.shape == (49, 4) and np.array_equal(pts, jkitti.read_velodyne_bin(files[0]))


# ------------------------------------------------------------ export ---- #

def _tokens_close(a: str, b: str, atol: float):
    """Two text files have the same lines, tokens and order; tokens that
    parse as numbers agree within `atol`, the others are equal."""
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        tx, ty = x.split(), y.split()
        assert len(tx) == len(ty), (x, y)
        for u, v in zip(tx, ty):
            try:
                fu, fv = float(u), float(v)
            except ValueError:
                assert u == v, (x, y)
            else:
                assert abs(fu - fv) <= atol, (x, y)


def _json_close(a, b, atol):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _json_close(a[k], b[k], atol)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _json_close(u, v, atol)
    elif isinstance(a, float):
        assert abs(a - b) <= atol
    else:
        assert a == b


@pytest.mark.parametrize("binary", [True, False])
def test_pcd_files_cross_between_packages(tmp_path, binary):
    xyz = np.random.default_rng(4).normal(size=(200, 3)).astype(np.float32) * 30
    pa, pb = str(tmp_path / "a.pcd"), str(tmp_path / "b.pcd")
    texport.write_pcd(pa, xyz, binary=binary)
    jexport.write_pcd(pb, xyz, binary=binary)
    with open(pa, "rb") as fa, open(pb, "rb") as fb:
        assert fa.read() == fb.read()
    tol = 0 if binary else 1e-6
    np.testing.assert_allclose(jexport.read_pcd(pa), xyz, rtol=0, atol=tol)
    np.testing.assert_allclose(texport.read_pcd(pb), xyz, rtol=0, atol=tol)
    texport.write_pcd(pa, np.zeros((0, 3), np.float32))
    assert texport.read_pcd(pa).shape == (0, 3)


def test_g2o_and_markers_identical_for_identical_input(tmp_path):
    """The writers are pure numpy: the same arrays give the same bytes."""
    T = _poses(12, 5)
    between = np.einsum("kab,kbc->kac", np.linalg.inv(np.roll(T, 1, 0)), T)
    loops = [(0, 10, np.linalg.inv(T[0]) @ T[10], 3.5), (2, 11, np.linalg.inv(T[2]) @ T[11], 0.25)]
    for mod, tag in ((texport, "t"), (jexport, "j")):
        mod.write_g2o(str(tmp_path / f"{tag}.g2o"), T, between, loops, odom_info=(1e3, 1e2))
        mod.write_markers(str(tmp_path / f"{tag}.json"), T, [(i, j) for i, j, *_ in loops])
    for ext in ("g2o", "json"):
        assert (tmp_path / f"t.{ext}").read_text() == (tmp_path / f"j.{ext}").read_text()
    lines = (tmp_path / "t.g2o").read_text().splitlines()
    assert sum(ln.startswith("VERTEX_SE3:QUAT") for ln in lines) == 12
    assert sum(ln.startswith("EDGE_SE3:QUAT") for ln in lines) == 11 + 2


def _cfg(mod, K=24, L=6):
    return mod.SlamConfig(pgo=mod.PgoConfig(max_keyframes=K, max_loops=L,
                                            odom_noise_trans=1e-3, odom_noise_rot=1e-2))


@pytest.fixture(scope="module")
def twin_pipelines():
    """One pipeline state in both packages: 17 live keyframes of random
    clouds on an arc, 2 loops, a short odometry log; made in the reference's
    layout and carried to the port by `convert`."""
    rng = np.random.default_rng(8)
    K, P, n, L = 24, 256, 17, 6
    jp = jpipe.SlamPipeline(_cfg(jconfig, K, L), kf_points=P)
    ang = np.linspace(0, 2.5, K)
    poses = np.c_[30 * np.cos(ang), 30 * np.sin(ang), 0.05 * np.arange(K),
                  rng.normal(size=(K, 2)) * 0.02, ang + np.pi / 2].astype(np.float32)
    opt = poses + rng.normal(size=(K, 6)).astype(np.float32) * [0.1, 0.1, 0.02, 0, 0, 0.01]
    T = np.asarray(jnp.asarray(se3.pose_to_matrix(torch.from_numpy(poses)).numpy()))
    between = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    between[1:n] = np.einsum("kab,kbc->kac", np.linalg.inv(T[:n - 1]), T[1:n])
    g = jpg.empty_graph(jp.gspec)
    loop_T = np.array(g.loop_T)
    loop_T[0], loop_T[1] = np.linalg.inv(T[1]) @ T[15], np.linalg.inv(T[0]) @ T[16]
    jp.graph = g._replace(
        between_T=jnp.asarray(between), kf_mask=jnp.arange(K) < n,
        loop_i=jnp.asarray([1, 0, 0, 0, 0, 0], jnp.int32),
        loop_j=jnp.asarray([15, 16, 0, 0, 0, 0], jnp.int32),
        loop_T=jnp.asarray(loop_T),
        loop_info=jnp.asarray([2.5, 1.25, 0, 0, 0, 0], jnp.float32),
        loop_mask=jnp.arange(L) < 2)
    jp.db = jp.db._replace(
        poses=jnp.asarray(poses), opt_poses=jnp.asarray(opt.astype(np.float32)),
        stamps=jnp.asarray(0.3 * np.arange(K), jnp.float32),
        clouds=jnp.asarray(rng.normal(size=(K, P, 3)).astype(np.float32) * [12, 12, 2]),
        cloud_mask=jnp.asarray(rng.random((K, P)) > 0.25),
        isc_db=jnp.asarray(rng.random((K, 60, 60)).astype(np.float32)),
        count=jnp.int32(n))
    jp.kf_count, jp.loop_count = n, 2
    jp.odom_log = [{"stamp": 0.1 * i, "pose": poses[i], "iterations": 3 + i,
                    "matched_frac": 0.5, "fitness": 0.25} for i in range(1, 5)]
    tp = tpipe.SlamPipeline(_cfg(tconfig, K, L), kf_points=P)
    tp.db = convert.kfdb_from_ref(type(jp.db)(*(np.asarray(a) for a in jp.db)))
    tp.graph = convert.graph_from_ref(type(jp.graph)(*(np.asarray(a) for a in jp.graph)))
    tp.kf_count, tp.loop_count, tp.odom_log = n, 2, jp.odom_log
    return jp, tp


def test_assemble_map_matches_reference(twin_pipelines):
    """Every valid keyframe point at its optimized pose within 1e-4 of the
    reference's (no dedup), and the deduplicated map the same size; an empty
    pipeline gives an empty map."""
    jp, tp = twin_pipelines
    raw_j, raw_t = jp.assemble_map(voxel=0.0), tp.assemble_map(voxel=0.0)
    assert raw_t.shape == raw_j.shape == (int(np.asarray(jp.db.cloud_mask[:17]).sum()), 3)
    np.testing.assert_allclose(raw_t, raw_j, rtol=0, atol=1e-4)
    assert tp.assemble_map(voxel=0.5).shape == jp.assemble_map(voxel=0.5).shape
    assert len(tp.assemble_map(voxel=0.5, max_points=100)) == 100
    assert tpipe.SlamPipeline(_cfg(tconfig), kf_points=8).assemble_map().shape == (0, 3)


def test_save_run_matches_reference(twin_pipelines, tmp_path):
    """The same state exported by both packages: g2o, TUM and odometry-log
    files with the same lines, tokens and order and every number within
    2e-6 (both print float32 trigonometry that may differ in the last ulp);
    markers.json the same structure within 2e-6; the PCD files with the same
    point count and the same points to 1e-4."""
    jp, tp = twin_pipelines
    cam_T = np.eye(4)
    cam_T[:3, :3] = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    pj = jexport.save_run(jp, dj, cam_T=cam_T)
    pt = texport.save_run(tp, dt, cam_T=cam_T)
    assert set(pt) - {"map_png"} == set(pj) - {"map_png"}
    assert {"odom_tum", "lidar_odom", "trajectory_pcd", "final_map_pcd", "g2o",
            "markers", "odom_log"} <= set(pt)
    for key in ("odom_tum", "lidar_odom", "g2o", "odom_log"):
        with open(pj[key]) as fj, open(pt[key]) as ft:
            _tokens_close(ft.read(), fj.read(), 2e-6)
    with open(pj["markers"]) as fj, open(pt["markers"]) as ft:
        _json_close(json.load(ft), json.load(fj), 2e-6)
    for key in ("trajectory_pcd", "final_map_pcd"):
        a, b = texport.read_pcd(pt[key]), jexport.read_pcd(pj[key])
        assert a.shape == b.shape and len(a) > 0
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    s, T = tkitti.read_tum(pt["odom_tum"])
    assert len(s) == 17 and np.isfinite(T).all()
    with open(pt["g2o"]) as f:
        assert sum(ln.startswith("EDGE_SE3:QUAT") for ln in f) == 16 + 2
    # the two other frames of the TUM export
    for kw in ({}, {"to_camera_frame": True}):
        a = texport.save_run(tp, str(tmp_path / "t2"), **kw)
        b = jexport.save_run(jp, str(tmp_path / "j2"), **kw)
        with open(a["odom_tum"]) as fa, open(b["odom_tum"]) as fb:
            _tokens_close(fa.read(), fb.read(), 2e-6)
