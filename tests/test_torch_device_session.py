"""The device engine as a whole session on the CPU (its kernels' plain
routes): device-engine checkpoints crossing between the packages both ways,
the legacy `last_stamp` migration, a bit-identical resume, `localize`
against a device file, session continuation against the reference's
`continue_session`, and batched odometry against single-sequence steps and
the reference's `batch_step`. Small sizes; tolerances are stated per test."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xchu_slam_tpu import config as jconfig
from xchu_slam_tpu.models import (batch_odometry as jbatch, continue_session as jcs,
                                  device_pipeline as jdp, odometry as jodom)
from xchu_slam_tpu.ops import imu as jimu, ndt as jndt, voxel_map as jvm
from xchu_slam_tpu.types import make_cloud as jmake_cloud
from xchu_slam_tpu.utils import checkpoint as jckpt
from xchu_slam_tpu_torch import config as tconfig
from xchu_slam_tpu_torch.models import (batch_odometry as tbatch, continue_session as tcs,
                                        device_pipeline as tdp, odometry as todom,
                                        pipeline as tpipe, relocalize as treloc)
from xchu_slam_tpu_torch.ops import imu as timu, ndt as tndt, voxel_map as tvm
from xchu_slam_tpu_torch.utils import checkpoint as tckpt, sim

torch.set_num_threads(2)

N_MAP, SAVE_AT = 30, 19        # the checkpoints are written after scan SAVE_AT
OVERRIDES = {
    "filter.max_raw_points": 8192, "filter.max_points": 4096,
    "filter.outlier_method": "statistical",
    "ndt.grid_x": 48, "ndt.grid_y": 48, "ndt.grid_z": 16,
    "pgo.max_keyframes": 64, "pgo.max_loops": 8, "pgo.use_gps": True,
    "pgo.odom_noise_trans": 1e-3, "pgo.odom_noise_rot": 1e-3,
    "odom.use_imu": True, "odom.use_odom": True,
    "loop.method": "none",       # an arc: no revisit to detect in the mapped session
    "loop.submap_points": 2048, "loop.submap_half_width": 4,
    "loop.icp_fitness_thresh": 2.0, "sc.dist_thresh": 0.35,  # 1024-point clouds
}


def _cfg(mod):
    return mod.default_config().override(OVERRIDES)


def _feeds():
    """A 30-scan arc of a 12 m circle: scans of 6000 points, IMU and wheel
    windows and altimeter readings, from one generator."""
    world = sim.make_world(5, extent=50.0, ground_pts=40_000)
    gt = sim.loop_trajectory(N_MAP, radius=12.0, speed=1.0)
    stamps = 0.1 * np.arange(N_MAP)
    rng = np.random.default_rng(5)
    imu = sim.imu_windows(gt, stamps, samples=16, rng=rng, gyro_noise=0.002, accel_noise=0.05)
    whl = sim.wheel_windows(gt, stamps, samples=16, rng=rng, vel_noise=0.03, gyro_noise=0.002)
    alts = gt[:, 2] + rng.normal(0.0, 0.5, N_MAP)
    alts[rng.random(N_MAP) < 0.2] = np.nan
    scans = [sim.render_scan(world, p, rng, n_points=6000) for p in gt]
    return world, gt, stamps, imu, whl, alts, scans


def _feed_port(pipe, feeds, i):
    _, _, stamps, imu, whl, alts, scans = feeds
    pipe.process_scan(*scans[i], stamp=float(stamps[i]),
                      gps_alt=float(alts[i]) if np.isfinite(alts[i]) else None,
                      imu=timu.ImuWindow(*(a[i] for a in imu)),
                      wheel=timu.OdomWindow(*(a[i] for a in whl)))


def _feed_ref(pipe, feeds, i):
    _, _, stamps, imu, whl, alts, scans = feeds
    pipe.process_scan(jmake_cloud(*scans[i], capacity=8192), stamp=float(stamps[i]),
                      gps_alt=float(alts[i]) if np.isfinite(alts[i]) else None,
                      imu=jimu.ImuWindow(*(jnp.asarray(a[i]) for a in imu)),
                      wheel=jimu.OdomWindow(*(jnp.asarray(a[i]) for a in whl)))


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if tree is None or isinstance(tree, int):
        return tree
    return type(tree)(*(_clone(t) for t in tree))


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """N_MAP scans through the port's device engine and SAVE_AT + 1 through
    the reference's, each saving a device checkpoint after scan SAVE_AT; the
    port's state at the save and its uninterrupted run's log."""
    feeds = _feeds()
    d = tmp_path_factory.mktemp("device_session")
    paths = {"j": str(d / "ref.npz"), "t": str(d / "port.npz")}
    port = tdp.DeviceSlamPipeline(_cfg(tconfig), kf_points=1024, log_capacity=64,
                                  device="cpu")
    ref = jdp.DeviceSlamPipeline(_cfg(jconfig), kf_points=1024, log_capacity=64)
    saved = None
    for i in range(N_MAP):
        _feed_port(port, feeds, i)
        if i <= SAVE_AT:
            _feed_ref(ref, feeds, i)
        if i == SAVE_AT:
            tckpt.save_checkpoint(port, paths["t"])
            jckpt.save_checkpoint(ref, paths["j"])
            saved = _clone(port.state)
    port.finalize()
    return feeds, port, saved, paths


def _ref_arrays(state, cfg) -> dict:
    """The reference's `DevState` as the file's arrays (each grid's `fin`
    in its base form)."""
    arrays = jckpt._flatten("state", state)
    jckpt._slim_grid_fin(arrays, cfg)
    return arrays


def _port_arrays(state) -> dict:
    arrays = tckpt._flatten("state", state)
    del arrays["state.kf_count"]
    return arrays


def _same_leaves(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


def test_reference_loads_port_device_checkpoint(session):
    """The reference's `load_checkpoint` of a port-written device file is
    the port's state at the save, leaf by leaf, bit for bit."""
    _, port, saved, paths = session
    ref = jckpt.load_checkpoint(paths["t"])
    assert isinstance(ref, jdp.DeviceSlamPipeline)
    assert int(ref.state.scan_count) == SAVE_AT + 1
    assert int(ref.state.db.count) == int(saved.kf_count)
    _same_leaves(_ref_arrays(ref.state, ref.cfg), _port_arrays(saved))


def test_port_loads_reference_device_checkpoint(session):
    """The port's `load_checkpoint` of a reference-written device file is
    the reference's own reading of it, leaf by leaf, bit for bit; the
    pipeline is ready for its next chunk."""
    _, _, _, paths = session
    ref = jckpt.load_checkpoint(paths["j"])
    got = tckpt.load_checkpoint(paths["j"], device="cpu")
    assert isinstance(got, tdp.DeviceSlamPipeline) and got.spec.use_imu and got.spec.use_odom
    assert got.state.db.count == int(ref.state.db.count)
    assert int(got.state.kf_count) == got.state.db.count
    assert got._scans_fed == SAVE_AT + 1 and got.state.loop_count.dtype == torch.int64
    _same_leaves(_ref_arrays(ref.state, ref.cfg), _port_arrays(got.state))


def test_device_checkpoint_layout_is_the_references(session):
    """Both packages' device files hold the same keys with the same dtypes
    and shapes, and `__meta__` the same keys."""
    _, _, _, paths = session
    with np.load(paths["j"]) as fj, np.load(paths["t"]) as ft:
        assert set(fj.files) == set(ft.files)
        for k in fj.files:
            if k != "__meta__":
                assert fj[k].dtype == ft[k].dtype and fj[k].shape == ft[k].shape, k
        mj = json.loads(bytes(fj["__meta__"]).decode())
        mt = json.loads(bytes(ft["__meta__"]).decode())
    assert set(mj) == set(mt) and mt["engine"] == "device" and mt["log_capacity"] == 64
    assert json.loads(mt["config"]) == json.loads(mj["config"])


def test_legacy_last_stamp_migrates(session, tmp_path):
    """A device file without `state.last_stamp` (an older layout) loads with
    the newest stamp of its log ring, in both packages."""
    _, _, _, paths = session
    old = str(tmp_path / "legacy.npz")
    with np.load(paths["t"]) as f:
        data = {k: f[k] for k in f.files if k != "state.last_stamp"}
    np.savez_compressed(old, **data)
    got = tckpt.load_checkpoint(old, device="cpu")
    assert float(got.state.last_stamp) == np.float32(0.1 * SAVE_AT)
    assert float(jckpt.load_checkpoint(old).state.last_stamp) == float(got.state.last_stamp)


def test_device_resume_is_bit_identical(session):
    """Port → port: the pipeline loaded from the file continues the
    remaining 10 scans to the uninterrupted run's poses, log rows, keyframe
    store and graph, bit for bit."""
    feeds, port, _, paths = session
    again = tckpt.load_checkpoint(paths["t"], device="cpu")
    for i in range(SAVE_AT + 1, N_MAP):
        _feed_port(again, feeds, i)
    again.finalize()
    assert again.scan_count == port.scan_count == N_MAP
    np.testing.assert_array_equal(again.odometry_trajectory(),
                                  port.odometry_trajectory()[-len(again.odom_log):])
    assert len(again.odom_log) == N_MAP
    assert again.kf_count == port.kf_count and again.loop_count == port.loop_count
    for a, b in zip(again.db[:-1] + again.graph, port.db[:-1] + port.graph):
        assert torch.equal(a, b)
    assert torch.equal(again.state.imu_vel, port.state.imu_vel)


def test_localizer_from_device_checkpoint(session):
    feeds, _, saved, paths = session
    loc = treloc.localizer_from_checkpoint(paths["t"], device="cpu")
    assert loc.db.count == int(saved.kf_count) > 3
    r = loc.localize(*feeds[6][0], max_points=256)     # the scan keyframe 0 was made from
    assert r.kf_idx == 0 and r.sc_dist < 1e-6 and np.isfinite(r.icp_fitness)


# ---------------------------------------------------------- continuation -- #
def _continuation_scans(feeds, n=9):
    """A second session's first n scans along the same path, with noise of
    their own."""
    world, gt = feeds[0], feeds[1]
    rng = np.random.default_rng(55)
    return [sim.render_scan(world, p, rng, n_points=6000) for p in gt[:n]]


def test_continue_session_matches_reference(session):
    """Both packages continue the reference-written file from the same first
    scan: the same K0 and matched keyframe, the seeded store row, between
    factor and loop factor within 1e-4 (the loop's information within 1e-4
    relative), then 8 more scans with poses within 1e-3."""
    feeds, _, _, paths = session
    scans = _continuation_scans(feeds)
    t0 = 100.0
    jp = jcs.continue_session(paths["j"], *scans[0], stamp=t0, log_capacity=64)
    tp = tcs.continue_session(paths["j"], *scans[0], stamp=t0, log_capacity=64, device="cpu")
    K0 = tp.continuation["old_keyframes"]
    assert K0 == jp.continuation["old_keyframes"] > 3
    assert tp.continuation["matched_kf"] == jp.continuation["matched_kf"] == 0
    js, ts = jp.state, tp.state
    q = int(js.loop_count) - 1
    assert int(ts.loop_count) == int(js.loop_count) and ts.db.count == K0 + 1
    assert int(ts.graph.loop_i[q]) == int(js.graph.loop_i[q]) and \
        int(ts.graph.loop_j[q]) == int(js.graph.loop_j[q]) == K0
    for t, j in ((ts.db.poses[K0], js.db.poses[K0]), (ts.db.opt_poses[K0], js.db.opt_poses[K0]),
                 (ts.db.travel[K0], js.db.travel[K0]), (ts.db.stamps[K0], js.db.stamps[K0]),
                 (ts.graph.between_T[K0], js.graph.between_T[K0]),
                 (ts.graph.loop_T[q], js.graph.loop_T[q])):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4)
    np.testing.assert_allclose(float(ts.graph.loop_info[q]), float(js.graph.loop_info[q]),
                               rtol=1e-4)
    assert bool(ts.graph.kf_mask[K0]) and bool(ts.graph.loop_mask[q])
    np.testing.assert_array_equal(ts.db.clouds[K0].numpy(), np.asarray(js.db.clouds[K0]))
    np.testing.assert_allclose(ts.log[0, :6].numpy(), np.asarray(js.log[0, :6]), atol=1e-4)
    np.testing.assert_array_equal(ts.log[0, 6:].numpy(), np.asarray(js.log[0, 6:]))
    _, _, stamps, imu, whl, _, _ = feeds
    for i in range(1, len(scans)):
        stamp = t0 + float(stamps[i])
        tp.process_scan(*scans[i], stamp=stamp, imu=timu.ImuWindow(*(a[i] for a in imu)),
                        wheel=timu.OdomWindow(*(a[i] for a in whl)))
        jp.process_scan(jmake_cloud(*scans[i], capacity=8192), stamp=stamp,
                        imu=jimu.ImuWindow(*(jnp.asarray(a[i]) for a in imu)),
                        wheel=jimu.OdomWindow(*(jnp.asarray(a[i]) for a in whl)))
    tp.finalize()
    jp.finalize()
    assert tp.scan_count == jp.scan_count == len(scans)
    np.testing.assert_allclose(tp.odometry_trajectory(), jp.odometry_trajectory(), atol=1e-3)
    assert tp.kf_count == jp.kf_count > K0 + 1


def test_continuation_errors(session, tmp_path):
    """`ContinuationError` for a first scan far outside the saved map and
    for a host-engine file."""
    feeds, _, _, paths = session
    world = feeds[0]
    far = np.array([400.0, 400.0, 0.0, 0.0, 0.0, 0.3], np.float32)
    xyz, inten = sim.render_scan(world, far, np.random.default_rng(7), n_points=6000)
    with pytest.raises(tcs.ContinuationError, match="relocalization failed"):
        tcs.continue_session(paths["t"], xyz, inten, device="cpu")
    host = tpipe.SlamPipeline(_cfg(tconfig).override({"odom.use_imu": False,
                                                      "odom.use_odom": False}),
                              kf_points=512)
    for i in range(2):
        host.process_scan(*feeds[6][i], stamp=0.1 * i)
    path = str(tmp_path / "host.npz")
    tckpt.save_checkpoint(host, path)
    with pytest.raises(tcs.ContinuationError, match="device-engine checkpoint"):
        tcs.continue_session(path, *feeds[6][0], device="cpu")


# ------------------------------------------------------ batched odometry -- #
def test_batch_matches_single():
    """The reference's `test_batch_matches_single` on the port: B = 3
    sequences of 6 scans, batched poses bit-equal to the port's
    single-sequence steps, within 1e-3 of the reference's `batch_step`, and
    on the ground truth within its bound (0.3 m)."""
    B, n_scans, n_pts = 3, 6, 4096
    worlds = [sim.make_world(s, extent=70.0, ground_pts=40_000) for s in range(B)]
    trajs = [sim.loop_trajectory(n_scans=40, radius=30.0 + 5 * s, speed=1.0)[:n_scans]
             for s in range(B)]
    rngs = [np.random.default_rng(s) for s in range(B)]

    def scan(b, i):
        xyz, _ = sim.render_scan(worlds[b], trajs[b][i], rngs[b], n_points=6000)
        out = np.zeros((n_pts, 3), np.float32)
        m = np.zeros(n_pts, bool)
        n = min(len(xyz), n_pts)
        out[:n], m[:n] = xyz[:n], True
        return out, m

    scans = [[scan(b, i) for i in range(n_scans)] for b in range(B)]
    xyz = np.stack([np.stack([scans[b][i][0] for b in range(B)]) for i in range(n_scans)])
    mask = np.stack([np.stack([scans[b][i][1] for b in range(B)]) for i in range(n_scans)])
    poses0 = np.stack([trajs[b][0] for b in range(B)]).astype(np.float32)
    gkw = dict(gx=48, gy=48, gz=12, resolution=2.0, min_points=6, eig_inflation=0.01)
    okw = dict(min_add_scan_shift=0.5, max_localmap_size=5.0, recentre_margin=10.0)
    tspec = todom.OdomSpec(gspec=tvm.GridSpec(**gkw), nspec=tndt.NdtSpec(max_iterations=20),
                           **okw)
    jspec = jodom.OdomSpec(gspec=jvm.GridSpec(**gkw), nspec=jndt.NdtSpec(max_iterations=20),
                           **okw)

    states = tbatch.batch_init(tspec, torch.from_numpy(poses0), torch.from_numpy(xyz[0]),
                               torch.from_numpy(mask[0]))
    jstates = jbatch.batch_init(jspec, jnp.asarray(poses0), jnp.asarray(xyz[0]),
                                jnp.asarray(mask[0]))
    batched, jbatched = [], []
    for i in range(1, n_scans):
        states, out = tbatch.batch_step(states, torch.from_numpy(xyz[i]),
                                        torch.from_numpy(mask[i]), tspec)
        jstates, jout = jbatch.batch_step(jstates, jnp.asarray(xyz[i]), jnp.asarray(mask[i]),
                                          jspec)
        assert out.pose.shape == (B, 6) and out.iterations.shape == (B,)
        batched.append(out.pose.numpy())
        jbatched.append(np.asarray(jout.pose))
    batched, jbatched = np.stack(batched, axis=1), np.stack(jbatched, axis=1)
    for b in range(B):
        st = todom.init_state(tspec, torch.from_numpy(poses0[b]), torch.from_numpy(xyz[0, b]),
                              torch.from_numpy(mask[0, b]))
        single = []
        for i in range(1, n_scans):
            st, out = todom.step(st, torch.from_numpy(xyz[i, b]), torch.from_numpy(mask[i, b]),
                                 tspec)
            single.append(out.pose.numpy())
        np.testing.assert_array_equal(batched[b], np.stack(single))
        np.testing.assert_allclose(batched[b], jbatched[b], atol=1e-3)
        err = np.linalg.norm(batched[b][:, :2] - trajs[b][1:, :2], axis=1)
        assert err.max() < 0.3, (b, err)
    # the batched state is each member's, stacked
    assert states.grid_a.fin.shape[0] == B and torch.equal(states.grid_a.fin[B - 1],
                                                           st.grid_a.fin)

