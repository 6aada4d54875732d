"""The port's NDT derivatives, alignment and odometry step against the JAX
reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from xchu_slam_tpu.config import tiny_config as jtiny
from xchu_slam_tpu.models import odometry as jodom
from xchu_slam_tpu.ops import filter as jfilter, ndt as jndt, ndt_deriv as jderiv, voxel_map as jvm
from xchu_slam_tpu.types import make_cloud as jmake_cloud
from xchu_slam_tpu.utils import compile_cache
from xchu_slam_tpu_torch import convert
from xchu_slam_tpu_torch.config import tiny_config as ttiny
from xchu_slam_tpu_torch.models import odometry as todom
from xchu_slam_tpu_torch.ops import ndt as tndt, ndt_deriv as tderiv, voxel_map as tvm
from xchu_slam_tpu_torch.ops.cuda import ndt_kernel
from xchu_slam_tpu_torch.utils import sim

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(x):
    return type(x)(*(_np_tree(a) if isinstance(a, tuple) else np.asarray(a) for a in x))


@pytest.fixture(scope="module")
def graft():
    """The `__graft_entry__.entry()` fixture: grid, 1024-pt source, mask and
    initial pose, with its specs. The persistent-cache switch in entry() is
    skipped so the test keeps its worker's own cache directory."""
    mp = pytest.MonkeyPatch()
    mp.setattr(compile_cache, "enable", lambda *a, **k: None)
    try:
        fn, (grid, src, mask, pose0) = __graft_entry__.entry()
    finally:
        mp.undo()
    gspec = jvm.GridSpec(gx=32, gy=32, gz=12, resolution=2.0, min_points=6,
                         eig_inflation=0.01)
    nspec = jndt.NdtSpec(max_iterations=10, ls_max_trials=5)
    return fn, grid, np.asarray(src), np.asarray(mask), np.asarray(pose0), gspec, nspec


def test_gauss_constants_match_reference():
    for ratio, res in [(0.55, 2.0), (0.3, 1.0), (0.7, 0.5)]:
        assert tndt.gauss_constants(ratio, res) == jndt.gauss_constants(ratio, res)


@pytest.mark.parametrize("want_hess", [True, False])
@pytest.mark.parametrize("pose", [
    [0.3, -0.2, 0.1, 0.02, -0.01, 0.05],
    [-1.5, 0.8, -0.2, -0.05, 0.04, 0.6],
])
def test_ndt_value_grad_hess_matches_reference(graft, want_hess, pose):
    """L, g and H to 1e-4 relative (to the largest entry of each)."""
    _, grid, src, mask, _, gspec, _ = graft
    tgrid = convert.voxel_grid_from_ref(_np_tree(grid), tvm.GridSpec(*gspec))
    d1, d2 = jndt.gauss_constants(0.55, 2.0)
    p = np.asarray(pose, np.float32)
    Lj, gj, Hj = (np.asarray(a) for a in jderiv.ndt_value_grad_hess(
        jnp.asarray(p), jnp.asarray(src), jnp.asarray(mask), grid, gspec, d1, d2,
        want_hess=want_hess))
    Lt, gt, Ht = (a.numpy() for a in tderiv.ndt_value_grad_hess(
        _t(p), _t(src), _t(mask), tgrid, tvm.GridSpec(*gspec), d1, d2,
        want_hess=want_hess))
    assert abs(Lt - Lj) <= 1e-4 * abs(Lj)
    assert np.abs(gt - gj).max() <= 1e-4 * np.abs(gj).max()
    if want_hess:
        assert np.abs(Ht - Hj).max() <= 1e-4 * np.abs(Hj).max()
    else:
        assert not Ht.any()


def test_newton_direction_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(20):
        M = rng.normal(size=(6, 6)).astype(np.float32)
        H = (M @ M.T + rng.normal(size=(6, 6)) * 0.5).astype(np.float32)
        H = 0.5 * (H + H.T)                    # often indefinite
        g = rng.normal(size=6).astype(np.float32)
        dj = np.asarray(jndt.newton_direction(jnp.asarray(g), jnp.asarray(H)))
        dt = tndt.newton_direction(_t(g), _t(H)).numpy()
        np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-5 * np.abs(dj).max())
        xj, okj = jndt._chol_solve6(jnp.asarray(H), jnp.asarray(g))
        xt, okt = tndt._chol_solve6(_t(H), _t(g))
        assert bool(okt) == bool(okj)
        if bool(okj):
            np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-3, atol=1e-5)


def test_align_on_graft_fixture_matches_reference(graft):
    """Same Newton iteration count; pose within 1e-4."""
    fn, grid, src, mask, pose0, gspec, nspec = graft
    jres = fn(grid, jnp.asarray(src), jnp.asarray(mask), jnp.asarray(pose0))
    ts = tvm.GridSpec(*gspec)
    tgrid = convert.voxel_grid_from_ref(_np_tree(grid), ts)
    tres = tndt.align(tgrid, _t(src), _t(mask), _t(pose0), ts,
                      tndt.NdtSpec(max_iterations=10, ls_max_trials=5))
    assert tres.iterations == int(jres.iterations)
    assert tres.converged == bool(jres.converged)
    np.testing.assert_allclose(tres.pose.numpy(), np.asarray(jres.pose), atol=1e-4)
    assert abs(tres.score - float(jres.score)) <= 1e-4 * abs(float(jres.score))
    np.testing.assert_allclose(float(tres.fitness), float(jres.fitness), rtol=1e-4)
    np.testing.assert_allclose(float(tres.matched_frac), float(jres.matched_frac), rtol=1e-6)


def _no_launch(*_a, **_k):
    raise AssertionError("the NDT kernel was reached on CPU tensors")


def test_align_on_cpu_is_the_plain_version_and_never_launches(graft, monkeypatch):
    """`align` picks its route by where the tensors live: on CPU tensors it is
    `align_ref` bit for bit, every field a tensor, and the kernel's launch
    function is never reached."""
    monkeypatch.setattr(ndt_kernel, "_launch", _no_launch)
    _, grid, src, mask, pose0, gspec, _ = graft
    ts = tvm.GridSpec(*gspec)
    tgrid = convert.voxel_grid_from_ref(_np_tree(grid), ts)
    nspec = tndt.NdtSpec(max_iterations=10, ls_max_trials=5)
    before = ndt_kernel.launches
    got = tndt.align(tgrid, _t(src), _t(mask), _t(pose0), ts, nspec)
    want = tndt.align_ref(tgrid, _t(src), _t(mask), _t(pose0), ts, nspec)
    assert ndt_kernel.launches == before
    for a, b in zip(got, want):
        assert isinstance(a, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    assert got.iterations.dtype == torch.int32 and got.converged.dtype == torch.bool
    assert got.score.dtype == torch.float32 and int(got.iterations) >= 1


def _check_plan(n, sms, lanes):
    """`plan` gives every (point, neighbour) lane of every point to exactly
    one thread of one trip, with no more blocks than the card holds, the
    fewest trips, and the fewest blocks for those trips."""
    blocks, trips = ndt_kernel.plan(n, sms, lanes)
    per_block = ndt_kernel.THREADS // lanes
    assert ndt_kernel.THREADS % 32 == 0 and 32 % lanes == 0
    assert 1 <= blocks <= sms and trips >= 1
    assert blocks * trips * per_block >= n
    assert (trips - 1) * sms * per_block < n           # no fewer trips would do
    assert (blocks - 1) * trips * per_block < n        # nor fewer blocks
    # the kernel's grid-stride loop, a warp at a time: warp bases below the
    # item count, a stride of blocks × threads
    items = n * lanes
    stride = blocks * ndt_kernel.THREADS
    bases = np.arange(0, stride, 32)
    walked = (bases[:, None] + stride * np.arange(trips)[None, :]).ravel()
    walked = walked[walked < items]
    lanes_ = (walked[:, None] + np.arange(32)[None, :]).ravel()
    points = lanes_[lanes_ < items] // lanes
    assert np.array_equal(np.bincount(points, minlength=n), np.full(n, lanes))
    assert -(-items // stride) == trips


@pytest.mark.parametrize("sms", [1, 16, 132])
@pytest.mark.parametrize("n", [1, 127, 128, 8192, 8193, 32768])
def test_ndt_kernel_plan_covers_every_point_once(n, sms):
    """`plan` at the default mode's lanes (DIRECT7: 8 a point); see
    `_check_plan`."""
    _check_plan(n, sms, ndt_kernel.LANES["direct7"])


def test_ndt_kernel_plan_rejects_empty_input():
    with pytest.raises(ValueError):
        ndt_kernel.plan(0, 132)
    with pytest.raises(ValueError):
        ndt_kernel.plan(8192, 0)


def test_host_branch_step_returns_the_aligns_scalars_as_host_values(monkeypatch):
    """The host-branch step folds the align's trip count, flag and score into
    its one readback: they come back as an int, a bool and a float equal to
    the align's tensors, and the pose is the align's."""
    monkeypatch.setattr(ndt_kernel, "_launch", _no_launch)
    tcfg = ttiny().override({"filter.outlier_method": "statistical"})
    tspec = todom.spec_from_config(tcfg)
    rng = np.random.default_rng(3)
    pts = (rng.normal(size=(2048, 3)) * [10.0, 10.0, 1.5]).astype(np.float32)
    mask = rng.random(2048) > 0.1
    st = todom.init_state(tspec, torch.zeros(6), _t(pts), _t(mask))
    moved = (pts + np.float32([0.2, -0.1, 0.0])).astype(np.float32)
    res = tndt.align(st.grid_a, _t(moved), _t(mask), todom._guess(st), tspec.gspec,
                     tspec.nspec)
    new, out = todom.step(st, _t(moved), _t(mask), tspec)
    assert type(out.iterations) is int and out.iterations == int(res.iterations) >= 1
    assert type(out.converged) is bool and out.converged == bool(res.converged)
    assert type(out.score) is float and out.score == float(res.score)
    assert torch.equal(out.pose, res.pose) and torch.equal(new.pose, res.pose)
    assert type(out.inserted) is bool and type(out.swapped) is bool
    dev_new, dev_out = todom.step(st, _t(moved), _t(mask), tspec, on_device=True)
    assert torch.equal(dev_out.pose, out.pose) and int(dev_out.iterations) == out.iterations
    assert float(dev_out.score) == out.score and bool(dev_out.converged) == out.converged


def test_odometry_steps_match_reference():
    """Each step starts both packages from the same (converted) state: the
    pose to 1e-4, identical iteration counts and insert/swap decisions,
    across map insertions, a localmap swap and a grid recentre."""
    # the radius filter keeps almost nothing of a sparse sim scan
    jcfg = jtiny().override({"filter.outlier_method": "statistical"})
    tcfg = ttiny().override({"filter.outlier_method": "statistical"})
    jspec, tspec = jodom.spec_from_config(jcfg), todom.spec_from_config(tcfg)
    world = sim.make_world(6, extent=50.0, ground_pts=60_000)
    gt = sim.loop_trajectory(24, radius=12.0, speed=1.0)
    rng = np.random.default_rng(6)
    clouds = []
    for p in gt:
        xyz, inten = sim.render_scan(world, p, rng, n_points=4000)
        f = jfilter.filter_scan(jmake_cloud(xyz, inten, capacity=4096), jcfg.filter)
        clouds.append((np.asarray(f.xyz), np.asarray(f.mask)))
    jst = jodom.init_state(jspec, jnp.zeros(6, jnp.float32),
                           jnp.asarray(clouds[0][0]), jnp.asarray(clouds[0][1]))
    flags = {"inserted": 0, "swapped": 0, "recentred": 0}
    for xyz, mask in clouds[1:]:
        tst = convert.odom_state_from_ref(_np_tree(jst), tspec.gspec)
        origin0 = np.asarray(jst.grid_a.origin)
        jst, jout = jodom.step(jst, jnp.asarray(xyz), jnp.asarray(mask), jspec)
        tst, tout = todom.step(tst, _t(xyz), _t(mask), tspec)
        np.testing.assert_allclose(tout.pose.numpy(), np.asarray(jout.pose), atol=1e-4)
        assert tout.iterations == int(jout.iterations)
        assert tout.inserted == bool(jout.inserted)
        assert tout.swapped == bool(jout.swapped)
        assert np.array_equal(tst.grid_a.origin.numpy(), np.asarray(jst.grid_a.origin))
        flags["inserted"] += tout.inserted
        flags["swapped"] += tout.swapped
        flags["recentred"] += not np.array_equal(origin0, np.asarray(jst.grid_a.origin))
    assert all(v > 0 for v in flags.values()), flags


def test_convert_odom_state_roundtrip():
    cfg = jtiny()
    spec = jodom.spec_from_config(cfg)
    pts = np.random.default_rng(1).uniform(-20, 20, (1024, 3)).astype(np.float32)
    jst = _np_tree(jodom.init_state(spec, jnp.zeros(6, jnp.float32), jnp.asarray(pts),
                                    jnp.ones(1024, bool)))
    back = convert.odom_state_to_ref(
        convert.odom_state_from_ref(jst, tvm.GridSpec(*spec.gspec)), tvm.GridSpec(*spec.gspec))
    for f in ("pose", "prev_pose", "diff", "localmap_travel", "added_pose"):
        assert np.array_equal(back[f], getattr(jst, f))
    for g in ("grid_a", "grid_b"):
        for f in ("origin", "stats", "fin"):
            assert np.array_equal(back[g][f], getattr(getattr(jst, g), f))
