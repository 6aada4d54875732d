"""The port's NDT modes and the block-Jacobi PCG against the JAX reference:
the neighbourhoods (DIRECT1, DIRECT7, DIRECT7_ROWS, DIRECT26, KDTREE), the
More-Thuente functions trial for trial, whole aligns in each non-default
mode with the neighbourhood gathered every iteration and frozen
(`regather_dist`), a convergence refused on a stale neighbourhood, an
odometry chain in mt_exact + kdtree, the jacobi preconditioner, the
kernel's launch plan at every lane count, and `run-sim` on the CPU with
each mode set. The modes' kernels are held to these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from test_mt_line_search import _random_quartic, oracle_mt
from test_torch_ndt import _check_plan
from xchu_slam_tpu.config import tiny_config as jtiny
from xchu_slam_tpu.models import odometry as jodom
from xchu_slam_tpu.ops import filter as jfilter, ndt as jndt, voxel_map as jvm
from xchu_slam_tpu.types import make_cloud as jmake_cloud
from xchu_slam_tpu.utils import compile_cache
from xchu_slam_tpu_torch import cli, convert
from xchu_slam_tpu_torch.config import tiny_config as ttiny
from xchu_slam_tpu_torch.models import odometry as todom, pose_graph as tpg
from xchu_slam_tpu_torch.ops import ndt as tndt, voxel_map as tvm
from xchu_slam_tpu_torch.ops.cuda import ndt_kernel, pgo_kernel
from xchu_slam_tpu_torch.utils import sim

torch.set_num_threads(2)

NEIGHBOR_MODES = ("direct1", "direct7", "direct7_rows", "direct26", "kdtree")
# the five modes other than the default (backtrack, direct7)
MODES = (("backtrack", "direct1"), ("backtrack", "direct26"), ("backtrack", "kdtree"),
         ("mt_exact", "direct7"), ("ref_clamped", "direct7"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(x):
    return type(x)(*(_np_tree(a) if isinstance(a, tuple) else np.asarray(a) for a in x))


GS = jvm.GridSpec(gx=16, gy=16, gz=8, resolution=2.0, min_points=6, eig_inflation=0.01)
TS = tvm.GridSpec(*GS)


@pytest.fixture(scope="module")
def small_grid():
    """A reference grid of walls, a floor and a blob, and the port's copy."""
    rng = np.random.default_rng(11)
    pts = np.concatenate([
        rng.uniform([-14, -14, -6], [14, 14, -5], size=(3000, 3)),
        rng.uniform([-14, 8, -6], [14, 9, 6], size=(1500, 3)),
        rng.uniform([6, -14, -6], [7, 14, 6], size=(1500, 3)),
        rng.normal(size=(1500, 3)) * [3, 3, 2]]).astype(np.float32)
    jg = jvm.make_grid(GS, jvm.centered_origin(GS, jnp.zeros(3)))
    jg = jvm.finalize(jvm.insert_points(jg, jnp.asarray(pts), jnp.ones(len(pts), bool), GS), GS)
    return jg, convert.voxel_grid_from_ref(_np_tree(jg), TS)


@pytest.mark.parametrize("mode", NEIGHBOR_MODES)
def test_lookup_neighbors_matches_reference_in_every_mode(small_grid, mode):
    """Points inside the grid, on its border, one voxel outside each face and
    far out: identical valid masks (KDTREE's distance mask included), means
    within 1e-6 and identical inverse covariances wherever valid."""
    jg, tg = small_grid
    rng = np.random.default_rng(5)
    lo = np.asarray(jg.origin)
    hi = lo + np.array([GS.gx, GS.gy, GS.gz]) * GS.resolution
    inside = rng.uniform(lo, hi, (1500, 3))
    border = rng.uniform(lo - 0.5 * GS.resolution, lo + 0.5 * GS.resolution, (500, 3))
    border_hi = rng.uniform(hi - 0.5 * GS.resolution, hi + 0.5 * GS.resolution, (500, 3))
    outside = rng.uniform(lo - GS.resolution, hi + GS.resolution, (1500, 3))
    far = rng.uniform(lo - 10 * GS.resolution, hi + 10 * GS.resolution, (300, 3))
    q = np.vstack([inside, border, border_hi, outside, far]).astype(np.float32)
    jm, ji, jv = (np.asarray(a) for a in jvm.lookup_neighbors(jg, GS, jnp.asarray(q), mode))
    tm, ti, tv = (a.numpy() for a in tvm.lookup_neighbors(tg, TS, torch.from_numpy(q), mode))
    m = tvm.NEIGHBOR_COUNT[mode]
    assert tv.shape == jv.shape == (len(q), m) and tm.shape == (len(q), m, 3)
    assert np.array_equal(tv, jv)
    assert jv.sum() > 300
    np.testing.assert_allclose(tm[tv], jm[jv], rtol=1e-6, atol=1e-6)
    assert np.array_equal(ti[tv], ji[jv])
    # the offsets in the reference's order, on the query's device
    offs = tvm.neighbor_offsets(mode, torch.device("cpu")).numpy()
    assert np.array_equal(offs, jvm._MODE_OFFSETS[mode])


def test_neighbour_modes_refuse_what_is_not_ported():
    with pytest.raises(ValueError, match="direct9"):
        tvm.neighbor_offsets("direct9", torch.device("cpu"))
    for bad, what in ((dict(neighbor_mode="direct9"), "direct9"),
                      (dict(ls_mode="wolfe"), "wolfe")):
        spec = tndt.NdtSpec(**bad)
        with pytest.raises(ValueError, match=what):
            tndt.check_spec(spec)
        with pytest.raises(ValueError, match=what):
            ndt_kernel.check_modes(spec)
    with pytest.raises(ValueError, match="lu"):
        tpg.spec_from_config(ttiny().override({"pgo.precond": "lu"}).pgo)
    with pytest.raises(ValueError, match="lu"):
        pgo_kernel.precond_code("lu")


# ------------------------------------------------------ More-Thuente -- #

def _random_args(rng):
    """Endpoint and trial triples (a, f, g) that walk every case of the
    trial selection and the interval update."""
    a = np.sort(rng.uniform(0.0, 0.1, 3)).astype(np.float32)
    f = rng.normal(size=3).astype(np.float32)
    g = rng.normal(size=3).astype(np.float32)
    if rng.random() < 0.2:
        g[2] = np.float32(0.0)
    order = rng.permutation(3)
    return [v for i in order for v in (a[i], f[i], g[i])]


def test_mt_trial_value_and_update_interval_match_reference():
    """On 400 random triples: the trial step to 1e-6 relative and the updated
    interval and its converged flag equal, case for case."""
    rng = np.random.default_rng(8)
    trial_j = jax.jit(jndt.mt_trial_value)
    update_j = jax.jit(jndt.mt_update_interval)
    for _ in range(400):
        args = _random_args(rng)
        want = float(trial_j(*(jnp.float32(v) for v in args)))
        got = float(tndt.mt_trial_value(*(torch.tensor(v) for v in args)))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
        ju = [np.float32(v) for v in update_j(*(jnp.float32(v) for v in args))]
        tu = tndt.mt_update_interval(*(torch.tensor(v) for v in args))
        assert bool(tu[6]) == bool(ju[6])
        assert all(float(x) == float(y) for x, y in zip(tu[:6], ju[:6]))


def test_mt_exact_search_matches_reference_trial_for_trial(rng):
    """The quartic corpus of tests/test_mt_line_search.py: every trial step
    of the port's host search equals the reference's, in number and value
    (to 1e-6 relative); both agree with the C++ oracle as the reference's
    own test asks."""
    spec_j = jndt.NdtSpec(step_size=0.1, trans_eps=0.01, ls_max_trials=10)
    spec_t = tndt.NdtSpec(step_size=0.1, trans_eps=0.01, ls_max_trials=10)
    n_oracle = 0
    for _ in range(60):
        phi_dphi, (c4, c3, c2, c1) = _random_quartic(rng)
        alpha0 = float(rng.uniform(0.005, 0.2))
        cj = [jnp.float32(c) for c in (c4, c3, c2, c1)]
        ct = [torch.tensor(c, dtype=torch.float32) for c in (c4, c3, c2, c1)]
        trials_j, trials_t = [], []

        def phi_j(a):
            trials_j.append(float(a))
            return ((((cj[0] * a + cj[1]) * a + cj[2]) * a + cj[3]) * a,
                    ((4 * cj[0] * a + 3 * cj[1]) * a + 2 * cj[2]) * a + cj[3])

        def phi_t(a):
            trials_t.append(float(a))
            return ((((ct[0] * a + ct[1]) * a + ct[2]) * a + ct[3]) * a,
                    ((4 * ct[0] * a + 3 * ct[1]) * a + 2 * ct[2]) * a + ct[3])

        with jax.disable_jit():
            a_j, phi_fj, it_j = jndt.mt_exact_search(phi_j, jnp.float32(0.0), cj[3],
                                                     jnp.float32(alpha0), spec_j)
        a_t, phi_ft, it_t = tndt.mt_exact_search(phi_t, torch.tensor(0.0), ct[3],
                                                 torch.tensor(alpha0, dtype=torch.float32),
                                                 spec_t)
        assert it_t == int(it_j) == len(trials_t) - 1
        assert len(trials_t) == len(trials_j)
        np.testing.assert_allclose(trials_t, trials_j, rtol=1e-6, atol=0)
        assert abs(float(a_t) - float(a_j)) <= 1e-6 * float(a_j)
        assert abs(float(phi_ft) - float(phi_fj)) <= 1e-5 * max(1e-3, abs(float(phi_fj)))
        a_ref, it_ref = oracle_mt(phi_dphi, 0.0, c1, alpha0, 0.1, 0.005, 10)
        n_oracle += it_t == it_ref and abs(float(a_t) - a_ref) <= 1e-4 * max(a_ref, 1e-3)
    assert n_oracle >= 55, f"only {n_oracle}/60 matched the C++ oracle"


# --------------------------------------------------------- the aligns -- #

@pytest.fixture(scope="module")
def graft():
    """The `__graft_entry__.entry()` grid, 1024-point source, mask and pose
    (the persistent-cache switch skipped, as tests/test_torch_ndt.py does)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(compile_cache, "enable", lambda *a, **k: None)
    try:
        _fn, (grid, src, mask, pose0) = __graft_entry__.entry()
    finally:
        mp.undo()
    gspec = jvm.GridSpec(gx=32, gy=32, gz=12, resolution=2.0, min_points=6,
                         eig_inflation=0.01)
    return grid, np.asarray(src), np.asarray(mask), np.asarray(pose0), gspec


def _agrees(tres, jres) -> bool:
    """The same iteration count and convergence, the pose within 1e-4 and
    the score within 1e-4 relative."""
    return (int(tres.iterations) == int(jres.iterations)
            and bool(tres.converged) == bool(jres.converged)
            and np.abs(tres.pose.numpy() - np.asarray(jres.pose)).max() <= 1e-4
            and abs(float(tres.score) - float(jres.score)) <= 1e-4 * abs(float(jres.score)))


@pytest.mark.parametrize("regather_dist", [0.0, 0.3])
@pytest.mark.parametrize("ls_mode,neighbor_mode", MODES)
def test_align_matches_reference_in_each_mode(graft, ls_mode, neighbor_mode, regather_dist):
    """Each non-default mode on the graft fixture, the neighbourhood gathered
    every iteration (0.0) or frozen within 0.3: the same iteration count,
    the pose within 1e-4, as test_torch_ndt holds the default; score,
    fitness and matched fraction to 1e-4 relative.

    A frozen neighbourhood makes some aligns a knife edge: the reference's
    own More-Thuente and clamped-step aligns here, started 1e-7 m apart in
    x, end 1.6e-3 m apart (the step after a refused convergence on a stale
    neighbourhood amplifies the last bits). Where the port is not within
    the bounds of the reference's result, it must be within them of the
    reference started 1e-7 m to either side, and the reference itself must
    have moved past the bounds there: the port took the reference's other
    branch."""
    grid, src, mask, pose0, gspec = graft
    jspec = jndt.NdtSpec(max_iterations=10, ls_max_trials=5, ls_mode=ls_mode,
                         neighbor_mode=neighbor_mode, regather_dist=regather_dist)

    def ref(p):
        return jndt.align(grid, jnp.asarray(src), jnp.asarray(mask), jnp.asarray(p),
                          gspec, jspec)

    jres = ref(pose0)
    ts = tvm.GridSpec(*gspec)
    tgrid = convert.voxel_grid_from_ref(_np_tree(grid), ts)
    tspec = tndt.NdtSpec(max_iterations=10, ls_max_trials=5, ls_mode=ls_mode,
                         neighbor_mode=neighbor_mode, regather_dist=regather_dist)
    stats = {}
    tres = tndt.align_ref(tgrid, _t(src), _t(mask), _t(pose0), ts, tspec, stats=stats)
    if regather_dist > 0 and not _agrees(tres, jres):
        branches = [ref(pose0 + np.float32(e) * np.eye(6, dtype=np.float32)[0])
                    for e in (1e-7, -1e-7)]
        jres = next(b for b in branches if _agrees(tres, b))
        assert np.abs(np.asarray(jres.pose) - np.asarray(ref(pose0).pose)).max() > 1e-4
    assert int(tres.iterations) == int(jres.iterations)
    assert bool(tres.converged) == bool(jres.converged)
    np.testing.assert_allclose(tres.pose.numpy(), np.asarray(jres.pose), atol=1e-4)
    assert abs(float(tres.score) - float(jres.score)) <= 1e-4 * abs(float(jres.score))
    np.testing.assert_allclose(float(tres.fitness), float(jres.fitness), rtol=1e-4)
    np.testing.assert_allclose(float(tres.matched_frac), float(jres.matched_frac), rtol=1e-4)
    # the trial passes: one an iteration for the clamped step, at least one
    # for the others
    if ls_mode == "ref_clamped":
        assert stats["trials"] == int(tres.iterations)
    else:
        assert stats["trials"] >= int(tres.iterations)
    assert stats["passes"] == stats["trials"] + int(tres.iterations)
    if regather_dist == 0.0:
        assert stats["stale_refusals"] == 0


def test_align_refuses_a_stale_convergence_and_gathers_afresh(graft):
    """The default mode with the neighbourhood frozen within 0.3: steps
    shorter than trans_eps on a stale neighbourhood are refused as
    convergences (4 here), each forcing a gather at the next iteration, so
    the align runs longer than with a gather every iteration, and it still
    converges where the reference does: the same iteration count, the pose
    within 1e-4."""
    grid, src, mask, pose0, gspec = graft
    ts = tvm.GridSpec(*gspec)
    tgrid = convert.voxel_grid_from_ref(_np_tree(grid), ts)
    got = {}
    for rd in (0.0, 0.3):
        jres = jndt.align(grid, jnp.asarray(src), jnp.asarray(mask), jnp.asarray(pose0), gspec,
                          jndt.NdtSpec(ls_max_trials=5, regather_dist=rd))
        stats = {}
        tres = tndt.align_ref(tgrid, _t(src), _t(mask), _t(pose0), ts,
                              tndt.NdtSpec(ls_max_trials=5, regather_dist=rd), stats=stats)
        assert int(tres.iterations) == int(jres.iterations)
        assert bool(tres.converged) and bool(jres.converged)
        np.testing.assert_allclose(tres.pose.numpy(), np.asarray(jres.pose), atol=1e-4)
        got[rd] = (stats["stale_refusals"], int(tres.iterations))
    assert got[0.0][0] == 0 and got[0.3][0] >= 1, got
    assert got[0.3][1] > got[0.0][1], got


def test_odometry_chain_mt_exact_kdtree_matches_reference():
    """Ten odometry steps in mt_exact + kdtree, each from the same (converted)
    state: the pose to 1e-4 and identical iteration counts and insert /
    swap decisions."""
    over = {"filter.outlier_method": "statistical", "ndt.ls_mode": "mt_exact",
            "ndt.neighbor_mode": "kdtree"}
    jcfg, tcfg = jtiny().override(over), ttiny().override(over)
    jspec, tspec = jodom.spec_from_config(jcfg), todom.spec_from_config(tcfg)
    assert (tspec.nspec.ls_mode, tspec.nspec.neighbor_mode) == ("mt_exact", "kdtree")
    world = sim.make_world(6, extent=50.0, ground_pts=60_000)
    gt = sim.loop_trajectory(11, radius=12.0, speed=1.0)
    rng = np.random.default_rng(6)
    clouds = []
    for p in gt:
        xyz, inten = sim.render_scan(world, p, rng, n_points=4000)
        f = jfilter.filter_scan(jmake_cloud(xyz, inten, capacity=4096), jcfg.filter)
        clouds.append((np.asarray(f.xyz), np.asarray(f.mask)))
    jst = jodom.init_state(jspec, jnp.zeros(6, jnp.float32),
                           jnp.asarray(clouds[0][0]), jnp.asarray(clouds[0][1]))
    inserted = 0
    for xyz, mask in clouds[1:]:
        tst = convert.odom_state_from_ref(_np_tree(jst), tspec.gspec)
        jst, jout = jodom.step(jst, jnp.asarray(xyz), jnp.asarray(mask), jspec)
        tst, tout = todom.step(tst, _t(xyz), _t(mask), tspec)
        np.testing.assert_allclose(tout.pose.numpy(), np.asarray(jout.pose), atol=1e-4)
        assert tout.iterations == int(jout.iterations)
        assert tout.inserted == bool(jout.inserted)
        assert tout.swapped == bool(jout.swapped)
        inserted += tout.inserted
    assert inserted > 0


# ------------------------------------------------- the kernels' plans -- #

@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("n", [1, 127, 8192, 8193, 32768])
@pytest.mark.parametrize("mode", ["direct1", "kdtree"])
def test_ndt_kernel_plan_covers_every_point_once_at_every_lane_count(mode, n, sms):
    """`plan` at DIRECT1's 1 lane a point and the 27-cube's 32 (DIRECT7's 8:
    tests/test_torch_ndt.py)."""
    _check_plan(n, sms, ndt_kernel.LANES[mode])


def test_circuit_width_keeps_its_rows_in_shared_memory():
    """At the circuit's 8192 points on 132 SMs every mode's launch takes at
    most the trips whose rows the kernel keeps in shared memory (the 27-cube:
    4 trips of 128 blocks), so no pass gathers twice."""
    for mode in NEIGHBOR_MODES:
        _blocks, trips = ndt_kernel.plan(8192, 132, ndt_kernel.LANES[mode])
        assert trips <= ndt_kernel.CACHE_TRIPS[mode], mode
        assert ndt_kernel.NEIGHBOURS[mode] <= ndt_kernel.LANES[mode] <= 32


# ------------------------------------------------------------ run-sim -- #

TINY = ("filter.max_points=4096", "pgo.max_keyframes=16", "loop.submap_points=4096")


@pytest.mark.parametrize("setting", [
    "ndt.ls_mode=mt_exact", "ndt.ls_mode=ref_clamped", "ndt.neighbor_mode=direct1",
    "ndt.neighbor_mode=direct26", "ndt.neighbor_mode=kdtree", "pgo.precond=jacobi"])
def test_run_sim_on_cpu_runs_each_mode(setting, monkeypatch):
    """`run-sim --device cpu --set <mode>` on a 6-scan circuit through the
    host engine: the mode reaches the specs, the plain versions run, the
    kernels are never reached."""
    monkeypatch.setattr(ndt_kernel, "_launch", _no_launch)
    monkeypatch.setattr(pgo_kernel, "_launch", _no_launch)
    pipe, summary = cli.run_sim(6, 20.0, 0, "cpu", overrides=(*TINY, setting))
    key, val = setting.split("=")
    section, field = key.split(".")
    assert getattr(getattr(pipe.cfg, section), field) == val
    assert summary["scans"] == 6 and len(pipe.odom_log) == 5
    assert all(r["iterations"] >= 1 for r in pipe.odom_log)
    assert np.isfinite(pipe.odometry_trajectory()).all()


def test_run_sim_device_engine_on_cpu_runs_the_modes(monkeypatch):
    """The device engine with mt_exact + kdtree and jacobi set together."""
    monkeypatch.setattr(ndt_kernel, "_launch", _no_launch)
    monkeypatch.setattr(pgo_kernel, "_launch", _no_launch)
    pipe, summary = cli.run_sim(6, 20.0, 0, "cpu", overrides=(
        *TINY, "ndt.ls_mode=mt_exact", "ndt.neighbor_mode=kdtree", "pgo.precond=jacobi"),
        engine="device", chunk=4)
    nspec = pipe.spec.ospec.nspec
    assert (nspec.ls_mode, nspec.neighbor_mode, pipe.gspec.precond) == \
        ("mt_exact", "kdtree", "jacobi")
    assert summary["scans"] == 6
    assert np.isfinite(pipe.odometry_trajectory()).all()


@pytest.mark.parametrize("setting,what", [
    ("ndt.ls_mode=golden", "golden"), ("pgo.precond=ilu", "ilu")])
@pytest.mark.parametrize("engine", ["host", "device"])
def test_run_sim_refuses_what_is_not_ported(setting, what, engine):
    with pytest.raises(ValueError, match=what):
        cli.run_sim(3, 20.0, 0, "cpu", overrides=(*TINY, setting), engine=engine, chunk=4)


@pytest.mark.parametrize("setting", ["ndt.regather_dist=0.3", "ndt.neighbor_mode=direct7_rows"])
@pytest.mark.parametrize("engine", ["host", "device"])
def test_run_sim_runs_regather_and_direct7_rows(setting, engine, monkeypatch):
    """`run-sim --device cpu --set <setting>` on both engines, 4 scans: the
    setting reaches the align's spec, the poses are finite, and direct7_rows
    (the reference's other data path to the DIRECT7 voxels) gives the bits
    of direct7."""
    monkeypatch.setattr(ndt_kernel, "_launch", _no_launch)
    kw = dict(engine=engine, chunk=4)
    pipe, summary = cli.run_sim(4, 20.0, 0, "cpu", overrides=(*TINY, setting), **kw)
    key, val = setting.split("=")
    assert str(getattr(pipe.cfg.ndt, key.split(".")[1])) == val
    assert summary["scans"] == 4
    poses = pipe.odometry_trajectory()
    assert np.isfinite(poses).all()
    if "direct7_rows" in setting:
        base, _ = cli.run_sim(4, 20.0, 0, "cpu", overrides=TINY, **kw)
        assert np.array_equal(poses, base.odometry_trajectory())


def _no_launch(*_a, **_k):
    raise AssertionError("a kernel was reached on CPU tensors")
