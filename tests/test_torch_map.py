"""The port's scan filter and voxel map against the JAX reference, on
simulated scans (inputs made with numpy from fixed seeds)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xchu_slam_tpu.config import FilterConfig
from xchu_slam_tpu.ops import filter as jfilter, voxel_map as jvm
from xchu_slam_tpu.types import make_cloud as jmake_cloud
from xchu_slam_tpu_torch import convert
from xchu_slam_tpu_torch.ops import filter as tfilter, voxel_map as tvm
from xchu_slam_tpu_torch.types import make_cloud as tmake_cloud
from xchu_slam_tpu_torch.utils import sim

torch.set_num_threads(2)

# per-voxel inverse covariances: relative to each voxel's largest entry. The
# eigenvalue floor inherits the float32 conditioning of the trigonometric
# eigensolver (see test_torch_foundations), measured at ~1e-4 here
ICOV_RTOL = 5e-4


@pytest.fixture(scope="module")
def world():
    return sim.make_world(5, extent=60.0)


def _scans(world, n, n_points, seed, max_range=60.0):
    rng = np.random.default_rng(seed)
    return [sim.render_scan(world, p, rng, n_points=n_points, max_range=max_range)
            for p in sim.loop_trajectory(n, radius=12.0)]


# statistical: the run-sim setting; radius on a dense, finely downsampled
# cloud so that it keeps points (sim scans at 0.5 m voxels are too sparse);
# a capacity below the voxel count exercises the hashed-key overflow order.
# statistical_approx at the statistical setting (the reference's
# approx_min_k is exact on the CPU, the port exact everywhere).
# statistical_bucketed on a dense cloud (0.25 m voxels to 12 m, k = 16) where
# most rows are proven, with a fallback of 128 rows that leaves rows unknown
FILTERS = {
    "statistical": FilterConfig(max_raw_points=12000, max_points=2048,
                                outlier_method="statistical"),
    "statistical_approx": FilterConfig(max_raw_points=12000, max_points=2048,
                                       outlier_method="statistical_approx"),
    "statistical_bucketed": FilterConfig(max_raw_points=22000, max_points=4096,
                                         voxel_size=0.25, max_range=12.0,
                                         outlier_method="statistical_bucketed",
                                         stat_outlier_k=16, stat_fallback_rows=128),
    "radius": FilterConfig(max_raw_points=20000, max_points=4096, voxel_size=0.15,
                           max_range=25.0, outlier_method="radius"),
    "none_overflow": FilterConfig(max_raw_points=12000, max_points=512,
                                  outlier_method="none"),
}
# (points a scan, range of the render) where a case needs a denser cloud
RENDER = {"radius": (18000, 25.0), "statistical_bucketed": (20000, 12.0)}


def _bucket_classes(xyz, mask, cfg):
    """The bucketed filter's row classes computed here in numpy, from its
    definition: a valid row is proven where none of its 9 x-ranges of the
    27-bucket cube holds more than 3·cap points and its exact k-th
    neighbour distance lies below the bucket size (then the k nearest all
    lie in the cube); the first `stat_fallback_rows` unproven rows are
    solved again, the rest are unknown."""
    bucket = cfg.stat_bucket_mult * cfg.voxel_size
    cap, k = cfg.stat_bucket_mult ** 3, cfg.stat_outlier_k
    v = np.flatnonzero(mask)
    p = xyz[v].astype(np.float64)
    sq = (p * p).sum(1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * p @ p.T
    kth = np.partition(d2, k, axis=1)[:, k]          # the row itself is the 0th
    b = np.clip(np.floor(p / bucket).astype(np.int64) + [64, 64, 16], 0, [127, 127, 31])
    count = np.zeros((130, 130, 34), np.int64)       # a margin of one bucket
    np.add.at(count, tuple((b + 1).T), 1)
    overflow = np.zeros(len(v), bool)
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            x, y, z = b[:, 0] + 1, b[:, 1] + 1 + dy, b[:, 2] + 1 + dz
            overflow |= count[x - 1, y, z] + count[x, y, z] + count[x + 1, y, z] > 3 * cap
    proven = ~overflow & (kth < bucket * bucket)
    unproven = v[~proven]
    return {"proven": int(proven.sum()),
            "fallback": min(len(unproven), cfg.stat_fallback_rows),
            "unknown": max(len(unproven) - cfg.stat_fallback_rows, 0)}


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_scan_kept_masks_identical(world, name):
    cfg = FILTERS[name]
    n_points, max_range = RENDER.get(name, (10000, 60.0))
    kept = 0
    classes = {"proven": 0, "fallback": 0, "unknown": 0}
    for xyz, inten in _scans(world, 3, n_points, seed=1, max_range=max_range):
        j = jfilter.filter_scan(jmake_cloud(xyz, inten, capacity=cfg.max_raw_points), cfg)
        tc = tmake_cloud(xyz, inten, capacity=cfg.max_raw_points)
        t = tfilter.filter_scan(tc, cfg)
        assert np.array_equal(np.asarray(j.mask), t.mask.numpy())
        np.testing.assert_allclose(t.xyz.numpy(), np.asarray(j.xyz), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(t.intensity.numpy(), np.asarray(j.intensity),
                                   rtol=1e-6, atol=1e-6)
        kept += int(t.mask.sum())
        if name == "statistical_bucketed":
            # the outlier stage's input (the stages before it are held to the
            # reference by test_filter_stages_match_reference)
            d = tfilter.voxel_downsample(tfilter.range_crop(tc, cfg.min_range, cfg.max_range),
                                         cfg.voxel_size, cfg.max_points)
            for key, count in _bucket_classes(d.xyz.numpy(), d.mask.numpy(), cfg).items():
                classes[key] += count
    assert kept > 0
    if name == "statistical_bucketed":
        # every class of row is exercised, and proven rows dominate
        assert min(classes.values()) > 0, classes
        assert classes["proven"] > classes["fallback"] + classes["unknown"], classes


def test_filter_stages_match_reference(world):
    """range_crop and voxel_downsample on their own, with NaN points."""
    xyz, inten = _scans(world, 1, 6000, seed=2)[0]
    xyz = xyz.copy()
    xyz[::50] = np.nan
    jc, tc = jmake_cloud(xyz, inten, capacity=8192), tmake_cloud(xyz, inten, capacity=8192)
    jr, tr = jfilter.range_crop(jc, 1.0, 60.0), tfilter.range_crop(tc, 1.0, 60.0)
    assert np.array_equal(np.asarray(jr.mask), tr.mask.numpy())
    assert np.array_equal(np.asarray(jr.xyz), tr.xyz.numpy())
    jd = jfilter.voxel_downsample(jr, 0.5, 1024)
    td = tfilter.voxel_downsample(tr, 0.5, 1024)
    assert np.array_equal(np.asarray(jd.mask), td.mask.numpy())
    np.testing.assert_allclose(td.xyz.numpy(), np.asarray(jd.xyz), rtol=1e-6, atol=1e-6)
    jk, tk = jfilter.compact(jd, 700), tfilter.compact(td, 700)
    assert np.array_equal(np.asarray(jk.mask), tk.mask.numpy())
    np.testing.assert_allclose(tk.xyz.numpy(), np.asarray(jk.xyz), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ voxel map -- #

GS = jvm.GridSpec(gx=40, gy=40, gz=12, resolution=2.0, min_points=6, eig_inflation=0.01)
TS = tvm.GridSpec(*GS)


@pytest.fixture(scope="module")
def map_points(world):
    rng = np.random.default_rng(5)
    gt = sim.loop_trajectory(6, radius=10.0)
    pts = np.vstack([sim.render_scan(world, p, rng, n_points=8000)[0] + p[:3]
                     for p in gt]).astype(np.float32)
    mask = np.ones(len(pts), bool)
    mask[::7] = False
    return pts, mask


def _assert_grid_equal(tg, jg):
    """stats exact; finalized table under the reference's packed layout:
    means and valid flags exact, inverse covariances to ICOV_RTOL."""
    assert np.array_equal(tg.origin.numpy(), np.asarray(jg.origin))
    assert np.array_equal(tg.stats.numpy(), np.asarray(jg.stats))
    jb = convert.unpack_base(np.asarray(jg.fin), TS)
    tb = tg.fin.numpy()
    assert np.array_equal(tb[:, 9], jb[:, 9])
    assert np.array_equal(tb[:, :3], jb[:, :3])
    scale = np.abs(jb[:, 3:9]).max(1, keepdims=True) + 1e-30
    assert (np.abs(tb[:, 3:9] - jb[:, 3:9]) / scale).max() <= ICOV_RTOL


@pytest.fixture(scope="module")
def grids(map_points):
    pts, mask = map_points
    jg = jvm.make_grid(GS, jvm.centered_origin(GS, jnp.zeros(3)))
    jg = jvm.finalize(jvm.insert_points(jg, jnp.asarray(pts), jnp.asarray(mask), GS), GS)
    tg = tvm.make_grid(TS, tvm.centered_origin(TS, torch.zeros(3)))
    tg = tvm.finalize(tvm.insert_points(tg, torch.from_numpy(pts),
                                        torch.from_numpy(mask), TS), TS)
    return jg, tg


def test_insert_and_finalize_match_reference(grids):
    jg, tg = grids
    assert int(tg.valid.sum()) > 500
    _assert_grid_equal(tg, jg)


def test_insert_points_pair_matches_reference(map_points):
    pts, mask = map_points
    origin = np.asarray(jvm.centered_origin(GS, jnp.asarray([3.0, -2.0, 0.5])))
    ja = jvm.make_grid(GS, jnp.asarray(origin))
    jb = jvm.make_grid(GS, jnp.asarray(origin))
    ja, jb = jvm.insert_points_pair(ja, jb, jnp.asarray(pts), jnp.asarray(mask), GS)
    ta = tvm.make_grid(TS, torch.from_numpy(np.array(origin)))
    tb = tvm.make_grid(TS, torch.from_numpy(np.array(origin)))
    ta, tb = tvm.insert_points_pair(ta, tb, torch.from_numpy(pts), torch.from_numpy(mask), TS)
    assert np.array_equal(ta.stats.numpy(), np.asarray(ja.stats))
    assert np.array_equal(tb.stats.numpy(), np.asarray(jb.stats))


@pytest.mark.parametrize("centre", [(9.0, -5.0, 0.3), (-31.0, 44.0, 2.0), (200.0, 0.0, 0.0)])
def test_recentre_matches_reference(map_points, centre):
    pts, mask = map_points
    jg = jvm.make_grid(GS, jvm.centered_origin(GS, jnp.zeros(3)))
    jg = jvm.finalize(jvm.insert_points(jg, jnp.asarray(pts), jnp.asarray(mask), GS), GS)
    tg = convert.voxel_grid_from_ref(jax_np(jg), TS)
    jr = jvm.recentre(jg, jnp.asarray(centre, jnp.float32), GS)
    tr = tvm.recentre(tg, torch.tensor(centre, dtype=torch.float32), TS)
    assert np.array_equal(tr.origin.numpy(), np.asarray(jr.origin))
    assert np.array_equal(tr.stats.numpy(), np.asarray(jr.stats))
    assert np.array_equal(tr.fin.numpy(), convert.unpack_base(np.asarray(jr.fin), TS))


def jax_np(g):
    """A reference grid as numpy leaves (what `convert` takes)."""
    return type(g)(*(np.asarray(a) for a in g))


def test_lookup_neighbors_matches_reference_including_outside_centres(grids):
    """Query centres inside the grid, within one voxel outside each face,
    and far outside: identical valid masks; identical means and inverse
    covariances wherever valid."""
    jg, _ = grids
    tg = convert.voxel_grid_from_ref(jax_np(jg), TS)
    rng = np.random.default_rng(3)
    lo = np.asarray(jg.origin)
    hi = lo + np.array([GS.gx, GS.gy, GS.gz]) * GS.resolution
    inside = rng.uniform(lo, hi, (3000, 3))
    shell = rng.uniform(lo - GS.resolution, hi + GS.resolution, (3000, 3))
    far = rng.uniform(lo - 10 * GS.resolution, hi + 10 * GS.resolution, (500, 3))
    q = np.vstack([inside, shell, far]).astype(np.float32)
    jm, ji, jv = (np.asarray(a) for a in jvm.lookup_neighbors(jg, GS, jnp.asarray(q)))
    tm, ti, tv = (a.numpy() for a in tvm.lookup_neighbors(tg, TS, torch.from_numpy(q)))
    assert np.array_equal(tv, jv)
    assert jv.sum() > 1000
    assert np.array_equal(tm[tv], jm[jv])
    assert np.array_equal(ti[tv], ji[jv])


def test_grid_points_match_reference(grids):
    jg, _ = grids
    tg = convert.voxel_grid_from_ref(jax_np(jg), TS)
    jp, jmask = (np.asarray(a) for a in jvm.grid_points(jg, GS))
    tp, tmask = (a.numpy() for a in tvm.grid_points(tg, TS))
    assert np.array_equal(tmask, jmask)
    np.testing.assert_allclose(tp[tmask], jp[jmask], rtol=1e-6, atol=1e-5)


def test_convert_voxel_grid_roundtrip(grids):
    jg, _ = grids
    tg = convert.voxel_grid_from_ref(jax_np(jg), TS)
    back = convert.voxel_grid_to_ref(tg, TS)
    assert np.array_equal(back["fin"], np.asarray(jg.fin))
    assert np.array_equal(back["stats"], np.asarray(jg.stats))
