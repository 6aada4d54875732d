"""The port's Intensity Scan Context and the remaining Scan Context
retrieval functions against the JAX reference, on a seeded store of
rendered sim scans. Tolerances are stated per test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xchu_slam_tpu.config import IscConfig as JIscConfig
from xchu_slam_tpu.ops import isc as jisc, scancontext as jsc
from xchu_slam_tpu_torch.config import IscConfig as TIscConfig
from xchu_slam_tpu_torch.ops import isc as tisc, scancontext as tsc
from xchu_slam_tpu_torch.utils import sim

torch.set_num_threads(2)

K = 24   # store capacity; the revisits make 16 live entries


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def store():
    """A half circuit of 12 scans, then 4 revisits of scans 1..4 a little
    off their pose and turned (so a shifted match exists), as raw scans and
    as the reference's descriptors in a store of capacity K."""
    world = sim.make_world(17, extent=60.0)
    rng = np.random.default_rng(17)
    gt = sim.loop_trajectory(12, radius=10.0, speed=3.0)
    gt = np.vstack([gt, gt[1:5] + np.array([0.15, -0.1, 0, 0, 0, 0.45], np.float32)])
    scans = []
    for p in gt:
        xyz, inten = sim.render_scan(world, p, rng, n_points=6000, max_range=45.0)
        mask = np.ones(len(xyz), bool)
        mask[::13] = False
        scans.append((xyz, inten, mask))
    spec = jisc.IscSpec()
    db = np.zeros((K, spec.num_ring, spec.num_sector), np.float32)
    for k, (xyz, inten, mask) in enumerate(scans):
        db[k] = np.asarray(jisc.make_descriptor(
            jnp.asarray(xyz), jnp.asarray(inten), jnp.asarray(mask), spec))
    positions = np.zeros((K, 3), np.float32)
    positions[:len(gt)] = gt[:, :3] - gt[0, :3]
    step = np.linalg.norm(np.diff(positions[:12, :2], axis=0), axis=1)
    travel = np.zeros(K, np.float32)
    travel[1:12] = np.cumsum(step)
    travel[12:16] = travel[11] + 3.0 * np.arange(1, 5) + 30.0
    return scans, db, positions, travel, len(gt)


def test_isc_spec_from_config():
    assert tuple(tisc.spec_from_config(TIscConfig())) == \
        tuple(jisc.spec_from_config(JIscConfig()))


def test_isc_descriptor_exact(store):
    """The scatter-max image is equal bit for bit."""
    scans, db, *_ = store
    spec = tisc.IscSpec()
    for k, (xyz, inten, mask) in enumerate(scans):
        dt = tisc.make_descriptor(_t(xyz), _t(inten), _t(mask), spec).numpy()
        assert np.array_equal(dt, db[k]), k
    assert (db[:len(scans)] > 0).mean() > 0.02     # the images are not empty


def test_isc_geometry_scores_exact(store):
    """0/1 occupancy sums are exact in float32: the scores are equal bit for
    bit to the reference's arithmetic evaluated op by op, the shifts equal
    to the jitted reference's too. XLA's fused program rounds the four-term
    score differently from its own op-by-op evaluation, so against the
    jitted scores the bound is one float32 ulp at 1.0 (1.2e-7)."""
    import jax

    _, db, _, _, n = store
    for q in (n - 1, n - 3, 5):
        args = (jnp.asarray(db[q]), jnp.asarray(db), jisc.IscSpec())
        gj, sj = (np.asarray(a) for a in jisc.geometry_scores(*args))
        with jax.disable_jit():
            g_ops, s_ops = (np.asarray(a) for a in jisc.geometry_scores(*args))
        gt_, st = tisc.geometry_scores(_t(db[q]), _t(db), tisc.IscSpec())
        assert np.array_equal(gt_.numpy(), g_ops)
        assert np.array_equal(st.numpy(), s_ops) and np.array_equal(st.numpy(), sj)
        np.testing.assert_allclose(gt_.numpy(), gj, rtol=0, atol=1.2e-7)


@pytest.mark.parametrize("chunk", [256, 7])
def test_isc_intensity_scores(store, chunk):
    """Means over 3600 cells, within 1e-6 of the reference, whatever the
    port's chunking of the store."""
    _, db, _, _, n = store
    spec = jisc.IscSpec()
    for q in (n - 1, n - 2):
        _, shift = jisc.geometry_scores(jnp.asarray(db[q]), jnp.asarray(db), spec)
        ij = np.asarray(jisc.intensity_scores(jnp.asarray(db[q]), jnp.asarray(db), shift, spec))
        it = tisc.intensity_scores(_t(db[q]), _t(db), _t(np.asarray(shift)).long(),
                                   tisc.IscSpec(), chunk=chunk).numpy()
        np.testing.assert_allclose(it, ij, rtol=0, atol=1e-6)
    # a row is its own perfect match at shift 0
    assert it[n - 2] == pytest.approx(1.0, abs=1e-6)


def test_isc_detect_loop_matches_reference(store):
    """The same (idx, found); yaw and score within 1e-5. The thresholds are
    loosened so that the revisits pass the gates on these sparse scans."""
    _, db, positions, travel, n = store
    kw = dict(geometry_thresh=0.6, intensity_thresh=0.8, inflation_covariance=0.05)
    spec_j, spec_t = jisc.IscSpec(**kw), tisc.IscSpec(**kw)
    n_found = 0
    for cur in (0, 5, n - 4, n - 3, n - 2, n - 1):
        rj = jisc.detect_loop(jnp.asarray(db[cur]), jnp.asarray(db), jnp.int32(n),
                              jnp.asarray(positions), jnp.asarray(travel), spec_j,
                              cur=jnp.int32(cur))
        rt = tisc.detect_loop(_t(db[cur]), _t(db), n, _t(positions), _t(travel),
                              spec_t, cur=cur)
        assert rt.found == bool(rj.found) and rt.idx == int(rj.idx), cur
        assert abs(rt.score - float(rj.score)) <= 1e-5
        if rt.found:
            assert abs(rt.yaw - float(rj.yaw)) <= 1e-5
            assert rt.idx == cur - 11          # the revisited scan
            n_found += 1
    assert n_found >= 2
    # the default query is the newest keyframe
    assert tisc.detect_loop(_t(db[n - 1]), _t(db), n, _t(positions), _t(travel),
                            spec_t) == rt


def test_isc_rgb_matches_reference(store):
    _, db, *_ = store
    assert np.array_equal(tisc.isc_rgb(_t(db[3])).numpy(),
                          np.asarray(jisc.isc_rgb(jnp.asarray(db[3]))))


# ------------------------------------------- Scan Context: the rest ------ #

@pytest.fixture(scope="module")
def sc_store(store):
    scans, _, _, _, n = store
    spec = jsc.ScSpec(dist_thresh=0.35)
    db = np.zeros((K, spec.num_ring, spec.num_sector), np.float32)
    for k, (xyz, _inten, mask) in enumerate(scans):
        db[k] = np.asarray(jsc.make_descriptor(jnp.asarray(xyz), jnp.asarray(mask), spec))
    return db, n


def test_sc_keys_and_topk_match_reference(sc_store):
    """Ring and sector keys within 1e-6; the same top-k candidates, their
    distances within 1e-5."""
    db, n = sc_store
    rj, rt = np.asarray(jsc.ring_key(jnp.asarray(db))), tsc.ring_key(_t(db)).numpy()
    np.testing.assert_allclose(rt, rj, atol=1e-6)
    np.testing.assert_allclose(tsc.sector_key(_t(db)).numpy(),
                               np.asarray(jsc.sector_key(jnp.asarray(db))), atol=1e-6)
    mask = np.arange(K) < n - 2
    ij, dj = jsc.ring_key_topk(jnp.asarray(rj[n - 1]), jnp.asarray(rj), jnp.asarray(mask), k=3)
    it, dt = tsc.ring_key_topk(_t(rj[n - 1]), _t(rj), _t(mask), k=3)
    assert np.array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5)


def test_sc_detect_loop_between_sessions_matches_reference(sc_store, store):
    """Queries from another session (fresh noise) against the whole store:
    the same (idx, found, yaw), dist within 1e-5."""
    db, n = sc_store
    world = sim.make_world(17, extent=60.0)
    gt = sim.loop_trajectory(12, radius=10.0, speed=3.0)
    rng = np.random.default_rng(99)
    spec_j, spec_t = jsc.ScSpec(dist_thresh=0.35), tsc.ScSpec(dist_thresh=0.35)
    hits = 0
    for k in (2, 7, 11):
        pose = gt[k] + np.array([0.1, 0.1, 0, 0, 0, -0.3], np.float32)
        xyz = sim.render_scan(world, pose, rng, n_points=6000, max_range=45.0)[0]
        q = np.asarray(jsc.make_descriptor(jnp.asarray(xyz),
                                           jnp.ones(len(xyz), bool), spec_j))
        cj = jsc.detect_loop_between_sessions(jnp.asarray(q), jnp.asarray(db),
                                              jnp.int32(n), spec_j)
        ct = tsc.detect_loop_between_sessions(_t(q), _t(db), n, spec_t)
        assert ct.found == bool(cj.found) and ct.idx == int(cj.idx)
        assert abs(ct.dist - float(cj.dist)) <= 1e-5
        assert abs(ct.yaw - float(cj.yaw)) <= 1e-6
        hits += ct.found
    assert hits >= 2
    # an empty store finds nothing
    assert not tsc.detect_loop_between_sessions(_t(q), _t(db), 0, spec_t).found
