"""The port's ground segmentation (`ops/ground.py`) and `smallest_eigvec3`
against the JAX reference, on the scenes of tests/test_ground.py.

RANSAC's draws cannot be matched across the two random-number generators,
so the port is held to the reference given the reference's own triples
(drawn here with JAX from the key and the probabilities the reference uses),
and its own draw is held to be seeded: a rerun is bit-identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_ground import make_scene
from xchu_slam_tpu.ops import ground as jground
from xchu_slam_tpu.utils import linalg as jlinalg
from xchu_slam_tpu_torch import config as tconfig
from xchu_slam_tpu_torch.models import pipeline as tpipe
from xchu_slam_tpu_torch.ops import ground as tground
from xchu_slam_tpu_torch.utils import linalg as tlinalg, sim

torch.set_num_threads(2)

JSPEC, TSPEC = jground.GroundSpec(), tground.GroundSpec()
NEAR = 1e-5     # points this close to a threshold may fall either side


# ------------------------------------------------------ smallest_eigvec3 -- #

def test_smallest_eigvec3_matches_reference():
    """Random SPD matrices with a spectral gap: the same direction
    (|v·v'| ≥ 1 − 1e-5) and the same sign; the isotropic case gives +z."""
    rng = np.random.default_rng(3)
    lam = np.sort(rng.uniform(0.1, 3.0, (400, 3)), axis=1)
    lam[:, 1:] += 0.05                                  # λ0 at least 0.05 below λ1
    q, _ = np.linalg.qr(rng.normal(size=(400, 3, 3)))
    A = np.einsum("nij,nj,nkj->nik", q, lam, q).astype(np.float32)
    A = 0.5 * (A + A.transpose(0, 2, 1))
    vj = np.asarray(jlinalg.smallest_eigvec3(jnp.asarray(A)))
    vt = tlinalg.smallest_eigvec3(torch.from_numpy(A)).numpy()
    assert np.abs(np.linalg.norm(vt, axis=-1) - 1.0).max() < 1e-5
    assert (np.sum(vt * vj, -1) >= 1.0 - 1e-5).all()     # the same sign too
    iso = np.tile(2.0 * np.eye(3, dtype=np.float32), (4, 1, 1))
    assert np.array_equal(tlinalg.smallest_eigvec3(torch.from_numpy(iso)).numpy(),
                          np.tile(np.float32([0, 0, 1]), (4, 1)))
    assert np.array_equal(np.asarray(jlinalg.smallest_eigvec3(jnp.asarray(iso))),
                          np.tile(np.float32([0, 0, 1]), (4, 1)))


# ---------------------------------------------------------- the scenes --- #

def _scene(name):
    rng = np.random.default_rng(0)
    if name == "plane_scatter":        # test_smallest_eigvec's flat cloud
        pts = rng.normal(0, 1, (500, 3)).astype(np.float32)
        pts[:, 2] *= 0.01
        return pts, np.ones(500, bool)
    if name == "flat":
        pts = make_scene(rng)
        return pts, np.ones(len(pts), bool)
    if name == "wall_only":
        w = np.c_[rng.uniform(-30, 30, 2000), np.full(2000, 8.0),
                  rng.uniform(-4, 0.5, 2000)].astype(np.float32)
        return w, np.ones(len(w), bool)
    return np.zeros((256, 3), np.float32), np.zeros(256, bool)    # masked_empty


def _reference_triples(xyz, cand, iters):
    """The triples the reference's detect_plane draws: PRNGKey(0) split into
    `iters` keys, `jax.random.choice(k, n, (3,), p=cand / max(Σcand, 1))`."""
    p = jnp.asarray(cand).astype(jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    keys = jax.random.split(jax.random.PRNGKey(0), iters)
    tri = jax.vmap(lambda k: jax.random.choice(k, xyz.shape[0], shape=(3,), p=p))(keys)
    return torch.from_numpy(np.array(tri, np.int64))


@pytest.mark.parametrize("name", ["plane_scatter", "flat", "wall_only", "masked_empty"])
def test_detect_plane_matches_reference_given_its_triples(name):
    """Band equal; candidates equal but for points whose |n_z| lies within
    1e-5 of the cosine threshold; given the reference's triples, `valid`
    equal, coefficients within 1e-4, the ground mask equal but for points
    within 1e-5 of `ransac_thresh`."""
    pts, mask = _scene(name)
    ref = jground.detect_plane(jnp.asarray(pts), jnp.asarray(mask), JSPEC)
    xj, mj = jnp.asarray(pts), jnp.asarray(mask)
    band_j = np.asarray(mj & (jnp.abs(xj[:, 2] + JSPEC.sensor_height) <= JSPEC.height_clip))
    nz_j = np.abs(np.asarray(jground._knn_normals(xj, jnp.asarray(band_j),
                                                  JSPEC.normal_knn))[:, 2])
    cos_t = float(np.cos(np.deg2rad(np.float32(JSPEC.normal_angle_deg))))

    xyz, band, _normals, cand = tground.candidates(torch.from_numpy(pts),
                                                   torch.from_numpy(mask), TSPEC)
    assert np.array_equal(band.numpy(), band_j)
    cand_j = np.asarray(ref.candidate_mask)
    differ = cand.numpy() != cand_j
    near = np.abs(nz_j - cos_t) <= NEAR
    assert not (differ & ~near).any(), np.flatnonzero(differ & ~near)
    assert differ.sum() <= near.sum()

    res = tground.fit_plane(xyz, cand, _reference_triples(pts, cand_j, JSPEC.ransac_iters),
                            TSPEC)
    assert bool(res.valid) == bool(ref.valid)
    assert np.isfinite(res.coeffs.numpy()).all()
    np.testing.assert_allclose(res.coeffs.numpy(), np.asarray(ref.coeffs), rtol=0, atol=1e-4)
    c = np.asarray(ref.coeffs)
    dist = np.abs(pts @ c[:3] + c[3])
    gdiff = res.ground_mask.numpy() != np.asarray(ref.ground_mask)
    assert not (gdiff & ~(np.abs(dist - JSPEC.ransac_thresh) <= NEAR)).any()


def test_detect_plane_draw_is_seeded_and_picks_candidates():
    """The port's own draw: a rerun is bit-identical, every drawn index is a
    candidate, and the flat scene's plane is the reference test's (normal
    ≈ +z, d ≈ 1.73, most ground points in, the wall out)."""
    pts, mask = _scene("flat")
    args = (torch.from_numpy(pts), torch.from_numpy(mask), TSPEC)
    a, b = tground.detect_plane(*args), tground.detect_plane(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    tri = tground.draw_triples(a.candidate_mask, TSPEC.ransac_iters)
    assert tri.shape == (TSPEC.ransac_iters, 3)
    assert bool(a.candidate_mask[tri].all())
    c = a.coeffs.numpy()
    assert bool(a.valid) and c[2] > 0.99 and abs(c[3] - 1.73) < 0.1
    gm = a.ground_mask.numpy()
    assert gm[:2000].mean() > 0.7 and gm[2000:2800].mean() < 0.05
    empty = tground.draw_triples(torch.zeros(256, dtype=torch.bool), 8)
    assert not empty.any()


def test_host_engine_detects_ground():
    """`filter.detect_ground` in the host engine: every scan's result
    carries the plane of its filtered cloud, valid on the simulator's ground
    at z = −1.73 m, and the poses are those of the run without it."""
    cfg = tconfig.tiny_config().override({"filter.outlier_method": "none"})
    world = sim.make_world(5, extent=40.0, ground_pts=30_000)
    gt = sim.loop_trajectory(5, radius=10.0, speed=1.0)
    rng = np.random.default_rng(5)
    scans = [sim.render_scan(world, p, rng, n_points=4000) for p in gt]
    runs = []
    for on in (False, True):
        pipe = tpipe.SlamPipeline(cfg.override({"filter.detect_ground": on}), kf_points=512)
        runs.append([pipe.process_scan(x, i, stamp=0.1 * k) for k, (x, i) in enumerate(scans)])
    for off, on in zip(*runs):
        assert off["ground"] is None
        np.testing.assert_array_equal(off["pose"], on["pose"])
        g = on["ground"]
        assert isinstance(g, tground.GroundResult) and bool(g.valid)
        assert abs(float(g.coeffs[3]) - 1.73) < 0.05 and float(g.coeffs[2]) > 0.99
        assert int(g.ground_mask.sum()) > 100


@pytest.mark.parametrize("setting", ["filter.detect_ground=true", "loop.async_detect=true"])
def test_run_sim_host_engine_runs_and_device_engine_refuses(setting):
    """`run-sim --set` of the ground path or the loop worker: the host
    engine runs it; the device engine refuses it by name, as the
    reference's device engine has neither."""
    from xchu_slam_tpu_torch import cli

    tiny = ["filter.max_points=2048", "filter.max_raw_points=8192", "pgo.max_keyframes=16",
            "loop.submap_points=2048", setting]
    pipe, summary = cli.run_sim(4, 20.0, 0, "cpu", overrides=tiny)
    assert summary["scans"] == 4 and pipe.kf_count >= 1
    assert getattr(pipe, "_worker", None) is None          # stopped by finalize
    with pytest.raises(ValueError, match=setting.split("=")[0]):
        cli.run_sim(4, 20.0, 0, "cpu", overrides=tiny, engine="device")
